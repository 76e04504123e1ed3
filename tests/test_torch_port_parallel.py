"""The port's data parallelism (``amuse_tpu_torch/parallel/mesh.py``) on the CPU.

Two gloo ranks, spawned once for the module (``tests/torch_port_dist.py``),
run the LPDM and stage-1 steps over one global batch, the sharded fbank and
the sharded ``encode_audio``; each result is held against one process over
the same global batch (``mesh=None``), against JAX's 8-device mesh step
(``conftest.py`` gives 8 CPU devices), and across the ranks, whose
parameters must agree bit for bit. Four ranks run the two-axis mesh of
``tests/test_mesh.py``.

Two ranks against one process (``torch_port_dist.errors``): every logged
loss of both steps rtol 1e-5; the first step's gradients, after the sync,
within 1e-4 of their parameter's largest entry; the parameters after the
first Adam step (lr 1e-4) within lr/10 on every element whose gradient is
above 1e-6, which is half of them or more. Adam's first updates are
sign-like where a gradient is near 0, so float32 reduction-order noise may
move those elements by up to ~lr (and the second step's gradients and
parameters with them): the bound leaves them out, as the single-device
comparisons with JAX do, and the second step is held by its losses. A
planted fault (each rank steps on its own rows' gradient) fails each of
these bounds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from amuse_tpu.diffusion import add_noise as jadd_noise
from amuse_tpu.diffusion import ddim_sample as jddim_sample
from amuse_tpu.diffusion import make_schedule as jmake_schedule
from amuse_tpu.core import motion as jmotion
from amuse_tpu.models import ast as jast
from amuse_tpu.models import denoiser as jden
from amuse_tpu.models import vae as jvae
from amuse_tpu.parallel import make_mesh as jmake_mesh
from amuse_tpu.train import losses as jL
from amuse_tpu.train.fused_adam import make_fused_adam
from amuse_tpu.utils import torch_import as ti
from amuse_tpu_torch import convert
from amuse_tpu_torch.models import transformer as ttr
from amuse_tpu_torch.parallel import mesh as M
from amuse_tpu_torch.train import audio as ta
from amuse_tpu_torch.train import gesture as tg
from tests import torch_port_dist as D

CPU = torch.device("cpu")
GLOBAL_B = 8
STAGE1_QUADS = 8  # the JAX mesh's 8 devices, 4 quads a rank here


def _noise(seed: int, b: int) -> dict:
    rng = np.random.default_rng(seed)
    shape = (b, 1, 16)
    return {"enc": rng.normal(size=shape).astype(np.float32),
            "enc2": rng.normal(size=shape).astype(np.float32),
            "t": rng.integers(0, 1000, b).astype(np.int64),
            "noise": rng.normal(size=shape).astype(np.float32),
            "latents": rng.normal(size=shape).astype(np.float32)}


def _jax_value_and_grad():
    """The JAX LPDM loss (amuse_tpu/train/gesture.py:126-205 without the vertex
    monitors) with the draws injected and dropout off, jitted."""
    prior = jvae.MotionPrior(jvae.PriorConfig(**D.PRIOR_KW))
    den = jden.Denoiser(jden.DenoiserConfig(**D.DEN_KW))
    sched = jmake_schedule()

    def loss(params, batch, draws):
        m6 = jmotion.featurize(batch["motion"], "6D", False)
        pp = {"params": params["prior"]}
        mu, logvar = prior.apply(pp, m6, method="encode_params")
        m_rst = prior.apply(pp, mu + jnp.exp(0.5 * logvar) * draws["enc"], D.T, method="decode")
        mu2, lv2 = prior.apply(pp, m6, method="encode_params")
        z_sg = jax.lax.stop_gradient(mu2 + jnp.exp(0.5 * lv2) * draws["enc2"])
        conds = (batch["con"], batch["emo"], batch["sty"])
        noise_pred = den.apply({"params": params["denoiser"]},
                               jadd_noise(sched, z_sg, draws["noise"], draws["t"]),
                               draws["t"], *conds)
        sg = jax.lax.stop_gradient(params)
        gen_z = jddim_sample(sched, lambda x, t: den.apply({"params": sg["denoiser"]}, x, t,
                                                           *conds),
                             None, draws["latents"].shape, D.STEPS,
                             initial_latents=draws["latents"])
        gen_m = prior.apply({"params": sg["prior"]}, gen_z, D.T, method="decode")
        return jL.lpdm_losses(m6, m_rst, mu, logvar, draws["noise"], noise_pred, gen_m)

    return jax.jit(jax.value_and_grad(loss, has_aux=True))


def _port_tree(tree) -> dict:
    """A JAX {prior, denoiser} tree under ``torch_port_dist._params``' names."""
    tree = jax.tree.map(np.asarray, tree)
    return {**{f"0.{k}": v for k, v in convert.prior_from_jax(tree["prior"]).items()},
            **{f"1.{k}": v for k, v in convert.denoiser_from_jax(tree["denoiser"]).items()}}


@pytest.fixture(scope="module")
def jax_case():
    """JAX parameters (the port's seed-0 initialisation through the JAX
    package's importer), their conversion back into the port, and one set of
    draws for the global batch."""
    state = tg.init_state(0, tg.PriorConfig(**D.PRIOR_KW), tg.DenoiserConfig(**D.DEN_KW),
                          device=CPU)
    sd = {k: {n: v.numpy() for n, v in m.state_dict().items()}
          for k, m in (("prior", state.prior), ("denoiser", state.denoiser))}
    params = {"prior": ti.motion_prior_from_torch(sd["prior"], num_layers=3),
              "denoiser": ti.denoiser_from_torch(sd["denoiser"], num_layers=3)}
    tree = jax.tree.map(np.asarray, params)
    weights = {"prior": convert.prior_from_jax(tree["prior"]),
               "denoiser": convert.denoiser_from_jax(tree["denoiser"])}
    return params, weights, _noise(9, GLOBAL_B)


def _jax_stage1_value_and_grad(model):
    """The JAX stage-1 step's composition (amuse_tpu/train/audio.py:164-231)
    with augmentation and dropout off, as tests/test_torch_port_train.py
    runs it on one device, jitted."""
    t, f = D.AST_KW["input_tdim"], D.AST_KW["input_fdim"]

    def loss(params, batch):
        quad = jnp.swapaxes(batch["fbanks"], 0, 1)
        b = quad.shape[1]
        enc = model.apply({"params": params}, quad.reshape(4 * b, t, f), True, True,
                          method="encode")
        fe, fs, fc = (enc[k]["feature"].reshape(4, b, -1) for k in ("emo", "sty", "con"))
        part, other, ident = jnp.asarray([2, 3, 0, 1]), jnp.asarray([1, 0, 3, 2]), jnp.arange(4)
        cb = lambda e, s, c: jnp.concatenate([fe[e], fs[s], fc[c]], -1)  # noqa: E731
        groups = jnp.concatenate([cb(ident, ident, ident), cb(ident, ident, part),
                                  cb(other, ident, ident), cb(ident, other, ident)])
        recons = model.apply({"params": params}, groups, True, method="reconstruct")
        return jL.ast_swap_losses(recons, quad, enc["emo"]["logits"].reshape(4, b, -1),
                                  enc["sty"]["logits"].reshape(4, b, -1), fc,
                                  batch["emo_id"], batch["a1_id"], batch["a2_id"])

    return jax.jit(jax.value_and_grad(loss, has_aux=True))


@pytest.fixture(scope="module")
def jax_stage1_case():
    """A flax-initialised stage-1 model at the workers' widths (fusion 64)
    and its conversion into the port."""
    model = jast.ASTDisentangler(dtype=jnp.float32, base_cfg=jast.ASTConfig(**D.AST_KW),
                                 fusion_dim=64)
    x = jnp.zeros((1, D.AST_KW["input_tdim"], D.AST_KW["input_fdim"]))
    params = jax.jit(lambda r: model.init(r, x, True))(jax.random.key(0))["params"]
    return model, params, convert.disentangler_from_jax(jax.tree.map(np.asarray, params))


@pytest.fixture(scope="module")
def ranks(jax_case, jax_stage1_case, tmp_path_factory):
    """Both ranks' results of every two-rank scenario (one spawn)."""
    _, weights, noise = jax_case
    return D.run_ranks(D.suite, 2, tmp_path_factory.mktemp("two_ranks"), weights, noise,
                       jax_stage1_case[2])


@pytest.fixture(scope="module")
def one():
    """One process's LPDM and stage-1 steps over the global batches."""
    return {"lpdm": D.lpdm_steps(None, CPU), "stage1": D.stage1_steps(None, CPU)}


def _assert_ranks_equal(results: list, key: str) -> None:
    a, b = (r[key]["params"] for r in results)
    assert a.keys() == b.keys()
    for n in a:
        assert torch.equal(a[n], b[n]), n


def _assert_close(results: list, want: dict, key: str) -> None:
    """Bit-equal across the ranks, and each rank within the module's bounds
    of one process."""
    _assert_ranks_equal(results, key)
    for r in results:
        err = D.errors(r[key], want)
        assert D.within(err), err


class TestTwoRanks:
    def test_lpdm_two_ranks_equal_one_process(self, ranks, one):
        """Two LPDM steps at global batch 8 (4 rows a rank), the DDIM monitor on,
        dropout 0, the StepNoise drawn from the step's generator for the global
        batch on each rank (each keeps its rows)."""
        assert [r["lpdm"]["rows"] for r in ranks] == [4, 4]
        assert [(r["rank"], r["size"]) for r in ranks] == [(0, 2), (1, 2)]
        _assert_close(ranks, one["lpdm"], "lpdm")

    def test_lpdm_dropout_is_drawn_for_the_global_batch(self, ranks, one):
        """Dropout 0.1 in the prior and the denoiser: each rank draws every
        mask at the global batch's shape from the step's one generator and
        keeps its rows, so the two ranks reproduce one process's two steps
        within the module's bounds (and the masks did act: a logged term of
        the first step lies over 100 times LOSS_RTOL from the dropout-0
        step's). Each rank's masks drawn at its local
        shape from a generator of its own (``torch_port_dist.LocalMasks``, the
        step before this draw) fall outside them."""
        want = D.lpdm_steps(None, CPU, dropout=0.1)
        _assert_close(ranks, want, "lpdm_dropout")
        plain, drop = one["lpdm"]["logs"][0], want["logs"][0]
        assert max(abs(plain[k] / drop[k] - 1) for k in drop) > 100 * D.LOSS_RTOL
        for r in ranks:
            err = D.errors(r["lpdm_local_masks"], want)
            assert not D.within(err) and max(err["loss"]) > 10 * D.LOSS_RTOL, err

    def test_stage1_two_ranks_equal_one_process(self, ranks, one):
        """Two stage-1 steps at 2 global quads (1 a rank), augmentation and
        dropout off; the fusion and decoder attend across the batch, so each
        rank runs them on the gathered global stack. The parameters the loss
        does not reach (``fusion_ablation``: the step reconstructs through
        ``fusion``) get a zero gradient before the Adam step, the same set on
        both ranks and in one process; the label heads of the other branch
        keep ``None``."""
        want = one["stage1"]
        _assert_close(ranks, want, "stage1")
        no_grad = [r["stage1"]["no_grad"] for r in ranks]
        assert no_grad[0] == no_grad[1] == want["no_grad"]
        assert no_grad[0] and all("_enc.mlp_head." in n for n in no_grad[0])
        filled = [r["stage1"]["zero_filled"] for r in ranks]
        assert filled[0] == filled[1] == want["zero_filled"]
        assert "fusion_ablation.fc.weight" in filled[0]
        assert all(n.startswith("fusion_ablation.") for n in filled[0])

    def test_stage1_augmentation_and_dropout_are_drawn_for_the_global_batch(self, ranks, one):
        """With augmentation and dropout (0.1) on, each rank draws the masks,
        the noise and the shifts for the global batch's 8 members and keeps
        its own 4, and the decoder's dropout masks for the global stack from
        the step's one generator: the two ranks reproduce one process's step
        within the same bounds (and the draws did act: the plain step's loss
        is >1% away)."""
        want = D.stage1_steps(None, CPU, stochastic=True, dropout=0.1)
        _assert_close(ranks, want, "stage1_augmented")
        plain = one["stage1"]
        assert abs(plain["logs"][0]["total"] / want["logs"][0]["total"] - 1) > 1e-2

    @pytest.mark.parametrize("key", ["lpdm", "stage1"])
    def test_a_rank_stepping_on_its_own_rows_fails(self, ranks, one, key):
        """The planted fault (``torch_port_dist.OwnRowsOnly``: the gradients
        are not all-reduced, the logs still are): the ranks' parameters part,
        and each rank's gradients and parameters fall outside the bounds
        that the synced step meets."""
        want = one[key]
        with pytest.raises(AssertionError):
            _assert_ranks_equal(ranks, f"{key}_fault")
        for r in ranks:
            err = D.errors(r[f"{key}_fault"], want)
            assert not D.within(err)
            assert (max(err["loss"]) > 10 * D.LOSS_RTOL and err["grad"] > 100 * D.GRAD_REL
                    and err["param"] > D.PARAM_ATOL), err

    def test_stage1_two_ranks_match_jax_mesh(self, ranks, jax_stage1_case):
        """The port's two-rank stage-1 step (4 quads a rank, ``stochastic=False``)
        against the JAX step's composition on the 8-device mesh (2 quads a
        device, parameters replicated), from the same flax-initialised
        weights: the bounds of the single-device comparison
        (tests/test_torch_port_train.py): the loss rtol 1e-6 and every
        logged term rtol 1e-5 (atol 1e-6) at step 1; each gradient of step 1
        within 1e-4 of its largest entry; after two Adam steps (FusedAdam "l2",
        lr 1e-4) each parameter within lr/10 where both steps' gradients
        exceed 1e-5, which is most of them, and every element of those the
        loss does not reach (``fusion_ablation``, zero gradient on both
        sides, moved by the L2 decay alone)."""
        model, params, _ = jax_stage1_case
        mesh = jmake_mesh()
        assert mesh.devices.size == 8
        data, repl = NamedSharding(mesh, P("data")), NamedSharding(mesh, P())
        host = D.stage1_batch(2, STAGE1_QUADS, D.AST_KW["input_tdim"], D.AST_KW["input_fdim"])
        batch = jax.device_put({k: np.asarray(v, np.float32 if k == "fbanks" else np.int32)
                                for k, v in host.items()}, data)
        value_and_grad = _jax_stage1_value_and_grad(model)
        opt = make_fused_adam(b1=0.95, b2=0.999, weight_decay=5e-7, mode="l2")
        jparams = jax.device_put(params, repl)
        jstate, jlogs, jgrads = jax.device_put(opt.init(params, D.LR), repl), [], []
        with mesh:
            for _ in range(2):
                (loss, logs), g = value_and_grad(jparams, batch)
                jlogs.append({"total": float(loss), **{k: float(v) for k, v in logs.items()}})
                jgrads.append(convert.disentangler_from_jax(jax.tree.map(np.asarray, g)))
                jparams, jstate = jax.jit(opt.apply)(jstate, jparams, g)
        _assert_ranks_equal(ranks, "stage1_jax")
        got = {k: ranks[0]["stage1_jax"][k] for k in ("logs", "grads", "params")}
        got["grads"] = [{n[len("0."):]: g for n, g in step.items()} for step in got["grads"]]
        got["params"] = {n[len("0."):]: p for n, p in got["params"].items()}
        assert got["logs"][0]["total"] == pytest.approx(jlogs[0]["total"], rel=1e-6)
        for k, v in jlogs[0].items():
            assert got["logs"][0][k] == pytest.approx(v, rel=1e-5, abs=1e-6), k
        for n, g in got["grads"][0].items():
            w = jgrads[0][n]
            assert bool(g.any()) == bool(w.any()), n  # zero only where the loss does not reach
            assert (g - w).abs().max() <= 1e-4 * w.abs().max() + 1e-9, n
        want, moved, reached = convert.disentangler_from_jax(
            jax.tree.map(np.asarray, jparams)), 0, 0
        for n, g in got["grads"][0].items():
            keep = (jgrads[0][n].abs() > 1e-5) & (jgrads[1][n].abs() > 1e-5)
            if not (jgrads[0][n].any() or jgrads[1][n].any()):
                keep = torch.ones_like(keep)  # unreached: decay alone moves it
            diff = (got["params"][n] - want[n]).abs()[keep]
            assert diff.numel() == 0 or diff.max().item() <= D.LR / 10, n
            moved, reached = moved + int(keep.sum()), reached + g.numel()
        assert moved > 0.75 * reached

    def test_lpdm_two_ranks_match_jax_mesh(self, ranks, jax_case):
        """The port's two-rank step against JAX's 8-device mesh step (batch and
        draws sharded over "data", parameters replicated), the same converted
        weights and injected draws: the tolerances of the single-device
        comparison (tests/test_torch_port_gesture.py): every logged term of
        step 1 rtol 1e-5 (atol 1e-7), and after two AdamW steps (FusedAdam
        "decoupled", weight decay 0.01) each parameter within lr/10 where both
        steps' gradients are above 1e-5."""
        params, _, noise = jax_case
        mesh = jmake_mesh()
        assert mesh.devices.size == 8
        data, repl = NamedSharding(mesh, P("data")), NamedSharding(mesh, P())
        batch = jax.device_put(D.lpdm_batch(1, GLOBAL_B), data)
        draws = jax.device_put(noise, data)
        value_and_grad = _jax_value_and_grad()
        opt = make_fused_adam(weight_decay=0.01, mode="decoupled")
        jparams = jax.device_put(params, repl)
        jstate, jlogs, jgrads = jax.device_put(opt.init(params, D.LR), repl), [], []
        with mesh:
            for _ in range(2):
                (_, logs), g = value_and_grad(jparams, batch, draws)
                jlogs.append({k: float(v) for k, v in logs.items()})
                jgrads.append(_port_tree(g))
                jparams, jstate = jax.jit(opt.apply)(jstate, jparams, g)
        _assert_ranks_equal(ranks, "lpdm_injected")
        got = ranks[0]["lpdm_injected"]
        assert got["logs"][0].keys() == jlogs[0].keys()
        for k, v in jlogs[0].items():
            assert got["logs"][0][k] == pytest.approx(v, rel=1e-5, abs=1e-7), k
        want, moved = _port_tree(jparams), 0
        for n, p in got["params"].items():
            keep = (jgrads[0][n].abs() > 1e-5) & (jgrads[1][n].abs() > 1e-5)
            diff = (p - want[n]).abs()[keep]
            assert diff.numel() == 0 or diff.max().item() <= D.LR / 10, n
            moved += int(keep.sum())
        assert moved > 0.5 * sum(p.numel() for p in got["params"].values())

    def test_sharded_fbank_and_encode_equal_one_rank(self, ranks):
        """``make_sharded_fbank`` over 6 chunks (3 a rank) gives one rank's
        bytes on both ranks (each chunk's fbank is computed alone). The
        sharded ``encode_audio`` over 5 chunks (padded to 6, the pad
        stripped) is within 1e-6 of one rank's (features of ~1.3): the CPU's
        float32 GEMMs round by the batch's row count, 1.2e-7 here, as they do
        for another split of the chunks in one process."""
        want = D.fbank_and_encode(None, CPU)
        assert want["fbank"].shape == (6, 1024, 128) and want["con"].shape == (5, 8)
        for r in ranks:
            assert torch.equal(r["encode"]["fbank"], want["fbank"])
            for k in ("con", "emo", "sty"):
                torch.testing.assert_close(r["encode"][k], want[k], atol=1e-6, rtol=0)

    def test_replicate_raises_when_ranks_disagree(self, ranks):
        """A module whose ranks hold different weights: replicate raises on both
        ranks, and leaves rank 0's weights on both."""
        for r in ranks:
            assert "ranks disagree" in r["replicate_raised"]
            assert torch.equal(r["after_replicate"], torch.zeros(2, 3))


def test_model_axis_megatron_matmul(tmp_path):
    """Four gloo ranks as a (data=2, model=2) mesh: the Megatron two-matmul
    product with an explicit all-reduce over the model group equals the
    unsharded product (rtol and atol 1e-5, float32); the host gathers refuse
    a model axis above 1."""
    results = D.run_ranks(D.megatron, 4, tmp_path, n_model=2)
    assert [(r["data_rank"], r["model_rank"]) for r in results] == [(0, 0), (0, 1), (1, 0),
                                                                     (1, 1)]
    for r in results:
        assert r["shape"] == (2, 2)
        np.testing.assert_allclose(r["y"].numpy(), r["want"].numpy(), rtol=1e-5, atol=1e-5)
        assert "model axis is 1" in r["gather_error"]


class TestSingleProcess:
    def test_no_process_group_and_identity_helpers(self, monkeypatch):
        """Without WORLD_SIZE nothing initializes a group; every helper is the
        identity or its single-process meaning for ``mesh=None``."""
        monkeypatch.delenv("WORLD_SIZE", raising=False)
        calls = []
        monkeypatch.setattr(torch.distributed, "init_process_group",
                            lambda *a, **k: calls.append((a, k)))
        assert M.initialize_distributed("cpu") is False and not calls
        assert M.current_mesh() is None and not torch.distributed.is_initialized()
        batch = {"a": np.arange(6)}
        assert M.shard_rows(batch, None) is batch
        assert M.data_size(None) == 1 and M.data_rank(None) == 0 and M.is_main(None)
        assert M.broadcast_object("x", None) == "x"
        logs = {"total": torch.tensor(1.5)}
        assert M.mean_logs(logs, None) is logs
        fn = M.sharded_rows_fn(np.negative, None)
        assert fn is np.negative
        lin = torch.nn.Linear(2, 2)
        lin(torch.ones(1, 2)).sum().backward()
        g = lin.weight.grad.clone()
        M.all_reduce_grads(lin.parameters(), None)
        M.replicate([lin], None)
        assert torch.equal(lin.weight.grad, g)

    @pytest.mark.parametrize("kind", ["lpdm", "stage1"])
    def test_grad_sync_without_a_mesh_is_the_plain_step(self, kind):
        """``GradSync(None)`` (one rank, no group) gives the step without
        ``grad_sync`` bit for bit, dropout 0.1 on: the same draws, masks,
        gradients and logs."""
        prior_cfg = tg.PriorConfig(**{**D.PRIOR_KW, "dropout": 0.1})
        den_cfg = tg.DenoiserConfig(**{**D.DEN_KW, "dropout": 0.1})

        def run(sync):
            torch.manual_seed(0)
            if kind == "lpdm":
                state = tg.init_state(0, prior_cfg, den_cfg, D.TCFG, CPU)
                step = tg.make_train_step(prior_cfg, den_cfg, D.TCFG, grad_sync=sync)
                batch = tg.batch_to_device(D.lpdm_batch(2, 4), CPU)
                modules = (state.prior, state.denoiser)
            else:
                model = D.ASTDisentangler(D.ASTConfig(**D.AST_KW), fusion_dim=64, dropout=0.1)
                state = ta.AudioTrainState(model, ta.make_optimizer(model, D.ACFG))
                step, _ = ta.make_train_step(D.ACFG, sync)
                batch = ta.batch_to_device(D.stage1_batch(3, 2, 64, 32), CPU)
                modules = (model,)
            logs = [step(state, batch, ta.step_generator(1, 0, i, CPU)) for i in range(2)]
            return logs, D._params(*modules)

        (la, pa), (lb, pb) = run(None), run(M.GradSync(None))
        assert all(torch.equal(a[k], b[k]) for a, b in zip(la, lb) for k in a)
        assert all(torch.equal(pa[n], pb[n]) for n in pa)

    def test_shard_rows_and_rows(self):
        """A rank's contiguous rows; a leading dim that does not divide raises;
        a rank's dropout masks are its rows of the global batch's."""
        class Fake:  # the two calls shard_rows makes of a DeviceMesh
            def size(self, dim):
                return 2

            def get_local_rank(self, name):
                return 1

        batch = {"a": np.arange(8).reshape(4, 2), "b": (torch.arange(4),)}
        got = M.shard_rows(batch, Fake())
        np.testing.assert_array_equal(got["a"], [[4, 5], [6, 7]])
        assert torch.equal(got["b"][0], torch.tensor([2, 3]))
        with pytest.raises(ValueError, match="not divisible"):
            M.shard_rows({"a": np.zeros(3)}, Fake())
        sync = M.GradSync.__new__(M.GradSync)
        sync.size, sync.rank = 2, 1
        assert sync.rows(4) == slice(4, 8)
        # rank 1's dropout draws: the global batch's mask, its rows 4..8
        x = torch.ones(4, 3, 5)
        draws = sync.dropout_draws(torch.Generator().manual_seed(7))
        assert draws[1:] == (2, 1)
        mine = ttr.dropout(x, 0.5, True, draws)
        whole = ttr.dropout(torch.ones(8, 3, 5), 0.5, True, torch.Generator().manual_seed(7))
        assert torch.equal(mine, whole[4:8])

    def test_buckets_bound_their_bytes(self):
        """Buckets of consecutive same-dtype tensors of at most the bound; a
        larger tensor is a bucket alone; values round-trip through the flat
        buffer."""
        ts = [torch.zeros(10), torch.zeros(10), torch.zeros(30), torch.zeros(5, dtype=torch.int64),
              torch.zeros(3)]
        got = [[t.numel() for t in b] for b in M._buckets(ts, 80)]
        assert got == [[10, 10], [30], [5], [3]]
        flat = torch.arange(6.0)
        a, b = torch.zeros(2, 2), torch.zeros(2)
        M._unflatten_into(flat, [a, b])
        assert a.tolist() == [[0, 1], [2, 3]] and b.tolist() == [4, 5]
