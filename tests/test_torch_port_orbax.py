"""JAX orbax checkpoints carried into the port (``orbax_to_torch.py``), on the CPU.

Tiny JAX runs are saved with ``amuse_tpu.train.checkpoint.CheckpointManager``
and converted by the root script's ``convert_run``. A stage-1 run (the AST
of tests/test_torch_port_train.py, 64x32 fbanks) and an LPDM run (the prior
and denoiser of tests/torch_port_dist.py) take one JAX step first, so that
the moments and ``count`` are not zero; draws are injected and dropout is
off on both sides, as in those tests. Both packages then resume and take
the next step, held to the bounds of the existing two-step comparisons:
  * stage 1 (tests/test_torch_port_train.py, ``TestTrainStep``): the loss
    rtol 1e-6, every logged term rtol 1e-5 (atol 1e-6); the parameters
    within lr/10 where both steps' gradients exceed 1e-5, which must hold
    over 75% of the elements the loss reaches;
  * LPDM (tests/test_torch_port_gesture.py, ``TestTrainStep``): every logged
    term rtol 1e-5 (atol 1e-7); the parameters within lr/10 on the same
    elements, over 50% of them.
Inference from the converted runs is held to the float32 bounds of
tests/test_torch_port_pipeline.py. Also here: the stage-1 bank that a
data-parallel run maps from one copy per host unpacked into the run's
directory.
"""

import json
import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import orbax_to_torch
from amuse_tpu.models import ast as jast
from amuse_tpu.models import denoiser as jden
from amuse_tpu.models import vae as jvae
from amuse_tpu.train import audio as jta
from amuse_tpu.train import gesture as jtg
from amuse_tpu.train.checkpoint import CheckpointManager as JaxManager
from amuse_tpu.train.checkpoint import restore_train_state as jax_restore
from amuse_tpu.utils import checkpoint_io as jcio
from amuse_tpu.utils import torch_import as ti
from amuse_tpu_torch import convert
from amuse_tpu_torch.data import stage1
from amuse_tpu_torch.models import ast as tast
from amuse_tpu_torch.models.denoiser import DenoiserConfig
from amuse_tpu_torch.models.vae import PriorConfig
from amuse_tpu_torch.train import audio as ta
from amuse_tpu_torch.train import gesture as tg
from amuse_tpu_torch.train.checkpoint import CheckpointManager, restore_train_state
from amuse_tpu_torch.utils import checkpoint_io as cio
from tests import torch_port_dist as D
from tests import torch_sd
from tests.test_torch_port_parallel import _jax_value_and_grad as _jax_lpdm_value_and_grad
from tests.test_torch_port_pipeline import DEN_KW as PIPE_DEN
from tests.test_torch_port_pipeline import PRIOR_KW as PIPE_PRIOR
from tests.test_torch_port_pipeline import _chunks, _compare, _jax, _latents, _port
from tests.test_torch_port_train import AST, _batch as _s1_batch, _jax_stage1_value_and_grad

CPU = torch.device("cpu")
LR = D.LR
PARAM_ATOL = LR / 10  # both existing two-step comparisons
GRAD_FLOOR = 1e-5  # "well above Adam's eps in both steps"
S1_COVERED, LPDM_COVERED = 0.75, 0.5
S1_LOSS_RTOL, S1_TERM_RTOL, S1_TERM_ATOL = 1e-6, 1e-5, 1e-6
LPDM_TERM_RTOL, LPDM_TERM_ATOL = 1e-5, 1e-7


def _tree(x) -> dict:
    return jax.tree.map(np.asarray, x)


def _lpdm_names(tree) -> dict:
    """A JAX {prior, denoiser} tree under the port's ``prior.*`` / ``denoiser.*`` names."""
    tree = _tree(tree)
    return {**{f"prior.{k}": v for k, v in convert.prior_from_jax(tree["prior"]).items()},
            **{f"denoiser.{k}": v for k, v in convert.denoiser_from_jax(tree["denoiser"]).items()}}


def _draws(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    shape = (4, 1, 16)
    return {"enc": rng.normal(size=shape).astype(np.float32),
            "enc2": rng.normal(size=shape).astype(np.float32),
            "t": rng.integers(0, 1000, 4).astype(np.int64),
            "noise": rng.normal(size=shape).astype(np.float32),
            "latents": rng.normal(size=shape).astype(np.float32)}


def _noise(draws) -> tg.StepNoise:
    return tg.StepNoise(*(torch.from_numpy(draws[k]) for k in tg.StepNoise._fields))


def _held(got: dict, want: dict, grads: list) -> tuple[float, float]:
    """The largest |got - want| where every step's JAX gradient exceeds
    GRAD_FLOOR, and the share of the elements of ``got`` that holds it."""
    worst, kept, total = 0.0, 0, 0
    for n, p in got.items():
        keep = torch.ones_like(p, dtype=torch.bool)
        for g in grads:
            keep &= g[n].abs() > GRAD_FLOOR
        if keep.any():
            worst = max(worst, (p - want[n]).abs()[keep].max().item())
        kept, total = kept + int(keep.sum()), total + p.numel()
    return worst, kept / total


# ---------------------------------------------------------------- stage 1

@pytest.fixture(scope="module")
def stage1_run(tmp_path_factory):
    """A JAX stage-1 run after one step (FusedAdam "l2", lr 1e-4), saved at
    step 1 and converted; the jitted value_and_grad; the first step's gradients."""
    root = tmp_path_factory.mktemp("stage1")
    cfg = jta.AudioTrainConfig(learning_rate=LR)
    state = jta.init_state(jax.random.key(0), cfg, jnp.float32, jast.ASTConfig(**AST))
    _, value_and_grad = _jax_stage1_value_and_grad(jnp.float32)
    apply = jax.jit(jta.make_optimizer(cfg).apply)
    _, g1 = value_and_grad(state.params, _s1_batch(21))
    params, opt = apply(state.opt_state, state.params, g1)
    state = jta.AudioTrainState(params, opt, state.step + 1)
    JaxManager(root / "jax").save(1, state, {"total": 1.5})
    assert orbax_to_torch.convert_run(root / "jax", root / "port") == [1]
    return root, state, (value_and_grad, apply), convert.disentangler_from_jax(_tree(g1))


def _port_stage1() -> ta.AudioTrainState:
    return ta.init_state(3, ta.AudioTrainConfig(learning_rate=LR), torch.float32,
                         tast.ASTConfig(**AST), CPU)


def _stage1_next(state, jax_fns, batch):
    value_and_grad, apply = jax_fns
    (loss, logs), g = value_and_grad(state.params, batch)
    params, _ = apply(state.opt_state, state.params, g)
    return float(loss), {k: float(v) for k, v in logs.items()}, g, params


class TestStage1:
    @pytest.fixture(scope="class")
    def resumed(self, stage1_run):
        """JAX's next step from the orbax run: its losses and parameters, and
        both steps' gradients under the port's names."""
        root, template, jax_fns, g1 = stage1_run
        jstate, jepoch = jax_restore(root / "jax", template, "AST-T")
        batch = _s1_batch(22)
        jloss, jlogs, g2, jparams = _stage1_next(jstate, jax_fns, batch)
        return {"batch": batch, "epoch": jepoch, "loss": jloss, "logs": jlogs,
                "grads": [g1, convert.disentangler_from_jax(_tree(g2))],
                "params": convert.disentangler_from_jax(_tree(jparams))}

    def test_parameters_moments_and_layout(self, stage1_run):
        """The converted parameters are ``disentangler_from_jax`` of the tree
        bit for bit; each parameter's Adam state holds the moments mapped the
        same way and ``step`` = count = 1; ``lr`` is the JAX state's; the
        metadata is copied. The untraced label heads are the one-sided
        parameters: absent, without optimizer state."""
        root, state = stage1_run[:2]
        saved, meta = CheckpointManager(root / "port").restore()
        assert meta == json.loads((root / "jax" / "step_00000001" / "metadata.json").read_text())
        want = convert.disentangler_from_jax(_tree(state.params))
        assert saved["model"].keys() == want.keys() and saved["step"] == 1
        for k, v in want.items():
            assert torch.equal(saved["model"][k], v), k
        port = _port_stage1()
        names = [n for n, _ in port.model.named_parameters()]
        one_sided = sorted(set(names) - set(want))
        assert one_sided and all(".mlp_head." in n for n in one_sided), one_sided
        opt = saved["optimizer"]
        mu, nu = (convert.disentangler_from_jax(_tree(x)) for x in (state.opt_state.mu,
                                                                   state.opt_state.nu))
        assert sorted(opt["state"]) == [i for i, n in enumerate(names) if n in want]
        for i, n in enumerate(names):
            if n in want:
                s = opt["state"][i]
                assert torch.equal(s["exp_avg"], mu[n]) and torch.equal(s["exp_avg_sq"], nu[n])
                assert s["step"].dtype == torch.float32 and s["step"].item() == 1.0
        assert opt["param_groups"][0]["lr"] == float(state.opt_state.lr)
        # the JAX lr is the schedule's at the epoch trained (0); set_lr at the
        # resumed epoch replaces it in both packages
        assert float(state.opt_state.lr) == pytest.approx(
            ta.lr_schedule(ta.AudioTrainConfig(learning_rate=LR), 0), rel=1e-7)

    def test_resume_equals_jax_next_step(self, stage1_run, resumed, capsys):
        """The port resumes the converted run through ``restore_train_state``
        and takes the next step; JAX resumes the orbax run through its own
        and takes the same step: losses and parameters within the bounds of
        the module docstring. Parameters the loss does not reach
        (``fusion_ablation``, the label heads) get no gradient in the port and
        are left out, as there."""
        state, epoch = restore_train_state(stage1_run[0] / "port", _port_stage1(), "AST-T")
        assert epoch == resumed["epoch"] == 1 and state.step == 1
        assert "resumed full train state (params + optimizer)" in capsys.readouterr().out
        logs = _stage1_port_next(state, resumed["batch"])
        assert logs["total"].item() == pytest.approx(resumed["loss"], rel=S1_LOSS_RTOL)
        for k, v in resumed["logs"].items():
            assert logs[k].item() == pytest.approx(v, rel=S1_TERM_RTOL, abs=S1_TERM_ATOL), k
        got = _stage1_reached(state)
        assert not any(n.startswith("fusion_ablation") for n in got)
        worst, share = _held(got, resumed["params"], resumed["grads"])
        assert worst <= PARAM_ATOL and share > S1_COVERED, (worst, share)
        # the Adam step reads 2 on every parameter the step reached
        steps = {n: state.optimizer.state[p]["step"].item()
                 for n, p in state.model.named_parameters() if p.grad is not None}
        assert set(steps.values()) == {2.0}

    def test_zeroed_moments_fall_outside_the_bounds(self, stage1_run, resumed):
        """The planted fault: the same resume with both moments zeroed (count
        kept) misses the parameter bound that the true resume meets."""
        saved, _ = CheckpointManager(stage1_run[0] / "port").restore()
        for s in saved["optimizer"]["state"].values():
            s["exp_avg"].zero_()
            s["exp_avg_sq"].zero_()
        state = _port_stage1()
        state.load_state_dict(saved)
        _stage1_port_next(state, resumed["batch"])
        worst, _ = _held(_stage1_reached(state), resumed["params"], resumed["grads"])
        assert worst > PARAM_ATOL, worst


def _stage1_port_next(state, batch) -> dict:
    step, _ = ta.make_train_step(ta.AudioTrainConfig(learning_rate=LR))
    return step(state, ta.batch_to_device(batch, CPU), None, stochastic=False)


def _stage1_reached(state) -> dict:
    """The parameters that the step's loss reached (those with a gradient)."""
    return {n: p.detach() for n, p in state.model.named_parameters() if p.grad is not None}


# ---------------------------------------------------------------- LPDM

@pytest.fixture(scope="module")
def lpdm_run(tmp_path_factory):
    """A JAX LPDM run after one step (FusedAdam "decoupled", weight decay
    0.01, lr 1e-4) at the widths of tests/torch_port_dist.py, saved at step 1
    and converted; also its bare parameters saved as an older run."""
    root = tmp_path_factory.mktemp("lpdm")
    cfg = jtg.GestureTrainConfig(learning_rate=LR)
    state = jtg.init_state(jax.random.key(1), jvae.PriorConfig(**D.PRIOR_KW),
                           jden.DenoiserConfig(**D.DEN_KW), cfg)
    value_and_grad = _jax_lpdm_value_and_grad()
    apply = jax.jit(jtg.make_optimizer(cfg).apply)
    batch = D.lpdm_batch(31, 4)
    _, g1 = value_and_grad(state.params, batch, _draws(32))
    params, opt = apply(state.opt_state, state.params, g1)
    state = jtg.TrainState(params, opt, state.step + 1)
    JaxManager(root / "jax").save(1, state, {"total": 0.5})
    JaxManager(root / "jax_bare").save(1, state.params)
    orbax_to_torch.convert_run(root / "jax", root / "port")
    return root, state, (value_and_grad, apply), batch, _lpdm_names(g1)


def _jax_lpdm_params(seed: int, prior_cfg: PriorConfig, den_cfg: DenoiserConfig) -> dict:
    """JAX {prior, denoiser} parameters: the port's initialisation from
    ``seed`` through the JAX package's importer (no flax init to compile)."""
    state = tg.init_state(seed, prior_cfg, den_cfg, device=CPU)
    sd = {k: {n: v.numpy() for n, v in m.state_dict().items()}
          for k, m in (("prior", state.prior), ("denoiser", state.denoiser))}
    return {"prior": ti.motion_prior_from_torch(sd["prior"], num_layers=prior_cfg.num_layers),
            "denoiser": ti.denoiser_from_torch(sd["denoiser"], num_layers=den_cfg.num_layers)}


def _port_lpdm() -> tg.GestureTrainState:
    return tg.init_state(0, PriorConfig(**D.PRIOR_KW), DenoiserConfig(**D.DEN_KW), D.TCFG, CPU)


def _lpdm_named(state) -> dict:
    return {**{f"prior.{k}": v.detach() for k, v in state.prior.named_parameters()},
            **{f"denoiser.{k}": v.detach() for k, v in state.denoiser.named_parameters()}}


def _lpdm_jax_next(jstate, jax_fns, batch, draws):
    value_and_grad, apply = jax_fns
    (_, logs), g = value_and_grad(jstate.params, batch, draws)
    params, _ = apply(jstate.opt_state, jstate.params, g)
    return {k: float(v) for k, v in logs.items()}, _lpdm_names(g), _lpdm_names(params)


def _lpdm_port_next(state, batch, draws) -> dict:
    step = tg.make_train_step(PriorConfig(**D.PRIOR_KW), DenoiserConfig(**D.DEN_KW), D.TCFG)
    logs = step(state, tg.batch_to_device(batch, CPU), None, stochastic=False,
                noise=_noise(draws))
    return {k: v.item() for k, v in logs.items()}


def _logs_within(got: dict, want: dict) -> bool:
    return got.keys() == want.keys() and all(
        abs(got[k] - v) <= LPDM_TERM_ATOL + LPDM_TERM_RTOL * abs(v) for k, v in want.items())


class TestLpdm:
    @pytest.fixture(scope="class")
    def resumed(self, lpdm_run):
        """JAX's next step from the orbax run, and the port's converted state."""
        root, template, jax_fns, batch, g1 = lpdm_run
        jstate, _ = jax_restore(root / "jax", template, "LPDM-T")
        draws = _draws(33)
        jlogs, g2, jparams = _lpdm_jax_next(jstate, jax_fns, batch, draws)
        return {"draws": draws, "jlogs": jlogs, "grads": [g1, g2], "jparams": jparams}

    def test_parameters_and_moments(self, lpdm_run):
        """``from_jax_params``' maps of the tree bit for bit (both moments
        too), every parameter with Adam state at step = count = 1, in the
        optimizer's order: the prior's parameters, then the denoiser's."""
        root, state = lpdm_run[:2]
        saved, _ = CheckpointManager(root / "port").restore()
        tree = _tree(state.params)
        for part, fn in (("prior", convert.prior_from_jax), ("denoiser", convert.denoiser_from_jax)):
            want = fn(tree[part])
            assert saved["params"][part].keys() == want.keys()
            assert all(torch.equal(saved["params"][part][k], v) for k, v in want.items())
        names = list(_lpdm_named(_port_lpdm()))
        mu, nu = _lpdm_names(state.opt_state.mu), _lpdm_names(state.opt_state.nu)
        opt = saved["optimizer"]
        assert sorted(opt["state"]) == list(range(len(names)))
        for i, n in enumerate(names):
            s = opt["state"][i]
            assert torch.equal(s["exp_avg"], mu[n]) and torch.equal(s["exp_avg_sq"], nu[n]), n
            # C-contiguous, as the parameters: fused AdamW on the card wants their strides
            assert s["exp_avg"].is_contiguous() and s["exp_avg_sq"].is_contiguous(), n
            assert s["step"].item() == 1.0
        assert saved["step"] == 1 and opt["param_groups"][0]["lr"] == float(state.opt_state.lr)

    def test_resume_equals_jax_next_step(self, lpdm_run, resumed, capsys):
        """``--resume`` of the converted run (``restore_train_state``) then one
        step, against JAX's ``restore_train_state`` of the orbax run then one
        step: the logged terms and the parameters within the module's LPDM
        bounds; each parameter's Adam ``step`` reads 2."""
        root, batch = lpdm_run[0], lpdm_run[3]
        state, epoch = restore_train_state(root / "port", _port_lpdm(), "LPDM-T")
        assert epoch == 1 and "resumed full train state" in capsys.readouterr().out
        logs = _lpdm_port_next(state, batch, resumed["draws"])
        assert _logs_within(logs, resumed["jlogs"]), (logs, resumed["jlogs"])
        worst, share = _held(_lpdm_named(state), resumed["jparams"], resumed["grads"])
        assert worst <= PARAM_ATOL and share > LPDM_COVERED, (worst, share)
        assert {s["step"].item() for s in state.optimizer.state.values()} == {2.0}

    def test_zeroed_moments_fall_outside_the_bounds(self, lpdm_run, resumed):
        """The planted fault: the same resume with both moments zeroed (count
        kept) misses the parameter bound that the true resume meets."""
        root, batch = lpdm_run[0], lpdm_run[3]
        saved, _ = CheckpointManager(root / "port").restore()
        for s in saved["optimizer"]["state"].values():
            s["exp_avg"].zero_()
            s["exp_avg_sq"].zero_()
        state = _port_lpdm()
        state.load_state_dict(saved)
        _lpdm_port_next(state, batch, resumed["draws"])
        worst, _ = _held(_lpdm_named(state), resumed["jparams"], resumed["grads"])
        assert worst > PARAM_ATOL, worst

    def test_bare_parameters_resume_with_fresh_moments(self, lpdm_run, tmp_path, capsys):
        """An orbax checkpoint of bare parameters (the format before the full
        train state) converts without an optimizer; the port resumes it with
        fresh moments and step 0 and prints JAX's fallback line, and its next
        step equals JAX's fallback resume's within the same bounds."""
        root, template, jax_fns, batch = lpdm_run[:4]
        orbax_to_torch.convert_run(root / "jax_bare", tmp_path / "port")
        saved, _ = CheckpointManager(tmp_path / "port").restore()
        assert "optimizer" not in saved and saved["step"] == 0
        assert "[convert] step 1: params ONLY" in capsys.readouterr().out
        # JAX's fallback keeps the template's fresh optimizer state and step
        template = template._replace(opt_state=jtg.make_optimizer(jtg.GestureTrainConfig(
            learning_rate=LR)).init(template.params, LR), step=jnp.zeros((), jnp.int32))
        jstate, _ = jax_restore(root / "jax_bare", template, "LPDM-T")
        state, _ = restore_train_state(tmp_path / "port", _port_lpdm(), "LPDM-T")
        line = "resumed params ONLY (old checkpoint format; optimizer moments reset)"
        assert capsys.readouterr().out.count(line) == 2
        assert state.step == 0 and not state.optimizer.state
        draws = _draws(34)
        jlogs, g, jparams = _lpdm_jax_next(jstate, jax_fns, batch, draws)
        logs = _lpdm_port_next(state, batch, draws)
        assert _logs_within(logs, jlogs)
        worst, share = _held(_lpdm_named(state), jparams, [g])
        assert worst <= PARAM_ATOL and share > LPDM_COVERED, (worst, share)


# ---------------------------------------------------------------- inference

def test_inference_from_converted_runs_equals_jax(tmp_path, monkeypatch):
    """``AMUSE_TPU_CKPT`` / ``AMUSE_TPU_AST_CKPT`` at the converted LPDM and
    stage-1 runs give the port's pipeline whose ``wav_to_motion`` equals the
    JAX pipeline's from ``load_pipeline_params`` of the orbax runs, with the
    same initial latents: float32, features atol 1e-4, poses and translation
    atol 1e-3 (tests/test_torch_port_pipeline.py). The stage-1 run holds the
    whole disentangler (its decoder at 1024x128, fusion width 8)."""
    sd = {}
    torch_sd.disentangler_sd(np.random.default_rng(40), sd, embed=16, depth=1, feature_dim=12,
                             fusion_dim=8, out_frames=1024, out_bins=128)
    ast = ti.ast_disentangler_from_torch(sd, depth=1)
    jcfg = jta.AudioTrainConfig()
    JaxManager(tmp_path / "jax_ast").save(
        2, jta.AudioTrainState(ast, jta.make_optimizer(jcfg).init(ast, 1e-5),
                               jnp.asarray(3, jnp.int32)))
    lpdm = _jax_lpdm_params(41, PriorConfig(**PIPE_PRIOR), DenoiserConfig(**PIPE_DEN))
    gcfg = jtg.GestureTrainConfig()
    JaxManager(tmp_path / "jax_lpdm").save(
        4, jtg.TrainState(lpdm, jtg.make_optimizer(gcfg).init(lpdm, 1e-4),
                          jnp.asarray(4, jnp.int32)))
    for name in ("ast", "lpdm"):
        orbax_to_torch.convert_run(tmp_path / f"jax_{name}", tmp_path / f"port_{name}")
    monkeypatch.setenv("AMUSE_TPU_CKPT", str(tmp_path / "jax_lpdm"))
    monkeypatch.setenv("AMUSE_TPU_AST_CKPT", str(tmp_path / "jax_ast"))
    jpipe = _jax(jcio.load_pipeline_params())
    monkeypatch.setenv("AMUSE_TPU_CKPT", str(tmp_path / "port_lpdm"))
    monkeypatch.setenv("AMUSE_TPU_AST_CKPT", str(tmp_path / "port_ast"))
    pipe = _port(cio.load_pipeline_params())
    poses, trans = _compare(jpipe, pipe, _chunks(42), _latents(43), 1e-4, 1e-3)
    assert poses.shape == (2, 300, 55, 3) and torch.isfinite(trans).all()


def _layout(tree) -> dict:
    return {jax.tree_util.keystr(path): np.shape(x)
            for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_chip_smoke_builds_the_jax_layout(stage1_run, lpdm_run):
    """chip_smoke.py's ``orbax_resume`` phase builds JAX trees without JAX, from
    the port's state dicts: their keys and shapes are the JAX package's init
    trees', and ``convert.py`` maps them back to the same state dicts."""
    import chip_smoke

    state = _port_lpdm()
    sds = [{k: v.numpy() for k, v in m.state_dict().items()} for m in (state.prior, state.denoiser)]
    tree = chip_smoke.flax_lpdm_tree(*sds)
    assert _layout(tree) == _layout(lpdm_run[1].params)
    back = _lpdm_names(tree)
    assert all(np.array_equal(back[f"{pre}.{k}"], v) for pre, sd in zip(("prior", "denoiser"), sds)
               for k, v in sd.items())
    model = _port_stage1().model
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    tree = chip_smoke.flax_stage1_tree(sd)
    assert _layout(tree) == _layout(stage1_run[1].params)
    back = convert.disentangler_from_jax(tree)
    assert all(np.array_equal(v, sd[k]) for k, v in back.items())
    jt = chip_smoke.jax_train_tree(tree, 0, 1e-4)
    assert jt["opt_state"]["count"] == chip_smoke.ORBAX_COUNT
    assert (jt["opt_state"]["nu"]["decoder"]["proj2"]["kernel"] >= 0).all()


def test_permutation_check_has_teeth():
    """``convert.assert_permutation`` passes the maps of the train states and
    refuses a map that sums, one that drops an element and one that copies."""
    tree = {"a": {"kernel": np.zeros((3, 2), np.float32), "bias": np.zeros(2, np.float32)}}

    def linear(t):
        out = {}
        convert._linear(t["a"], out, "a")
        return out

    convert.assert_permutation(linear, tree)
    for bad in (lambda t: {"w": linear(t)["a.weight"] + 0.0 * linear(t)["a.weight"] + 1.0},
                lambda t: {"w": linear(t)["a.weight"]},
                lambda t: {**linear(t), "c": linear(t)["a.bias"]}):
        with pytest.raises(AssertionError):
            convert.assert_permutation(bad, tree)


# ---------------------------------------------------------------- the stage-1 bank

BANK_ROWS = 128  # x (1024, 128) float32 = 64 MiB


@pytest.fixture(scope="module")
def bank_npz(tmp_path_factory):
    rng = np.random.default_rng(50)
    root = tmp_path_factory.mktemp("bank")
    # two random bins a frame, zeros elsewhere: deflate packs it in a second
    bank = np.zeros((BANK_ROWS, 1024, 128), np.float32)
    bank[:, :, :2] = rng.normal(size=(BANK_ROWS, 1024, 2))
    split = {"fbank_bank": bank, "quad_idx": rng.integers(0, BANK_ROWS, (96, 4)).astype(np.int32),
             **{k: rng.integers(0, 8, 96).astype(np.int32) for k in ("emo_id", "a1_id", "a2_id")}}
    val = {k: v[:2] if k != "fbank_bank" else v[:4] for k, v in split.items()}
    stage1.save_dataset(root / "s1.npz", split, val, ["1/0_9_9"])
    return root / "s1.npz", bank.nbytes


def test_two_ranks_map_one_copy_of_the_bank(bank_npz, tmp_path):
    """Two gloo ranks load a stage-1 npz whose bank is 64 MiB: each maps the
    arrays that local rank 0 unpacked once into the run's directory, and its
    private memory grows by under a quarter of the bank's bytes over the load
    and one batch, where the whole-npz read of one process grows it by the
    bank's bytes or more. The batches are bit-equal to the npz path's, on
    each rank, and nothing is written beside the dataset."""
    npz, nbytes = bank_npz
    unpacked = tmp_path / "run" / "stage1_unpacked"
    results = D.run_ranks(D.stage1_bank, 2, tmp_path, str(npz), str(unpacked))
    want, _ = stage1.load_dataset(npz)
    want_batch = next(stage1.batches(want, 2, np.random.default_rng(0)))
    for r in results:
        assert r["mapped_is_memmap"] and not r["npz_is_memmap"]
        assert r["mapped_growth"] < nbytes / 4, ([q["mapped_growth"] for q in results], nbytes)
        assert r["npz_growth"] >= nbytes, (r["npz_growth"], nbytes)
        for k, v in want_batch.items():
            assert torch.equal(r["mapped_batch"][k], torch.from_numpy(v)), k
            assert torch.equal(r["npz_batch"][k], torch.from_numpy(v)), k
    assert sorted(p.name for p in unpacked.glob("*.npy")) == sorted(
        f"{k}.npy" for k in np.load(npz).files)
    assert [p.name for p in npz.parent.iterdir()] == [npz.name]


def test_unpack_is_atomic_and_reused(bank_npz, tmp_path):
    """``_unpack`` writes each member once and leaves it while the npz's mtime
    and the file's size match its record; a torn file or a newer npz is
    written anew. Two writers unpacking into one directory at once (the local
    rank 0 of two hosts over a shared run directory) both finish, and the
    files are whole."""
    src = tmp_path / "s1.npz"
    src.write_bytes(bank_npz[0].read_bytes())
    root = tmp_path / "unpacked"
    stage1._unpack(src, root)
    bank = root / "train_fbank_bank.npy"
    first = bank.stat().st_mtime_ns
    stage1._unpack(src, root)
    assert bank.stat().st_mtime_ns == first
    with open(bank, "r+b") as f:  # a torn file: the record's size no longer matches
        f.truncate(1000)
    stage1._unpack(src, root)
    record = json.loads((root / "train_fbank_bank.npy.json").read_text())
    assert bank.stat().st_size == record["size"] > 1000
    np.testing.assert_array_equal(np.load(bank, mmap_mode="r")[:2],
                                  np.load(src)["train_fbank_bank"][:2])
    os.utime(src, ns=(first + 10**9, first + 10**9))  # a rebuilt npz
    before = bank.stat().st_mtime_ns
    stage1._unpack(src, root)
    assert bank.stat().st_mtime_ns != before
    assert not list(root.glob(".*.tmp"))

    shared = tmp_path / "shared"
    with ThreadPoolExecutor(2) as pool:
        list(pool.map(lambda _: stage1._unpack(src, shared), range(2)))
    want = np.load(src)
    for k in want.files:
        np.testing.assert_array_equal(np.load(shared / f"{k}.npy", mmap_mode="r"), want[k])
    assert not list(shared.glob(".*.tmp"))
