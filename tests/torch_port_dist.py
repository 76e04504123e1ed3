"""Rank workers of the port's data-parallel tests.

``run_ranks`` spawns W processes that join one process group through a file
in the test's temporary directory (no TCP port to collide on when test files
run in parallel), run a worker on the (data, model) mesh and save what it
returns, which the parent compares. The workers below also run in the
parent with ``mesh=None``: the single process the ranks are held against.
This module imports torch and the port only, so a spawned rank starts
without JAX, on the CPU here and on the card (tests/test_torch_port_gpu.py).

Small widths, dropout 0 unless a worker says otherwise: the LPDM prior and denoiser of
tests/test_torch_port_gesture.py (d 16, ff 32, 3 layers, 2 heads, 12-frame
windows, 3 DDIM steps); the stage-1 AST over 64x32 fbanks, 64 wide with 2
heads (as tests/test_torch_port_train.py's, but K1/K2's head dim 32).
"""

from __future__ import annotations

import os
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from amuse_tpu_torch.audio import fbank as fb
from amuse_tpu_torch.data import stage1
from amuse_tpu_torch.data.cache import sharded_encoder
from amuse_tpu_torch.infer.pipeline import GesturePipeline, init_random_params
from amuse_tpu_torch.models.ast import ASTConfig, ASTDisentangler
from amuse_tpu_torch.models.denoiser import DenoiserConfig
from amuse_tpu_torch.models.vae import PriorConfig
from amuse_tpu_torch.ops import attention, denoiser_kernel
from amuse_tpu_torch.parallel import mesh as M
from amuse_tpu_torch.train import audio as ta
from amuse_tpu_torch.train import gesture as tg

T, COND, LR, STEPS = 12, 24, 1e-4, 3
PRIOR_KW = dict(nfeats=333, latent_dim=16, ff_size=32, num_layers=3, num_heads=2, window=T,
                dropout=0.0)
DEN_KW = dict(latent_dim=16, ff_size=32, num_layers=3, num_heads=2, cond_dim=COND, dropout=0.0)
TCFG = tg.GestureTrainConfig(learning_rate=LR, num_inference_steps=STEPS)
# the AST 64 wide with 2 heads: K1 and K2 take head dims 32 and 64 on the card
AST_KW = dict(input_tdim=64, input_fdim=32, embed_dim=64, depth=1, num_heads=2, feature_dim=12)
ACFG = ta.AudioTrainConfig(learning_rate=LR, freq_mask=8, time_mask=16)
ENC_AST = dict(embed_dim=64, depth=1, num_heads=2, feature_dim=8)  # encode_audio's, 1024x128
# two ranks against one process (``errors``); readings on the CPU: losses
# 1.8e-7, first-step gradients 4.7e-7 of their largest entry, first-step
# parameters 1.5e-8 on 59-84% of the elements (the planted fault: 5.6e-4
# and 0.33 in the second step's losses, 1.4-2.8, 2.0e-4)
LOSS_RTOL = 1e-5  # every logged term, both steps
GRAD_REL = 1e-4  # the first step's, per parameter (the single-device JAX bound)
PARAM_ATOL = LR / 10  # after the first step, where its gradient exceeds GRAD_FLOOR
GRAD_FLOOR = 1e-6
COVERED = 0.5  # the least share of the elements that the parameter bound holds


def run_ranks(fn, world: int, tmp_path, *args, n_model: int = 1, device: str = "cpu",
              backend=None, timeout: float = 240.0) -> list:
    """``fn(mesh, device, *args)`` on each of ``world`` spawned ranks -> their
    results in rank order; a rank's failure raises with its traceback."""
    out = Path(tmp_path)
    out.mkdir(parents=True, exist_ok=True)
    init = out / "process_group"
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank, args=(fn, r, world, n_model, str(init), str(out),
                                             device, backend, args))
             for r in range(world)]
    for p in procs:
        p.start()
    errors = []
    for r, p in enumerate(procs):
        p.join(timeout)
        if p.is_alive():
            p.kill()
            p.join()
            errors.append(f"rank {r} did not finish in {timeout} s")
        elif p.exitcode != 0:
            err = out / f"rank{r}.err"
            errors.append(err.read_text() if err.exists() else f"rank {r}: exit {p.exitcode}")
    if errors:
        raise RuntimeError("\n".join(errors))
    return [torch.load(out / f"rank{r}.pt") for r in range(world)]


def _rank(fn, rank, world, n_model, init, out, device, backend, args) -> None:
    os.environ.update(WORLD_SIZE=str(world), RANK=str(rank), LOCAL_RANK="0")
    torch.set_num_threads(2)
    try:
        dev = M.initialize_distributed(device, backend=backend, init_method=f"file://{init}")
        result = fn(M.make_mesh(n_model=n_model), dev, *args)
        torch.save(result, Path(out) / f"rank{rank}.pt")
    except BaseException:
        (Path(out) / f"rank{rank}.err").write_text(f"rank {rank}:\n{traceback.format_exc()}")
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _counts() -> dict:
    return {"attention_fwd": attention.mha.launches, "attention_bwd": attention.mha_bwd.launches,
            "ddim_sampler": denoiser_kernel.ddim_sample_fused.launches}


def _params(*modules) -> dict:
    return {f"{i}.{n}": p.detach().cpu().clone()
            for i, m in enumerate(modules) for n, p in m.named_parameters()}


def _grads(*modules) -> dict:
    """The gradients the optimizer stepped on (after the sync), under
    ``_params``' names; a parameter without one is left out."""
    return {f"{i}.{n}": p.grad.detach().cpu().clone()
            for i, m in enumerate(modules) for n, p in m.named_parameters()
            if p.grad is not None}


class OwnRowsOnly(M.GradSync):
    """A planted fault: each rank steps on its own rows' gradient, the
    all-reduce left out (the logs are still averaged)."""

    def all_reduce(self, params) -> None:
        pass


class LocalMasks(M.GradSync):
    """A planted fault, the LPDM step as it drew its dropout masks before they
    were drawn for the global batch: at the rank's local shape, from a
    generator of the rank's own (seeded from the step's seed and the rank)."""

    def dropout_draws(self, generator):
        hi, lo = np.random.SeedSequence([generator.initial_seed(), self.rank]).generate_state(
            2, np.uint32)
        return torch.Generator(device=generator.device).manual_seed((int(hi) << 32) | int(lo))


def _sync(mesh, fault: bool, local_masks: bool = False):
    if mesh is None:
        return None
    return (OwnRowsOnly if fault else LocalMasks if local_masks else M.GradSync)(mesh)


def errors(got: dict, want: dict) -> dict:
    """How far ``got`` (a rank's steps) lies from ``want`` (one process's):
    the largest relative error of a logged term per step; the first step's
    largest gradient error over its parameter's largest entry; the largest
    error of the parameters after the first step where its gradient exceeds
    GRAD_FLOOR, and the share of the elements that bound holds.

    Both runs start from the same parameters, so the first step's gradients
    and update are the sync's to get right. Adam's first update is ~lr times
    the gradient's sign, which reduction-order noise sets where a gradient
    is ~0 (the attention's key bias): those elements leave the bound, and
    the later steps' gradients and parameters inherit their ±lr, so the
    later steps are held by their losses."""
    assert got["logs"][0].keys() == want["logs"][0].keys()
    loss = [max(abs(g[k] - w[k]) / max(abs(w[k]), 1e-7) for k in w)
            for g, w in zip(got["logs"], want["logs"])]
    g0, w0 = got["grads"][0], want["grads"][0]
    assert g0.keys() == w0.keys()
    grad = max(((g0[n] - w0[n]).abs().max() / w0[n].abs().max().clamp_min(1e-30)).item()
               for n in w0)
    param, covered = 0.0, 0
    for n, p in want["params_1"].items():
        if n not in w0:
            continue
        keep = w0[n].abs() > GRAD_FLOOR
        if keep.any():
            param = max(param, (got["params_1"][n] - p).abs()[keep].max().item())
        covered += int(keep.sum())
    return {"loss": loss, "grad": grad, "param": param,
            "covered": covered / sum(p.numel() for p in want["params_1"].values())}


def within(err: dict) -> bool:
    return (max(err["loss"]) <= LOSS_RTOL and err["grad"] <= GRAD_REL
            and err["param"] <= PARAM_ATOL and err["covered"] >= COVERED)


def lpdm_batch(seed: int, b: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"motion": (0.1 * rng.normal(size=(b, T, 168))).astype(np.float32),
            "con": rng.normal(size=(b, COND)).astype(np.float32),
            "emo": rng.normal(size=(b, COND)).astype(np.float32),
            "sty": rng.normal(size=(b, COND)).astype(np.float32),
            "betas": np.zeros((b, 16), np.float32)}


def lpdm_steps(mesh, device, batch_size: int = 8, steps: int = 2, weights=None,
               noise=None, fault: bool = False, dropout: float = 0.0,
               local_masks: bool = False) -> dict:
    """``steps`` LPDM steps with the DDIM monitor over the global batch
    ``lpdm_batch(1, batch_size)`` (this rank's rows), at ``dropout`` (0 by
    default), the draws from ``step_generator(5, 0, i)`` unless ``noise``
    (global numpy ``StepNoise`` fields) is injected; ``weights`` are
    {"prior", "denoiser"} state dicts, else the seed-0 initialisation.
    ``fault`` steps each rank on its own rows' gradient (``OwnRowsOnly``),
    ``local_masks`` draws each rank's dropout masks from its own generator
    (``LocalMasks``)."""
    prior_cfg = PriorConfig(**{**PRIOR_KW, "dropout": dropout})
    den_cfg = DenoiserConfig(**{**DEN_KW, "dropout": dropout})
    state = tg.init_state(0, prior_cfg, den_cfg, TCFG, device)
    if weights is not None:
        state.prior.load_state_dict(weights["prior"])
        state.denoiser.load_state_dict(weights["denoiser"])
    M.replicate([state.prior, state.denoiser], mesh)
    step = tg.make_train_step(prior_cfg, den_cfg, TCFG, with_monitor=True,
                              grad_sync=_sync(mesh, fault, local_masks))
    local = M.shard_rows(lpdm_batch(1, batch_size), mesh)
    batch = tg.batch_to_device(local, torch.device(device))
    before, logs, grads = _counts(), [], []
    for i in range(steps):
        injected = None if noise is None else tg.StepNoise(
            *(torch.from_numpy(noise[k]).to(device) for k in tg.StepNoise._fields))
        out = step(state, batch, ta.step_generator(5, 0, i, device), noise=injected)
        logs.append({k: v.item() for k, v in out.items()})
        grads.append(_grads(state.prior, state.denoiser))
        if i == 0:
            params_1 = _params(state.prior, state.denoiser)
    if not fault:
        M.replicate([state.prior, state.denoiser], mesh)  # raises unless the ranks agree
    return {"logs": logs, "grads": grads, "params_1": params_1,
            "params": _params(state.prior, state.denoiser),
            "rows": batch["motion"].shape[0],
            "launches": {k: v - before[k] for k, v in _counts().items()}}


def stage1_batch(seed: int, b: int, t: int, f: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"fbanks": rng.normal(size=(b, 4, t, f)).astype(np.float32),
            "emo_id": rng.integers(0, 8, b), "a1_id": rng.integers(0, 30, b),
            "a2_id": rng.integers(0, 30, b)}


def stage1_steps(mesh, device, stochastic: bool = False, quads: int = 2, steps: int = 2,
                 ast_kw=None, fusion_dim: int = 64, dropout: float = 0.0, weights=None,
                 fault: bool = False) -> dict:
    """``steps`` stage-1 steps over ``quads`` global quads: ``stochastic=False``
    turns augmentation and dropout off, ``True`` draws both from
    ``step_generator(6, 0, i)``. ``weights`` (a state dict without the
    untraced label heads) replace the seed-11 initialisation; ``fault`` as
    in ``lpdm_steps``. Records which parameters got no gradient and which got
    the zero gradient of ``train.audio.fill_missing_grads``."""
    ast_cfg = ASTConfig(**(ast_kw or AST_KW))
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(11)
        model = ASTDisentangler(ast_cfg, fusion_dim=fusion_dim, dropout=dropout)
    if weights is not None:
        missing, unexpected = model.load_state_dict(weights, strict=False)
        assert not unexpected and all(".mlp_head" in k for k in missing), missing
    model.to(device)
    state = ta.AudioTrainState(model, ta.make_optimizer(model, ACFG))
    M.replicate([model], mesh)
    step, _ = ta.make_train_step(ACFG, _sync(mesh, fault))
    host = stage1_batch(2, quads, ast_cfg.input_tdim, ast_cfg.input_fdim)
    batch = ta.batch_to_device(M.shard_rows(host, mesh), torch.device(device))
    before, logs, grads = _counts(), [], []
    for i in range(steps):
        out = step(state, batch, ta.step_generator(6, 0, i, device), stochastic=stochastic)
        logs.append({k: v.item() for k, v in out.items()})
        grads.append(_grads(model))
        if i == 0:
            params_1 = _params(model)
    if not fault:
        M.replicate([model], mesh)
    return {"logs": logs, "grads": grads, "params_1": params_1, "params": _params(model),
            "no_grad": sorted(n for n, p in model.named_parameters() if p.grad is None),
            "zero_filled": sorted(n for n, p in model.named_parameters()
                                  if p.grad is not None and not p.grad.any()),
            "launches": {k: v - before[k] for k, v in _counts().items()}}


def private_bytes() -> int:
    """This process's private memory: the ``Anonymous`` pages of
    ``/proc/self/smaps_rollup``, or summed over ``/proc/self/smaps`` where the
    kernel has no ``smaps_rollup`` (gVisor). That is what it holds that no
    other process can share: its heap, its copies, and copy-on-write pages of
    a private mapping. A mapped file's pages are the page cache's, one copy a
    host, and are left out: ``Private_Clean`` would count them for whichever
    rank faulted them first until the other rank faults them too, so two
    ranks reading the same batch would see their growth depend on which
    measured first (up to 11 MB of a 64 MiB bank for one batch where the
    kernel maps the page cache's large folios whole)."""
    proc = Path("/proc/self")
    path = proc / "smaps_rollup" if (proc / "smaps_rollup").exists() else proc / "smaps"
    return 1024 * sum(int(line.split()[1]) for line in path.read_text().splitlines()
                      if line.split(":")[0] == "Anonymous")


def stage1_bank(mesh, device, npz: str, unpack_dir: str, batch_size: int = 2) -> dict:
    """``stage1.load_dataset`` of ``npz`` on this rank (``mesh``: the arrays
    mapped from one copy unpacked into ``unpack_dir``) and its first shuffled
    batch, then the same through the whole-npz read of one process
    (``mesh=None``): each one's growth of this rank's private memory, and both
    batches. The ranks are one host's: local rank r is rank r."""
    os.environ["LOCAL_RANK"] = str(M.data_rank(mesh))
    out = {}
    for name, m in (("mapped", mesh), ("npz", None)):
        M.barrier(mesh)
        before = private_bytes()
        train, _ = stage1.load_dataset(npz, m, unpack_dir)
        batch = next(stage1.batches(train, batch_size, np.random.default_rng(0)))
        out[f"{name}_growth"] = private_bytes() - before
        out[f"{name}_batch"] = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
        out[f"{name}_is_memmap"] = isinstance(train["fbank_bank"], np.memmap)
        del train
    return out


def chunks(n: int, seed: int = 3) -> np.ndarray:
    return np.random.default_rng(seed).normal(scale=0.05, size=(n, fb.CHUNK_SAMPLES)).astype(
        np.float32)


def fbank_and_encode(mesh, device, n_fbank: int = 6, n_encode: int = 5) -> dict:
    """``make_sharded_fbank`` over ``n_fbank`` chunks and the sharded
    ``encode_audio`` (random encoders of width 16) over ``n_encode``."""
    pipe = GesturePipeline(init_random_params(4, PriorConfig(**PRIOR_KW),
                                              DenoiserConfig(**DEN_KW), ASTConfig(**ENC_AST)),
                           PriorConfig(**PRIOR_KW), DenoiserConfig(**DEN_KW),
                           ASTConfig(**ENC_AST), dtype=torch.float32, num_inference_steps=STEPS,
                           device=device)
    before = _counts()
    fbanks = fb.make_sharded_fbank(mesh, device)(chunks(n_fbank))
    enc = sharded_encoder(pipe, mesh)(chunks(n_encode, seed=4))
    return {"fbank": torch.from_numpy(fbanks), **{k: torch.from_numpy(v) for k, v in enc.items()},
            "launches": {k: v - before[k] for k, v in _counts().items()}}


def suite(mesh, device, weights=None, noise=None, stage1_weights=None) -> dict:
    """Every two-rank scenario of tests/test_torch_port_parallel.py in one
    spawn (a spawned rank takes seconds to import torch): the steps, the
    LPDM steps at dropout 0.1 (and with the per-rank masks of ``LocalMasks``),
    the steps with the planted fault, and where they are given the LPDM steps
    from ``weights`` with ``noise`` injected and the stage-1 steps over 8
    quads from ``stage1_weights``."""
    out = {"lpdm": lpdm_steps(mesh, device),
           "lpdm_dropout": lpdm_steps(mesh, device, dropout=0.1),
           "lpdm_local_masks": lpdm_steps(mesh, device, dropout=0.1, local_masks=True),
           "stage1": stage1_steps(mesh, device),
           "stage1_augmented": stage1_steps(mesh, device, stochastic=True, dropout=0.1),
           "lpdm_fault": lpdm_steps(mesh, device, fault=True),
           "stage1_fault": stage1_steps(mesh, device, fault=True),
           "encode": fbank_and_encode(mesh, device),
           "rank": M.data_rank(mesh), "size": M.data_size(mesh)}
    if weights is not None:
        out["lpdm_injected"] = lpdm_steps(mesh, device, weights=weights, noise=noise)
    if stage1_weights is not None:
        out["stage1_jax"] = stage1_steps(mesh, device, quads=8, weights=stage1_weights)
    # one rank's parameters changed: replicate restores rank 0's and raises on both
    lin = torch.nn.Linear(3, 2)
    with torch.no_grad():
        for p in lin.parameters():
            p.fill_(float(M.data_rank(mesh)))
    try:
        M.replicate([lin], mesh)
        out["replicate_raised"] = ""
    except RuntimeError as e:
        out["replicate_raised"] = str(e)
    out["after_replicate"] = lin.weight.detach().clone()
    return out


def megatron(mesh, device) -> dict:
    """The two-axis mesh (tests/test_mesh.py): x (B, K) sharded over data, W1
    column-sharded and W2 row-sharded over model (the Megatron layout),
    relu(x W1) W2 with the contraction over the sharded dim summed by an
    all-reduce over the model group, then gathered over the data group."""
    rs = np.random.RandomState(0)
    b, k, n = 16, 12, 8
    x, w1, w2 = (torch.from_numpy(rs.randn(*s).astype(np.float32))
                 for s in ((b, k), (k, n), (n, k)))
    n_model, m = mesh.size(1), mesh.get_local_rank(M.MODEL_AXIS)
    cols = slice(m * n // n_model, (m + 1) * n // n_model)
    part = torch.relu(M.shard_rows(x, mesh) @ w1[:, cols]) @ w2[cols]
    dist.all_reduce(part, group=mesh.get_group(M.MODEL_AXIS))
    parts = [torch.empty_like(part) for _ in range(M.data_size(mesh))]
    dist.all_gather(parts, part, group=M.data_group(mesh))
    try:
        M.gather_rows(np.zeros((1, 2), np.float32), mesh)
        gather_error = ""
    except ValueError as e:
        gather_error = str(e)
    return {"y": torch.cat(parts), "want": torch.relu(x @ w1) @ w2,
            "shape": (M.data_size(mesh), n_model), "data_rank": M.data_rank(mesh),
            "model_rank": m, "gather_error": gather_error}
