"""The stage-1 train step of ``amuse_tpu_torch`` under test:
``train/audio.py::make_train_step``'s step on a state the benchmark builds
(``ASTDisentangler`` in bf16 over float32 master parameters, Adam
``fused=True``), fed as ``train_audio`` feeds it (numpy quads copied to the
card by ``batch_to_device``, one generator a step).

Set-up builds the configuration's kernel sources, draws the float32
parameters on the card under the reference's keys and loads them into a
model made on the meta device, makes the pool of quads (fbanks of the
speech stand-in, computed on the card by the plain fbank, and labels) in
host memory, and then drives the state through its first steps, the ones
the check compares: ``check.steps`` steps on distinct rows through the
window's own call and feed. Their loss terms, the first gradient as Adam holds
it (its first moment after one step, over 1 - beta1) and each parameter's
change over the steps are read before the next step. The window's steps
follow on the same state. The check runs the plain reference over the same
first steps, from the same parameters drawn again, after the program is
freed.
"""

from __future__ import annotations

import statistics
import sys
import time

import numpy as np
import torch

from portbench.generator import Done, Request, Traffic
from portbench.inputs import draw_weights, speech_like, sub_seed
from portbench.reference import fbank as fbank_ref
from portbench.reference import stage1 as ref
from portbench.systems import _session

ENTRIES = ("train_step",)


def weights(cfg: dict, seed: int, device: torch.device) -> dict:
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, 1))
    return draw_weights(ref.param_shapes(cfg), torch.float32, g, device)


def make_pool(cfg: dict, quads: int, seed: int, device: torch.device) -> dict:
    """{"fbanks": (quads, 4, T, F) float32, "emo_id", "a1_id", "a2_id"} on the host."""
    a = cfg["ast"]
    size = cfg["audio"]["window_samples"]
    members = np.empty((4 * quads, a["input_tdim"], a["input_fdim"]), np.float32)
    for i in range(0, 4 * quads, 32):
        n = min(32, 4 * quads - i)
        wave = speech_like(n, size, cfg["audio"]["sample_rate"], sub_seed(seed, 8, i), device)
        fb = fbank_ref.fbank(wave)[:, :a["input_tdim"], :a["input_fdim"]]
        members[i:i + n] = fb.cpu().numpy()
    rng = np.random.default_rng(sub_seed(seed, 11))
    labels = cfg["stage1"]["label_dims"]
    a1 = rng.integers(0, labels["sty"], quads)
    a2 = (a1 + rng.integers(1, labels["sty"], quads)) % labels["sty"]  # another actor
    return {"fbanks": members.reshape(quads, 4, a["input_tdim"], a["input_fdim"]),
            "emo_id": rng.integers(0, labels["emo"], quads), "a1_id": a1, "a2_id": a2}


def rows(pool: dict, start: int, n: int) -> dict:
    return {k: v[start:start + n] for k, v in pool.items()}


def check_requests(cfg: dict, mix: dict, settings: dict, seed: int) -> list[Request]:
    """The first steps, on distinct rows: step k takes rows k B .. (k + 1) B."""
    b = int(mix["samples_per_request"][0])
    steps = int(settings["check"]["steps"])
    if steps * b > int(mix["pool_samples"]):
        raise ValueError("the pool is smaller than the checked steps' rows")
    return [Request(-1000 - k, b, k * b, sub_seed(seed, 10, k)) for k in range(steps)]


def leaf_gaps(got: dict, want: dict, counted: list) -> list:
    """[(gap, leaf)], the worst first: each leaf's gap of norms against the
    reference's norm of that leaf or of the median leaf, whichever is larger."""
    median = statistics.median(want[k] for k in counted)
    return sorted(((abs(got.get(k, 0.0) - want[k]) / max(want[k], median), k) for k in counted),
                  reverse=True)


def worst_leaves(prog: dict, want: dict, key: str, top: int = 4) -> str:
    """The leaves with the largest gaps of ``key``, for standard error."""
    gaps = leaf_gaps(prog[key], want[key], ref.counted_leaves(want["raw1"]))[:top]
    return "; ".join(f"{k} {g:.4g} (program {prog[key].get(k, 0.0):.4g}, reference "
                     f"{want[key][k]:.4g}, raw gradient {want['raw1'][k]:.4g})" for g, k in gaps)


def term_gaps(prog: dict, want: dict) -> list:
    """[(gap, step, term)], the worst first: each checked step's loss terms'
    relative gaps."""
    return sorted(((abs(p[t] - w[t]) / abs(w[t]), k, t)
                   for k, (p, w) in enumerate(zip(prog["losses"], want["losses"]), 1)
                   for t in ref.TERMS), reverse=True)


def worst_terms(prog: dict, want: dict, top: int = 3) -> str:
    """The loss terms with the largest gaps, for standard error."""
    return "; ".join(f"step {k} {t} {g:.4g} (program {prog['losses'][k - 1][t]:.6g}, "
                     f"reference {want['losses'][k - 1][t]:.6g})"
                     for g, k, t in term_gaps(prog, want)[:top])


def judge(prog: dict, want: dict) -> dict:
    """-> ``loss_gap`` (each step's loss terms, ``TERMS``), ``grad_gap`` (the first gradient)
    and ``step_gap`` (each parameter's change over the steps, over the
    elements the reference keeps, ``reference.stage1.kept_elements``) over
    the leaves compared (``reference.stage1.counted_leaves``), with the
    counts of leaves kept and of leaves and elements left out."""
    counted = ref.counted_leaves(want["raw1"])
    losses = [g for g, _, _ in term_gaps(prog, want)]
    return {"loss_gap": max(losses) if all(np.isfinite(losses)) else float("inf"),
            "grad_gap": leaf_gaps(prog["grad1"], want["grad1"], counted)[0][0],
            "step_gap": leaf_gaps(prog["change"], want["change"], counted)[0][0],
            "leaves_counted": float(len(counted)),
            "leaves_left_out": float(len(want["raw1"]) - len(counted)),
            "elements_left_out": float(sum(int((~want["kept"][k]).sum()) for k in counted))}


def reference_steps(cfg, mix, settings, seed, pool, device, precision="float32",
                    half=False, kept=None) -> dict:
    """The plain reference over the checked steps: the same parameters, rows
    and generators' seeds; ``half`` leaves out the second half of each
    batch; ``kept`` as in ``Stage1.steps``."""
    requests = check_requests(cfg, mix, settings, seed)
    if half:
        requests = [Request(r.index, max(1, r.samples // 2), r.start, r.seed) for r in requests]
    batches = [{k: torch.as_tensor(np.asarray(v)).to(device)
                for k, v in rows(pool, r.start, r.samples).items()} for r in requests]
    gens = [torch.Generator(device=device).manual_seed(r.seed) for r in requests]
    return ref.Stage1(cfg, device, precision).steps(weights(cfg, seed, device), batches, gens,
                                                     kept=kept)


def fault_reading(cell, seed: int, device: torch.device) -> dict:
    """Half of each checked batch left out, the mean taken over the rest,
    planted in the reference in the program's place, judged against the
    whole batch."""
    cfg, mix, settings = cell.config, cell.traffic, cell.settings
    pool = make_pool(cfg, int(mix["pool_samples"]), seed, device)
    want = reference_steps(cfg, mix, settings, seed, pool, device)
    return judge(reference_steps(cfg, mix, settings, seed, pool, device, half=True,
                                 kept=want["kept"]), want)


def control_reading(cell, seed: int, device: torch.device) -> dict:
    """The control (``precision="control"``) judged against the float32 reference."""
    cfg, mix, settings = cell.config, cell.traffic, cell.settings
    pool = make_pool(cfg, int(mix["pool_samples"]), seed, device)
    want = reference_steps(cfg, mix, settings, seed, pool, device)
    return judge(reference_steps(cfg, mix, settings, seed, pool, device, "control",
                                 kept=want["kept"]), want)


class Session(_session.Session):
    PROGRAM = ("state", "step_fn", "logs")
    grad_sync = None  # the step's GradSync: one process, none

    def __init__(self, cfg: dict, mix: dict, settings: dict, seed: int, device: torch.device):
        from amuse_tpu_torch.models.ast import ASTConfig, ASTDisentangler
        from amuse_tpu_torch.ops import _build
        from amuse_tpu_torch.train import audio as ta

        _session.check_entry(mix, ENTRIES)
        self.cfg, self.mix, self.settings, self.seed, self.device = cfg, mix, settings, seed, device
        self.traffic = Traffic(mix, seed)
        self.ta, self.stages = ta, {}
        t = time.perf_counter()
        if device.type == "cuda":
            _build.build(list(cfg["sources"]))
            self.stages["build_s"], t = time.perf_counter() - t, time.perf_counter()
            torch.ones(1, device=device).sum().item()
            self.stages["cuda_init_s"], t = time.perf_counter() - t, time.perf_counter()
        a, s, tr = cfg["ast"], cfg["stage1"], cfg["train"]
        with torch.device("meta"):
            model = ASTDisentangler(ASTConfig(**{k: a[k] for k in _session.AST_KEYS}),
                                    s["fusion_dim"], dtype=getattr(torch, tr["dtype"]),
                                    dropout=s["dropout"])
        model = model.to_empty(device=device)
        model.load_state_dict(weights(cfg, seed, device))
        self.tcfg = ta.AudioTrainConfig(
            learning_rate=tr["learning_rate"], beta1=tr["betas"][0], beta2=tr["betas"][1],
            weight_decay=tr["weight_decay"], frame_based_feats=tr["frame_based_feats"],
            freq_mask=tr["freq_mask"], time_mask=tr["time_mask"], noise_aug=tr["noise_aug"])
        self.state = ta.AudioTrainState(model, ta.make_optimizer(model, self.tcfg))
        self.step_fn, set_lr = ta.make_train_step(self.tcfg, self.grad_sync)
        set_lr(self.state, 0)
        self._sync()
        self.stages["state_s"], t = time.perf_counter() - t, time.perf_counter()
        self.pool = self._make_pool()
        self.stages["data_s"], t = time.perf_counter() - t, time.perf_counter()
        self.first = self._first_steps()
        self.stages["checked_steps_s"], t = time.perf_counter() - t, time.perf_counter()
        for r in self.traffic.warmup():
            self.request(r)
        self._sync()
        self.stages["warmup_s"] = time.perf_counter() - t

    def _make_pool(self) -> dict:
        return make_pool(self.cfg, self.traffic.pool, self.seed, self.device)

    def _first_steps(self) -> dict:
        """The checked steps through ``request``, read as the docstring says."""
        beta1 = self.tcfg.beta1
        named = dict(self.state.model.named_parameters())
        out = {"losses": [], "grad1": {}, "change": {}}
        for k, r in enumerate(check_requests(self.cfg, self.mix, self.settings, self.seed)):
            self.request(r)
            out["losses"].append({t: float(self.logs[t]) for t in ref.TERMS})
            if k == 0:
                for name, p in named.items():
                    st = self.state.optimizer.state.get(p, {})
                    if "exp_avg" in st:
                        out["grad1"][name] = float(st["exp_avg"].norm()) / (1 - beta1)
        # the state after the checked steps, on the host until the check
        # knows which elements to compare (``reference.stage1.Stage1.steps``)
        out["after"] = {name: p.detach().to("cpu", copy=True) for name, p in named.items()}
        return out

    def _batch(self, r: Request) -> dict:
        """The request's rows of the pool that this process trains on."""
        return rows(self.pool, r.start, r.samples)

    def request(self, r: Request) -> Done:
        batch = self._batch(r)
        start = time.perf_counter()
        gen = torch.Generator(device=self.device).manual_seed(r.seed)
        self.logs = self.step_fn(self.state, self.ta.batch_to_device(batch, self.device), gen)
        return Done(r, start, time.perf_counter())

    def check_requests(self) -> list:
        """Requests a reading of the check sends after set-up: none, the
        checked steps ran in it."""
        return []

    def check(self, done: list) -> dict:
        """The reference over the checked steps -> ``judge``'s numbers."""
        want = reference_steps(self.cfg, self.mix, self.settings, self.seed, self.pool,
                               self.device)
        start = weights(self.cfg, self.seed, self.device)
        self.first["change"] = {
            k: float((self.first["after"][k].to(self.device) - start[k])[kept].norm())
            for k, kept in want["kept"].items()}
        for key in ("grad1", "change"):
            print(f"worst {key}: {worst_leaves(self.first, want, key)}", file=sys.stderr)
        print(f"worst loss terms: {worst_terms(self.first, want)}", file=sys.stderr)
        return judge(self.first, want)

    def slice_flops(self, requests: list[Request]) -> dict:
        """Operations and bytes of the attention kernels' work in the traced slice."""
        from portbench import roofline

        a = self.cfg["ast"]
        s, heads = roofline.vit_tokens(a), a["num_heads"]
        hd = a["embed_dim"] // heads
        out = {"attention_fwd": [0.0, 0.0], "attention_bwd": [0.0, 0.0]}
        for r in requests:
            b = 3 * 4 * r.samples  # three encoders over the quads' four members
            out["attention_fwd"][0] += a["depth"] * roofline.attention_fwd_flops(b, heads, s, hd)
            out["attention_fwd"][1] += a["depth"] * roofline.attention_fwd_bytes(
                b, heads, s, hd, self.cfg["train"]["dtype"])
            out["attention_bwd"][0] += a["depth"] * roofline.attention_bwd_flops(b, heads, s, hd)
            out["attention_bwd"][1] += a["depth"] * roofline.attention_bwd_bytes(
                b, heads, s, hd, self.cfg["train"]["dtype"])
        return out
