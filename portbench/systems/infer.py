"""The frozen inference stack of ``amuse_tpu_torch`` under test:
``GesturePipeline.wav_to_motion`` (a batch of windows, outputs copied to the
host) or ``GesturePipeline.infer_wav`` (one clip, numpy back), as the mix's
``entry`` says.

Set-up builds the configuration's kernel sources, draws the weights on the
device under the reference's keys and hands them to the pipeline, makes the
pool of audio on the device and copies it to the host (where a user's audio
lies), and runs every request size of the mix ``warmup_rounds`` times. The
check re-draws the same weights after the program is freed and runs the
plain reference over a sample of the window's requests.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench.generator import Done, Request, Traffic
from portbench.inputs import make_weights, speech_like, sub_seed
from portbench.reference import fbank as fbank_ref
from portbench.reference import infer as ref
from portbench.systems import _session

POOL_CHUNK = 32  # windows of audio made per call, to keep set-up's peak low


def make_pool(cfg: dict, windows: int, seed: int, device: torch.device) -> np.ndarray:
    """(windows, samples) float32 speech stand-in on the host, made on ``device``."""
    size = cfg["audio"]["window_samples"]
    pool = np.empty((windows, size), np.float32)
    for i in range(0, windows, POOL_CHUNK):
        n = min(POOL_CHUNK, windows - i)
        pool[i:i + n] = speech_like(n, size, cfg["audio"]["sample_rate"], sub_seed(seed, 8, i),
                                    device).cpu().numpy()
    return pool


def request_inputs(cfg: dict, mix: dict, pool: np.ndarray, r: Request,
                   device: torch.device) -> tuple[np.ndarray, torch.Tensor]:
    """What the reference takes for request ``r``: its (n, 160000) windows as
    the entry cuts them, and the initial latents the program starts from
    (handed to ``wav_to_motion``; drawn by ``infer_wav`` from the request's
    seed on the device)."""
    dn = cfg["denoiser"]
    chunks = pool[r.start:r.start + r.samples]
    if mix["entry"] == "infer_wav":
        chunks = fbank_ref.windows(chunks.reshape(-1))
    x_t = ref.initial_latents((r.samples, dn["latent_tokens"], dn["latent_dim"]), r.seed,
                              device)
    return np.ascontiguousarray(chunks), x_t


def judge(errors: torch.Tensor, probes: torch.Tensor) -> dict:
    """Per-window gaps from the reference (``errors``) and the reference's
    own gaps under its probe (``probes``) -> the numbers a run compares,
    ``err_median_rel`` and ``err_max_rel``: the median and the largest
    window's gap in units of the probe's median gap (how far one bf16
    rounding of the AST's features moves this seed's model), and the raw
    readings beside them."""
    unit = float(probes.median())
    finite = bool(torch.isfinite(errors).all())
    worst = float(errors.max()) if finite else float("inf")
    return {"err_median_rel": float(errors.median()) / unit if finite else float("inf"),
            "err_max_rel": worst / unit, "window_err_median": float(errors.median()),
            "window_err_max": worst, "probe_median": unit}


def served_types(cfg: dict) -> dict:
    return {"ast": cfg["ast"]["dtype"], "denoiser": cfg["denoiser"]["dtype"],
            "prior": cfg["prior"]["dtype"]}


ENTRIES = ("wav_to_motion", "infer_wav")


class Session(_session.Session):
    PROGRAM = ("pipe",)

    def __init__(self, cfg: dict, mix: dict, settings: dict, seed: int, device: torch.device):
        from amuse_tpu_torch.infer.pipeline import GesturePipeline, PipelineParams
        from amuse_tpu_torch.models.ast import ASTConfig
        from amuse_tpu_torch.models.denoiser import DenoiserConfig
        from amuse_tpu_torch.models.vae import PriorConfig
        from amuse_tpu_torch.ops import _build

        _session.check_entry(mix, ENTRIES)
        self.cfg, self.mix, self.settings = cfg, mix, settings
        self.seed, self.device = seed, device
        self.traffic = Traffic(mix, seed)
        self.stages = {}  # set-up's parts on the host clock, for standard error
        t = time.perf_counter()
        if device.type == "cuda":
            _build.build(list(cfg["sources"]))
            self.stages["build_s"], t = time.perf_counter() - t, time.perf_counter()
            torch.ones(1, device=device).sum().item()
            self.stages["cuda_init_s"], t = time.perf_counter() - t, time.perf_counter()
        a, dn, pr = cfg["ast"], cfg["denoiser"], cfg["prior"]
        weights = make_weights(ref.param_shapes(cfg), served_types(cfg), seed, device)
        self._sync()
        self.stages["weights_s"], t = time.perf_counter() - t, time.perf_counter()
        den_keys = ("latent_tokens", "latent_dim", "ff_size", "num_layers", "num_heads",
                    "cond_dim", "max_len")
        prior_keys = ("nfeats", "latent_tokens", "latent_dim", "ff_size", "num_layers",
                      "num_heads", "window", "max_len")
        self.pipe = GesturePipeline(
            PipelineParams(ast=weights["ast"], prior=weights["prior"],
                           denoiser=weights["denoiser"]),
            PriorConfig(**{k: pr[k] for k in prior_keys}),
            DenoiserConfig(**{k: dn[k] for k in den_keys}),
            ASTConfig(**{k: a[k] for k in _session.AST_KEYS}),
            dtype=getattr(torch, a["dtype"]),
            num_inference_steps=cfg["diffusion"]["num_inference_steps"],
            device=device)
        del weights  # the pipeline holds its own copies; the check draws them again
        self._sync()
        self.stages["pipeline_s"], t = time.perf_counter() - t, time.perf_counter()
        self.pool = make_pool(cfg, self.traffic.pool, seed, device)
        self.stages["audio_s"], t = time.perf_counter() - t, time.perf_counter()
        for r in self.traffic.warmup():
            self.request(r)
        self._sync()
        self.stages["warmup_s"] = time.perf_counter() - t

    def request(self, r: Request) -> Done:
        if self.mix["entry"] == "wav_to_motion":
            chunks = self.pool[r.start:r.start + r.samples]
            dn = self.cfg["denoiser"]
            x_t = ref.initial_latents((r.samples, dn["latent_tokens"], dn["latent_dim"]),
                                      r.seed, self.device)
            start = time.perf_counter()
            poses, trans = self.pipe.wav_to_motion(chunks, initial_latents=x_t)
            out = {"poses": poses.cpu().numpy(), "trans": trans.cpu().numpy()}
        else:  # infer_wav: the clip is the run of windows, one waveform
            wave = self.pool[r.start:r.start + r.samples].reshape(-1)
            start = time.perf_counter()
            out = self.pipe.infer_wav(wave, seed=r.seed)
        return Done(r, start, time.perf_counter(), out["poses"], out["trans"])

    def check_requests(self) -> list:
        """Requests a reading of the check sends after set-up: the traffic's
        first ``check.requests``."""
        return [self.traffic.request(i) for i in range(int(self.settings["check"]["requests"]))]

    def sample(self, done: list[Done]) -> list[Done]:
        """``check.requests`` requests of the window drawn from the seed, one
        of the largest among them."""
        k = min(int(self.settings["check"]["requests"]), len(done))
        rng = np.random.default_rng(sub_seed(self.seed, 7))
        picked = [done[i] for i in sorted(rng.choice(len(done), size=k, replace=False))]
        largest = max(d.request.samples for d in done)
        if all(d.request.samples < largest for d in picked):
            big = [d for d in done if d.request.samples == largest]
            picked[-1] = big[int(rng.integers(len(big)))]
        return picked

    def check(self, done: list[Done]) -> dict:
        """The reference over the sampled requests -> ``judge``'s numbers."""
        picked = self.sample(done)
        weights = make_weights(ref.param_shapes(self.cfg), served_types(self.cfg), self.seed,
                               self.device)
        reference = ref.Reference(self.cfg, weights, self.device)
        del weights
        errors, probes = [], []
        infer_wav = self.mix["entry"] == "infer_wav"
        for d in picked:
            chunks, x_t = request_inputs(self.cfg, self.mix, self.pool, d.request, self.device)
            want, probe = reference.motion(torch.from_numpy(chunks), x_t, zero_jaw=infer_wav,
                                           probe_seed=sub_seed(self.seed, 9, d.request.index))
            got_m = ref.axis_angle_to_matrix(torch.from_numpy(d.poses).to(self.device))
            got_t = torch.from_numpy(d.trans).to(self.device)
            errors.append(ref.window_errors(got_m, got_t, *want).cpu())
            probes.append(ref.window_errors(*probe, *want).cpu())
        return judge(torch.cat(errors), torch.cat(probes))

    def slice_flops(self, requests: list[Request]) -> dict:
        """Operations and bytes of the kernels' work in the traced slice."""
        from portbench import roofline

        a, dn = self.cfg["ast"], self.cfg["denoiser"]
        enc, s = len(a["encoders"]), roofline.vit_tokens(a)
        heads, hd = a["num_heads"], a["embed_dim"] // a["num_heads"]
        steps = self.cfg["diffusion"]["num_inference_steps"]
        out = {"attention_fwd": [0.0, 0.0], "ddim_sampler": [0.0, 0.0]}
        for r in requests:
            b = enc * r.samples
            out["attention_fwd"][0] += a["depth"] * roofline.attention_fwd_flops(b, heads, s, hd)
            out["attention_fwd"][1] += a["depth"] * roofline.attention_fwd_bytes(
                b, heads, s, hd, a["dtype"])
            out["ddim_sampler"][0] += roofline.sampler_flops(dn, r.samples, steps, enc)
            out["ddim_sampler"][1] += roofline.sampler_bytes(dn, r.samples, enc)
        return out


def control_reading(cell, seed: int, device: torch.device) -> dict:
    """The control (``Reference(precision="control")``) in the program's
    place over the traffic's first ``check.requests``, judged as a run
    judges the program."""
    cfg, mix = cell.config, cell.traffic
    pool = make_pool(cfg, int(mix["pool_samples"]), seed, device)
    weights = make_weights(ref.param_shapes(cfg), served_types(cfg), seed, device)
    exact = ref.Reference(cfg, weights, device)
    low = ref.Reference(cfg, weights, device, precision="control")
    infer_wav = mix["entry"] == "infer_wav"
    traffic = Traffic(mix, seed)
    errors, probes = [], []
    for r in (traffic.request(i) for i in range(int(cell.settings["check"]["requests"]))):
        chunks, x_t = request_inputs(cfg, mix, pool, r, device)
        chunks = torch.from_numpy(chunks)
        want, probe = exact.motion(chunks, x_t, zero_jaw=infer_wav,
                                   probe_seed=sub_seed(seed, 9, r.index))
        got = low.motion(chunks, x_t, zero_jaw=infer_wav)
        errors.append(ref.window_errors(*got, *want).cpu())
        probes.append(ref.window_errors(*probe, *want).cpu())
    return judge(torch.cat(errors), torch.cat(probes))
