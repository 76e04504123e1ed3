"""The port's checkpoint loading (utils/checkpoint_io.py) against the JAX package.

A released AMUSE directory is written from reference-keyed state dicts
(``tests/torch_sd.py``) at small widths: the AST as a DataParallel
``model_*.pkl``, a prior and a latdiff (``denoiser.``-prefixed, inside
``model_state_dict``) per epoch, with decoys whose filename metrics must
lose. The JAX importer's defaults fix the depths (AST 12 blocks, prior and
denoiser 9 layers, ``torch_import.py``). Both packages load it through
``load_pipeline_params``; ``wav_to_motion`` from the same initial latents
agrees at the float32 bounds of ``test_torch_port_pipeline.py`` (features
atol 1e-4, poses as rotation matrices and translation atol 1e-3).
"""

import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amuse_tpu.infer.pipeline import GesturePipeline as JPipeline
from amuse_tpu.models.ast import ASTConfig as JAST
from amuse_tpu.models.denoiser import DenoiserConfig as JDen
from amuse_tpu.models.vae import PriorConfig as JPrior
from amuse_tpu.utils import checkpoint_io as jcio
from amuse_tpu.utils import torch_import as ti
from amuse_tpu_torch.audio.wavio import save_wav
from amuse_tpu_torch.cli import main as cli
from amuse_tpu_torch.infer.pipeline import GesturePipeline
from amuse_tpu_torch.models.ast import ASTConfig
from amuse_tpu_torch.models.denoiser import DenoiserConfig
from amuse_tpu_torch.models.vae import PriorConfig
from amuse_tpu_torch.train.checkpoint import CheckpointManager
from amuse_tpu_torch.utils import checkpoint_io as cio
from tests import torch_sd
from tests.torch_port_pipes import FEAT_ATOL, assert_motion_close

D, FF, LAYERS, COND, EMBED, DEPTH = 16, 32, 9, 12, 16, 12
PRIOR_KW = dict(latent_dim=D, ff_size=FF, num_layers=LAYERS, num_heads=2)
DEN_KW = dict(latent_dim=D, ff_size=FF, num_layers=LAYERS, num_heads=2, cond_dim=COND)
AST_KW = dict(embed_dim=EMBED, depth=DEPTH, num_heads=2, feature_dim=COND)
STEPS = 3


def _stage2_name(kind: str, total: float, epoch: int, rng) -> str:
    v = rng.uniform(0, 9, size=8)
    return (f"{kind}_recF{v[0]:.4f}_recJ{v[1]:.4f}_kl{v[2]:.4f}_genF{v[3]:.4f}"
            f"_genJ{v[4]:.4f}_instL{v[5]:.4f}_vtexR{v[6]:.4f}_vtexG{v[7]:.4f}"
            f"_total{total:.4f}_e{epoch}.pt")


def _ast_name(epoch, tL, tEA, tPA, vL, vEA, vPA) -> str:
    return (f"model_{epoch}_tL{tL:.8f}_tEA{tEA:.8f}_tPA{tPA:.8f}"
            f"_vL{vL:.8f}_vEA{vEA:.8f}_vPA{vPA:.8f}.pkl")


def _tensors(sd: dict) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}


def write_released_dir(root: Path, seed: int = 0) -> tuple[dict, dict]:
    """-> ({kind: the file that must be selected}, {kind: its state dict as written})."""
    rng = np.random.default_rng(seed)
    sds = {"ast": {}, "prior": {}, "denoiser": {}}
    torch_sd.disentangler_sd(rng, sds["ast"], embed=EMBED, depth=DEPTH, feature_dim=COND,
                             fusion_dim=8, out_frames=4, out_bins=4)
    torch_sd.prior_sd(rng, sds["prior"], d=D, ff=FF, layers=LAYERS)
    torch_sd.denoiser_sd(rng, sds["denoiser"], d=D, ff=FF, layers=LAYERS, cond=COND)
    root.mkdir(parents=True, exist_ok=True)
    decoy = {"decoy.weight": torch.zeros(3)}  # fails to load if ever selected
    want = {"ast": root / _ast_name(7, 0.5, 0.91, 0.2, 0.6, 0.8, 0.3),
            "prior": root / _stage2_name("prior_model_NoOpt", 2.0, 200, rng),
            "denoiser": root / _stage2_name("latdiff_model_wOpt", 0.25, 200, rng)}
    torch.save({f"module.{k}": v for k, v in _tensors(sds["ast"]).items()}, want["ast"])
    torch.save(_tensors(sds["prior"]), want["prior"])
    torch.save({"model_state_dict": {f"denoiser.{k}": v
                                     for k, v in _tensors(sds["denoiser"]).items()},
                "optimizer_state_dict": {"state": {}, "param_groups": [{"lr": 1e-4}]}},
               want["denoiser"])
    for name in (_ast_name(3, 0.4, 0.90, 0.95, 0.5, 0.9, 0.9),  # higher tPA, lower tEA
                 _stage2_name("prior_model_NoOpt", 0.5, 300, rng),  # lower total, other epoch
                 _stage2_name("prior_model_NoOpt", 1.0, 100, rng),
                 _stage2_name("latdiff_model_wOpt", 0.75, 300, rng)):
        torch.save(decoy, root / name)
    return want, sds


@pytest.fixture(scope="module")
def released(tmp_path_factory):
    root = tmp_path_factory.mktemp("released")
    want, sds = write_released_dir(root)
    return root, want, sds


def _load_both(root, monkeypatch):
    monkeypatch.setenv("AMUSE_TPU_CKPT", str(root))
    monkeypatch.delenv("AMUSE_TPU_AST_CKPT", raising=False)
    return jcio.load_pipeline_params(), cio.load_pipeline_params()


def test_released_dir_selects_the_files_jax_selects(released):
    root, want, _ = released
    got = cio.released_files(root)
    assert got == want
    latdiff, epoch = jcio.select_latdiff_checkpoint(sorted(root.glob("latdiff*.pt")))
    assert latdiff == got["denoiser"] and epoch == 200
    assert jcio.select_prior_checkpoint(sorted(root.glob("prior*.pt")), epoch) == got["prior"]
    assert jcio.select_ast_checkpoint(sorted(root.glob("model_*.pkl"))) == got["ast"]


def test_released_dir_loads_bit_equal(released, monkeypatch):
    """module. and denoiser. prefixes stripped; every tensor as written."""
    root, _, sds = released
    _, params = _load_both(root, monkeypatch)
    for kind in ("ast", "prior", "denoiser"):
        got = getattr(params, kind)
        assert got.keys() == sds[kind].keys()
        for k, v in sds[kind].items():
            np.testing.assert_array_equal(got[k].numpy(), v)


def test_released_dir_wav_to_motion_matches_jax(released, monkeypatch):
    root, _, _ = released
    jparams, params = _load_both(root, monkeypatch)
    jpipe = JPipeline(jparams, JPrior(**PRIOR_KW), JDen(**DEN_KW), JAST(**AST_KW),
                      dtype=jnp.float32, num_inference_steps=STEPS)
    pipe = GesturePipeline(params, PriorConfig(**PRIOR_KW), DenoiserConfig(**DEN_KW),
                           ASTConfig(**AST_KW), dtype=torch.float32,
                           num_inference_steps=STEPS, device="cpu")
    chunks = np.random.default_rng(1).normal(scale=0.05, size=(2, 160000)).astype(np.float32)
    x0 = np.random.default_rng(2).normal(size=(2, 1, D)).astype(np.float32)
    jc = jpipe.encode_audio(jnp.asarray(chunks))
    tc = pipe.encode_audio(chunks)
    for k in ("con", "emo", "sty"):
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]), atol=FEAT_ATOL, rtol=1e-3)
    jl = jpipe.generate_latents(None, jc["con"], jc["emo"], jc["sty"],
                                initial_latents=jnp.asarray(x0))
    poses, trans = pipe.wav_to_motion(chunks, initial_latents=torch.from_numpy(x0))
    assert poses.shape == (2, 300, 55, 3)
    assert_motion_close((poses.numpy(), trans.numpy()), jpipe.decode_motion(jl))


def _run_dirs(tmp_path, sds, ast_layout: str):
    """The port's own run directories: {"prior", "denoiser"} (under
    "params") in one, the AST in another (bare, or the port's train_audio
    state with the parameters under "model")."""
    CheckpointManager(tmp_path / "lpdm").save(
        3, {"params": {"prior": _tensors(sds["prior"]), "denoiser": _tensors(sds["denoiser"])}})
    ast = _tensors(sds["ast"])
    CheckpointManager(tmp_path / "ast").save(
        1, ast if ast_layout == "bare" else {"model": ast, "optimizer": {}, "step": 1})
    return tmp_path / "lpdm", tmp_path / "ast"


@pytest.mark.parametrize("ast_layout", ["bare", "train_state"])
def test_run_dirs_load(released, tmp_path, monkeypatch, ast_layout):
    _, _, sds = released
    lpdm, ast = _run_dirs(tmp_path, sds, ast_layout)
    monkeypatch.setenv("AMUSE_TPU_CKPT", str(lpdm))
    monkeypatch.setenv("AMUSE_TPU_AST_CKPT", str(ast))
    params = cio.load_pipeline_params()
    for kind in ("ast", "prior", "denoiser"):
        got = getattr(params, kind)
        assert got.keys() == sds[kind].keys()
        for k, v in sds[kind].items():
            np.testing.assert_array_equal(got[k].numpy(), v)


@pytest.mark.parametrize("case", ["unset", "missing_path", "incomplete_released_dir",
                                  "run_dir_without_ast", "orbax_step_dir"])
def test_refusals(released, tmp_path, monkeypatch, case):
    """No checkpoint configured -> None; a configured one that cannot be
    assembled raises, as in the JAX package, and never gives random weights."""
    monkeypatch.delenv("AMUSE_TPU_AST_CKPT", raising=False)
    if case == "unset":
        monkeypatch.delenv("AMUSE_TPU_CKPT", raising=False)
        assert cio.load_pipeline_params() is None and jcio.load_pipeline_params() is None
        return
    if case == "missing_path":
        root, err, match = tmp_path / "nowhere", FileNotFoundError, "neither"
    elif case == "incomplete_released_dir":
        root, err, match = tmp_path, ValueError, "could not be assembled"
        torch.save({}, tmp_path / "prior_model_NoOpt_total1.0000_e1.pt")
    elif case == "run_dir_without_ast":
        root, err, match = _run_dirs(tmp_path, released[2], "bare")[0], ValueError, "AST_CKPT"
    else:
        root, err, match = tmp_path, NotImplementedError, "orbax.*from_jax_params"
        (tmp_path / "step_00000001" / "state").mkdir(parents=True)
        (tmp_path / "step_00000001" / "metadata.json").write_text(json.dumps({"step": 1}))
    monkeypatch.setenv("AMUSE_TPU_CKPT", str(root))
    with pytest.raises(err, match=match):
        cio.load_pipeline_params()


def test_cli_infer_gesture_loads_released_dir(released, tmp_path, monkeypatch, capsys):
    """``AMUSE_TPU_CKPT`` drives the port's CLI: no random-weights notice, and
    the npz files of the loaded pipeline."""
    root, _, _ = released
    (tmp_path / "wavs").mkdir()
    save_wav(tmp_path / "wavs" / "2_scott_0_9_9.wav",
             np.random.default_rng(3).normal(scale=0.05, size=170000).astype(np.float32))
    cfg = {"audio": {"ast_embed_dim": EMBED, "ast_depth": DEPTH, "ast_heads": 2,
                     "ast_feature_dim": COND},
           "gesture": {"latent_dim": D, "ff_size": FF, "num_layers": LAYERS, "num_heads": 2,
                       "cond_dim": COND, "num_inference_steps": STEPS},
           "dtype": "float32", "out_dir": str(tmp_path / "runs")}
    (tmp_path / "cfg.json").write_text(json.dumps(cfg))
    monkeypatch.setenv("AMUSE_TPU_CKPT", str(root))
    cli.main(["--fn", "infer_gesture", "--cfg", str(tmp_path / "cfg.json"),
              "--wav-dir", str(tmp_path / "wavs"), "--device", "cpu"])
    assert "random weights" not in capsys.readouterr().out
    (npz,) = tmp_path.glob("runs/*/gesture/2_scott_0_9_9/rep0/seq_0/*.npz")
    d = np.load(npz)
    assert d["poses"].shape == (300, 55, 3) and np.isfinite(d["poses"]).all()


# ---------------------------- tests/test_checkpoint_import.py's grammar fuzz, both packages


def _fuzz_latdiff(impl):
    for seed in range(10):
        rng = np.random.default_rng(seed)
        totals = rng.uniform(0.01, 99.0, size=12)
        epochs = rng.permutation(np.arange(1, 13)) * 10
        paths = [Path(_stage2_name("latdiff_model_wOpt", t, e, rng))
                 for t, e in zip(totals, epochs)]
        k = int(np.argmin(totals))
        assert impl.select_latdiff_checkpoint(paths) == (paths[k], int(epochs[k]))


def _fuzz_prior(impl):
    rng = np.random.default_rng(0)
    priors = [Path(_stage2_name("prior_model_NoOpt", rng.uniform(0.1, 5), e, rng))
              for e in (100, 200, 300)]
    assert impl.select_prior_checkpoint(priors, 200) == priors[1]
    lone = [Path(_stage2_name("prior_model_NoOpt", 1.0, 999, rng))]
    assert impl.select_prior_checkpoint(lone, 200) == lone[0]


def _fuzz_ast(impl):
    for seed in range(10):
        rng = np.random.default_rng(100 + seed)
        tea, tpa = rng.uniform(0, 1, size=8), rng.uniform(0, 1, size=8)
        paths = [Path(_ast_name(e + 1, rng.uniform(0, 2), tea[e], tpa[e], rng.uniform(0, 2),
                                rng.uniform(0, 1), rng.uniform(0, 1))) for e in range(8)]
        assert impl.select_ast_checkpoint(paths) == paths[int(np.argmax(tea))]
        assert impl.select_ast_checkpoint(paths, ablation="identity") == paths[int(np.argmax(tpa))]


def _ast_epoch_zero(impl):
    p0 = Path(_ast_name(0, 1.0, 0.99, 0.5, 1.0, 0.9, 0.5))
    p1 = Path(_ast_name(1, 1.0, 0.10, 0.5, 1.0, 0.9, 0.5))
    assert impl.select_ast_checkpoint([p0, p1]) == p1


def _unparseable(impl):
    paths = [Path("latdiff_final.pt"), Path("latdiff_release.pt")]
    assert impl.select_latdiff_checkpoint(paths)[0] == paths[-1]
    assert impl.select_ast_checkpoint([Path("ast.pkl")]) == Path("ast.pkl")


@pytest.mark.parametrize("impl", ["jax", "port"])
@pytest.mark.parametrize("case", [_fuzz_latdiff, _fuzz_prior, _fuzz_ast, _ast_epoch_zero,
                                  _unparseable], ids=lambda f: f.__name__.strip("_"))
def test_filename_grammar(case, impl):
    case({"jax": jcio, "port": cio}[impl])


# ---------------------------- tests/test_checkpoint_import.py's DataParallel layouts


@pytest.mark.parametrize("case", ["wrapped_equals_bare", "partial_prefix_untouched", "empty"])
def test_dataparallel_layouts(case):
    if case == "wrapped_equals_bare":
        sd = {"a.weight": np.ones((2, 2), np.float32), "b.bias": np.zeros(2, np.float32)}
        wrapped = {f"module.{k}": v for k, v in sd.items()}
        assert cio.state_dict_is_dataparallel(wrapped) and not cio.state_dict_is_dataparallel(sd)
        got = cio.strip_dataparallel_prefix(wrapped)
        assert got.keys() == sd.keys() == ti.strip_dataparallel_prefix(wrapped).keys()
        for k in sd:
            np.testing.assert_array_equal(got[k], sd[k])
    elif case == "partial_prefix_untouched":
        sd = {"module.a.weight": np.ones(2, np.float32), "head.bias": np.zeros(2, np.float32)}
        assert set(cio.strip_dataparallel_prefix(sd)) == {"module.a.weight", "head.bias"}
    else:
        assert cio.strip_dataparallel_prefix({}) == {} and not cio.state_dict_is_dataparallel({})
