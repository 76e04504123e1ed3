"""The port's legacy model zoo and MFCC + DTW against the JAX package (CPU).

``models/{audio_legacy,legacy_family,actor,registry}.py`` and
``audio/mfcc.py`` at small widths. Every parameter leaf (and BatchNorm
statistic) comes from a seeded numpy normal and reaches both packages as
the same numbers (``convert.legacy_from_jax``); inputs are numpy from a
seed. Tolerances, from readings on this CPU (float32 both sides, summation
order apart), as a fraction of the reference's largest magnitude (or 1):

  * every forward and every BatchNorm running statistic: 1e-5 (readings
    2e-8 to 2e-6; the conv AE's 3e-5 on outputs of ~40 is 7e-7);
  * MFCC: 5e-4 absolute on coefficients of 100-500 (readings to 2.2e-4:
    ``torch.fft.rfft`` rounds otherwise than XLA's FFT, and the dB scale
    magnifies it in low-energy bins);
  * ``dtw_cost``: 1e-6 on a random cost (reading 2e-7; the first row is a
    left-to-right sum here and ``jnp.cumsum`` in XLA's order there), 2e-4
    on MFCC sequences (reading 5e-5: their pairwise distances come from a
    matmul of large norms); against a float32 loop in JAX's order on the
    port's own cost: bit-equal.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amuse_tpu.audio import mfcc as jmfcc
from amuse_tpu.models import actor as jac
from amuse_tpu.models import audio_legacy as jal
from amuse_tpu.models import legacy_family as jlf
from amuse_tpu.models import registry as jreg
from amuse_tpu_torch.audio import mfcc as tmfcc
from amuse_tpu_torch.models import actor as tac
from amuse_tpu_torch.models import audio_legacy as tal
from amuse_tpu_torch.models import legacy_family as tlf
from amuse_tpu_torch.models import registry as treg
from tests.torch_port_legacy_util import load, max_err, random_variables, shapes_of, t

TOL = 1e-5


def _x(seed, *shape, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=shape)).astype(np.float32)


def _ids(seed, high, *shape):
    return np.random.default_rng(seed).integers(0, high, shape).astype(np.int32)


def _close(mine, ref, tol=TOL):
    scale = max(1.0, float(np.max(np.abs(np.asarray(ref)))))
    assert max_err(mine, ref) <= tol * scale, (max_err(mine, ref), scale)


def _apply(jmod, variables, *args, **kwargs):
    """``jmod.apply`` under jit (one compile, not one per primitive)."""
    return jax.jit(functools.partial(jmod.apply, **kwargs))(variables, *args)


def _pair(jmod, tmod, tag, args, seed=0, **init_kwargs):
    """(random variables, the port module holding them) for ``jmod`` initialised on ``args``."""
    v = random_variables(shapes_of(jmod.init, *args, **init_kwargs), seed)
    return v, load(tmod, tag, v)


# ------------------------------------------------------------------ registry


def test_registry_tags_and_classes_match_jax():
    assert set(treg.REGISTRY) == set(jreg.REGISTRY)
    for tag in jreg.REGISTRY:
        assert treg.get_model(tag).__name__ == jreg.get_model(tag).__name__, tag
        assert issubclass(treg.get_model(tag), torch.nn.Module)
    with pytest.raises(KeyError):
        treg.get_model("nope")


# ------------------------------------------------------------- wav_mfcc AEs


@pytest.mark.parametrize("frames,coeffs", [(64, 28), (64, 13)])
def test_audio_autoencoders(frames, coeffs):
    """EmotionNet, AutoEncoder2x, AutoEncoder3x: encode (latents, logits),
    decode and the full pass; 13 coefficients give odd sides (pads (1, 1))."""
    kw = dict(in_frames=frames, in_coeffs=coeffs, channels=4, latent_dim=8)
    x = _x(1, 2, frames, coeffs)
    for i, name in enumerate(("EmotionNet", "AutoEncoder2x", "AutoEncoder3x")):
        jm = getattr(jal, name)(jal.LegacyAudioConfig(**kw))
        v, tm = _pair(jm, getattr(tal, name)(tal.LegacyAudioConfig(**kw)), name, (x,), seed=i)
        ref = _apply(jm, v, x)
        with torch.no_grad():
            out = tm(t(x))
        if name == "EmotionNet":
            for a, b in zip(out, ref):
                _close(a, b)
            continue
        _close(out[0], ref[0])
        assert set(out[1]) == set(ref[1])
        for k in ref[1]:
            _close(out[1][k], ref[1][k])
        z = ref[1]
        parts = [z[k] for k in ("con", "emo", "sty") if k in z]
        with torch.no_grad():
            _close(tm.decode(*map(t, parts)), _apply(jm, v, *parts, method="decode"))


# ------------------------------------------------------------------- family


def test_tcn_matches_and_is_causal():
    x = _x(2, 2, 16, 3)
    jm = jlf.TemporalConvNet((4, 6))
    v, tm = _pair(jm, tlf.TemporalConvNet(3, (4, 6)), "TemporalConvNet", (x,))
    with torch.no_grad():
        out = tm(t(x))
        _close(out, _apply(jm, v, x))
        x2 = x.copy()
        x2[0, 10] = 99.0
        out2 = tm(t(x2))
    assert torch.equal(out[0, :10], out2[0, :10])
    assert not torch.allclose(out[0, 10:], out2[0, 10:])


def _stats_close(tm_bn, mutated):
    _close(tm_bn.running_mean, mutated["mean"])
    _close(tm_bn.running_var, mutated["var"])


def test_facenet_batchnorm_train_and_eval():
    """Train mode: the output and every running mean and variance (flax
    momentum 0.9, biased batch variance); then eval mode over the stats."""
    x = _x(3, 2, 20, 5)
    jm = jlf.FaceNet(8)
    v, tm = _pair(jm, tlf.FaceNet(5, 8), "FaceNet", (x,), seed=1)
    ref, mut = _apply(jm, v, x, train=True, mutable=["batch_stats"])
    tm.train()
    _close(tm(t(x)), ref)
    for b in ("b0", "b1", "b2", "b3"):
        for bn, stats in mut["batch_stats"][b].items():
            _stats_close(getattr(getattr(tm, b), bn), stats)
    tm.eval()
    with torch.no_grad():
        _close(tm(t(x)), _apply(jm, {"params": v["params"], **mut}, x))


def test_batchnorm_variance_at_a_large_mean():
    """A fault of the reference: flax's BatchNorm takes the batch variance as
    E[x^2] - E[x]^2 in float32, which cancels when a channel's mean is large
    against its spread. The port's two-pass variance keeps the running
    variance within 1e-5 of float64 (mean 1000, spread 1, 32 x 300 frames;
    reading 8e-8) and the output within 1e-4 (reading 2.5e-5: x itself is
    float32 at 1000), where flax's batch variance is off by more than 1e-2
    (reading 0.30; its normalised output is off by up to 0.76)."""
    x = (1000.0 + _x(30, 32, 300, 4)).astype(np.float32)
    var = x.astype(np.float64).var(axis=(0, 1))
    bn = tlf.BatchNorm(4).train()
    out = bn(t(x))
    np.testing.assert_allclose(bn.running_var.numpy(), 0.9 + 0.1 * var, rtol=1e-5)
    want = (x - x.astype(np.float64).mean(axis=(0, 1))) / np.sqrt(var + 1e-5)
    assert max_err(out, want) <= 1e-4
    import flax.linen as fnn

    jbn = fnn.BatchNorm(use_running_average=False, momentum=0.9)
    _, mut = _apply(jbn, jbn.init(jax.random.key(0), x), x, mutable=["batch_stats"])
    jax_batch_var = (np.asarray(mut["batch_stats"]["var"]) - 0.9) / 0.1
    assert np.abs(jax_batch_var / var - 1).max() > 1e-2


@pytest.mark.parametrize("disentangled", [True, False])
def test_audio_net(disentangled):
    x = _x(4, 2, 10, 6)
    jm = jlf.AudioNet(8, disentangled=disentangled, tcn_channels=(5,))
    v, tm = _pair(jm, tlf.AudioNet(6, 8, disentangled=disentangled, tcn_channels=(5,)),
                  "AudioNet", (x,))
    with torch.no_grad():
        _close(tm(t(x)), _apply(jm, v, x))


def test_fusion_and_addons():
    x = _x(5, 2, 7, 12)
    jm = jlf.FusionNet(8)
    v, tm = _pair(jm, tlf.FusionNet(12, 8), "FusionNet", (x,))
    with torch.no_grad():
        _close(tm(t(x)), _apply(jm, v, x))
    spk = _ids(6, 30, 2, 7)
    jm = jlf.SpeakerAddon(8)
    v, tm = _pair(jm, tlf.SpeakerAddon(8), "SpeakerAddon", (spk,))
    with torch.no_grad():
        _close(tm(t(spk).long()), _apply(jm, v, spk))
    emo = _ids(7, 8, 2, 12)
    jm = jlf.EmotionAddon(8)
    v, tm = _pair(jm, tlf.EmotionAddon(8), "EmotionAddon", (emo,), seed=2)
    ref, mut = _apply(jm, v, emo, train=True, mutable=["batch_stats"])
    tm.train()
    _close(tm(t(emo).long()), ref)
    for i in range(4):
        _stats_close(tm.bns[i], mut["batch_stats"][f"bn{i}"])


CAMN = dict(nfeats=6, latent_dim=8, fusion_dim=8, num_layers=2)


@pytest.mark.parametrize("streams", ["all", "audio"])
def test_camn_generator(streams):
    """The fusion LSTM generator in eval and train mode (the emotion addon's
    BatchNorm statistics), with all four conditioning streams or audio only."""
    pose, audio, text = _x(8, 2, 9, 6), _x(9, 2, 9, 4), _x(10, 2, 9, 3)
    emo, spk = _ids(11, 8, 2, 9), _ids(12, 30, 2, 9)
    args = (pose, audio, emo, spk, text) if streams == "all" else (pose, audio)
    jm = jlf.CaMNPoseGenerator(jlf.CaMNConfig(**CAMN))
    tcfg = tlf.CaMNConfig(audio_dim=4, **(dict(text_dim=3) if streams == "all"
                                            else dict(num_emotions=0, num_speakers=0)), **CAMN)
    v, tm = _pair(jm, tlf.CaMNPoseGenerator(tcfg), "camn_lstm", args, seed=3)
    targs = [t(a).long() if a.dtype == np.int32 else t(a) for a in args]
    with torch.no_grad():
        _close(tm(*targs), _apply(jm, v, *args))
    if streams == "all":
        ref, mut = _apply(jm, v, *args, train=True, mutable=["batch_stats"])
        tm.train()
        with torch.no_grad():
            _close(tm(*targs), ref)
        for i in range(4):
            _stats_close(tm.emo_addon.bns[i], mut["batch_stats"]["emo_addon"][f"bn{i}"])
    else:
        with pytest.raises(ValueError, match="stream"):
            tm(targs[0], targs[1], t(emo).long())


def test_faceformer_tables():
    np.testing.assert_array_equal(tlf.periodic_positional_encoding(60, 10).numpy(),
                                  np.asarray(jlf.periodic_positional_encoding(60, 10)))
    np.testing.assert_array_equal(tlf.biased_causal_mask(60).numpy(),
                                  np.asarray(jlf.biased_causal_mask(60)))


@pytest.mark.parametrize("with_emotion", [True, False])
def test_faceformer_decoder(with_emotion):
    """Random non-zero weights (the output map is zero-initialised, so a
    fresh decoder outputs 0), 30 frames over two periods; the port is causal
    over the shifted targets."""
    face, audio = _x(13, 2, 30, 5), _x(14, 2, 30, 3)
    spk, emo = np.array([1, 29]), np.array([0, 7])
    args = (face, audio, spk, emo) if with_emotion else (face, audio, spk)
    kw = dict(n_face_feats=5, latent_dim=8, num_heads=2, ff_size=16, num_layers=2)
    jm = jlf.FaceformerDecoder(**kw)
    tkw = dict(audio_dim=3, num_emotions=8 if with_emotion else 0, **kw)
    v, tm = _pair(jm, tlf.FaceformerDecoder(**tkw), "faceformer", args, seed=4)
    ref = _apply(jm, v, *args)
    assert float(np.abs(ref).max()) > 0.5
    targs = [t(a) if a.dtype == np.float32 else t(a).long() for a in args]
    with torch.no_grad():
        out = tm(*targs)
        _close(out, ref)
        targs[0][0, 20] += 5.0  # frame 20 may move outputs 21+ only
        out2 = tm(*targs)
    assert torch.equal(out[0, :21], out2[0, :21]) and not torch.equal(out[0, 21:], out2[0, 21:])
    fresh = tlf.FaceformerDecoder(**tkw)
    with torch.no_grad():
        assert not fresh(*targs).any()


@functools.lru_cache(maxsize=None)
def _text_pair():
    ids = _ids(15, 50257, 3, 7)
    jm = jlf.TextEncoder(latent_dim=8)
    return jax.jit(jm.apply), ids, *_pair(jm, tlf.TextEncoder(latent_dim=8), "txt_gpt2", (ids,),
                                          seed=5)


@pytest.mark.parametrize("mask", ["none", "right", "left"])
def test_text_encoder_gpt2(mask):
    """GPT-2 (64 wide, 2 layers) with no mask, right padding and left
    padding: left padding's position id -1 reads the last position row, as
    JAX's lookup wraps it."""
    apply, ids, v, tm = _text_pair()
    m = {"none": None,
         "right": np.array([[1] * 7, [1] * 4 + [0] * 3, [1] * 6 + [0]], np.int32),
         "left": np.array([[1] * 7, [0] * 3 + [1] * 4, [0] + [1] * 6], np.int32)}[mask]
    ref = apply(v, ids) if m is None else apply(v, ids, m)
    with torch.no_grad():
        out = tm(t(ids).long(), None if m is None else t(m).long())
    _close(out, ref)


def test_text_encoder_backbone_is_frozen():
    _, ids, _, tm = _text_pair()
    tm.train()
    loss = tm(t(ids).long()).square().sum()
    loss.backward()
    assert all(p.grad is None and not p.requires_grad for p in tm.backbone.parameters())
    assert tm.proj.weight.grad is not None and tm.proj.weight.grad.abs().sum() > 0


@pytest.mark.parametrize("frames", [7, 8])
def test_discriminator_odd_and_even_length(frames):
    x = _x(16, 2, frames, 3)
    jm = jlf.ConvDiscriminator((4, 6))
    v, tm = _pair(jm, tlf.ConvDiscriminator(3, (4, 6)), "discriminator", (x,), seed=6)
    with torch.no_grad():
        out = tm(t(x))
    assert out.shape == (2,)
    _close(out, _apply(jm, v, x))


# --------------------------------------------------------------------- ACTOR


def test_actor_ae_dict_and_decode():
    kw = dict(njoints=2, nfeats=3, num_frames=5, latent_dim=8, ff_size=16, num_layers=2,
              num_heads=2)
    jm = jac.ActorAE(jac.ActorConfig(**kw))
    x, y = _x(17, 2, 5, 6), np.array([1, 6])

    def both(mod, x, y):  # init through decode too, so the decoder's params exist
        out = mod(x, y)
        return out, mod.decode(out["z"], 7)

    v, tm = _pair(jm, tac.ActorAE(tac.ActorConfig(**kw)), "actor_ae", (x, y), seed=7,
                  method=both)
    ref, ref_dec = _apply(jm, v, x, y, method=both)
    with torch.no_grad():
        out = tm(t(x), t(y).long())
        dec = tm.decode(out["z"], 7)
    assert set(out) == set(ref)
    for k in ref:
        _close(out[k], ref[k])
    assert dec.shape == (2, 7, 6)
    _close(dec, ref_dec)


# ---------------------------------------------------------------- MFCC + DTW


def _clips():
    sr = 16_000
    s = np.arange(2 * sr) / sr
    tones = (0.5 * np.sin(2 * np.pi * 440 * s) + 0.2 * np.sin(2 * np.pi * 1234 * s)).astype(
        np.float32)
    quiet = _x(18, 2 * sr, scale=1e-4)
    tail = tones.copy()
    tail[sr:] = 0.0  # a silent second
    return {"tones": tones, "quiet": quiet, "silent_tail": tail}


def test_mfcc_clips():
    """Tones, a quiet clip, a silent tail, each alone and batched (the 80 dB
    floor is per clip), and a clip shorter than the reflect padding."""
    clips = _clips()
    for name, w in clips.items():
        out = tmfcc.mfcc(t(w))
        assert out.shape == (2 * 16_000 // 128 + 1, 13), name
        assert max_err(out, jmfcc.mfcc(jnp.asarray(w))) <= 5e-4, name
    batch = np.stack(list(clips.values()))
    assert max_err(tmfcc.mfcc(t(batch)), jmfcc.mfcc(jnp.asarray(batch))) <= 5e-4
    short = clips["tones"][:500]
    assert max_err(tmfcc.mfcc(t(short)), jmfcc.mfcc(jnp.asarray(short))) <= 5e-4
    np.testing.assert_array_equal(tmfcc._mel_filterbank(1025, 128, 16_000),
                                  jmfcc._mel_filterbank(1025, 128, 16_000))
    np.testing.assert_array_equal(tmfcc._dct_matrix(13, 128), jmfcc._dct_matrix(13, 128))


def test_dtw_cost_and_path():
    a, b = _x(19, 60, 13), _x(20, 45, 13)
    acc = tmfcc.dtw_cost(t(a), t(b)).numpy()
    ref = np.asarray(jmfcc.dtw_cost(jnp.asarray(a), jnp.asarray(b)))
    assert acc.shape == (60, 45)
    assert max_err(acc, ref) <= 1e-6 * float(ref.max())
    # the wavefront keeps JAX's order of operations: a plain loop over the
    # port's own cost matrix gives the same bits
    d = torch.sqrt(torch.clamp((t(a) ** 2).sum(1)[:, None] + (t(b) ** 2).sum(1)[None]
                               - 2.0 * (t(a) @ t(b).T), min=1e-12)).numpy()
    loop = np.empty_like(d)
    loop[0] = np.cumsum(d[0], dtype=np.float32)
    for i in range(1, d.shape[0]):
        left = np.float32(np.inf)
        for j in range(d.shape[1]):
            diag = loop[i - 1, j - 1] if j else np.float32(np.inf)
            left = d[i, j] + min(min(loop[i - 1, j], diag), left)
            loop[i, j] = left
    np.testing.assert_array_equal(acc, loop)
    assert tmfcc.dtw_path(ref) == jmfcc.dtw_path(ref)  # on JAX's own matrix: the same path


def test_align_mfcc():
    clips = _clips()
    wa, wb = clips["tones"], clips["silent_tail"][: 16_000 + 4_000]
    dist, path = tmfcc.align_mfcc(t(wa), t(wb))
    ref_dist, ref_path = jmfcc.align_mfcc(jnp.asarray(wa), jnp.asarray(wb))
    assert abs(dist - ref_dist) <= 2e-4 * ref_dist
    ma, mb = (jmfcc.mfcc(jnp.asarray(w)) for w in (wa, wb))
    acc = tmfcc.dtw_cost(t(np.asarray(ma)), t(np.asarray(mb))).numpy()
    ref_acc = np.asarray(jmfcc.dtw_cost(ma, mb))
    assert max_err(acc, ref_acc) <= 2e-4 * float(ref_acc.max())
    assert path[0] == (0, 0) and path[-1] == (ma.shape[0] - 1, mb.shape[0] - 1)
    steps = np.diff(np.asarray(path), axis=0)
    assert ((steps >= 0) & (steps <= 1)).all() and (steps.sum(1) >= 1).all()
    assert ref_path[-1] == path[-1]


def test_audio_autoencoder_bfloat16_compute():
    """``LegacyAudioConfig.dtype`` bf16: convolutions and dense layers compute
    in bf16 over float32 parameters, as flax's; within 3e-2 of the largest
    output of JAX's bf16 (readings 0.7-1.4e-2: both round at their own
    points)."""
    kw = dict(channels=4, latent_dim=8)
    x = _x(21, 2, 64, 28)
    jm = jal.AutoEncoder3x(jal.LegacyAudioConfig(dtype=jnp.bfloat16, **kw))
    tm = tal.AutoEncoder3x(tal.LegacyAudioConfig(dtype=torch.bfloat16, **kw))
    v, tm = _pair(jm, tm, "wav_mfcc", (x,), seed=9)
    ref = _apply(jm, v, x)
    with torch.no_grad():
        out = tm(t(x))
    assert out[0].dtype == torch.float32
    for a, b in ((out[0], ref[0]), *((out[1][k], ref[1][k]) for k in ref[1])):
        _close(a, b, 3e-2)
