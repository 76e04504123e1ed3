"""Text/corpus utilities: word embeddings for TextGrid dialogue.

The port's copy of ``amuse_tpu/data/corpus.py`` (with its own copy of
``beat_transcripts.json``).

Re-provides dm/utils/corpus_utils.py (GPT-2 text encoding of TextGrid
dialogue, models/diffusion/text/txt_models.py) with graceful degradation:
if HuggingFace GPT-2 weights are available locally they are used; otherwise
a deterministic hashing-based bag-of-words embedding stands in so the legacy
text-conditioned path stays executable offline.
"""

from __future__ import annotations

import hashlib
from typing import Optional

import numpy as np

_GPT2 = None


def _try_load_gpt2():
    global _GPT2
    if _GPT2 is not None:
        return _GPT2
    try:
        from transformers import GPT2Model, GPT2Tokenizer

        tok = GPT2Tokenizer.from_pretrained("gpt2", local_files_only=True)
        model = GPT2Model.from_pretrained("gpt2", local_files_only=True)
        model.eval()
        _GPT2 = (tok, model)
    except Exception:
        _GPT2 = False
    return _GPT2


def hash_embedding(text: str, dim: int = 768) -> np.ndarray:
    """Deterministic per-word hashed embedding, mean-pooled over the text."""
    words = text.lower().split()
    if not words:
        return np.zeros(dim, np.float32)
    vecs = []
    for w in words:
        seed = int.from_bytes(hashlib.sha256(w.encode()).digest()[:8], "little")
        vecs.append(np.random.default_rng(seed).normal(size=dim))
    return np.mean(vecs, axis=0).astype(np.float32)


def encode_dialogue(text: str, dim: int = 768) -> np.ndarray:
    """Dialogue string -> (dim,) embedding (GPT-2 mean-pooled hidden state
    when weights are present, hashed fallback otherwise)."""
    if not text.strip():
        # GPT-2 over a zero-length sequence would mean() to NaN; the hashed
        # fallback already returns zeros for empty text - match it
        return np.zeros(dim, np.float32)
    g = _try_load_gpt2()
    if g:
        import torch

        tok, model = g
        with torch.no_grad():
            ids = tok(text, return_tensors="pt", truncation=True, max_length=512)
            out = model(**ids).last_hidden_state.mean(dim=1)[0]
        emb = out.numpy().astype(np.float32)
        if dim != emb.shape[0]:
            # honor the requested dim on BOTH paths: downstream arrays must
            # not change shape with the environment (GPT-2 cached or not).
            # Fixed-seed Gaussian projection preserves distances in
            # expectation (Johnson-Lindenstrauss) and is deterministic.
            proj = np.random.default_rng(0).normal(
                size=(emb.shape[0], dim)
            ).astype(np.float32) / np.sqrt(dim)
            emb = emb @ proj
        return emb
    return hash_embedding(text, dim)


def encode_dialogue_batch(texts: list[str], dim: int = 768) -> np.ndarray:
    return np.stack([encode_dialogue(t, dim) for t in texts])


# ---------------------------------------------------------------------------
# BEAT take transcripts (the reference's dm/utils/all_words.py `corpos_text`)
# ---------------------------------------------------------------------------

_TRANSCRIPTS = None


def take_transcript(take: str) -> Optional[str]:
    """Spoken text of a BEAT take (e.g. "0_9_9") or None if unknown.

    The per-take transcript corpus is BEAT dataset content the reference
    hardcodes (all_words.py:corpos_text, 21 takes - the 16 pretrained takes
    plus extras); vendored here as data (beat_transcripts.json) the same way
    the per-actor MoSh betas are. Feeds the legacy text-conditioned path
    (txt_models.py GPT-2 encoding via encode_dialogue).
    """
    global _TRANSCRIPTS
    if _TRANSCRIPTS is None:
        import json
        from pathlib import Path

        path = Path(__file__).parent / "beat_transcripts.json"
        _TRANSCRIPTS = {k: " ".join(v) for k, v in json.loads(path.read_text()).items()}
    return _TRANSCRIPTS.get(take)


def encode_take_transcript(take: str, dim: int = 768) -> Optional[np.ndarray]:
    """take id -> dialogue embedding (GPT-2 or hashed fallback), or None."""
    text = take_transcript(take)
    return None if text is None else encode_dialogue(text, dim)
