"""Text quality metrics: WER / CER / token error rate via Levenshtein
edit distance (whisper_tpu/utils/metrics.py, the same values). Pure host
code: numpy and the standard library."""

from __future__ import annotations

import re
from typing import Sequence

import numpy as np


def normalize_text(text: str) -> str:
    """Minimal normalization before scoring (the openai/whisper
    BasicTextNormalizer shape: lowercase, strip punctuation, collapse
    whitespace). Deliberately dependency-free."""
    text = text.lower()
    text = re.sub(r"[^\w\s']", " ", text)
    return re.sub(r"\s+", " ", text).strip()


def edit_distance(ref: Sequence, hyp: Sequence) -> int:
    """Levenshtein distance (substitution/insertion/deletion all cost 1),
    O(len(ref) * len(hyp)) with a vectorized inner loop."""
    n, m = len(ref), len(hyp)
    if n == 0:
        return m
    if m == 0:
        return n
    # Map to int codes so the inner comparison is a numpy broadcast.
    vocab = {t: i for i, t in enumerate(dict.fromkeys(list(ref) + list(hyp)))}
    r = np.asarray([vocab[t] for t in ref])
    h = np.asarray([vocab[t] for t in hyp])
    prev = np.arange(m + 1)
    for i in range(1, n + 1):
        cur = np.empty(m + 1, dtype=np.int64)
        cur[0] = i
        sub = prev[:-1] + (h != r[i - 1])
        ins = prev[1:] + 1
        best = np.minimum(sub, ins)
        # deletion needs the running prefix: cur[j] = min(best[j-1], cur[j-1]+1)
        acc = cur[0]
        for j in range(1, m + 1):
            acc = min(best[j - 1], acc + 1)
            cur[j] = acc
        prev = cur
    return int(prev[m])


def wer(ref_text: str, hyp_text: str, normalize: bool = True) -> float:
    """Word error rate: edit_distance over words / len(ref words).
    Returns 0.0 when both are empty, 1.0 when only the hypothesis is."""
    if normalize:
        ref_text, hyp_text = normalize_text(ref_text), normalize_text(hyp_text)
    ref, hyp = ref_text.split(), hyp_text.split()
    if not ref:
        return 0.0 if not hyp else 1.0
    return edit_distance(ref, hyp) / len(ref)


def cer(ref_text: str, hyp_text: str, normalize: bool = True) -> float:
    """Character error rate (spaces included after normalization)."""
    if normalize:
        ref_text, hyp_text = normalize_text(ref_text), normalize_text(hyp_text)
    if not ref_text:
        return 0.0 if not hyp_text else 1.0
    return edit_distance(ref_text, hyp_text) / len(ref_text)


def token_er(ref_ids: Sequence[int], hyp_ids: Sequence[int]) -> float:
    """Token error rate over raw id sequences — the weight-agnostic variant
    used for offline A/B runs (random weights produce degenerate text, but
    token-level divergence between numerics modes is still meaningful)."""
    if not len(ref_ids):
        return 0.0 if not len(hyp_ids) else 1.0
    return edit_distance(list(ref_ids), list(hyp_ids)) / len(ref_ids)
