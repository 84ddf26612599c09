"""Word-level timestamps by cross-attention alignment (whisper_tpu/
alignment.py, openai/whisper's find_alignment): one teacher-forced decoder
pass over the decoded sequence collects the cross-attention
probabilities, the alignment heads' rows are normalized along time,
median-filtered and averaged, the -matrix is dynamic-time-warped, and the
tokens are grouped into words whose first and last aligned frames give
their times (one encoder position = 0.02 s).

Without an official (layer, head) table the heads of the upper half of
the decoder layers are used; a checkpoint's sidecar (alignment_heads.json
or HF's generation_config.json) gives the official one.

The probabilities must be materialized, so the pass is plain PyTorch
einsums and a softmax in fp32 (TF32 off on the card), never the flash
kernels, which return no probabilities. The DTW and the median filter are
numpy on the host, copied from the JAX module as they are.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from whisper_tpu_torch.config import WhisperConfig
from whisper_tpu_torch.models.whisper import (
    compute_dtype,
    full_fp32,
    gelu,
    layer_index,
    layer_norm,
    linear,
    merge_heads,
    qkv_fused,
    split_heads,
    split_heads_hm,
    tok_embed,
)
from whisper_tpu_torch.ops.attention import mha_reference

FRAME_S = 0.02          # one encoder position


@dataclasses.dataclass
class WordTiming:
    word: str
    start: float
    end: float
    tokens: list[int]


def _fp32(tree):
    """A params subtree with every floating leaf in fp32 (int8 weights
    stay int8: `linear` dequantizes them in x's dtype)."""
    if isinstance(tree, dict):
        return {k: _fp32(v) for k, v in tree.items()}
    return tree.float() if tree.is_floating_point() else tree


@torch.inference_mode()
def cross_attention_weights(params, cfg: WhisperConfig, tokens: torch.Tensor,
                            enc_out: torch.Tensor) -> torch.Tensor:
    """Teacher-forced decoder pass returning the cross-attention
    probabilities (:54).

    Args:
      tokens: (B, T) int — the full decoded sequence (prompt + text), on
        enc_out's device.
      enc_out: (B, S, d) in the compute dtype.
    Returns:
      (L, B, H, T, S) fp32 probabilities on enc_out's device.

    As in JAX, the embeddings are summed in the compute dtype and the
    residual stream is fp32 from there on; the cross K/V are projected
    from enc_out in the compute dtype (bf16 products rounded to bf16, as
    jnp.dot of two bf16 operands gives) and upcast."""
    dec = params["decoder"]
    dtype = compute_dtype(cfg)
    T = tokens.shape[1]
    D = cfg.head_dim
    probs = []
    with full_fp32():
        h = (tok_embed(dec, tokens, dtype)
             + dec["pos_emb"][:T].to(dtype)).float()
        for i in range(cfg.n_text_layers):
            lp_native = layer_index(dec["layers"], i)
            lp = _fp32(lp_native)
            y = layer_norm(h, lp["attn_ln"]["g"], lp["attn_ln"]["b"],
                           cfg.ln_eps)
            q, k, v = qkv_fused(y, lp["attn"], cfg.n_heads)
            h = h + linear(merge_heads(mha_reference(q, k, v, causal=True)),
                           lp["attn"]["o"])
            y = layer_norm(h, lp["cross_ln"]["g"], lp["cross_ln"]["b"],
                           cfg.ln_eps)
            q = split_heads(linear(y, lp["cross_attn"]["q"]), cfg.n_heads)
            ca = lp_native["cross_attn"]
            xk = split_heads_hm(linear(enc_out, ca["k"]), cfg.n_heads)
            xv = split_heads_hm(linear(enc_out, ca["v"]), cfg.n_heads)
            scores = torch.einsum("bthd,bhsd->bhts", q.float() * D ** -0.5,
                                  xk.float())
            p = torch.softmax(scores, dim=-1)                  # (B, H, T, S)
            a = torch.einsum("bhts,bhsd->bthd", p, xv.float())
            h = h + linear(merge_heads(a), lp["cross_attn"]["o"])
            y = layer_norm(h, lp["mlp_ln"]["g"], lp["mlp_ln"]["b"],
                           cfg.ln_eps)
            h = h + linear(gelu(linear(y, lp["fc1"])), lp["fc2"])
            probs.append(p)
    return torch.stack(probs)                              # (L, B, H, T, S)


def median_filter(x: np.ndarray, width: int = 7) -> np.ndarray:
    """Median filter along the last axis (openai uses width 7)."""
    if width <= 1:
        return x
    pad = width // 2
    xp = np.pad(x, [(0, 0)] * (x.ndim - 1) + [(pad, pad)], mode="edge")
    out = np.empty_like(x)
    for i in range(x.shape[-1]):
        out[..., i] = np.median(xp[..., i:i + width], axis=-1)
    return out


def dtw_path(cost: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Monotonic DTW over cost (N, M): returns (text_indices, time_indices)
    tracing the minimal path from (0,0) to (N-1,M-1), with the standard
    (match, insertion, deletion) step set.

    Cells on anti-diagonal i+j depend only on the two previous diagonals, so
    the DP fills diagonal-by-diagonal with vectorized gathers: O(N+M) numpy
    calls instead of N*M Python iterations (~2k vs ~670k on a full window).
    Tie-breaking (match preferred, then insertion) matches the scalar DP."""
    N, M = cost.shape
    D = np.full((N + 1, M + 1), np.inf)
    D[0, 0] = 0.0
    trace = np.zeros((N + 1, M + 1), dtype=np.int8)
    for d in range(2, N + M + 1):
        i = np.arange(max(1, d - M), min(N, d - 1) + 1)
        j = d - i
        c0 = D[i - 1, j - 1]        # match
        c1 = D[i - 1, j]            # insertion
        c2 = D[i, j - 1]            # deletion
        t = np.where((c0 <= c1) & (c0 <= c2), 0,
                     np.where(c1 <= c2, 1, 2)).astype(np.int8)
        best = np.where(t == 0, c0, np.where(t == 1, c1, c2))
        D[i, j] = best + cost[i - 1, j - 1]
        trace[i, j] = t
    i, j = N, M
    ti, tj = [], []
    while i > 0 and j > 0:
        ti.append(i - 1)
        tj.append(j - 1)
        t = trace[i, j]
        if t == 0:
            i, j = i - 1, j - 1
        elif t == 1:
            i -= 1
        else:
            j -= 1
    return np.asarray(ti[::-1]), np.asarray(tj[::-1])


def _split_words(tokenizer, text_tokens: Sequence[int]) -> list[list[int]]:
    """Group text tokens into words at space boundaries (the byte-level
    token starting with 'Ġ' opens a new word)."""
    words: list[list[int]] = []
    for tid in text_tokens:
        tok = tokenizer.id_to_token(int(tid))
        if tok.startswith("Ġ") or not words:
            words.append([int(tid)])
        else:
            words[-1].append(int(tid))
    return words


def word_timestamps(params, cfg: WhisperConfig, tokenizer,
                    tokens: Sequence[int], enc_out: torch.Tensor,
                    audio_seconds: float = 30.0,
                    alignment_heads: Optional[Sequence[tuple[int, int]]] = None,
                    medfilt_width: int = 7,
                    prompt_len: int = 0) -> list[WordTiming]:
    """Word timings for one decoded sequence (:164).

    Args:
      tokens: the full decoded ids (prompt + text + EOT) for ONE sequence.
      enc_out: (1, S, d) — that sequence's encoder output.
      audio_seconds: actual (pre-padding) audio length; frames beyond it
        are excluded from alignment.
      alignment_heads: explicit (layer, head) pairs; default = all heads of
        the upper half of decoder layers.
      prompt_len: positions before this index are never aligned — necessary
        when the prompt carries <|startofprev|> *text* tokens (previous-
        window conditioning), which would otherwise be mistaken for
        transcript text.
    """
    tokens = [int(t) for t in tokens]
    tok_arr = torch.tensor([tokens], dtype=torch.long, device=enc_out.device)
    w = cross_attention_weights(params, cfg, tok_arr, enc_out).cpu().numpy()
    L, _, H, T, S = w.shape

    if alignment_heads is None:
        alignment_heads = [(l, h) for l in range(L // 2, L) for h in range(H)]
    sel = np.stack([w[l, 0, h] for l, h in alignment_heads])   # (A, T, S)

    n_frames = min(S, max(1, int(round(audio_seconds / FRAME_S))))
    sel = sel[:, :, :n_frames]
    # normalize each head's attention along time, median filter, average
    sel = (sel - sel.mean(-1, keepdims=True)) / (sel.std(-1, keepdims=True)
                                                 + 1e-9)
    sel = median_filter(sel, medfilt_width)
    matrix = sel.mean(axis=0)                                  # (T, n_frames)

    # align only generated text positions (skip the prompt — including any
    # <|startofprev|> conditioning text — and specials)
    is_text = [(i, t) for i, t in enumerate(tokens)
               if i >= prompt_len and t < cfg.eot_token]
    if not is_text:
        return []
    text_pos = [i for i, _ in is_text]
    text_ids = [t for _, t in is_text]
    ti, tj = dtw_path(-matrix[text_pos])

    # first/last aligned frame per token
    tok_start = np.full(len(text_pos), np.inf)
    tok_end = np.zeros(len(text_pos))
    for a, b in zip(ti, tj):
        tok_start[a] = min(tok_start[a], b)
        tok_end[a] = max(tok_end[a], b)

    out: list[WordTiming] = []
    k = 0
    for group in _split_words(tokenizer, text_ids):
        i0, i1 = k, k + len(group) - 1
        out.append(WordTiming(
            word=tokenizer.decode(group),
            start=float(tok_start[i0] * FRAME_S),
            end=float((tok_end[i1] + 1) * FRAME_S),
            tokens=group))
        k += len(group)
    return out


def load_alignment_heads(path: str) -> list[tuple[int, int]]:
    """Official per-model alignment heads from a JSON sidecar (:231): a
    bare list [[layer, head], ...], or an HF generation_config.json with an
    "alignment_heads" key (the convention HF transformers uses to carry
    openai/whisper's published head tables)."""
    import json

    with open(path) as f:
        data = json.load(f)
    if isinstance(data, dict):
        data = data.get("alignment_heads")
        if data is None:
            raise ValueError(f"{path}: no 'alignment_heads' key")
    return [(int(l), int(h)) for l, h in data]


def find_alignment_heads(weights_path: str) -> Optional[list[tuple[int, int]]]:
    """Auto-detect an alignment-heads sidecar next to a checkpoint file
    (:253): <dir>/alignment_heads.json, then <dir>/generation_config.json."""
    import os

    d = os.path.dirname(os.path.abspath(weights_path))
    for name in ("alignment_heads.json", "generation_config.json"):
        p = os.path.join(d, name)
        if os.path.exists(p):
            try:
                return load_alignment_heads(p)
            except (ValueError, KeyError):
                continue
    return None
