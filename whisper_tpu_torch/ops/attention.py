"""Plain multi-head attention (whisper_tpu/ops/attention.py:164
mha_reference).

The port's main path uses it for the decoder's prompt prefill, as the JAX
package does under its auto policy: the 4-token prefill's score matrix is
far below the flash-attention size gate (ops/attention.py:69-79), so XLA
runs the einsum form there.

Layouts: q (B, T, H, D) token-major; k, v (B, H, S, D) head-major.
Masking is (kv_len, causal, q_offset): key j is visible to query i iff
j < kv_len and, when causal, j <= q_offset + i.
"""

from __future__ import annotations

from typing import Optional

import torch

_NEG_INF = torch.finfo(torch.float32).min


def mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  kv_len: Optional[int] = None, *, causal: bool = False,
                  q_offset: int = 0) -> torch.Tensor:
    """Scaled dot-product attention in fp32, returned in q's dtype. The
    scale head_dim**-0.5 multiplies q before the score product
    (whisper_tpu/ops/attention.py:176)."""
    B, T, H, D = q.shape
    S = k.shape[2]
    qf = q.float() * (D ** -0.5)
    scores = torch.einsum("bthd,bhsd->bhts", qf, k.float())
    key_idx = torch.arange(S, device=q.device)[None, :]          # (1, S)
    mask = None
    if kv_len is not None:
        mask = key_idx < kv_len
    if causal:
        q_idx = q_offset + torch.arange(T, device=q.device)[:, None]
        c = key_idx <= q_idx                                     # (T, S)
        mask = c if mask is None else mask & c
    if mask is not None:
        scores = scores.masked_fill(~mask, _NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhts,bhsd->bthd", probs, v.float())
    return out.to(q.dtype)
