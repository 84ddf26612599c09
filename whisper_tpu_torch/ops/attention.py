"""Multi-head attention: the size dispatch, its int8-cache form and the
plain attention (whisper_tpu/ops/attention.py:73-122 multi_head_attention,
:125 multi_head_attention_quant, :164 mha_reference).

`multi_head_attention` is the JAX package's auto policy for T > 1: a call
whose fp32 score matrix would take at least 16 MiB goes to the flash
kernel (ops/flash_attention.py), anything smaller to `mha_reference`. Every
encoder-sized call is above the gate (one clip at 2 heads already carries
18 MB of scores); the decoder's 4-token prefills are below it (cross
prefill at turbo b32: 15.36 MB; self prefill over 128 slots: 1.3 MB).

A T==1 call over a cache of 4096 slots or more belongs to the JAX
package's decode_attention_bh (:76-77, :112-119), which the port has not
ported: on CUDA it raises rather than run the plain version quietly. No
Whisper path reaches it (the self cache holds at most 448 slots, cross
attention covers 1500 positions, and the decode step computes both reads
itself).

`multi_head_attention_quant` reads an int8 cache (values plus per-vector
fp32 scales): a T==1 read of 4096 slots or more goes to
decode_attention_q8_bh (the hand-written kernel on CUDA, its plain
version on the CPU), as the JAX gate sends it to its Pallas kernel; every
other read dequantizes to q's dtype and goes through multi_head_attention.

Layouts: q (B, T, H, D) token-major; k, v (B, H, S, D) head-major.
Masking is (kv_len, causal, q_offset): key j is visible to query i iff
j < kv_len and, when causal, j <= q_offset + i.
"""

from __future__ import annotations

from typing import Optional

import torch

from whisper_tpu_torch.ops.decode_attention import decode_attention_q8_bh
from whisper_tpu_torch.ops.flash_attention import flash_attention

_NEG_INF = torch.finfo(torch.float32).min

# The JAX package's gates (ops/attention.py:69-70), measured on a TPU v5e.
# They stay until the port's own benchmark measures the crossover on the
# H100.
_DECODE_KERNEL_MIN_S = 4096            # T==1: decode_attention_bh from here
_FLASH_MIN_SCORE_BYTES = 16 << 20      # T>1: B*H*T*S*4 (fp32 scores)


def _route(q: torch.Tensor, k: torch.Tensor) -> str:
    """'flash', 'decode' or 'reference': the JAX _auto_backend (:73-79),
    with its 'pallas' split by T."""
    B, T, H, _ = q.shape
    S = k.shape[2]
    if T == 1:
        return "decode" if S >= _DECODE_KERNEL_MIN_S else "reference"
    return ("flash" if B * H * T * S * 4 >= _FLASH_MIN_SCORE_BYTES
            else "reference")


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         kv_len: Optional[int] = None, *, causal: bool = False,
                         q_offset: int = 0) -> torch.Tensor:
    """Scaled dot-product attention, dispatched by size (`_route`).
    Returns (B, T, H, D) in q's dtype."""
    route = _route(q, k)
    if route == "flash":
        return flash_attention(q, k, v, kv_len, q_offset, causal=causal)
    if route == "decode" and q.device.type != "cpu":
        raise NotImplementedError(
            f"multi_head_attention: a T==1 read of a {k.shape[2]}-slot cache "
            f"takes the decode_attention_bh kernel "
            f"(whisper_tpu/ops/decode_attention.py:297), which the port has "
            f"not ported")
    return mha_reference(q, k, v, kv_len, causal=causal, q_offset=q_offset)


def multi_head_attention_quant(q: torch.Tensor, k: torch.Tensor,
                               k_scale: torch.Tensor, v: torch.Tensor,
                               v_scale: torch.Tensor,
                               kv_len: Optional[int] = None, *,
                               causal: bool = False,
                               q_offset: int = 0) -> torch.Tensor:
    """Attention over an int8 cache: k, v (B, H, S, D) int8 with k_scale,
    v_scale (B, H, S, 1) fp32. Returns (B, T, H, D) in q's dtype. At
    T == 1 the causal mask is the length mask, so the kernel route takes
    kv_len alone; a per-row kv_len or q_offset stays off it, as in JAX
    (:141-157)."""
    ragged = ((torch.is_tensor(kv_len) and kv_len.ndim >= 1)
              or (torch.is_tensor(q_offset) and q_offset.ndim >= 1))
    if q.shape[1] == 1 and not ragged and k.shape[2] >= _DECODE_KERNEL_MIN_S:
        return decode_attention_q8_bh(q, k, k_scale, v, v_scale, kv_len)
    kd = (k.float() * k_scale).to(q.dtype)
    vd = (v.float() * v_scale).to(q.dtype)
    return multi_head_attention(q, kd, vd, kv_len, causal=causal,
                                q_offset=q_offset)


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
