"""Multi-head attention: the backend switch, its int8-cache form and the
plain attention (whisper_tpu/ops/attention.py:42-161 default_backend,
multi_head_attention, multi_head_attention_quant; :164 mha_reference).

The backend is the JAX package's switch, with its precedence: an explicit
`backend=` (the models pass cfg.attn_backend) first, then the
WHISPER_TPU_ATTN environment variable, then "auto" (`default_backend`):
  * "reference": every call is the plain attention (`mha_reference`);
  * "pallas": a T > 1 call goes to the flash kernel
    (ops/flash_attention.py), a T==1 call to decode_attention_bh
    (ops/decode_attention.py);
  * "pallas_interpret": routes exactly like "pallas". The port has no
    interpret mode: a kernel's CPU counterpart is its plain version, and
    the tensors' device decides which runs;
  * "auto" (the default on every device, so that the card keeps its
    kernels): the JAX size gate. A T > 1 call whose fp32 score matrix would
    take at least 16 MiB goes to flash, a T==1 read of 4096 cache slots or
    more to decode_attention_bh, anything smaller to `mha_reference`. Every
    encoder-sized call is above the flash gate; the decoder's 4-token
    prefills are below it, and every T==1 read of a Whisper path (448 self
    slots at most, 1500 cross positions) is below the decode gate.
Any other name raises ValueError. A call with a per-row (B,) kv_len or
q_offset is ragged and always goes to `mha_reference`, whatever the
backend, as in JAX (:99-102): the kernels take one length for the batch.

`multi_head_attention_quant` reads an int8 cache (values plus per-vector
fp32 scales): a T==1, non-ragged read goes to decode_attention_q8_bh under
"pallas" and "auto" from 4096 slots up, and at every size under
"pallas_interpret", never under "reference" (JAX :138-157); every other
read dequantizes to q's dtype and goes through multi_head_attention with
the same backend.

Layouts: q (B, T, H, D) token-major; k, v (B, H, S, D) head-major.
Masking is (kv_len, causal, q_offset): key j is visible to query i of row
b iff j < kv_len[b] and, when causal, j <= q_offset[b] + i, with a scalar
standing for every row.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from whisper_tpu_torch.ops.decode_attention import (
    decode_attention_bh,
    decode_attention_q8_bh,
)
from whisper_tpu_torch.ops.flash_attention import flash_attention

_NEG_INF = torch.finfo(torch.float32).min
_BACKENDS = ("auto", "reference", "pallas", "pallas_interpret")

# The JAX package's auto gates (ops/attention.py:69-70), measured on a TPU
# v5e. They stay until the port's own benchmark measures the crossovers on
# the H100.
_DECODE_KERNEL_MIN_S = 4096            # T==1: decode_attention_bh from here
_FLASH_MIN_SCORE_BYTES = 16 << 20      # T>1: B*H*T*S*4 (fp32 scores)


def default_backend() -> str:
    """WHISPER_TPU_ATTN when set, else "auto" on every device (JAX :42-49
    answers "reference" off the TPU; the port's kernels run on the card)."""
    return os.environ.get("WHISPER_TPU_ATTN") or "auto"


def _backend(backend: Optional[str]) -> str:
    """The backend a call runs under (`backend`, else `default_backend`);
    ValueError on an unknown name."""
    backend = backend or default_backend()
    if backend not in _BACKENDS:
        raise ValueError(f"unknown attention backend {backend!r}")
    return backend


def _ragged(kv_len, q_offset) -> bool:
    """A per-row (B,) kv_len or q_offset (JAX :99-100)."""
    return any(torch.is_tensor(x) and x.ndim >= 1 for x in (kv_len, q_offset))


def _route(q: torch.Tensor, k: torch.Tensor,
           backend: Optional[str] = None) -> str:
    """'flash', 'decode' or 'reference' for a non-ragged call: the switch
    above, with JAX's 'pallas' split by T (:110-122) and its auto gate
    (`_auto_backend`, :73-79)."""
    backend = _backend(backend)
    B, T, H, _ = q.shape
    S = k.shape[2]
    if backend == "reference":
        return "reference"
    if backend == "auto":
        if T == 1:
            return "decode" if S >= _DECODE_KERNEL_MIN_S else "reference"
        return ("flash" if B * H * T * S * 4 >= _FLASH_MIN_SCORE_BYTES
                else "reference")
    return "decode" if T == 1 else "flash"


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         kv_len=None, *, causal: bool = False, q_offset=0,
                         backend: Optional[str] = None) -> torch.Tensor:
    """Scaled dot-product attention through the backend switch. At T==1
    the causal mask is the length mask (kv_len == q_offset + 1), so the
    decode kernel takes kv_len alone (JAX :112-119); it reads q
    contiguous, and a self-attention q is a strided view of the fused QKV
    projection, so the route copies it (B*H*D values). Returns
    (B, T, H, D) in q's dtype."""
    route = _route(q, k, backend)
    if _ragged(kv_len, q_offset) or route == "reference":
        return mha_reference(q, k, v, kv_len, causal=causal, q_offset=q_offset)
    if route == "flash":
        return flash_attention(q, k, v, kv_len, q_offset, causal=causal)
    return decode_attention_bh(q.contiguous(), k, v, kv_len)


def _q8_kernel_route(T: int, S: int, ragged: bool,
                     backend: Optional[str] = None) -> bool:
    """Whether multi_head_attention_quant reads an int8 cache of S slots
    with T queries through decode_attention_q8_bh (JAX :141-157): T==1,
    not ragged, and "pallas_interpret", or "auto"/"pallas" from 4096 slots
    up."""
    backend = _backend(backend)
    return (T == 1 and not ragged
            and (backend == "pallas_interpret"
                 or (backend in ("auto", "pallas")
                     and S >= _DECODE_KERNEL_MIN_S)))


def multi_head_attention_quant(q: torch.Tensor, k: torch.Tensor,
                               k_scale: torch.Tensor, v: torch.Tensor,
                               v_scale: torch.Tensor, kv_len=None, *,
                               causal: bool = False, q_offset=0,
                               backend: Optional[str] = None) -> torch.Tensor:
    """Attention over an int8 cache: k, v (B, H, S, D) int8 with k_scale,
    v_scale (B, H, S, 1) fp32. Returns (B, T, H, D) in q's dtype. The q8
    kernel takes kv_len alone (the T==1 length mask); a ragged read stays
    off it and is dequantized, as in JAX (:141-157)."""
    backend = _backend(backend)
    if _q8_kernel_route(q.shape[1], k.shape[2], _ragged(kv_len, q_offset),
                        backend):     # q contiguous, as in multi_head_attention
        return decode_attention_q8_bh(q.contiguous(), k, k_scale, v, v_scale,
                                      kv_len)
    kd = (k.float() * k_scale).to(q.dtype)
    vd = (v.float() * v_scale).to(q.dtype)
    return multi_head_attention(q, kd, vd, kv_len, causal=causal,
                                q_offset=q_offset, backend=backend)


def _per_row(x, device) -> torch.Tensor:
    """A scalar -> (1, 1, 1); a per-row (B,) length -> (B, 1, 1): the JAX
    per_batch broadcast over (T, S) (:180-183)."""
    t = torch.as_tensor(x, device=device)
    return t.reshape(-1, 1, 1) if t.ndim >= 1 else t.reshape(1, 1, 1)


def mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  kv_len=None, *, causal: bool = False,
                  q_offset=0) -> torch.Tensor:
    """Scaled dot-product attention in fp32, returned in q's dtype. kv_len
    and q_offset may each be a scalar or a per-row (B,) tensor (JAX
    :180-194). The scale head_dim**-0.5 multiplies q before the score
    product (:176)."""
    B, T, H, D = q.shape
    S = k.shape[2]
    qf = q.float() * (D ** -0.5)
    scores = torch.einsum("bthd,bhsd->bhts", qf, k.float())
    key_idx = torch.arange(S, device=q.device)[None, None, :]    # (1, 1, S)
    mask = None
    if kv_len is not None:
        mask = key_idx < _per_row(kv_len, q.device)               # (B?, 1, S)
    if causal:
        q_idx = (_per_row(q_offset, q.device)
                 + torch.arange(T, device=q.device)[None, :, None])
        c = key_idx <= q_idx                                      # (B?, T, S)
        mask = c if mask is None else mask & c
    if mask is not None:
        scores = scores.masked_fill(~mask[:, None], _NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhts,bhsd->bthd", probs, v.float())
    return out.to(q.dtype)
