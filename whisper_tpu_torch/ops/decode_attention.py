"""Single-token attention over an int8 K/V cache with per-vector fp32
scales (whisper_tpu/ops/decode_attention.py:464 decode_attention_q8_bh,
:525 decode_attention_q8).

The two JAX functions share one contract and differ only in their Pallas
grid (all heads per program, or one (batch, head) per program), so one
hand-written CUDA kernel (csrc/decode_attention.cu, which carries the
design note) serves both wrappers here, each with its own launch count.
For each (b, h):
    s_j = (q * D^-0.5) . (k8_j * ks_j)        for j < kv_len
    out = sum_j softmax(s)_j (v8_j * vs_j)    cast to q's dtype
and kv_len == 0 gives zeros, as the Pallas kernel's max(l, 1e-30) does.

CPU tensors take `decode_attention_q8_plain`; CUDA tensors launch the
kernel or raise (D != 64, K/V not int8, q not fp32 or bf16, anything not
contiguous). The main path reaches the kernel in fp32 token-parity mode
with an int8 cross cache (models/whisper.py decoder_step_ip), and through
multi_head_attention_quant for a T==1 read of >= 4096 slots.
"""

from __future__ import annotations

from typing import Optional

import torch

from whisper_tpu_torch.ops import _build

_Q_DTYPES = (torch.float32, torch.bfloat16)


def decode_attention_q8_plain(q: torch.Tensor, k: torch.Tensor,
                              k_scale: torch.Tensor, v: torch.Tensor,
                              v_scale: torch.Tensor,
                              kv_len: Optional[int] = None) -> torch.Tensor:
    """Dequantize, then fp32 masked softmax attention. A row with no valid
    key (kv_len == 0) is zeros, not the NaN of an all-masked softmax.
    Shapes as `decode_attention_q8_bh`."""
    D, S = q.shape[-1], k.shape[2]
    kv_len = S if kv_len is None else int(kv_len)
    kd = k.float() * k_scale
    vd = v.float() * v_scale
    s = torch.einsum("bthd,bhsd->bhts", q.float() * (D ** -0.5), kd)
    valid = torch.arange(S, device=q.device) < kv_len
    s = s.masked_fill(~valid, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - torch.where(torch.isfinite(m), m, 0.0))   # masked: 0
    p = p / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return torch.einsum("bhts,bhsd->bthd", p, vd).to(q.dtype)


def _check(q, k, k_scale, v, v_scale, kv_len: int) -> None:
    B, T, H, D = q.shape
    if T != 1:
        raise ValueError(f"decode attention takes one query token, got T={T}")
    S = k.shape[2]
    for name, t, shape in (("k", k, (B, H, S, D)), ("v", v, (B, H, S, D)),
                           ("k_scale", k_scale, (B, H, S, 1)),
                           ("v_scale", v_scale, (B, H, S, 1))):
        if tuple(t.shape) != shape:
            raise ValueError(f"decode_attention_q8: {name} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
        if t.device != q.device:
            raise ValueError(f"decode_attention_q8: {name} is on {t.device}, "
                             f"q on {q.device}")
    if not 0 <= kv_len <= S:
        raise ValueError(f"decode_attention_q8: kv_len {kv_len} outside "
                         f"[0, {S}]")


def _launch(q, k, k_scale, v, v_scale, kv_len: int, what: str
            ) -> torch.Tensor:
    """Raise on anything the kernel does not take, then launch it."""
    if q.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {q.device}")
    if q.dtype not in _Q_DTYPES:
        raise TypeError(f"{what}: no kernel for a {q.dtype} query")
    if k.dtype != torch.int8 or v.dtype != torch.int8:
        raise TypeError(f"{what}: the kernel takes int8 K/V, got {k.dtype} "
                        f"and {v.dtype}")
    if k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32:
        raise TypeError(f"{what}: the kernel takes fp32 scales")
    B, _, H, D = q.shape
    if D != 64:
        raise ValueError(f"{what}: the kernel takes head_dim 64, got {D}")
    for name, t in (("q", q), ("k", k), ("k_scale", k_scale), ("v", v),
                    ("v_scale", v_scale)):
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} is not contiguous")
    for name, t in (("k", k), ("v", v)):        # read in 16-byte vectors
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} is not 16-byte aligned")
    out = torch.empty_like(q)
    lib = _build.load_library()
    err = lib.wt_decode_attention_q8(
        q.data_ptr(), k.data_ptr(), k_scale.data_ptr(), v.data_ptr(),
        v_scale.data_ptr(), out.data_ptr(), B, H, k.shape[2], D, kv_len,
        int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, err, what)
    return out


def _run(fn, q, k, k_scale, v, v_scale, kv_len) -> torch.Tensor:
    """Check, then take the plain version (CPU) or launch the kernel and add
    one to `fn.launches` (CUDA)."""
    kv_len = k.shape[2] if kv_len is None else int(kv_len)
    _check(q, k, k_scale, v, v_scale, kv_len)
    if q.device.type == "cpu":
        return decode_attention_q8_plain(q, k, k_scale, v, v_scale, kv_len)
    out = _launch(q, k, k_scale, v, v_scale, kv_len, fn.__name__)
    fn.launches += 1
    return out


def decode_attention_q8_bh(q: torch.Tensor, k: torch.Tensor,
                           k_scale: torch.Tensor, v: torch.Tensor,
                           v_scale: torch.Tensor,
                           kv_len: Optional[int] = None) -> torch.Tensor:
    """Single-token attention over an int8 cache (:464).

    Args:
      q: (B, 1, H, D) fp32 or bf16.
      k, v: (B, H, S, D) int8; k_scale, v_scale: (B, H, S, 1) fp32.
      kv_len: keys [0, kv_len) are valid (None: all S).
    Returns:
      (B, 1, H, D) in q's dtype. CPU tensors take the plain version; CUDA
      tensors launch the kernel or raise.
    """
    return _run(decode_attention_q8_bh, q, k, k_scale, v, v_scale, kv_len)


def decode_attention_q8(q: torch.Tensor, k: torch.Tensor,
                        k_scale: torch.Tensor, v: torch.Tensor,
                        v_scale: torch.Tensor,
                        kv_len: Optional[int] = None) -> torch.Tensor:
    """The per-(batch, head) form (:525): the same contract and, on CUDA,
    the same kernel as `decode_attention_q8_bh`, counted apart."""
    return _run(decode_attention_q8, q, k, k_scale, v, v_scale, kv_len)


decode_attention_q8_bh.launches = 0   # kernel launches (CPU calls not counted)
decode_attention_q8.launches = 0
