"""Flash attention (whisper_tpu/ops/flash_attention.py:112 flash_attention).

`flash_attention` launches the hand-written CUDA kernel
(csrc/flash_attention.cu, which carries the design note) for CUDA tensors
and runs `flash_attention_plain` for CPU tensors. The plain version is the
CPU path and the kernel's oracle on the card: the JAX kernel's math
(_flash_kernel :40-94) with its rounding points, as a two-pass softmax.

Layouts and masking are the JAX kernel's: q (B, T, H, D) token-major,
k and v (B, H, S, D) head-major; key s is visible to query t iff
s < kv_len and, when causal, s <= q_offset + t. Keys at or past kv_len,
and keys past the causal diagonal of the last query, are never read.

Under autograd (the train step) the kernel's output carries the plain
version's gradient (ops/grad.py): the backward recomputes
`flash_attention_plain`, which is written without in-place ops for that.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from whisper_tpu_torch.ops import _build
from whisper_tpu_torch.ops.grad import kernel_with_plain_backward, tracks_grad

_DTYPES = (torch.float32, torch.bfloat16)
HEAD_DIM = 64                                       # every Whisper size
_MASK_VALUE = -0.7 * torch.finfo(torch.float32).max   # :37, not -inf


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          kv_len: Optional[int] = None, q_offset: int = 0, *,
                          causal: bool = False) -> torch.Tensor:
    """The kernel's math in torch ops: scores of the fp32 q * D**-0.5
    (:51), masked scores at -0.7 * FLT_MAX, p rounded to q's dtype before
    the p.v product while the denominator sums the fp32 p (:79-84), and
    acc / max(l, 1e-30), so a row that sees no key returns zeros (:93).
    Shapes as `flash_attention`."""
    B, T, H, D = q.shape
    S = k.shape[2]
    # one past the last key any query sees: the kernel reads none past it
    end = S if kv_len is None else min(int(kv_len), S)
    if causal:
        end = min(end, q_offset + T)
    if end <= 0:
        return torch.zeros_like(q)
    # k and v take q's dtype (:153-154); keys past `end` are never read
    k = k[:, :, :end].to(q.dtype)
    v = v[:, :, :end].to(q.dtype)
    s = torch.einsum("bthd,bhsd->bhts", q.float() * (D ** -0.5), k.float())
    if causal:
        q_pos = q_offset + torch.arange(T, device=q.device)[:, None]
        s = s.masked_fill(torch.arange(end, device=q.device)[None, :] > q_pos,
                          _MASK_VALUE)
    # out of place, for autograd; rebinding `s` frees each step's input
    s = s - s.amax(dim=-1, keepdim=True)
    p = s.exp()                                            # (B, H, T, S)
    del s
    denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)   # (B, H, T, 1)
    pv = torch.einsum("bhts,bhsd->bthd", p.to(q.dtype).float(), v.float())
    return (pv / denom.permute(0, 2, 1, 3)).to(q.dtype)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv_len: int,
           q_offset: int) -> None:
    """Raise on anything the CUDA kernel does not take."""
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention: no kernel for {q.dtype}")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype:
            raise TypeError(f"flash_attention: {name} is {t.dtype}, q is "
                            f"{q.dtype}")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} must be 4-D")
    B, T, H, D = q.shape
    S = k.shape[2]
    for name, t in (("k", k), ("v", v)):
        if tuple(t.shape) != (B, H, S, D):
            raise ValueError(f"flash_attention: {name} has shape "
                             f"{tuple(t.shape)}, expected {(B, H, S, D)}")
    if D != HEAD_DIM:
        raise ValueError(f"flash_attention: the kernel takes head_dim "
                         f"{HEAD_DIM}, got {D}")
    if min(B, T, H) < 1 or max(B, H) > 65535:
        raise ValueError(f"flash_attention: no launch for B={B}, T={T}, "
                         f"H={H}")
    if not 0 <= kv_len <= S:
        raise ValueError(f"flash_attention: kv_len {kv_len} outside "
                         f"[0, {S}]")
    if not 0 <= q_offset < 2 ** 30:
        raise ValueError(f"flash_attention: q_offset {q_offset} outside "
                         f"[0, 2**30)")
    tensors = (("q", q), ("k", k), ("v", v))
    for name, t in tensors:
        if t.stride(-1) != 1:
            raise ValueError(f"flash_attention: {name}'s head dim is not "
                             f"contiguous (stride {t.stride(-1)})")
        # both kernels move 16 bytes at a time (cp.async): 8 bf16 or 4 fp32
        vec = 16 // t.element_size()
        if any(s % vec for s in t.stride()[:3]):
            raise ValueError(f"flash_attention: {name}'s strides "
                             f"{t.stride()} are not multiples of {vec} "
                             f"elements")
    for name, t in tensors:
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"flash_attention: {name} is on {t.device}; "
                             f"the kernel takes tensors on one CUDA device")
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} does not start on a "
                             f"16-byte boundary")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kv_len: Optional[int] = None, q_offset: int = 0, *,
                    causal: bool = False) -> torch.Tensor:
    """softmax(q k^T / sqrt(D)) v with an online softmax; the score matrix
    never exists.

    Args:
      q: (B, T, H, D); k, v: (B, H, S, D) head-major, cast to q's dtype.
        Any strides with D contiguous: the kernel reads views in place.
        The strides are multiples of 16 bytes' worth of elements (bf16: 8,
        fp32: 4) and each tensor starts on a 16-byte boundary (every view
        the port hands over).
      kv_len: number of valid keys (default S); keys past it are never
        read.
      q_offset: absolute position of q[:, 0] for the causal mask.
      causal: mask keys past q_offset + query index.
    Returns:
      (B, T, H, D) in q's dtype, contiguous. CPU tensors take the plain
      version; CUDA tensors launch the kernel (fp32 or bf16, head_dim 64)
      or raise. Under autograd the kernel's output carries the plain
      version's gradient.
    """
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, kv_len, q_offset,
                                     causal=causal)
    S = k.shape[2]
    kv_len = S if kv_len is None else int(kv_len)
    q_offset = int(q_offset)
    k, v = k.to(q.dtype), v.to(q.dtype)
    _check(q, k, v, kv_len, q_offset)
    launch = functools.partial(_launch, kv_len=kv_len, q_offset=q_offset,
                               causal=causal)
    if tracks_grad(q, k, v):
        return kernel_with_plain_backward(
            launch, functools.partial(flash_attention_plain, kv_len=kv_len,
                                      q_offset=q_offset, causal=causal),
            q, k, v)
    return launch(q, k, v)


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
            kv_len: int, q_offset: int, causal: bool) -> torch.Tensor:
    """One kernel launch on checked tensors, counted on
    `flash_attention.launches`."""
    B, T, H, D = q.shape
    S = k.shape[2]
    lib = _build.load_library()
    out = torch.empty((B, T, H, D), dtype=q.dtype, device=q.device)
    err = lib.wt_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, T, S, H, D, kv_len, q_offset, int(causal),
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, err, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0     # kernel launches (CPU calls not counted)
