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

Under autograd on the card (the train step, fp32) the forward kernel
also writes each row's log-sum-exp and the backward is
`flash_attention_backward` (csrc/flash_attention_bwd.cu, FlashAttention-2's
backward on the forward's numerics; ops/grad.py), whose plain twin is
`flash_attention_backward_plain`. On the CPU autograd differentiates
`flash_attention_plain`, which is written without in-place ops for that.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from whisper_tpu_torch.ops import _build
from whisper_tpu_torch.ops.grad import (
    kernel_with_backward,
    refuse_bf16_grad,
    tracks_grad,
)

_DTYPES = (torch.float32, torch.bfloat16)
HEAD_DIM = 64                                       # every Whisper size
_MASK_VALUE = -0.7 * torch.finfo(torch.float32).max   # :37, not -inf


def _key_end(T: int, S: int, kv_len: Optional[int], q_offset: int,
             causal: bool) -> int:
    """One past the last key any query sees: the kernels read none past
    it."""
    end = S if kv_len is None else min(int(kv_len), S)
    return min(end, q_offset + T) if causal else end


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          kv_len: Optional[int] = None, q_offset: int = 0, *,
                          causal: bool = False, return_lse: bool = False):
    """The kernel's math in torch ops: scores of the fp32 q * D**-0.5
    (:51), masked scores at -0.7 * FLT_MAX, p rounded to q's dtype before
    the p.v product while the denominator sums the fp32 p (:79-84), and
    acc / max(l, 1e-30), so a row that sees no key returns zeros (:93).
    Shapes as `flash_attention`. With `return_lse`, also each row's fp32
    log-sum-exp of the scaled scores, (B, H, T) (-inf for a row that sees
    no key), as the fp32 kernel writes it under autograd."""
    B, T, H, D = q.shape
    S = k.shape[2]
    end = _key_end(T, S, kv_len, q_offset, causal)
    if end <= 0:
        out = torch.zeros_like(q)
        return (out, torch.full((B, H, T), -torch.inf, device=q.device)
                ) if return_lse else out
    # k and v take q's dtype (:153-154); keys past `end` are never read
    k = k[:, :, :end].to(q.dtype)
    v = v[:, :, :end].to(q.dtype)
    s = torch.einsum("bthd,bhsd->bhts", q.float() * (D ** -0.5), k.float())
    if causal:
        q_pos = q_offset + torch.arange(T, device=q.device)[:, None]
        s = s.masked_fill(torch.arange(end, device=q.device)[None, :] > q_pos,
                          _MASK_VALUE)
    # out of place, for autograd; rebinding `s` frees each step's input
    m = s.amax(dim=-1, keepdim=True)
    s = s - m
    p = s.exp()                                            # (B, H, T, S)
    del s
    total = p.sum(dim=-1, keepdim=True)
    denom = total.clamp_min(1e-30)                         # (B, H, T, 1)
    pv = torch.einsum("bhts,bhsd->bthd", p.to(q.dtype).float(), v.float())
    out = (pv / denom.permute(0, 2, 1, 3)).to(q.dtype)
    return (out, (m + total.log())[..., 0]) if return_lse else out


def flash_attention_backward_plain(q: torch.Tensor, k: torch.Tensor,
                                   v: torch.Tensor, out: torch.Tensor,
                                   lse: torch.Tensor, d_out: torch.Tensor,
                                   kv_len: Optional[int] = None,
                                   q_offset: int = 0, *, causal: bool = False
                                   ) -> tuple:
    """The backward kernel's math in torch ops, fp32 (FlashAttention-2's
    backward): with s = q * D**-0.5 . k over the visible keys,
        p  = exp(s - lse)                 lse: the forward's (B, H, T)
        dv = p^T dO;  dp = dO v^T;  delta = sum_d dO * out
        ds = p * (dp - delta);  dq = ds k D**-0.5;  dk = ds^T q D**-0.5
    Keys at or past the last visible one get zero gradients, and so does
    every input when no key is visible. Shapes as `flash_attention`, plus
    out and d_out (B, T, H, D) and lse (B, H, T). Returns (dq, dk, dv) in
    the inputs' dtypes."""
    B, T, H, D = q.shape
    S = k.shape[2]
    end = _key_end(T, S, kv_len, q_offset, causal)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    if end <= 0:
        return torch.zeros_like(q), dk.to(k.dtype), dv.to(v.dtype)
    scale = D ** -0.5
    qf, g = q.float(), d_out.float()
    kf, vf = k[:, :, :end].float(), v[:, :, :end].float()
    s = torch.einsum("bthd,bhsd->bhts", qf * scale, kf)
    if causal:
        q_pos = q_offset + torch.arange(T, device=q.device)[:, None]
        s = s.masked_fill(torch.arange(end, device=q.device)[None, :] > q_pos,
                          -torch.inf)
    p = torch.exp(s - lse.float()[..., None])              # (B, H, T, end)
    del s
    dv[:, :, :end] = torch.einsum("bhts,bthd->bhsd", p, g)
    dp = torch.einsum("bthd,bhsd->bhts", g, vf)
    delta = (g * out.float()).sum(dim=-1).permute(0, 2, 1)   # (B, H, T)
    ds = p * (dp - delta[..., None])
    del p, dp
    dq = torch.einsum("bhts,bhsd->bthd", ds, kf) * scale
    dk[:, :, :end] = torch.einsum("bhts,bthd->bhsd", ds, qf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


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
      or raise. Under autograd on the card (fp32 only; bf16 raises) the
      backward is `flash_attention_backward`.
    """
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, kv_len, q_offset,
                                     causal=causal)
    S = k.shape[2]
    kv_len = S if kv_len is None else int(kv_len)
    q_offset = int(q_offset)
    k, v = k.to(q.dtype), v.to(q.dtype)
    _check(q, k, v, kv_len, q_offset)
    kw = dict(kv_len=kv_len, q_offset=q_offset, causal=causal)
    if tracks_grad(q, k, v):
        refuse_bf16_grad("flash_attention", q.dtype)
        return kernel_with_backward(functools.partial(_forward_for_grad, **kw),
                                    functools.partial(_backward, **kw),
                                    q, k, v)
    return _launch(q, k, v, **kw)


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
            kv_len: int, q_offset: int, causal: bool,
            lse: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One kernel launch on checked tensors, counted on
    `flash_attention.launches`; with `lse` (fp32, (B, H, T) contiguous),
    the kernel writes each row's log-sum-exp there too."""
    B, T, H, D = q.shape
    S = k.shape[2]
    lib = _build.load_library()
    out = torch.empty((B, T, H, D), dtype=q.dtype, device=q.device)
    err = lib.wt_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(),
        B, T, S, H, D, kv_len, q_offset, int(causal),
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, err, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0     # kernel launches (CPU calls not counted)


def _forward_for_grad(q, k, v, **kw):
    """The forward under autograd: (out, (out, lse)), the residuals the
    backward reads."""
    B, T, H, _ = q.shape
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    out = _launch(q, k, v, lse=lse, **kw)
    return out, (out, lse)


def _backward(grad_out, tensors, residuals, **kw):
    return flash_attention_backward(*tensors, *residuals, grad_out, **kw)


def _check_backward(q, k, v, out, lse, d_out) -> None:
    """Raise on anything the backward kernel does not take, besides what
    `_check` refuses for the forward."""
    B, T, H, D = q.shape
    # `_check` holds k and v to q's dtype
    for name, t in (("q", q), ("out", out), ("lse", lse),
                    ("d_out", d_out)):
        if t.dtype != torch.float32:
            raise TypeError(f"flash_attention_backward: {name} is {t.dtype};"
                            f" the backward kernel is fp32 only")
    for name, t, shape in (("out", out, (B, T, H, D)),
                           ("lse", lse, (B, H, T)),
                           ("d_out", d_out, (B, T, H, D))):
        if tuple(t.shape) != shape:
            raise ValueError(f"flash_attention_backward: {name} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
        if t.device != q.device:
            raise ValueError(f"flash_attention_backward: {name} is on "
                             f"{t.device}, q on {q.device}")
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention_backward: {name} does not "
                             f"start on a 16-byte boundary")


def flash_attention_backward(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, out: torch.Tensor,
                             lse: torch.Tensor, d_out: torch.Tensor,
                             kv_len: Optional[int] = None, q_offset: int = 0,
                             *, causal: bool = False) -> tuple:
    """The gradients (dq, dk, dv) of `flash_attention` at (q, k, v), given
    its output `out`, the rows' log-sum-exp `lse` (B, H, T) that the
    forward kernel wrote, and the output's gradient `d_out` (B, T, H, D),
    under the forward's kv_len, q_offset and causal.

    Returns dq (B, T, H, D) and dk, dv (B, H, S, D), contiguous, zero for
    keys at or past the last visible one. CPU tensors take
    `flash_attention_backward_plain`; CUDA tensors launch the kernel
    (fp32, head_dim 64; q, k, v as the forward takes them; out, lse and
    d_out are made contiguous) or raise."""
    if q.device.type == "cpu":
        return flash_attention_backward_plain(q, k, v, out, lse, d_out,
                                              kv_len, q_offset, causal=causal)
    S = k.shape[2]
    kv_len = S if kv_len is None else int(kv_len)
    q_offset = int(q_offset)
    out, lse, d_out = (t.contiguous() for t in (out, lse, d_out))
    _check(q, k, v, kv_len, q_offset)
    _check_backward(q, k, v, out, lse, d_out)
    grads = launch_backward(q, k, v, out, lse, d_out, kv_len=kv_len,
                            q_offset=q_offset, causal=causal)
    flash_attention_backward.launches += 1
    return grads


flash_attention_backward.launches = 0   # kernel launches (CPU not counted)


def launch_backward(q, k, v, out, lse, d_out, *, kv_len: int, q_offset: int,
                    causal: bool) -> tuple:
    """The backward kernel's launches on checked tensors, uncounted (the
    caller counts them: `flash_attention_backward`, or the tail's
    backward for its attention). Returns (dq, dk, dv)."""
    B, T, H, D = q.shape
    S = k.shape[2]
    lib = _build.load_library()
    dq = torch.empty((B, T, H, D), dtype=torch.float32, device=q.device)
    dk = torch.empty((B, H, S, D), dtype=torch.float32, device=q.device)
    dv = torch.empty_like(dk)
    delta = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    err = lib.wt_flash_attention_backward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), d_out.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), delta.data_ptr(), B, T, S, H, D, kv_len, q_offset,
        int(causal), *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, err, "flash_attention_backward")
    return dq, dk, dv
