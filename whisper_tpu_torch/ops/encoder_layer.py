"""Fused encoder-block tail: attention + o-projection + residual + LN2 +
MLP + residual (whisper_tpu/ops/encoder_layer.py:240 encoder_block_tail),
in its unquantized form and its int8 form (`mlp_q`, `o_q`).

`encoder_block_tail` launches the hand-written CUDA kernel
(csrc/encoder_tail.cu, which carries the design note) for CUDA tensors
and runs `encoder_block_tail_plain` for CPU tensors. The plain version is
the CPU path and the kernel's oracle on the card: the XLA block's math
(tests/test_encoder_layer.py:36 _xla_tail) with the Pallas kernel's bf16
rounding points (_tail_kernel :88-92, :120, :136-148).

`encoder_block_tail_q8` is the int8 form (bf16 only, as in JAX, whose
encoder ignores the int8 flags in fp32): fc1 and fc2 int8 per output
column, and the o-projection int8 too when its scales are given (the
`WHISPER_TPU_ENC_I8O` default), each product `qdot`'s math (:120-129):
the activation rows quantized to int8 per row, an exact int32 product,
rescaled by (row scale x column scale). Its plain twin is
`encoder_block_tail_q8_plain`; its kernel is the int8 MLP tiles of
csrc/encoder_tail.cu after the same attention launch.

Differences from the JAX signature: `wo` is the unpadded (H*D, d)
o-projection (the 128-lane row padding of pad_tail_weights is a Mosaic
layout rule; its zero rows change no column's scale), and the five
vectors come as separate tensors instead of the packed fp32 `misc` row;
the wrapper packs them for the kernel. The int8 form takes its matrices
K-major, (out, in): the tensor cores read 8-bit operands K-major only,
so the encoder transposes them once per call, where it quantizes them.

Under autograd on the card (the train step, fp32) the unquantized
kernel's forward also keeps its attention rows and their log-sum-exp, and
its backward is `encoder_block_tail_backward` (csrc/encoder_tail_bwd.cu
plus the flash backward kernel; ops/grad.py), whose plain twin is
`encoder_block_tail_backward_plain`. On the CPU autograd differentiates
`encoder_block_tail_plain`. The int8 form has no backward and raises
under autograd.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from whisper_tpu_torch.ops import _build
from whisper_tpu_torch.ops.flash_attention import (
    flash_attention_backward_plain,
    launch_backward as flash_launch_backward,
)
from whisper_tpu_torch.ops.grad import (
    kernel_with_backward,
    refuse_bf16_grad,
    refuse_grad,
    tracks_grad,
)

_DTYPES = (torch.float32, torch.bfloat16)

# Shared memory one block may opt into on sm_90 (H100): the CPU takes this
# figure, so that both devices pick the same encoder branch for a model.
SM90_SMEM_OPTIN = 232_448
# csrc/encoder_tail.cu: the widest d (LN2 holds a row in registers), and
# the MLP tiles' shared memory (128 x 128 tiles: three stages of 128 bytes
# of k of both operands on the tensor cores plus the 1 KiB swizzle atom;
# three stages of 16 k of both in fp32)
TAIL_MAX_D = 1280
TAIL_SMEM = {"tc": 3 * 2 * 128 * 128 + 1024,
             "fp32": 3 * (128 * 16 + 16 * 128) * 4}


def tail_smem_bytes(d: int, ff: int, q8: bool = False) -> int:
    """Shared memory of the kernel's MLP launches at width (d, ff)
    (csrc/encoder_tail.cu wt_encoder_tail_smem gives the C side's): the
    tiles stream both operands and hold no row whole, so neither d nor ff
    enters. The unquantized form takes the larger of its tensor-core (bf16)
    and fp32 rings, 99,328 B; the int8 form the tensor-core ring."""
    return TAIL_SMEM["tc"] if q8 else max(TAIL_SMEM.values())


def tail_fits_smem(d: int, ff: int, device: torch.device,
                   q8: bool = False) -> bool:
    """Whether the tail kernel takes width (d, ff) on `device`, in its
    unquantized form or its int8 form (`q8`): d up to TAIL_MAX_D and its
    MLP launch within the card's opt-in shared memory per block (on CUDA
    read from the card, elsewhere SM90_SMEM_OPTIN). The counterpart of the
    JAX package's tail_fits_vmem (ops/encoder_layer.py:229), which takes
    the form too (mlp_q, o_q) and whose VMEM budgets are TPU calibration
    and are not ported. Every Whisper width fits, in every form (97 KB of
    the 227 KB)."""
    if d > TAIL_MAX_D:
        return False
    limit = SM90_SMEM_OPTIN
    if device.type == "cuda":
        limit = torch.cuda.get_device_properties(
            device).shared_memory_per_block_optin
    return tail_smem_bytes(d, ff, q8) <= limit


def _rounder(dtype):
    """Round an fp32 tensor through `dtype` and back: the JAX kernel's
    `rnd` (:88-92)."""
    return lambda x: x.to(dtype).float()


def _attention_rows(q, k, v, dtype) -> torch.Tensor:
    """The tail's attention (:101-120): per head softmax(q k^T / sqrt(D)) v,
    heads side by side, rounded through `dtype`; (B, T, H*D) fp32."""
    B, T, H, D = q.shape
    s = torch.einsum("bthd,bhsd->bhts", q.float() * (D ** -0.5), k.float())
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)     # (B, H, T, 1)
    pv = torch.einsum("bhts,bhsd->bthd", p.to(v.dtype).float(), v.float())
    return _rounder(dtype)(pv / denom.permute(0, 2, 1, 3)).reshape(
        B, T, H * D)


def _ln2(h2, ln2_g, ln2_b, eps: float, dtype) -> torch.Tensor:
    """LN2 in fp32 (JAX ops/decoder_step.py:91 _ln), rounded through
    `dtype`."""
    mean = h2.mean(dim=-1, keepdim=True)
    var = (h2 - mean).square().mean(dim=-1, keepdim=True)
    return _rounder(dtype)((h2 - mean) * torch.rsqrt(var + eps)
                           * ln2_g.float() + ln2_b.float())


def int8_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The exact int32 product of int8 x (..., K) and int8 w (K, N), as
    JAX's dot_general with an int32 result: torch._int_mm on 2-D operands.
    On CUDA it takes more than 16 rows, so fewer are padded with zero
    rows."""
    lead, m = x.shape[:-1], x[..., 0].numel()
    x2 = x.reshape(m, x.shape[-1])
    if x2.is_cuda and m <= 16:
        x2 = torch.nn.functional.pad(x2, (0, 0, 0, 17 - m))
    return torch._int_mm(x2.contiguous(), w.contiguous())[:m].reshape(
        *lead, w.shape[-1])


def rowquant(x32: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row int8 of fp32 activations (JAX models/whisper.py:112
    _rowquant_dyn): sx = max(max|x| / 127, 1e-10), then x / sx rounded half
    to even and clipped. Returns (int8 values, fp32 scales (..., 1))."""
    sx = torch.clamp_min(x32.abs().amax(dim=-1, keepdim=True) / 127.0, 1e-10)
    return (x32 / sx).round_().clamp_(-127, 127).to(torch.int8), sx


def qdot(x32: torch.Tensor, w_t: torch.Tensor, w_s: torch.Tensor
         ) -> torch.Tensor:
    """The JAX kernel's qdot (:120-129), which is linear_i8dyn's product:
    x (..., K) fp32 quantized per row (`rowquant`), the exact int32
    product with the K-major int8 weight w_t (N, K), rescaled by sx * w_s
    in fp32. Returns (..., N) fp32."""
    xq, sx = rowquant(x32)
    return int8_matmul(xq, w_t.t()).float() * (sx * w_s.float())


def encoder_block_tail_plain(q, k, v, h_in, wo, fc1_w, fc2_w, o_b, fc1_b,
                             fc2_b, ln2_g, ln2_b, eps: float = 1e-5
                             ) -> torch.Tensor:
    """The tail in torch ops, fp32 arithmetic rounded through h_in's dtype
    where the JAX kernel rounds. Shapes as `encoder_block_tail`."""
    dtype = h_in.dtype
    rnd = _rounder(dtype)

    def dot(x, w):
        # the kernel's dot: operands in the compute dtype, fp32 accumulate
        return x.to(dtype).float() @ w.float()

    a = _attention_rows(q, k, v, dtype)
    h2 = rnd(h_in.float() + rnd(rnd(dot(a, wo)) + rnd(o_b.float())))
    y = _ln2(h2, ln2_g, ln2_b, eps, dtype)
    t1 = rnd(rnd(dot(y, fc1_w)) + rnd(fc1_b.float()))
    t1 = rnd(torch.nn.functional.gelu(t1))                   # exact erf
    t2 = rnd(rnd(dot(t1, fc2_w)) + rnd(fc2_b.float()))
    return (h2 + t2).to(dtype)


def _grads_like(grads, tensors) -> tuple:
    """Each gradient in its input's dtype (a bias may be stored in another
    float dtype than the fp32 the backward computes in)."""
    return tuple(g.to(t.dtype) for g, t in zip(grads, tensors))


def gelu_grad(x: torch.Tensor) -> torch.Tensor:
    """d/dx of the exact-erf GELU x Phi(x): Phi(x) + x phi(x)."""
    cdf = 0.5 * (1.0 + torch.erf(x * 0.5 ** 0.5))
    return cdf + x * torch.exp(-0.5 * x * x) * (2.0 * torch.pi) ** -0.5


def backward_product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w: each of the backward twin's eight products, looked up at call
    time, so that a test can put a model of the kernel's arithmetic in its
    place."""
    return x @ w


def encoder_block_tail_backward_plain(q, k, v, h_in, wo, fc1_w, fc2_w, o_b,
                                      fc1_b, fc2_b, ln2_g, ln2_b, attn, lse,
                                      d_out, eps: float = 1e-5) -> tuple:
    """The backward kernel's math in torch ops, fp32: the gradients of
    `encoder_block_tail_plain` (fp32) at its twelve inputs, given the
    forward's attention rows `attn` (B, T, d) and their log-sum-exp `lse`
    (B, H, T), and the output's gradient d_out (B, T, d). h2 and the MLP's
    pre-activation are recomputed, as the kernel does:
        h2 = h_in + (a Wo + bo);  xhat = (h2 - mean) rstd;  y = xhat g + b
        u = y W1 + b1;  dt1 = G W2^T;  du = dt1 gelu'(u)
        dy = du W1^T;  dh2 = G + rstd (dy g - mean(dy g)
                                       - xhat mean(dy g xhat))
        da = dh2 Wo^T, then flash_attention_backward_plain
    Returns (dq, dk, dv, dh_in, dWo, dW1, dW2, dbo, db1, db2, dg, db) in the
    inputs' dtypes."""
    B, T, H, D = q.shape
    d = h_in.shape[-1]
    rows = B * T
    f32 = [t.float() for t in (wo, fc1_w, fc2_w, o_b, fc1_b, fc2_b, ln2_g,
                               ln2_b)]
    wo_, w1, w2, bo, b1, b2, g, b = f32
    a = attn.float().reshape(rows, d)
    G = d_out.float().reshape(rows, d)
    h2 = h_in.float().reshape(rows, d) + (backward_product(a, wo_) + bo)
    mean = h2.mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt((h2 - mean).square().mean(dim=-1, keepdim=True) + eps)
    xhat = (h2 - mean) * rstd
    y = xhat * g + b
    u = backward_product(y, w1) + b1
    t1 = torch.nn.functional.gelu(u)                          # exact erf
    du = backward_product(G, w2.t()) * gelu_grad(u)
    dy = backward_product(du, w1.t())
    dxhat = dy * g
    dh2 = G + rstd * (dxhat - dxhat.mean(dim=-1, keepdim=True)
                      - xhat * (dxhat * xhat).mean(dim=-1, keepdim=True))
    da = backward_product(dh2, wo_.t()).reshape(B, T, H, D)
    dq, dk, dv = flash_attention_backward_plain(
        q.float(), k.float(), v.float(), attn.float().reshape(B, T, H, D),
        lse, da)
    grads = (dq, dk, dv, dh2.reshape(B, T, d), backward_product(a.t(), dh2),
             backward_product(y.t(), du), backward_product(t1.t(), G),
             dh2.sum(dim=0), du.sum(dim=0), G.sum(dim=0),
             (dy * xhat).sum(dim=0), dy.sum(dim=0))
    return _grads_like(grads, (q, k, v, h_in, wo, fc1_w, fc2_w, o_b, fc1_b,
                              fc2_b, ln2_g, ln2_b))


def encoder_block_tail_q8_plain(q, k, v, h_in, wo_t, fc1_t, fc2_t, o_b,
                                fc1_b, fc2_b, ln2_g, ln2_b, fc1_s, fc2_s,
                                wo_s=None, eps: float = 1e-5
                                ) -> torch.Tensor:
    """The int8 form in torch ops, at the JAX kernel's rounding points
    with mlp_q and o_q (:136-148): the attention rows, then
    `tail_q8_mlp`. Shapes as `encoder_block_tail_q8`."""
    a = _attention_rows(q, k, v, h_in.dtype)
    return tail_q8_mlp(a, h_in, wo_t, fc1_t, fc2_t, o_b, fc1_b, fc2_b, ln2_g,
                       ln2_b, fc1_s, fc2_s, wo_s, eps)


def tail_q8_mlp(a, h_in, wo_t, fc1_t, fc2_t, o_b, fc1_b, fc2_b, ln2_g, ln2_b,
                fc1_s, fc2_s, wo_s=None, eps: float = 1e-5) -> torch.Tensor:
    """The int8 form after its attention: a (B, T, d) the attention rows
    (values of h_in's dtype), then
        o  = qdot(a, wo) (o_q) or a . wo in bf16, fp32 accumulate
        h2 = rnd(h + rnd(rnd(o) + rnd(o_b)));  y = rnd(LN2(h2))
        t1 = rnd(gelu(rnd(rnd(qdot(y, fc1)) + rnd(fc1_b))))
        out = h2 + rnd(rnd(qdot(t1, fc2)) + rnd(fc2_b))
    The kernel's MLP launch computes this from the attention launch's
    rows, so on the card the two are held to each other without the
    attention's own rounding differences."""
    dtype = h_in.dtype
    rnd = _rounder(dtype)
    a = a.float()
    if wo_s is not None:
        o = qdot(a, wo_t, wo_s)
    else:
        o = a @ wo_t.float().t()
    h2 = rnd(h_in.float() + rnd(rnd(o) + rnd(o_b.float())))
    y = _ln2(h2, ln2_g, ln2_b, eps, dtype)
    t1 = rnd(rnd(qdot(y, fc1_t, fc1_s)) + rnd(fc1_b.float()))
    t1 = rnd(torch.nn.functional.gelu(t1))                   # exact erf
    t2 = rnd(rnd(qdot(t1, fc2_t, fc2_s)) + rnd(fc2_b.float()))
    return (h2 + t2).to(dtype)


def _check(q, k, v, h_in, wo, fc1_w, fc2_w, vecs) -> None:
    """Raise on anything the CUDA kernel does not take."""
    dev, dtype = h_in.device, h_in.dtype
    if dtype not in _DTYPES:
        raise TypeError(f"encoder_block_tail: no kernel for {dtype}")
    for name, t in (("q", q), ("k", k), ("v", v), ("wo", wo),
                    ("fc1_w", fc1_w), ("fc2_w", fc2_w)):
        if t.dtype != dtype:
            raise TypeError(f"encoder_block_tail: {name} is {t.dtype}, "
                            f"h_in is {dtype}")
    B, T, H, D = q.shape
    S = k.shape[2]
    d = h_in.shape[-1]
    ff = fc1_w.shape[-1]
    want = {"q": (B, T, H, D), "k": (B, H, S, D), "v": (B, H, S, D),
            "h_in": (B, T, d), "wo": (H * D, d), "fc1_w": (d, ff),
            "fc2_w": (ff, d)}
    got = {"q": q, "k": k, "v": v, "h_in": h_in, "wo": wo, "fc1_w": fc1_w,
           "fc2_w": fc2_w}
    for name, shape in want.items():
        if tuple(got[name].shape) != shape:
            raise ValueError(f"encoder_block_tail: {name} has shape "
                             f"{tuple(got[name].shape)}, expected {shape}")
    if D != 64 or d != H * D or d > TAIL_MAX_D:
        raise ValueError(f"encoder_block_tail: the kernel takes head_dim 64 "
                         f"and d = H*64 up to {TAIL_MAX_D}; got D={D}, "
                         f"d={d}, H={H}")
    if ff % 64:
        raise ValueError(f"encoder_block_tail: ff={ff} is not a multiple of "
                         f"64")
    for name, t in (("o_b", vecs[0]), ("fc1_b", vecs[1]), ("fc2_b", vecs[2]),
                    ("ln2_g", vecs[3]), ("ln2_b", vecs[4])):
        n = ff if name == "fc1_b" else d
        if tuple(t.shape) != (n,):
            raise ValueError(f"encoder_block_tail: {name} has shape "
                             f"{tuple(t.shape)}, expected ({n},)")
    for name, t in (("q", q), ("k", k), ("v", v), ("h_in", h_in), ("wo", wo),
                    ("fc1_w", fc1_w), ("fc2_w", fc2_w), *zip(
                        ("o_b", "fc1_b", "fc2_b", "ln2_g", "ln2_b"), vecs)):
        if t.device != dev:
            raise ValueError(f"encoder_block_tail: {name} is on {t.device}, "
                             f"h_in on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"encoder_block_tail: {name} is not contiguous")
        if name in want and t.data_ptr() % 16:     # cp.async's 16 bytes
            raise ValueError(f"encoder_block_tail: {name} is not 16-byte "
                             f"aligned")


def _workspace(lib, rows: int, d: int, ff: int, elem: int, q8: bool,
               device) -> torch.Tensor:
    """The MLP tiles' workspace: y and t1 (and the int8 form's int8 rows
    and row scales), csrc/encoder_tail.cu wt_encoder_tail_workspace's
    bytes."""
    n = lib.wt_encoder_tail_workspace(rows, d, ff, elem, int(q8))
    return torch.empty(n, dtype=torch.uint8, device=device)


def encoder_block_tail(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       h_in: torch.Tensor, wo: torch.Tensor,
                       fc1_w: torch.Tensor, fc2_w: torch.Tensor,
                       o_b: torch.Tensor, fc1_b: torch.Tensor,
                       fc2_b: torch.Tensor, ln2_g: torch.Tensor,
                       ln2_b: torch.Tensor, eps: float = 1e-5
                       ) -> torch.Tensor:
    """One encoder block after LN1 + the fused QKV projection.

    Args:
      q: (B, T, H, D); k, v: (B, H, S, D) head-major; h_in: (B, T, d) the
        block's residual input — all in the compute dtype (fp32 or bf16).
      wo: (H*D, d); fc1_w: (d, ff); fc2_w: (ff, d) in the compute dtype.
      o_b, fc2_b, ln2_g, ln2_b: (d,); fc1_b: (ff,); any float dtype.
    Returns:
      (B, T, d) in h_in's dtype. CPU tensors take the plain version; CUDA
      tensors launch the kernel (head_dim 64, contiguous, a width that
      `tail_fits_smem`) or raise. Under autograd on the card (fp32 only;
      bf16 raises) the backward is `encoder_block_tail_backward`.
    """
    vecs = (o_b, fc1_b, fc2_b, ln2_g, ln2_b)
    if h_in.device.type == "cpu":
        return encoder_block_tail_plain(q, k, v, h_in, wo, fc1_w, fc2_w,
                                        *vecs, eps=eps)
    if h_in.device.type != "cuda":
        raise ValueError(f"encoder_block_tail: no kernel for device "
                         f"{h_in.device}")
    _check(q, k, v, h_in, wo, fc1_w, fc2_w, vecs)
    tensors = (q, k, v, h_in, wo, fc1_w, fc2_w, *vecs)
    if tracks_grad(*tensors):
        refuse_bf16_grad("encoder_block_tail", h_in.dtype)
        return kernel_with_backward(
            functools.partial(_forward_for_grad, eps=eps),
            functools.partial(_backward, eps=eps), *tensors)
    return _launch(*tensors, eps=eps)[0]


def _launch(q, k, v, h_in, wo, fc1_w, fc2_w, o_b, fc1_b, fc2_b, ln2_g,
            ln2_b, *, eps: float, keep: bool = False) -> tuple:
    """One kernel launch on checked tensors, counted on
    `encoder_block_tail.launches`. Returns (out, attention rows (B, T, d),
    their log-sum-exp (B, H, T) or None): with `keep` (fp32, under
    autograd) the attention launch writes the log-sum-exp too."""
    vecs = (o_b, fc1_b, fc2_b, ln2_g, ln2_b)
    B, T, H, D = q.shape
    S, d, ff = k.shape[2], h_in.shape[-1], fc1_w.shape[-1]
    lib = _build.load_library()
    misc = torch.cat([t.float() for t in vecs])              # (4d + ff,) fp32
    attn = torch.empty((B, T, d), dtype=h_in.dtype, device=h_in.device)
    lse = (torch.empty((B, H, T), dtype=torch.float32, device=h_in.device)
           if keep else None)
    work = _workspace(lib, B * T, d, ff, h_in.element_size(), False,
                      h_in.device)
    out = torch.empty_like(h_in)
    err = lib.wt_encoder_tail(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), h_in.data_ptr(),
        wo.data_ptr(), fc1_w.data_ptr(), fc2_w.data_ptr(), misc.data_ptr(),
        attn.data_ptr(), None if lse is None else lse.data_ptr(),
        work.data_ptr(), out.data_ptr(), B, T, S, H, D, d, ff, float(eps),
        int(h_in.dtype == torch.bfloat16),
        torch.cuda.current_stream(h_in.device).cuda_stream)
    _build.check(lib, err, "encoder_block_tail")
    encoder_block_tail.launches += 1
    return out, attn, lse


encoder_block_tail.launches = 0     # kernel launches (CPU calls not counted)


def _forward_for_grad(*tensors, eps: float):
    """The forward under autograd: (out, (attention rows, lse)), the
    residuals the backward reads."""
    out, attn, lse = _launch(*tensors, eps=eps, keep=True)
    return out, (attn, lse)


def _backward(grad_out, tensors, residuals, eps: float):
    return encoder_block_tail_backward(*tensors, *residuals, grad_out,
                                       eps=eps)


def _check_backward(q, h_in, attn, lse, d_out) -> None:
    """Raise on anything the backward kernels do not take, besides what
    `_check` refuses for the forward."""
    B, T, d = h_in.shape
    H = q.shape[2]
    # `_check` holds q, k, v and the matrices to h_in's dtype
    for name, t in (("h_in", h_in), ("attn", attn), ("lse", lse),
                    ("d_out", d_out)):
        if t.dtype != torch.float32:
            raise TypeError(f"encoder_block_tail_backward: {name} is "
                            f"{t.dtype}; the backward kernel is fp32 only")
    for name, t, shape in (("attn", attn, (B, T, d)), ("lse", lse, (B, H, T)),
                           ("d_out", d_out, (B, T, d))):
        if tuple(t.shape) != shape:
            raise ValueError(f"encoder_block_tail_backward: {name} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
        if t.device != h_in.device:
            raise ValueError(f"encoder_block_tail_backward: {name} is on "
                             f"{t.device}, h_in on {h_in.device}")
        if t.data_ptr() % 16:
            raise ValueError(f"encoder_block_tail_backward: {name} is not "
                             f"16-byte aligned")


def encoder_block_tail_backward(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, h_in: torch.Tensor,
                                wo: torch.Tensor, fc1_w: torch.Tensor,
                                fc2_w: torch.Tensor, o_b: torch.Tensor,
                                fc1_b: torch.Tensor, fc2_b: torch.Tensor,
                                ln2_g: torch.Tensor, ln2_b: torch.Tensor,
                                attn: torch.Tensor, lse: torch.Tensor,
                                d_out: torch.Tensor, eps: float = 1e-5
                                ) -> tuple:
    """The gradients of `encoder_block_tail` (fp32) at its twelve inputs,
    given the forward's attention rows `attn` (B, T, d), their log-sum-exp
    `lse` (B, H, T) and the output's gradient `d_out` (B, T, d).

    Returns (dq, dk, dv, dh_in, dWo, dW1, dW2, dbo, db1, db2, dg, db), each
    in its input's dtype. CPU tensors take
    `encoder_block_tail_backward_plain`; CUDA tensors run the backward
    (csrc/encoder_tail_bwd.cu: its eight products as split-TF32 tiles on
    the tensor cores at fp32's accuracy, whatever the TF32 flags, and the
    passes between them; then the flash backward kernel for the
    attention, counted here, not on `flash_attention_backward`) or
    raise. attn, lse and d_out are made contiguous."""
    vecs = (o_b, fc1_b, fc2_b, ln2_g, ln2_b)
    tensors = (q, k, v, h_in, wo, fc1_w, fc2_w, *vecs)
    if h_in.device.type == "cpu":
        return encoder_block_tail_backward_plain(*tensors, attn, lse, d_out,
                                                 eps=eps)
    if h_in.device.type != "cuda":
        raise ValueError(f"encoder_block_tail_backward: no kernel for "
                         f"device {h_in.device}")
    attn, lse, d_out = (t.contiguous() for t in (attn, lse, d_out))
    _check(q, k, v, h_in, wo, fc1_w, fc2_w, vecs)
    _check_backward(q, h_in, attn, lse, d_out)
    grads = _launch_backward(*tensors, attn, lse, d_out, eps=eps)
    encoder_block_tail_backward.launches += 1
    return _grads_like(grads, tensors)


encoder_block_tail_backward.launches = 0   # CPU calls not counted


# csrc/encoder_tail_bwd.cu's stages, in the order the backward runs them:
# the eight products (z and u recomputed) and the two LayerNorm passes
BACKWARD_STAGES = ("z", "ln_forward", "u", "dt1", "dw2", "dw1", "dy",
                   "ln_backward", "dwo", "da")


def _stage(lib, name: str, bufs, rows: int, d: int, ff: int, eps: float,
           device) -> None:
    """One stage of csrc/encoder_tail_bwd.cu on the current stream."""
    ptrs = (ctypes.c_void_p * len(bufs))(*[t.data_ptr() for t in bufs])
    err = lib.wt_encoder_tail_bwd(BACKWARD_STAGES.index(name), ptrs, rows, d,
                                  ff, float(eps),
                                  torch.cuda.current_stream(device)
                                  .cuda_stream)
    _build.check(lib, err, "encoder_block_tail_backward")


def _launch_backward(q, k, v, h_in, wo, fc1_w, fc2_w, o_b, fc1_b, fc2_b,
                     ln2_g, ln2_b, attn, lse, d_out, *, eps: float) -> tuple:
    """The backward on checked fp32 tensors: the kernel's ten stages (each
    buffer reused in place where the kernel says so), then the flash
    backward. No (B, H, T, S) tensor exists."""
    B, T, H, D = q.shape
    S, d, ff = k.shape[2], h_in.shape[-1], fc1_w.shape[-1]
    rows, dev = B * T, h_in.device
    lib = _build.load_library()

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    def run(name, *bufs):
        _stage(lib, name, bufs, rows, d, ff, eps, dev)

    misc = torch.cat([t.float() for t in (o_b, fc1_b, fc2_b, ln2_g, ln2_b)])
    work = empty(lib.wt_encoder_tail_bwd_workspace(rows, d, ff))
    d_vecs = empty(4 * d + ff)                    # [dbo | db1 | db2 | dg | db]
    a, G = attn.reshape(rows, d), d_out.reshape(rows, d)
    h2, y, u, du = empty(rows, d), empty(rows, d), empty(rows, ff), \
        empty(rows, ff)
    mean, rstd = empty(rows), empty(rows)
    # z and u read their weight K-major, as (N, K): a transposed copy
    run("z", a, wo.t().contiguous(), h2)          # ln_forward makes it h2
    run("ln_forward", h2, h_in, misc, y, mean, rstd)
    run("u", y, fc1_w.t().contiguous(), u)        # dt1 makes it t1
    run("dt1", G, fc2_w, u, misc, du)
    d_fc2 = empty(ff, d)
    run("dw2", u, G, work, d_fc2, d_vecs)
    del u
    d_fc1 = empty(d, ff)
    run("dw1", y, du, work, d_fc1, d_vecs)
    dy = empty(rows, d)
    run("dy", du, fc1_w, dy)
    del du
    run("ln_backward", h2, y, mean, rstd, dy, G, misc, work, d_vecs)
    del y, dy                                     # h2 is dh2 from here
    d_wo = empty(d, d)
    run("dwo", a, h2, work, d_wo, d_vecs)
    del work
    da = empty(rows, d)
    run("da", h2, wo, da)
    dq, dk, dv = flash_launch_backward(q, k, v, attn.reshape(B, T, H, D),
                                       lse, da.reshape(B, T, H, D), kv_len=S,
                                       q_offset=0, causal=False)
    return (dq, dk, dv, h2.reshape(B, T, d), d_wo, d_fc1, d_fc2,
            *d_vecs.split([d, ff, d, d, d]))


def _check_q8(q, k, v, h_in, wo_t, fc1_t, fc2_t, vecs, scales) -> None:
    """Raise on anything the int8 form's kernel does not take."""
    if h_in.dtype != torch.bfloat16:
        raise TypeError(f"encoder_block_tail_q8: the int8 form is bf16 only "
                        f"(h_in is {h_in.dtype})")
    B, T, H, D = q.shape
    S, d, ff = k.shape[2], h_in.shape[-1], fc1_t.shape[0]
    o_q = scales[2] is not None
    want = {"q": (q, (B, T, H, D), torch.bfloat16),
            "k": (k, (B, H, S, D), torch.bfloat16),
            "v": (v, (B, H, S, D), torch.bfloat16),
            "h_in": (h_in, (B, T, d), torch.bfloat16),
            "wo_t": (wo_t, (d, H * D), torch.int8 if o_q else torch.bfloat16),
            "fc1_t": (fc1_t, (ff, d), torch.int8),
            "fc2_t": (fc2_t, (d, ff), torch.int8)}
    for name, n, t in (("o_b", d, vecs[0]), ("fc1_b", ff, vecs[1]),
                       ("fc2_b", d, vecs[2]), ("ln2_g", d, vecs[3]),
                       ("ln2_b", d, vecs[4]), ("fc1_s", ff, scales[0]),
                       ("fc2_s", d, scales[1]), ("wo_s", d, scales[2])):
        if t is not None:
            want[name] = (t, (n,), None)
    for name, (t, shape, dt) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"encoder_block_tail_q8: {name} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
        if dt is not None and t.dtype != dt:
            raise TypeError(f"encoder_block_tail_q8: {name} is {t.dtype}, "
                            f"expected {dt}")
        if t.device != h_in.device:
            raise ValueError(f"encoder_block_tail_q8: {name} is on "
                             f"{t.device}, h_in on {h_in.device}")
        if not t.is_contiguous():
            raise ValueError(f"encoder_block_tail_q8: {name} is not "
                             f"contiguous")
        if dt is not None and t.data_ptr() % 16:
            raise ValueError(f"encoder_block_tail_q8: {name} is not 16-byte "
                             f"aligned")
    if D != 64 or d != H * D or d > TAIL_MAX_D:
        raise ValueError(f"encoder_block_tail_q8: the kernel takes head_dim "
                         f"64 and d = H*64 up to {TAIL_MAX_D}; got D={D}, "
                         f"d={d}, H={H}")
    if ff % 64 or ff < 64:
        raise ValueError(f"encoder_block_tail_q8: ff={ff} must be a "
                         f"positive multiple of 64")


def encoder_block_tail_q8(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          h_in: torch.Tensor, wo_t: torch.Tensor,
                          fc1_t: torch.Tensor, fc2_t: torch.Tensor,
                          o_b: torch.Tensor, fc1_b: torch.Tensor,
                          fc2_b: torch.Tensor, ln2_g: torch.Tensor,
                          ln2_b: torch.Tensor, fc1_s: torch.Tensor,
                          fc2_s: torch.Tensor,
                          wo_s: torch.Tensor | None = None,
                          eps: float = 1e-5) -> torch.Tensor:
    """The tail's int8 form (the JAX kernel with mlp_q, and o_q when
    `wo_s` is given), bf16.

    Args:
      q: (B, T, H, D); k, v: (B, H, S, D) head-major; h_in: (B, T, d); bf16.
      wo_t: (d, H*D) the o-projection K-major: int8 per output column with
        wo_s (d,) fp32, or bf16 without it.
      fc1_t: (ff, d) and fc2_t: (d, ff) int8, K-major, with their
        per-column scales fc1_s (ff,) and fc2_s (d,) fp32.
      o_b, fc2_b, ln2_g, ln2_b: (d,); fc1_b: (ff,); any float dtype.
    Returns:
      (B, T, d) bf16. CPU tensors take the plain version; CUDA tensors
      launch the kernel (head_dim 64, contiguous, a width that
      `tail_fits_smem` takes in the int8 form) or raise. No backward:
      RuntimeError under autograd.
    """
    vecs = (o_b, fc1_b, fc2_b, ln2_g, ln2_b)
    refuse_grad("encoder_block_tail_q8", q, k, v, h_in, wo_t, fc1_t, fc2_t,
                *vecs, fc1_s, fc2_s, wo_s)
    if h_in.device.type == "cpu":
        return encoder_block_tail_q8_plain(q, k, v, h_in, wo_t, fc1_t, fc2_t,
                                           *vecs, fc1_s, fc2_s, wo_s, eps=eps)
    if h_in.device.type != "cuda":
        raise ValueError(f"encoder_block_tail_q8: no kernel for device "
                         f"{h_in.device}")
    _check_q8(q, k, v, h_in, wo_t, fc1_t, fc2_t, vecs, (fc1_s, fc2_s, wo_s))
    B, T, H, D = q.shape
    S, d, ff = k.shape[2], h_in.shape[-1], fc1_t.shape[0]
    lib = _build.load_library()
    # the JAX kernel's pack (pack_tail_misc): [o_b | fc1_b | fc2_b | ln2_g
    # | ln2_b | fc1_s | fc2_s (| wo_s)], fp32
    misc = torch.cat([t.float() for t in (*vecs, fc1_s, fc2_s)
                      + ((wo_s,) if wo_s is not None else ())])
    attn = torch.empty((B, T, d), dtype=h_in.dtype, device=h_in.device)
    work = _workspace(lib, B * T, d, ff, 2, True, h_in.device)
    out = torch.empty_like(h_in)
    err = lib.wt_encoder_tail_q8(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), h_in.data_ptr(),
        wo_t.data_ptr(), fc1_t.data_ptr(), fc2_t.data_ptr(), misc.data_ptr(),
        attn.data_ptr(), work.data_ptr(), out.data_ptr(), B, T, S, H, D, d,
        ff, float(eps), int(wo_s is not None),
        torch.cuda.current_stream(h_in.device).cuda_stream)
    _build.check(lib, err, "encoder_block_tail_q8")
    encoder_block_tail_q8.launches += 1
    return out


encoder_block_tail_q8.launches = 0  # kernel launches (CPU calls not counted)
