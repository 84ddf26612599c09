"""Fused encoder-block tail: attention + o-projection + residual + LN2 +
MLP + residual (whisper_tpu/ops/encoder_layer.py:240 encoder_block_tail).

`encoder_block_tail` launches the hand-written CUDA kernel
(csrc/encoder_tail.cu, which carries the design note) for CUDA tensors
and runs `encoder_block_tail_plain` for CPU tensors. The plain version is
the CPU path and the kernel's oracle on the card: the XLA block's math
(tests/test_encoder_layer.py:36 _xla_tail) with the Pallas kernel's bf16
rounding points (_tail_kernel :88-92, :120, :136-148).

Differences from the JAX signature: `wo` is the unpadded (H*D, d)
o-projection (the 128-lane row padding of pad_tail_weights is a Mosaic
layout rule), and the five vectors come as separate tensors instead of
the packed fp32 `misc` row; the wrapper packs them for the kernel.
"""

from __future__ import annotations

import torch

from whisper_tpu_torch.ops import _build

_DTYPES = (torch.float32, torch.bfloat16)


def encoder_block_tail_plain(q, k, v, h_in, wo, fc1_w, fc2_w, o_b, fc1_b,
                             fc2_b, ln2_g, ln2_b, eps: float = 1e-5
                             ) -> torch.Tensor:
    """The tail in torch ops, fp32 arithmetic rounded through h_in's dtype
    where the JAX kernel rounds. Shapes as `encoder_block_tail`."""
    dtype = h_in.dtype
    B, T, H, D = q.shape

    def rnd(x):
        return x.to(dtype).float()

    def dot(x, w):
        # the kernel's dot: operands in the compute dtype, fp32 accumulate
        return x.to(dtype).float() @ w.float()

    s = torch.einsum("bthd,bhsd->bhts", q.float() * (D ** -0.5), k.float())
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)     # (B, H, T, 1)
    pv = torch.einsum("bhts,bhsd->bthd", p.to(v.dtype).float(), v.float())
    a = rnd(pv / denom.permute(0, 2, 1, 3)).reshape(B, T, H * D)

    h2 = rnd(h_in.float() + rnd(rnd(dot(a, wo)) + rnd(o_b.float())))
    xf = h2
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = rnd((xf - mean) * torch.rsqrt(var + eps) * ln2_g.float()
            + ln2_b.float())
    t1 = rnd(rnd(dot(y, fc1_w)) + rnd(fc1_b.float()))
    t1 = rnd(torch.nn.functional.gelu(t1))                   # exact erf
    t2 = rnd(rnd(dot(t1, fc2_w)) + rnd(fc2_b.float()))
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
    if D != 64 or d != H * D:
        raise ValueError(f"encoder_block_tail: the kernel takes head_dim 64 "
                         f"and d = H*64; got D={D}, d={d}, H={H}")
    if ff % 4:
        raise ValueError(f"encoder_block_tail: ff={ff} is not a multiple of 4")
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
      tensors launch the kernel (head_dim 64, contiguous) or raise.
    """
    vecs = (o_b, fc1_b, fc2_b, ln2_g, ln2_b)
    if h_in.device.type == "cpu":
        return encoder_block_tail_plain(q, k, v, h_in, wo, fc1_w, fc2_w,
                                        *vecs, eps=eps)
    if h_in.device.type != "cuda":
        raise ValueError(f"encoder_block_tail: no kernel for device "
                         f"{h_in.device}")
    _check(q, k, v, h_in, wo, fc1_w, fc2_w, vecs)
    B, T, H, D = q.shape
    S, d, ff = k.shape[2], h_in.shape[-1], fc1_w.shape[-1]
    lib = _build.load_library()
    misc = torch.cat([t.float() for t in vecs])              # (4d + ff,) fp32
    attn = torch.empty((B, T, d), dtype=h_in.dtype, device=h_in.device)
    out = torch.empty_like(h_in)
    err = lib.wt_encoder_tail(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), h_in.data_ptr(),
        wo.data_ptr(), fc1_w.data_ptr(), fc2_w.data_ptr(), misc.data_ptr(),
        attn.data_ptr(), out.data_ptr(), B, T, S, H, D, d, ff, float(eps),
        int(h_in.dtype == torch.bfloat16),
        torch.cuda.current_stream(h_in.device).cuda_stream)
    _build.check(lib, err, "encoder_block_tail")
    encoder_block_tail.launches += 1
    return out


encoder_block_tail.launches = 0     # kernel launches (CPU calls not counted)
