"""Fused decoder step: one T==1 decode step through ALL decoder layers in
one kernel launch (whisper_tpu/ops/decoder_step.py:320 fused_decoder_step).

Per layer, with h the (B, d) hidden state:
    y  = LN1(h);  q, k, v = y @ wqkv + qkv_b
    a  = softmax over [self cache rows < pos] and the current token (k, v)
    h += a @ wo + o_b
    y  = LN2(h);  q = y @ wcq + cq_b;  a = softmax over the cross K/V
    h += a @ wco + co_b
    y  = LN3(h);  h += gelu(y @ fc1 + fc1_b) @ fc2 + fc2_b
and each layer's k, v come back to the caller, who appends them at `pos`
(decode._make_fused_step: one cache_append_rows launch per step). The
rounding points are the JAX kernel's (`_kernel` :114-283): every product,
bias and residual sum is rounded through the compute dtype, LayerNorm and
softmax statistics stay fp32, q is scaled by D^-0.5 in fp32 after its
rounding, the softmax denominator is floored at 1e-30, GeLU takes the
exact erf, and the MLP sums in fp32 before its one rounding. (The kernel
masks with -0.7 * FLT_MAX as JAX does; the plain version reads only the
valid rows, which gives the same softmax.)

`fused_decoder_step` launches the hand-written CUDA kernel
(csrc/decoder_step.cu, which carries the design note) for CUDA tensors
and runs `fused_decoder_step_plain` for CPU tensors; a CUDA tensor the
kernel does not take (head_dim != 64, int8 or mixed dtypes, anything not
contiguous, pos outside the cache) raises.

Deliberate differences from the JAX function:
  * The layout is the port's own: self cache (L, B, H, S_self, D), cross
    K/V (L, B, H, S_cross, D), k_new/v_new (L, B, H, D), which is
    cache_append_rows' input. JAX's head-outer (L, H*B, ...) layout and
    its per-transcription `to_head_outer` copy (0.98 GB of cross K/V at
    large-v3-turbo b32 bf16) are not ported.
  * No 128-lane head padding (`_pad_head_*`): a Mosaic layout rule. The
    matrices are the stacked (L, ...) tensors of the params tree, passed
    as they are; the small vectors travel as one fp32 row per layer
    (`pack_decoder_weights`).
  * The TPU weight-block and VMEM knobs (block_*, w_budget) are not
    ported: the kernel picks its own tiles.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from whisper_tpu_torch.ops import _build
from whisper_tpu_torch.ops.grad import refuse_grad

_DTYPES = (torch.float32, torch.bfloat16)

# The kinds of the kernel's optional timeline (csrc/decoder_step.cu Phase):
# block 0 stamps %globaltimer as it leaves each grid barrier, naming the
# phase that barrier closed; "sync" stamps close back-to-back barriers
# timed alone after the step.
PHASES = ("start", "rows", "qkv", "self", "o", "cq", "cross", "co", "fc1",
          "fc2", "final", "sync")


def stamp_pairs(n_layers: int) -> int:
    """(kind, ns) pairs a timeline buffer holds for an n_layers step: room
    for 16 barriers a layer and the probes after it."""
    return 16 * n_layers + 16


class PackedDecoder(NamedTuple):
    """The decoder's per-step operands (`pack_decoder_weights`)."""
    wqkv: torch.Tensor   # (L, d, 3d) fused q|k|v, compute dtype
    wcq: torch.Tensor    # (L, d, d) cross-attention q
    wo: torch.Tensor     # (L, d, d) self-attention output
    wco: torch.Tensor    # (L, d, d) cross-attention output
    fc1: torch.Tensor    # (L, d, ff)
    fc2: torch.Tensor    # (L, ff, d)
    vec: torch.Tensor    # (L, 13d + ff) fp32, layout in `vec_offsets`


def vec_offsets(d: int, ff: int) -> dict[str, int]:
    """Start of each vector in a row of `PackedDecoder.vec`: the qkv, fc1
    and cross-q biases, then JAX's `miscd` order (:576-583)."""
    names = [("qkv_b", 3 * d), ("fc1_b", ff), ("cq_b", d), ("o_b", d),
             ("co_b", d), ("fc2_b", d), ("ln1_g", d), ("ln1_b", d),
             ("ln2_g", d), ("ln2_b", d), ("ln3_g", d), ("ln3_b", d)]
    out, at = {}, 0
    for name, n in names:
        out[name] = at
        at += n
    out["end"] = at
    return out


def pack_decoder_weights(layers: dict, dtype: torch.dtype) -> PackedDecoder:
    """The counterpart of split_weights (:528) and pack_misc (:561), once
    per transcription. The matrices are the params tree's stacked tensors
    in the compute dtype (no copy when the tree is already in it); the
    fused `qkv` linear is the one weights.to_device builds. The vectors
    are read from the live params, so bf16 biases keep their bf16 values
    and the kernel rounds where JAX does."""
    a, c = layers["attn"], layers["cross_attn"]
    if "qkv" not in a:
        raise ValueError("pack_decoder_weights: the fused qkv linear is "
                         "missing (place the params with weights.to_device)")
    if any("w_s" in p for p in (a["qkv"], a["o"], c["q"], c["o"],
                                layers["fc1"], layers["fc2"])):
        raise ValueError("pack_decoder_weights: int8 weights take the "
                         "unfused step (decode._fused_step_enabled)")
    vecs = [a["qkv"]["b"], layers["fc1"]["b"], c["q"]["b"], a["o"]["b"],
            c["o"]["b"], layers["fc2"]["b"],
            layers["attn_ln"]["g"], layers["attn_ln"]["b"],
            layers["cross_ln"]["g"], layers["cross_ln"]["b"],
            layers["mlp_ln"]["g"], layers["mlp_ln"]["b"]]
    return PackedDecoder(
        wqkv=a["qkv"]["w"].to(dtype), wcq=c["q"]["w"].to(dtype),
        wo=a["o"]["w"].to(dtype), wco=c["o"]["w"].to(dtype),
        fc1=layers["fc1"]["w"].to(dtype), fc2=layers["fc2"]["w"].to(dtype),
        vec=torch.cat([v.float() for v in vecs], dim=-1).contiguous())


def _ln(x, g, b, eps: float):
    """fp32 LayerNorm with JAX's `_ln` statistics (:91)."""
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * g + b


def fused_decoder_step_plain(h0, packed: PackedDecoder, self_k, self_v,
                             cross_k, cross_v, kv_len: int, *, n_heads: int,
                             eps: float = 1e-5, acc_dtype=torch.float32):
    """The JAX kernel's arithmetic as a plain loop over the layers, fp32
    with the compute dtype's rounding at JAX's points. Shapes as
    `fused_decoder_step`. `acc_dtype=torch.float64` keeps the rounding
    points but takes the arithmetic between them in fp64: a reference
    whose sums round nowhere else, for telling which of two fp32 orders a
    bf16 near-tie went the right way in."""
    dtype = h0.dtype
    f32 = acc_dtype
    B, d = h0.shape
    L = packed.wqkv.shape[0]
    H = n_heads
    D = d // H
    ff = packed.fc1.shape[2]
    n_stale = int(kv_len) - 1           # cache rows read: those below pos
    scale = D ** -0.5
    off = vec_offsets(d, ff)

    def rnd(x):
        return x.to(dtype).to(f32)

    def dot(x, w):          # x already holds compute-dtype values
        return x @ w.to(f32)

    def heads(x):           # (B, d) -> (B, H, D)
        return x.reshape(B, H, D)

    h = h0.to(f32)
    k_news, v_news = [], []
    for i in range(L):
        row = packed.vec[i]

        def seg(name, n=d):
            return row[off[name]:off[name] + n]

        # self-attention: the current token seeds the online softmax
        # (:208-214); only the stale rows < kv_len - 1 are read
        y = rnd(_ln(h, seg("ln1_g"), seg("ln1_b"), eps))
        qkv = rnd(rnd(dot(y, packed.wqkv[i])) + rnd(seg("qkv_b", 3 * d)))
        q, k, v = (heads(t) for t in qkv.split(d, dim=-1))
        k_news.append(k.to(self_k.dtype))
        v_news.append(v.to(self_v.dtype))
        qs = q * scale
        s_new = (qs * k).sum(-1, keepdim=True)                  # (B, H, 1)
        kc = self_k[i, :, :, :n_stale].to(f32)                  # (B, H, n, D)
        vc = self_v[i, :, :, :n_stale].to(f32)
        s = torch.einsum("bhd,bhnd->bhn", qs, kc)
        m = torch.maximum(s_new, s.amax(-1, keepdim=True)) if n_stale \
            else s_new
        p_new, p = torch.exp(s_new - m), torch.exp(s - m)
        den = p_new + p.sum(-1, keepdim=True)
        acc = p_new * v + torch.einsum("bhn,bhnd->bhd", p, vc)
        a = rnd(acc / den.clamp_min(1e-30)).reshape(B, d)
        h = rnd(h + rnd(rnd(dot(a, packed.wo[i])) + rnd(seg("o_b"))))

        # cross-attention over every encoder position
        y = rnd(_ln(h, seg("ln2_g"), seg("ln2_b"), eps))
        q = heads(rnd(rnd(dot(y, packed.wcq[i])) + rnd(seg("cq_b")))) * scale
        s = torch.einsum("bhd,bhnd->bhn", q, cross_k[i].to(f32))
        p = torch.exp(s - s.amax(-1, keepdim=True))
        acc = torch.einsum("bhn,bhnd->bhd", p, cross_v[i].to(f32))
        a = rnd(acc / p.sum(-1, keepdim=True).clamp_min(1e-30)).reshape(B, d)
        h = rnd(h + rnd(rnd(dot(a, packed.wco[i])) + rnd(seg("co_b"))))

        # MLP: exact-erf GeLU, the fc2 product summed in fp32, one rounding
        y = rnd(_ln(h, seg("ln3_g"), seg("ln3_b"), eps))
        t1 = rnd(rnd(dot(y, packed.fc1[i])) + rnd(seg("fc1_b", ff)))
        t1 = rnd(torch.nn.functional.gelu(t1))
        h = rnd(h + rnd(rnd(dot(t1, packed.fc2[i])) + rnd(seg("fc2_b"))))
    return h.to(dtype), torch.stack(k_news), torch.stack(v_news)


def _check(h0, packed: PackedDecoder, self_k, self_v, cross_k, cross_v,
           kv_len: int, n_heads: int) -> None:
    B, d = h0.shape
    L, _, three_d = packed.wqkv.shape
    ff = packed.fc1.shape[2]
    if d % n_heads or three_d != 3 * d:
        raise ValueError(f"fused_decoder_step: d={d}, {n_heads} heads, "
                         f"wqkv {tuple(packed.wqkv.shape)}")
    D = d // n_heads
    S = self_k.shape[3]
    Sc = cross_k.shape[3]
    shapes = {"wcq": (L, d, d), "wo": (L, d, d), "wco": (L, d, d),
              "fc1": (L, d, ff), "fc2": (L, ff, d),
              "vec": (L, vec_offsets(d, ff)["end"])}
    for name, shape in shapes.items():
        if tuple(getattr(packed, name).shape) != shape:
            raise ValueError(f"fused_decoder_step: {name} has shape "
                             f"{tuple(getattr(packed, name).shape)}, "
                             f"expected {shape}")
    for name, t, shape in (("self_k", self_k, (L, B, n_heads, S, D)),
                           ("self_v", self_v, (L, B, n_heads, S, D)),
                           ("cross_k", cross_k, (L, B, n_heads, Sc, D)),
                           ("cross_v", cross_v, (L, B, n_heads, Sc, D))):
        if tuple(t.shape) != shape:
            raise ValueError(f"fused_decoder_step: {name} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
    tensors = {"h0": h0, **packed._asdict(), "self_k": self_k,
               "self_v": self_v, "cross_k": cross_k, "cross_v": cross_v}
    for name, t in tensors.items():
        if t.device != h0.device:
            raise ValueError(f"fused_decoder_step: {name} is on {t.device}, "
                             f"h0 on {h0.device}")
    if not 1 <= kv_len <= S:
        raise IndexError(f"fused_decoder_step: kv_len {kv_len} (pos "
                         f"{kv_len - 1}) outside a {S}-slot self cache")


def _check_stamps(stamps: torch.Tensor, h0: torch.Tensor, L: int) -> None:
    """The timeline buffer: int64, contiguous, room for stamp_pairs(L)
    pairs, on h0's CUDA device. The plain version has no timeline, so a
    call on CPU tensors that asks for one is refused."""
    if stamps.dtype != torch.int64:
        raise TypeError(f"fused_decoder_step: stamps are {stamps.dtype}, "
                        f"not torch.int64")
    if not stamps.is_contiguous() or stamps.numel() < 2 * stamp_pairs(L):
        raise ValueError(f"fused_decoder_step: stamps need "
                         f"{2 * stamp_pairs(L)} contiguous int64 elements, "
                         f"got {stamps.numel()}")
    if h0.device.type != "cuda":
        raise ValueError("fused_decoder_step: stamps time the CUDA kernel; "
                         f"h0 is on {h0.device}")
    if stamps.device != h0.device:
        raise ValueError(f"fused_decoder_step: stamps are on "
                         f"{stamps.device}, h0 on {h0.device}")


@functools.lru_cache(maxsize=None)
def _scratch_floats(B: int, H: int, d: int, ff: int) -> int:
    """fp32 scratch the kernel needs, as its C side counts it."""
    lib = _build.load_library()
    return int(lib.wt_fused_decoder_step_scratch(B, H, d, ff))


def fused_decoder_step(h0: torch.Tensor, packed: PackedDecoder,
                       self_k: torch.Tensor, self_v: torch.Tensor,
                       cross_k: torch.Tensor, cross_v: torch.Tensor,
                       kv_len: int, *, n_heads: int, eps: float = 1e-5,
                       stamps: torch.Tensor | None = None
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One T==1 decode step through every decoder layer (:320).

    Args:
      h0: (B, d) compute dtype (fp32 or bf16): token + positional
        embedding of the current token.
      packed: `pack_decoder_weights` of the decoder layers.
      self_k, self_v: (L, B, H, S_self, D) self cache, the current token
        not yet written; only rows < kv_len - 1 are read.
      cross_k, cross_v: (L, B, H, S_cross, D).
      kv_len: valid self length INCLUDING the current token (pos + 1).
      stamps: for measurement only, a CUDA int64 tensor of at least
        2 * stamp_pairs(L) elements that receives the kernel's timeline:
        (kind, ns) pairs, kind an index into PHASES, ended by a kind of
        -1. None (every normal call) records nothing.
    Returns:
      h_out (B, d) in h0's dtype (before the final LayerNorm), and
      k_new, v_new (L, B, H, D) in the cache's dtype: each layer's row for
      position kv_len - 1. CPU tensors take the plain version; CUDA
      tensors launch the kernel (one launch for all layers) or raise.
      No backward: RuntimeError under autograd.
    """
    refuse_grad("fused_decoder_step", h0, *packed, self_k, self_v, cross_k,
                cross_v)
    kv_len = int(kv_len)
    _check(h0, packed, self_k, self_v, cross_k, cross_v, kv_len, n_heads)
    if stamps is not None:
        _check_stamps(stamps, h0, packed.wqkv.shape[0])
    if h0.device.type == "cpu":
        return fused_decoder_step_plain(h0, packed, self_k, self_v, cross_k,
                                        cross_v, kv_len, n_heads=n_heads,
                                        eps=eps)
    if h0.device.type != "cuda":
        raise ValueError(f"fused_decoder_step: no kernel for device "
                         f"{h0.device}")
    dtype = h0.dtype
    if dtype not in _DTYPES:
        raise TypeError(f"fused_decoder_step: no kernel for {dtype}")
    tensors = {"h0": h0, **packed._asdict(), "self_k": self_k,
               "self_v": self_v, "cross_k": cross_k, "cross_v": cross_v}
    for name, t in tensors.items():
        want = torch.float32 if name == "vec" else dtype
        if t.dtype != want:
            raise TypeError(f"fused_decoder_step: {name} is {t.dtype}, the "
                            f"kernel takes {want} here")
        if not t.is_contiguous():
            raise ValueError(f"fused_decoder_step: {name} is not contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"fused_decoder_step: {name} is not 16-byte "
                             f"aligned")
    B, d = h0.shape
    L, _, H, S, D = self_k.shape
    if D != 64:
        raise ValueError(f"fused_decoder_step: the kernel takes head_dim 64, "
                         f"got {D}")
    ff = packed.fc1.shape[2]
    h_out = torch.empty_like(h0)
    k_new = torch.empty((L, B, H, D), dtype=dtype, device=h0.device)
    v_new = torch.empty_like(k_new)
    scratch = torch.empty(_scratch_floats(B, H, d, ff), dtype=torch.float32,
                          device=h0.device)
    lib = _build.load_library()
    err = lib.wt_fused_decoder_step(
        h0.data_ptr(), packed.wqkv.data_ptr(), packed.wcq.data_ptr(),
        packed.wo.data_ptr(), packed.wco.data_ptr(), packed.fc1.data_ptr(),
        packed.fc2.data_ptr(), packed.vec.data_ptr(), self_k.data_ptr(),
        self_v.data_ptr(), cross_k.data_ptr(), cross_v.data_ptr(),
        h_out.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
        scratch.data_ptr(), scratch.numel(), L, B, H, D, d, ff, S,
        cross_k.shape[3], kv_len, float(eps), int(dtype == torch.bfloat16),
        None if stamps is None else stamps.data_ptr(),
        0 if stamps is None else stamps.numel() // 2,
        torch.cuda.current_stream(h0.device).cuda_stream)
    _build.check(lib, err, "fused_decoder_step")
    fused_decoder_step.launches += 1
    return h_out, k_new, v_new


fused_decoder_step.launches = 0     # kernel launches (CPU calls not counted)
