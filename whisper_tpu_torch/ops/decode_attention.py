"""Single-token attention over a head-major K/V cache
(whisper_tpu/ops/decode_attention.py): the fp32/bf16 reads
decode_attention_bh (:297), decode_attention_bg (:185) and
decode_attention (:354), and the int8 reads decode_attention_q8_bh (:464)
and decode_attention_q8 (:525).

The five JAX functions share one contract and differ in their Pallas grid
(all heads per program, block_b batch rows per program, or one (batch,
head) per program: TPU tilings) and in where they round, so one
hand-written CUDA kernel (csrc/decode_attention.cu, which carries the
design note) serves all five wrappers, each with its own launch count and
its own plain version. For each (b, h), over the keys j < kv_len:
    s_j = (q * D^-0.5) . k_j
    out = sum_j p_j v_j / max(sum_j p_j, 1e-30),  p_j = exp(s_j - max s)
in fp32, cast to q's dtype, where
  * decode_attention_bh and decode_attention_bg first cast K/V to q's
    dtype (:203-204, :308-309);
  * decode_attention keeps K/V as they are and rounds p to V's dtype
    before the p.v product (:82-84);
  * the q8 pair reads int8 K/V times their per-vector fp32 scales.
kv_len == 0 gives zeros, as the Pallas kernels' max(l, 1e-30) does.

CPU tensors take the plain versions, which read only the keys < kv_len;
CUDA tensors launch the kernel or raise (D != 64, a dtype the kernel does
not take, anything not contiguous or 16-byte aligned). On the card a
read whose B*H rows fill at most half the SMs is split over the keys
(flash-decoding): `_split_plan` picks the number of splits from B*H,
kv_len and the SM count, the splits of one (b, h) run as one thread-block
cluster, and its first block merges their partial softmaxes in the same
launch. The paths:
ops/attention.multi_head_attention sends T==1 reads to
decode_attention_bh under attn_backend "pallas" (the kv_cache_quant steps,
the engine's cross reads, detect_language) and from 4096 slots under
"auto"; decoder_step_ip's bf16 cross read takes decode_attention_bg under
WHISPER_TPU_IP_CROSS=bg[N]; its fp32 int8 cross read takes
decode_attention_q8_bh, as does multi_head_attention_quant's T==1 kernel
route. decode_attention and decode_attention_q8 are called from no path,
as in the JAX package (tests only).
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from whisper_tpu_torch.ops import _build
from whisper_tpu_torch.ops.grad import refuse_grad

_DTYPES = (torch.float32, torch.bfloat16)
# the launch plan. A read splits its keys only when its B*H rows fill at
# most half the SMs, into at most one block an SM; each split keeps
# at least SPLIT_MIN_KEYS keys (so below twice that a read is one block
# per (b, h), with no merge), and there are at most SPLIT_MAX (the
# kernel's MAX_SPLITS, the blocks of a portable cluster). A block has 8
# warps, or WIDE_WARPS when its read is long (>= 2*SPLIT_MIN_KEYS keys)
# and the grid fits WIDE_BLOCKS_PER_SM such blocks an SM (1- or 2-byte
# K/V; fp32 K/V takes too many registers)
SPLIT_MIN_KEYS = 256
SPLIT_MAX = 8
WIDE_WARPS = 12
WIDE_BLOCKS_PER_SM = 2

# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv_len: int,
           *, cast_kv: bool, p_round: bool) -> torch.Tensor:
    """The shared plain version over the keys [0, kv_len) alone, so that
    nothing past them (NaN included) reaches the result. cast_kv: K/V take
    q's dtype first; p_round: p is rounded to V's dtype before the p.v
    product (the sum of p stays unrounded)."""
    D = q.shape[-1]
    if kv_len == 0:
        return torch.zeros_like(q)
    k, v = k[:, :, :kv_len], v[:, :, :kv_len]
    if cast_kv:
        k, v = k.to(q.dtype), v.to(q.dtype)
    s = torch.einsum("bthd,bhsd->bhts", q.float() * (D ** -0.5), k.float())
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    if p_round:
        p = p.to(v.dtype)
    o = torch.einsum("bhts,bhsd->bthd", p.float(), v.float())
    return (o / l.permute(0, 2, 1, 3)).to(q.dtype)


def decode_attention_bh_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor,
                              kv_len: Optional[int] = None) -> torch.Tensor:
    """decode_attention_bh's rounding points (:247): K/V in q's dtype,
    scores, p and the p.v sum in fp32."""
    return _plain(q, k, v, _kv_len(k, kv_len), cast_kv=True, p_round=False)


def decode_attention_bg_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, kv_len: Optional[int] = None,
                              *, block_b: int = 8) -> torch.Tensor:
    """decode_attention_bg's (:138): decode_attention_bh's rounding points,
    with block_b dividing the batch."""
    _check_block_b(q, block_b)
    return _plain(q, k, v, _kv_len(k, kv_len), cast_kv=True, p_round=False)


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           kv_len: Optional[int] = None) -> torch.Tensor:
    """decode_attention's (:45): K/V as they are, scores in fp32, p rounded
    to V's dtype before the p.v product."""
    return _plain(q, k, v, _kv_len(k, kv_len), cast_kv=False, p_round=True)


def decode_attention_q8_plain(q: torch.Tensor, k: torch.Tensor,
                              k_scale: torch.Tensor, v: torch.Tensor,
                              v_scale: torch.Tensor,
                              kv_len: Optional[int] = None) -> torch.Tensor:
    """Dequantize, then fp32 masked softmax attention. A row with no valid
    key (kv_len == 0) is zeros, not the NaN of an all-masked softmax.
    Shapes as `decode_attention_q8_bh`."""
    D, S = q.shape[-1], k.shape[2]
    kv_len = _kv_len(k, kv_len)
    kd = k.float() * k_scale
    vd = v.float() * v_scale
    s = torch.einsum("bthd,bhsd->bhts", q.float() * (D ** -0.5), kd)
    valid = torch.arange(S, device=q.device) < kv_len
    s = s.masked_fill(~valid, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - torch.where(torch.isfinite(m), m, 0.0))   # masked: 0
    p = p / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return torch.einsum("bhts,bhsd->bthd", p, vd).to(q.dtype)


# ---------------------------------------------------------------------------
# checks and launches
# ---------------------------------------------------------------------------

def _kv_len(k: torch.Tensor, kv_len) -> int:
    return k.shape[2] if kv_len is None else int(kv_len)


def _split_plan(bh: int, kv_len: int, sms: int,
                kv_bytes: int = 2) -> tuple[int, int, int]:
    """(n_split, chunk, warps) for a read of kv_len keys of `kv_bytes`-byte
    K/V by each of bh (batch, head) rows on a card of `sms` SMs: split s
    reads keys [s*chunk, min((s+1)*chunk, kv_len)) with `warps` warps a
    block. One split when sms // bh < 2 (tiny b32's 192 rows, turbo
    b32's 640 and turbo B=4's 80 on 132 SMs: splitting them was slower on
    the H100, PERF.md) or below 2*SPLIT_MIN_KEYS keys; else sms // bh
    splits of chunk >= SPLIT_MIN_KEYS keys (the last one what the division
    leaves, never empty), at most SPLIT_MAX (a B=1 cross read of 1500
    keys: 5 of 300; the 8000-key cache at B=4, H=6: 5 of 1600).
    WIDE_WARPS warps where the read is long and its bh*n_split blocks fit
    WIDE_BLOCKS_PER_SM an SM (tiny b32's cross read), else 8 (turbo's,
    whose 640 blocks would take three waves; the 93-key self read,
    launch-bound)."""
    n = min(sms // bh, kv_len // SPLIT_MIN_KEYS, SPLIT_MAX)
    chunk = kv_len
    if n > 1:
        chunk = -(-kv_len // n)
        n = -(-kv_len // chunk)
    wide = (kv_bytes <= 2 and chunk >= 2 * SPLIT_MIN_KEYS
            and bh * max(n, 1) <= WIDE_BLOCKS_PER_SM * sms)
    return max(n, 1), chunk, WIDE_WARPS if wide else 8


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=4096)
def _launch_plan(bh: int, kv_len: int, device: torch.device,
                 kv_bytes: int) -> tuple[int, int, int]:
    """The C entry's (n_split, chunk, warps) for this read on `device`'s
    card, kept per read shape: a decode wrapper's call is host-bound at
    the self reads, and a hit costs less than the plan."""
    return _split_plan(bh, kv_len, _sm_count(device), kv_bytes)


def _check_block_b(q: torch.Tensor, block_b: int) -> None:
    if block_b < 1 or q.shape[0] % block_b:
        raise ValueError(f"decode_attention_bg: block_b {block_b} does not "
                         f"divide the batch {q.shape[0]}")


def _check(what: str, q: torch.Tensor, kv_len: int, **tensors) -> None:
    """One query token, every tensor of its expected shape on q's device,
    kv_len in [0, S]. `tensors`: name -> (tensor, its last dim)."""
    B, T, H, D = q.shape
    if T != 1:
        raise ValueError(f"{what}: decode attention takes one query token, "
                         f"got T={T}")
    S = tensors["k"][0].shape[2]
    for name, (t, last) in tensors.items():
        shape = (B, H, S, last)
        if tuple(t.shape) != shape:
            raise ValueError(f"{what}: {name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if t.device != q.device:
            raise ValueError(f"{what}: {name} is on {t.device}, q on "
                             f"{q.device}")
    if not 0 <= kv_len <= S:
        raise ValueError(f"{what}: kv_len {kv_len} outside [0, {S}]")


def _launchable(what: str, q: torch.Tensor, **tensors) -> torch.Tensor:
    """Raise on anything the kernel does not take whatever the K/V type;
    return an empty output."""
    if q.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {q.device}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"{what}: no kernel for a {q.dtype} query")
    if q.shape[-1] != 64:
        raise ValueError(f"{what}: the kernel takes head_dim 64, got "
                         f"{q.shape[-1]}")
    for name, t in (("q", q), *tensors.items()):
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} is not contiguous")
    for name in ("k", "v"):                 # read in 16-byte vectors
        if tensors[name].data_ptr() % 16:
            raise ValueError(f"{what}: {name} is not 16-byte aligned")
    return torch.empty_like(q)


def _stream(q: torch.Tensor) -> int:
    return torch.cuda.current_stream(q.device).cuda_stream


def _run(fn, q, k, v, kv_len, *, cast_kv: bool, p_round: bool,
         plain) -> torch.Tensor:
    """An fp32/bf16 read: check, then the plain version (CPU) or one
    kernel launch counted on `fn.launches` (CUDA). RuntimeError under
    autograd: no backward."""
    what = fn.__name__
    refuse_grad(what, q, k, v)
    kv_len = _kv_len(k, kv_len)
    _check(what, q, kv_len, k=(k, q.shape[-1]), v=(v, q.shape[-1]))
    if q.device.type == "cpu":
        return plain(q, k, v, kv_len)
    out = _launchable(what, q, k=k, v=v)
    if k.dtype not in _DTYPES or v.dtype != k.dtype:
        raise TypeError(f"{what}: the kernel takes fp32 or bf16 K/V of one "
                        f"dtype, got {k.dtype} and {v.dtype}")
    B, _, H, D = q.shape
    lib = _build.load_library()
    n_split, chunk, warps = _launch_plan(B * H, kv_len, q.device,
                                         k.element_size())
    err = lib.wt_decode_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H,
        k.shape[2], D, kv_len, int(q.dtype == torch.bfloat16),
        int(k.dtype == torch.bfloat16), int(p_round), int(cast_kv),
        n_split, chunk, warps, _stream(q))
    _build.check(lib, err, what)
    fn.launches += 1
    return out


def _run_q8(fn, q, k, k_scale, v, v_scale, kv_len) -> torch.Tensor:
    """An int8 read: check, then the plain version (CPU) or one kernel
    launch counted on `fn.launches` (CUDA). RuntimeError under autograd:
    no backward."""
    what = fn.__name__
    refuse_grad(what, q, k, k_scale, v, v_scale)
    kv_len = _kv_len(k, kv_len)
    D = q.shape[-1]
    _check(what, q, kv_len, k=(k, D), v=(v, D), k_scale=(k_scale, 1),
           v_scale=(v_scale, 1))
    if q.device.type == "cpu":
        return decode_attention_q8_plain(q, k, k_scale, v, v_scale, kv_len)
    out = _launchable(what, q, k=k, k_scale=k_scale, v=v, v_scale=v_scale)
    if k.dtype != torch.int8 or v.dtype != torch.int8:
        raise TypeError(f"{what}: the kernel takes int8 K/V, got {k.dtype} "
                        f"and {v.dtype}")
    if k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32:
        raise TypeError(f"{what}: the kernel takes fp32 scales")
    B, _, H, D = q.shape
    lib = _build.load_library()
    n_split, chunk, warps = _launch_plan(B * H, kv_len, q.device,
                                         k.element_size())
    err = lib.wt_decode_attention_q8(
        q.data_ptr(), k.data_ptr(), k_scale.data_ptr(), v.data_ptr(),
        v_scale.data_ptr(), out.data_ptr(), B, H, k.shape[2], D, kv_len,
        int(q.dtype == torch.bfloat16), n_split, chunk, warps, _stream(q))
    _build.check(lib, err, what)
    fn.launches += 1
    return out


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------

def decode_attention_bh(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        kv_len: Optional[int] = None) -> torch.Tensor:
    """Single-token attention over a (padded) cache (:297).

    Args:
      q: (B, 1, H, D) fp32 or bf16.
      k, v: (B, H, S, D) fp32 or bf16, cast to q's dtype.
      kv_len: keys [0, kv_len) are valid (None: all S).
    Returns:
      (B, 1, H, D) in q's dtype. CPU tensors take the plain version; CUDA
      tensors launch the kernel or raise.
    """
    return _run(decode_attention_bh, q, k, v, kv_len, cast_kv=True,
                p_round=False, plain=decode_attention_bh_plain)


def decode_attention_bg(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        kv_len: Optional[int] = None, *,
                        block_b: int = 8) -> torch.Tensor:
    """The batch-grouped form (:185): decode_attention_bh's contract, with
    block_b (default 8) dividing the batch, else ValueError. block_b is the
    JAX grid's rows per program; on the card the kernel keeps one block
    per (b, h) (csrc/decode_attention.cu)."""
    _check_block_b(q, block_b)
    return _run(decode_attention_bg, q, k, v, kv_len, cast_kv=True,
                p_round=False, plain=decode_attention_bh_plain)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_len: Optional[int] = None) -> torch.Tensor:
    """The per-(batch, head) form (:354): K/V are not cast to q's dtype,
    and p is rounded to V's dtype before the p.v product. Shapes as
    `decode_attention_bh`."""
    return _run(decode_attention, q, k, v, kv_len, cast_kv=False,
                p_round=True, plain=decode_attention_plain)


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
    return _run_q8(decode_attention_q8_bh, q, k, k_scale, v, v_scale, kv_len)


def decode_attention_q8(q: torch.Tensor, k: torch.Tensor,
                        k_scale: torch.Tensor, v: torch.Tensor,
                        v_scale: torch.Tensor,
                        kv_len: Optional[int] = None) -> torch.Tensor:
    """The per-(batch, head) form (:525): the same contract and, on CUDA,
    the same kernel as `decode_attention_q8_bh`, counted apart."""
    return _run_q8(decode_attention_q8, q, k, k_scale, v, v_scale, kv_len)


# kernel launches (CPU calls not counted)
decode_attention_bh.launches = 0
decode_attention_bg.launches = 0
decode_attention.launches = 0
decode_attention_q8_bh.launches = 0
decode_attention_q8.launches = 0
