"""In-place KV-cache row appends (whisper_tpu/ops/cache_append.py:62
cache_append_rows, :133 cache_append_rows_ragged).

All L layers' new K/V rows (L, B, H, D) land at row `pos` of the
(L, B, H, S, D) caches, in place: one shared `pos` for the greedy step
(models/whisper.py decoder_step_ip), one position per batch row, a (B,)
tensor on the device, for the continuous-batching engine's step
(decoder_step_ragged). Each step calls its append once, after its layer
loop: the step's self-attention reads the cache strictly below `pos` and
adds the current token as an explicit softmax term, so no layer needs its
own row written first.

Each wrapper launches its hand-written CUDA kernel (csrc/cache_append.cu,
which carries the design note) for CUDA tensors and runs its plain version
(indexed assignment) for CPU tensors. Both take fp32, bf16 and int8
caches: an int8 self cache's rows arrive quantized (models/whisper.py
decoder_step_ip, decoder_step_ragged), and the caller writes their scale
rows. Both write into the given tensors and return them; neither makes a
copy. The ragged wrapper never reads
`pos` on the host: the kernel reads it from device memory. Neither has a
backward: both raise under autograd (ops/grad.py).
"""

from __future__ import annotations

import torch

from whisper_tpu_torch.ops import _build
from whisper_tpu_torch.ops.grad import refuse_grad

# the kernels' element types, by the code their C entry points take
_APPEND_ELEM = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def cache_append_rows_plain(cache_k, cache_v, k_new, v_new, pos: int):
    """Indexed assignment: the plain version, in place."""
    cache_k[:, :, :, pos, :] = k_new
    cache_v[:, :, :, pos, :] = v_new
    return cache_k, cache_v


def _check(cache_k, cache_v, k_new, v_new, pos: int) -> None:
    L, B, H, S, D = cache_k.shape
    for name, t, shape in (("cache_v", cache_v, (L, B, H, S, D)),
                           ("k_new", k_new, (L, B, H, D)),
                           ("v_new", v_new, (L, B, H, D))):
        if tuple(t.shape) != shape:
            raise ValueError(f"cache_append_rows: {name} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
        if t.dtype != cache_k.dtype:
            raise TypeError(f"cache_append_rows: {name} is {t.dtype}, "
                            f"cache_k is {cache_k.dtype}")
        if t.device != cache_k.device:
            raise ValueError(f"cache_append_rows: {name} is on {t.device}, "
                             f"cache_k on {cache_k.device}")
    if not 0 <= pos < S:
        raise IndexError(f"cache_append_rows: pos {pos} outside [0, {S})")


def cache_append_rows(cache_k: torch.Tensor, cache_v: torch.Tensor,
                      k_new: torch.Tensor, v_new: torch.Tensor, pos: int
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Write k_new/v_new (L, B, H, D) at row `pos` of the (L, B, H, S, D)
    caches, in place; returns the same two tensors. CPU tensors take the
    plain version; CUDA tensors (fp32, bf16 or int8, contiguous) launch the
    kernel or raise. RuntimeError under autograd."""
    refuse_grad("cache_append_rows", cache_k, cache_v, k_new, v_new)
    pos = int(pos)
    _check(cache_k, cache_v, k_new, v_new, pos)
    if cache_k.device.type == "cpu":
        return cache_append_rows_plain(cache_k, cache_v, k_new, v_new, pos)
    if cache_k.device.type != "cuda":
        raise ValueError(f"cache_append_rows: no kernel for device "
                         f"{cache_k.device}")
    if cache_k.dtype not in _APPEND_ELEM:
        raise TypeError(f"cache_append_rows: no kernel for {cache_k.dtype}")
    for name, t in (("cache_k", cache_k), ("cache_v", cache_v),
                    ("k_new", k_new), ("v_new", v_new)):
        if not t.is_contiguous():
            raise ValueError(f"cache_append_rows: {name} is not contiguous")
    L, B, H, S, D = cache_k.shape
    lib = _build.load_library()
    err = lib.wt_cache_append(
        cache_k.data_ptr(), cache_v.data_ptr(), k_new.data_ptr(),
        v_new.data_ptr(), L * B * H, S, D, pos, _APPEND_ELEM[cache_k.dtype],
        torch.cuda.current_stream(cache_k.device).cuda_stream)
    _build.check(lib, err, "cache_append_rows")
    cache_append_rows.launches += 1
    return cache_k, cache_v


cache_append_rows.launches = 0      # kernel launches (CPU calls not counted)


def set_rows(cache: torch.Tensor, new: torch.Tensor, pos: torch.Tensor
             ) -> None:
    """In place: cache[..., b, :, pos[b], :] = new[..., b, :, :] for every
    row b whose pos[b] lies in [0, S); the other rows keep their values
    (each is written at a clamped position with the value already there).
    cache (..., B, H, S, X); new (..., B, H, X); pos (B,) on the cache's
    device. The separated advanced indices (rows, pos) move to the front
    of the indexed value, so `new` is moved to (B, ..., H, X) to match."""
    S = cache.shape[-2]
    rows = torch.arange(pos.shape[0], device=pos.device)
    at = (Ellipsis, rows, slice(None), pos.clamp(0, S - 1), slice(None))
    value = new.movedim(-3, 0).to(cache.dtype)
    keep = ((pos >= 0) & (pos < S)).reshape((-1,) + (1,) * (value.ndim - 1))
    cache[at] = torch.where(keep, value, cache[at])


def cache_append_rows_ragged_plain(cache_k, cache_v, k_new, v_new,
                                   pos: torch.Tensor):
    """Indexed assignment (`set_rows`), the JAX fallback of
    decoder_step_ragged (whisper_tpu/models/whisper.py:1484-1489). A row
    whose pos[b] lies outside [0, S) keeps its cache as it was."""
    set_rows(cache_k, k_new, pos)
    set_rows(cache_v, v_new, pos)
    return cache_k, cache_v


def _check_ragged(cache_k, cache_v, k_new, v_new, pos) -> None:
    L, B, H, S, D = cache_k.shape
    for name, t, shape in (("cache_v", cache_v, (L, B, H, S, D)),
                           ("k_new", k_new, (L, B, H, D)),
                           ("v_new", v_new, (L, B, H, D))):
        if tuple(t.shape) != shape:
            raise ValueError(f"cache_append_rows_ragged: {name} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
        if t.dtype != cache_k.dtype:
            raise TypeError(f"cache_append_rows_ragged: {name} is {t.dtype}, "
                            f"cache_k is {cache_k.dtype}")
        if t.device != cache_k.device:
            raise ValueError(f"cache_append_rows_ragged: {name} is on "
                             f"{t.device}, cache_k on {cache_k.device}")
    if not isinstance(pos, torch.Tensor) or tuple(pos.shape) != (B,) \
            or pos.dtype != torch.int64:
        raise ValueError(f"cache_append_rows_ragged: pos must be a ({B},) "
                         f"int64 tensor")
    if pos.device != cache_k.device:
        raise ValueError(f"cache_append_rows_ragged: pos is on {pos.device}, "
                         f"cache_k on {cache_k.device}")


def cache_append_rows_ragged(cache_k: torch.Tensor, cache_v: torch.Tensor,
                             k_new: torch.Tensor, v_new: torch.Tensor,
                             pos: torch.Tensor
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Write row b of k_new/v_new (L, B, H, D) at position pos[b] of the
    (L, B, H, S, D) caches, for every layer, in place; a row whose pos[b]
    lies outside [0, S) is left untouched. pos: (B,) int64 on the caches'
    device. Returns the same two tensors. CPU tensors take the
    plain version; CUDA tensors (fp32, bf16 or int8, contiguous) launch
    the kernel or raise. RuntimeError under autograd."""
    refuse_grad("cache_append_rows_ragged", cache_k, cache_v, k_new, v_new)
    _check_ragged(cache_k, cache_v, k_new, v_new, pos)
    if cache_k.device.type == "cpu":
        return cache_append_rows_ragged_plain(cache_k, cache_v, k_new, v_new,
                                              pos)
    if cache_k.device.type != "cuda":
        raise ValueError(f"cache_append_rows_ragged: no kernel for device "
                         f"{cache_k.device}")
    if cache_k.dtype not in _APPEND_ELEM:
        raise TypeError(f"cache_append_rows_ragged: no kernel for "
                        f"{cache_k.dtype}")
    for name, t in (("cache_k", cache_k), ("cache_v", cache_v),
                    ("k_new", k_new), ("v_new", v_new), ("pos", pos)):
        if not t.is_contiguous():
            raise ValueError(f"cache_append_rows_ragged: {name} is not "
                             f"contiguous")
    L, B, H, S, D = cache_k.shape
    lib = _build.load_library()
    err = lib.wt_cache_append_ragged(
        cache_k.data_ptr(), cache_v.data_ptr(), k_new.data_ptr(),
        v_new.data_ptr(), pos.data_ptr(), L * B * H, B, H, S, D,
        _APPEND_ELEM[cache_k.dtype],
        torch.cuda.current_stream(cache_k.device).cuda_stream)
    _build.check(lib, err, "cache_append_rows_ragged")
    cache_append_rows_ragged.launches += 1
    return cache_k, cache_v


cache_append_rows_ragged.launches = 0   # kernel launches (CPU calls not counted)
