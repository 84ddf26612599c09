"""In-place KV-cache row append (whisper_tpu/ops/cache_append.py:62
cache_append_rows).

All L layers' new K/V rows (L, B, H, D) land at row `pos` of the
(L, B, H, S, D) caches, in place. The decode step (models/whisper.py
decoder_step_ip) calls it once, after its layer loop: the step's
self-attention reads the cache strictly below `pos` and adds the current
token as an explicit softmax term, so no layer needs its own row written
first.

`cache_append_rows` launches the hand-written CUDA kernel
(csrc/cache_append.cu, which carries the design note) for CUDA tensors and
runs `cache_append_rows_plain` (indexed assignment) for CPU tensors. Both
write into the given tensors and return them; neither makes a copy.
"""

from __future__ import annotations

import torch

from whisper_tpu_torch.ops import _build

_DTYPES = (torch.float32, torch.bfloat16)


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
    plain version; CUDA tensors (fp32 or bf16, contiguous) launch the
    kernel or raise."""
    pos = int(pos)
    _check(cache_k, cache_v, k_new, v_new, pos)
    if cache_k.device.type == "cpu":
        return cache_append_rows_plain(cache_k, cache_v, k_new, v_new, pos)
    if cache_k.device.type != "cuda":
        raise ValueError(f"cache_append_rows: no kernel for device "
                         f"{cache_k.device}")
    if cache_k.dtype not in _DTYPES:
        raise TypeError(f"cache_append_rows: no kernel for {cache_k.dtype}")
    for name, t in (("cache_k", cache_k), ("cache_v", cache_v),
                    ("k_new", k_new), ("v_new", v_new)):
        if not t.is_contiguous():
            raise ValueError(f"cache_append_rows: {name} is not contiguous")
    L, B, H, S, D = cache_k.shape
    lib = _build.load_library()
    err = lib.wt_cache_append(
        cache_k.data_ptr(), cache_v.data_ptr(), k_new.data_ptr(),
        v_new.data_ptr(), L * B * H, S, D, pos,
        int(cache_k.dtype == torch.bfloat16),
        torch.cuda.current_stream(cache_k.device).cuda_stream)
    _build.check(lib, err, "cache_append_rows")
    cache_append_rows.launches += 1
    return cache_k, cache_v


cache_append_rows.launches = 0      # kernel launches (CPU calls not counted)
