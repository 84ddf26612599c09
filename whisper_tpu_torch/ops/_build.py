"""Builds the port's CUDA kernels at first use and binds them with ctypes.

Route: one nvcc per `csrc/*.cu`, all started together, compiles each
source to an object with a plain C interface (no PyTorch headers, so the
build takes seconds, not minutes); one more nvcc links them into a shared
library, which ctypes loads. The library lands in `_build/` beside the
package (listed in .gitignore), named by a hash of the sources and the
flags, so an edited kernel is rebuilt and an unchanged one is reused.

Every C entry point launches on the stream it is given, allocates
nothing, and returns `cudaGetLastError()` after its launches; `check`
turns a non-zero value into an exception. Nothing here falls back: a
missing nvcc or a failed build raises.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_BUILD_TIMEOUT_S = 600


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin): the port's "
                       "kernels are built from csrc/ with the CUDA toolkit")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libwhisper_kernels_{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, float, str]:
    """Compile the kernels unless the library for these sources exists.
    Returns (library path, seconds spent compiling, compiler output —
    with -Xptxas -v, each kernel's registers, shared memory and spills)."""
    so = library_path()
    log = so.with_suffix(".log")
    if so.exists():
        return so, 0.0, log.read_text() if log.exists() else ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as objs, \
            concurrent.futures.ThreadPoolExecutor() as pool:
        steps = [[nvcc, *NVCC_FLAGS, "-c", "-o", f"{objs}/{src.stem}.o",
                  str(src)] for src in sorted(CSRC.glob("*.cu"))]
        runs = list(pool.map(_run, steps))
        runs.append(_run([nvcc, "-shared", "-o", str(tmp),
                          *[cmd[-2] for cmd in steps]]))
    seconds = time.perf_counter() - t0
    text = "".join(r.stdout + r.stderr for r in runs)
    log.write_text(text)
    os.replace(tmp, so)          # atomic: a concurrent loader sees all or none
    return so, seconds, text


def _run(cmd: list[str]) -> subprocess.CompletedProcess:
    """One nvcc step; raises with the end of its output when it fails."""
    r = subprocess.run(cmd, capture_output=True, text=True,
                       timeout=_BUILD_TIMEOUT_S)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed with code {r.returncode} on "
                           f"{cmd[-1]}:\n{(r.stdout + r.stderr)[-6000:]}")
    return r


_load_lock = threading.Lock()
_library: ctypes.CDLL | None = None


def load_library() -> ctypes.CDLL:
    """Build if needed, load once, and declare every entry point's C
    signature (pointers and the stream as c_void_p, so none is cut to 32
    bits). Thread-safe: threads whose first calls meet wait for one build
    and one load."""
    global _library
    if _library is None:
        with _load_lock:
            if _library is None:
                _library = _load_library()
    return _library


def _load_library() -> ctypes.CDLL:
    so, _, _ = build()
    lib = ctypes.CDLL(str(so))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.wt_encoder_tail.argtypes = [
        P, P, P, P,            # q, k, v, h_in
        P, P, P, P,            # wo, fc1, fc2, misc (fp32)
        P, P, P, P,            # attn scratch, lse (or None), workspace, out
        I, I, I, I, I, I, I,   # B, T, S, H, D, d, ff
        F, I, P]               # eps, is_bf16, stream
    lib.wt_encoder_tail.restype = I
    lib.wt_encoder_tail_smem.argtypes = [I, I, I]             # d, ff, q8
    lib.wt_encoder_tail_smem.restype = ctypes.c_longlong
    # rows, d, ff, element bytes, int8 form
    lib.wt_encoder_tail_workspace.argtypes = [I, I, I, I, I]
    lib.wt_encoder_tail_workspace.restype = ctypes.c_longlong
    lib.wt_encoder_tail_q8.argtypes = [
        P, P, P, P,            # q, k, v, h_in
        P, P, P, P,            # wo (int8 or bf16), fc1, fc2 (int8), misc
        P, P, P,               # attn scratch, workspace, out
        I, I, I, I, I, I, I,   # B, T, S, H, D, d, ff
        F, I, P]               # eps, o_q, stream
    lib.wt_encoder_tail_q8.restype = I
    lib.wt_cache_append.argtypes = [
        P, P, P, P,            # cache_k, cache_v, k_new, v_new
        ctypes.c_longlong,     # rows = L*B*H
        I, I, I, I, P]         # S, D, pos, elem (fp32/bf16/int8), stream
    lib.wt_cache_append.restype = I
    lib.wt_cache_append_ragged.argtypes = [
        P, P, P, P,            # cache_k, cache_v, k_new, v_new
        P,                     # pos (B,) int64, on the device
        ctypes.c_longlong,     # rows = L*B*H
        I, I, I, I,            # B, H, S, D
        I, P]                  # elem (fp32/bf16/int8), stream
    lib.wt_cache_append_ragged.restype = I
    L = ctypes.c_longlong
    lib.wt_flash_attention.argtypes = [
        P, P, P, P, P,         # q, k, v, out, lse (fp32, or None)
        I, I, I, I, I,         # B, T, S, H, D
        I, I, I,               # kv_len, q_offset, causal
        L, L, L,               # q strides (b, t, h)
        L, L, L, L, L, L,      # k strides (b, h, s), v strides (b, h, s)
        I, P]                  # is_bf16, stream
    lib.wt_flash_attention.restype = I
    lib.wt_flash_attention_backward.argtypes = [
        P, P, P, P, P, P,      # q, k, v, out, lse, d_out
        P, P, P, P,            # dq, dk, dv, delta scratch
        I, I, I, I, I,         # B, T, S, H, D
        I, I, I,               # kv_len, q_offset, causal
        L, L, L,               # q strides (b, t, h)
        L, L, L, L, L, L,      # k strides (b, h, s), v strides (b, h, s)
        P]                     # stream
    lib.wt_flash_attention_backward.restype = I
    # stage, its buffers (an array of pointers), rows, d, ff, eps, stream
    lib.wt_encoder_tail_bwd.argtypes = [
        I, ctypes.POINTER(ctypes.c_void_p), I, I, I, F, P]
    lib.wt_encoder_tail_bwd.restype = I
    lib.wt_encoder_tail_bwd_workspace.argtypes = [I, I, I]   # rows, d, ff
    lib.wt_encoder_tail_bwd_workspace.restype = L
    lib.wt_decode_attention_q8.argtypes = [
        P, P, P, P, P, P,      # q, k, k_scale, v, v_scale, out
        I, I, I, I, I,         # B, H, S, D, kv_len
        I,                     # q_is_bf16
        I, I, I,               # n_split, chunk, warps
        P]                     # stream
    lib.wt_decode_attention_q8.restype = I
    lib.wt_decode_attention.argtypes = [
        P, P, P, P,            # q, k, v, out
        I, I, I, I, I,         # B, H, S, D, kv_len
        I, I, I, I,            # q_is_bf16, kv_is_bf16, p_round, cast_kv
        I, I, I,               # n_split, chunk, warps
        P]                     # stream
    lib.wt_decode_attention.restype = I
    lib.wt_fused_decoder_step.argtypes = [
        P, P, P, P, P, P, P,   # h0, wqkv, wcq, wo, wco, fc1, fc2
        P,                     # vec (fp32)
        P, P, P, P,            # self_k, self_v, cross_k, cross_v
        P, P, P,               # h_out, k_new, v_new
        P, L,                  # scratch (fp32) and its length
        I, I, I, I, I, I,      # L, B, H, D, d, ff
        I, I, I,               # S_self, S_cross, kv_len
        F, I,                  # eps, is_bf16
        P, I,                  # stamps (int64 pairs, or None), their count
        P]                     # stream
    lib.wt_fused_decoder_step.restype = I
    lib.wt_fused_decoder_step_scratch.argtypes = [I, I, I, I]   # B, H, d, ff
    lib.wt_fused_decoder_step_scratch.restype = L
    lib.wt_error_string.argtypes = [I]
    lib.wt_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        msg = lib.wt_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
