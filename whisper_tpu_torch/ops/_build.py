"""Builds the port's CUDA kernels at first use and binds them with ctypes.

Route: nvcc compiles every `csrc/*.cu` into one shared library with a
plain C interface (no PyTorch headers, so the build takes seconds, not
minutes), which ctypes loads. The library lands in `_build/` beside the
package (listed in .gitignore), named by a hash of the sources and the
flags, so an edited kernel is rebuilt and an unchanged one is reused.

Every C entry point launches on the stream it is given, allocates
nothing, and returns `cudaGetLastError()` after its launches; `check`
turns a non-zero value into an exception. Nothing here falls back: a
missing nvcc or a failed build raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
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
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *[str(p) for p in sorted(CSRC.glob("*.cu"))]]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, capture_output=True, text=True,
                       timeout=_BUILD_TIMEOUT_S)
    seconds = time.perf_counter() - t0
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed with code {r.returncode}:\n"
                           f"{r.stderr[-6000:]}")
    log.write_text(r.stdout + r.stderr)
    os.replace(tmp, so)          # atomic: a concurrent loader sees all or none
    return so, seconds, r.stdout + r.stderr


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build if needed, load once, and declare every entry point's C
    signature (pointers and the stream as c_void_p, so none is cut to 32
    bits)."""
    so, _, _ = build()
    lib = ctypes.CDLL(str(so))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.wt_encoder_tail.argtypes = [
        P, P, P, P,            # q, k, v, h_in
        P, P, P, P,            # wo, fc1, fc2, misc (fp32)
        P, P,                  # attn scratch, out
        I, I, I, I, I, I, I,   # B, T, S, H, D, d, ff
        F, I, P]               # eps, is_bf16, stream
    lib.wt_encoder_tail.restype = I
    lib.wt_cache_append.argtypes = [
        P, P, P, P,            # cache_k, cache_v, k_new, v_new
        ctypes.c_longlong,     # rows = L*B*H
        I, I, I, I, P]         # S, D, pos, is_bf16, stream
    lib.wt_cache_append.restype = I
    lib.wt_error_string.argtypes = [I]
    lib.wt_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        msg = lib.wt_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
