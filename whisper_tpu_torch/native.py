"""ctypes binding of the native host runtime (native/whisper_native.cpp;
whisper_tpu/native.py): WAV decoding (PCM 8/16/24/32-bit and IEEE float,
any channel count, mixed to mono), the windowed-sinc resampler, the
mmap'ed weight view (MappedWeights, which weights.from_flat_bin_path
reads through) and the batch detokenizer (NativeDetokenizer).

g++ compiles the C++ source, with the JAX binding's flags, into
`_build/libwhisper_native.so` beside this package (listed in
.gitignore) at first use, and again when the source is newer than the
library. A build writes a file of its own and renames it into place, so
two processes never load a half-written library. Without g++ or the
source, `available()` is False and `load_audio` falls back to
pipeline.load_wav, and MappedWeights to np.memmap, as JAX's do.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_PKG = Path(__file__).resolve().parent
SRC = _PKG.parent / "native" / "whisper_native.cpp"
LIB = _PKG / "_build" / "libwhisper_native.so"
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> bool:
    LIB.parent.mkdir(parents=True, exist_ok=True)
    tmp = LIB.with_name(f"{LIB.name}.{os.getpid()}.tmp")
    try:
        r = subprocess.run(["g++", *GXX_FLAGS, str(SRC), "-o", str(tmp)],
                           capture_output=True, timeout=120)
        if r.returncode != 0:
            return False
        os.replace(tmp, LIB)
        return True
    except (OSError, subprocess.TimeoutExpired):
        return False
    finally:
        tmp.unlink(missing_ok=True)


def _load() -> Optional[ctypes.CDLL]:
    """The library, built if needed, loaded once; None when it cannot be."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not SRC.exists():
            return None
        stale = (not LIB.exists()
                 or LIB.stat().st_mtime < SRC.stat().st_mtime)
        if stale and not _build():
            return None
        try:
            lib = ctypes.CDLL(str(LIB))
        except OSError:
            return None
        fptr = ctypes.POINTER(ctypes.c_float)
        lib.wn_free.argtypes = [ctypes.c_void_p]
        lib.wn_decode_wav.restype = ctypes.c_long
        lib.wn_decode_wav.argtypes = [ctypes.c_char_p, ctypes.c_long,
                                      ctypes.POINTER(fptr),
                                      ctypes.POINTER(ctypes.c_int)]
        lib.wn_resample.restype = ctypes.c_long
        lib.wn_resample.argtypes = [fptr, ctypes.c_long, ctypes.c_int,
                                    ctypes.c_int, ctypes.POINTER(fptr)]
        lib.wn_mmap_open.restype = ctypes.c_void_p
        lib.wn_mmap_open.argtypes = [ctypes.c_char_p,
                                     ctypes.POINTER(ctypes.c_long)]
        lib.wn_mmap_close.restype = None
        lib.wn_mmap_close.argtypes = [ctypes.c_void_p, ctypes.c_long]
        lib.wn_detok_new.restype = ctypes.c_void_p
        lib.wn_detok_new.argtypes = [ctypes.c_char_p, ctypes.c_long]
        lib.wn_detok_vocab_size.restype = ctypes.c_long
        lib.wn_detok_vocab_size.argtypes = [ctypes.c_void_p]
        lib.wn_detok_decode.restype = ctypes.c_long
        lib.wn_detok_decode.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32), ctypes.c_long,
            ctypes.c_char_p, ctypes.c_long, ctypes.c_int, ctypes.c_int]
        lib.wn_detok_free.restype = None
        lib.wn_detok_free.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    """True when the native library is built and loaded."""
    return _load() is not None


def _take(lib: ctypes.CDLL, out, n: int) -> np.ndarray:
    """A copy of the n floats the library allocated at `out`, then freed."""
    try:
        return np.ctypeslib.as_array(out, shape=(n,)).copy()
    finally:
        lib.wn_free(out)


def decode_wav(data: bytes) -> tuple[np.ndarray, int]:
    """WAV bytes -> (mono float32 samples, sample rate). ValueError on a
    file the decoder rejects; RuntimeError without the library."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    out = ctypes.POINTER(ctypes.c_float)()
    rate = ctypes.c_int()
    n = lib.wn_decode_wav(data, len(data), ctypes.byref(out),
                          ctypes.byref(rate))
    if n < 0:
        raise ValueError(f"wn_decode_wav error {n}")
    return _take(lib, out, n), rate.value


def resample(x: np.ndarray, in_rate: int, out_rate: int) -> np.ndarray:
    """Windowed-sinc resampling of float32 samples."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    x = np.ascontiguousarray(x, dtype=np.float32)
    out = ctypes.POINTER(ctypes.c_float)()
    n = lib.wn_resample(x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                        len(x), in_rate, out_rate, ctypes.byref(out))
    if n < 0:
        raise MemoryError("wn_resample failed")
    return _take(lib, out, n)


def load_audio(path: str, target_rate: int = 16_000) -> np.ndarray:
    """WAV file -> mono float32 at target_rate: the native decoder and
    resampler when the library is available and takes the file, else
    pipeline.load_wav."""
    if available():
        with open(path, "rb") as f:
            data = f.read()
        try:
            x, rate = decode_wav(data)
            return resample(x, rate, target_rate) if rate != target_rate \
                else x
        except ValueError:
            pass            # a format the native decoder does not read
    from whisper_tpu_torch.pipeline import load_wav
    return load_wav(path, target_rate)


class MappedWeights:
    """A read-only mmap of a flat-bin weight file as a zero-copy
    little-endian fp32 numpy view (`floats`): wn_mmap_open when the library
    is available, else np.memmap (the same zero-copy view). `close()`
    unmaps the native mapping; `floats` is None after it, so copy what must
    outlive the map (weights.from_flat_bin does)."""

    def __init__(self, path: str):
        self._lib = _load()
        self._addr = None
        if self._lib is not None:
            size = ctypes.c_long()
            addr = self._lib.wn_mmap_open(os.fsencode(path),
                                          ctypes.byref(size))
            if addr:
                self._addr, self._size = addr, size.value
                buf = (ctypes.c_byte * self._size).from_address(addr)
                self.floats = np.frombuffer(buf, dtype="<f4")
                return
        self.floats = np.memmap(path, dtype="<f4", mode="r")

    def close(self) -> None:
        self.floats = None              # drop the view before the unmap
        if self._addr is not None:
            self._lib.wn_mmap_close(self._addr, self._size)
            self._addr = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class NativeDetokenizer:
    """Batch detokenizer over the vocab.txt contract: GPT-2 byte-level
    decoding (Tokenizer.decode) and the reference's lossy mode
    (Tokenizer.decode_reference). RuntimeError without the library."""

    def __init__(self, vocab_path: str):
        lib = _load()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        with open(vocab_path, "rb") as f:
            data = f.read()
        self._h = lib.wn_detok_new(data, len(data))
        if not self._h:
            raise RuntimeError("wn_detok_new failed")

    @property
    def vocab_size(self) -> int:
        return self._lib.wn_detok_vocab_size(self._h)

    def decode(self, ids, skip_special: bool = True,
               reference_mode: bool = False) -> str:
        arr = np.ascontiguousarray(ids, dtype=np.int32)
        cap = max(64, 8 * len(arr))
        for _ in range(2):              # a negative return is the size needed
            buf = ctypes.create_string_buffer(cap)
            n = self._lib.wn_detok_decode(
                self._h, arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                len(arr), buf, cap, int(skip_special), int(reference_mode))
            if n >= 0:
                return buf.raw[:n].decode("utf-8", errors="replace")
            cap = -n
        raise RuntimeError("detok buffer sizing failed")

    def close(self) -> None:
        if self._h:
            self._lib.wn_detok_free(self._h)
            self._h = None

    def __del__(self):
        if getattr(self, "_h", None):
            self.close()
