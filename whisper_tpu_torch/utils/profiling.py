"""Tracing and timing (whisper_tpu/utils/profiling.py).

  * The tracer: spans and point events recorded inside the
    program at its layer boundaries (the engine's step, fill, token issue
    and device read; the decode loop's prefill, steps and polls), kept in
    memory between start() and stop(). Off by default: span() then
    returns one shared no-op context manager after a single flag check,
    allocates nothing and reads no clock.
  * trace() — a torch.profiler capture of the enclosed region, written as
    a Chrome trace (`trace.json`, viewable in Perfetto) into its log dir.
  * rtfx() — audio-seconds per wall-second.

Spans carry `time.time_ns()` stamps, the clock of torch.profiler's kineto
events, so a span and the runtime calls and kernels issued inside it line
up with no mapping. Each records its parent: the innermost span open on
the same thread when it opened. Records are appended to one list as spans
close, an operation the interpreter lock keeps whole.

    from whisper_tpu_torch.utils import profiling
    profiling.start()
    ...                                  # engine steps, transcribe_batch
    records = profiling.stop()           # {"spans", "start_ns", "stop_ns"}
"""

from __future__ import annotations

import contextlib
import itertools
import os
import tempfile
import threading
import time
from typing import Iterator, Optional

import torch

_on = False                       # the one flag span() reads when off
_records: list = []               # closed spans and events, in close order
_ids = itertools.count(1)
_local = threading.local()        # .open: this thread's open spans
_started_ns = 0


class _NoSpan:
    """What span() returns when tracing is off: enters, exits, takes an
    attribute and drops it, and is false, so that a caller can skip
    building an attribute that costs something (`if sp: sp[k] = ...`)."""
    __slots__ = ()

    def __enter__(self) -> "_NoSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False

    def __bool__(self) -> bool:
        return False

    def __setitem__(self, key, value) -> None:
        pass


_NO_SPAN = _NoSpan()


class Span:
    """One record: name, id, parent id (0 at the top), start and end in
    epoch ns, attributes. `sp[key] = value` sets an attribute
    while the span is open."""
    __slots__ = ("name", "id", "parent", "start_ns", "end_ns", "attrs")

    def __init__(self, name: str):
        self.name = name
        self.attrs: Optional[dict] = None
        stack = _open()
        self.parent = stack[-1].id if stack else 0
        self.id = next(_ids)

    def __setitem__(self, key, value) -> None:
        if self.attrs is None:
            self.attrs = {}
        self.attrs[key] = value

    def __enter__(self) -> "Span":
        _local.open.append(self)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.end_ns = time.time_ns()
        _local.open.pop()
        _records.append(self)
        return False

    def as_dict(self) -> dict:
        return {"name": self.name, "id": self.id, "parent": self.parent,
                "start_ns": self.start_ns, "end_ns": self.end_ns,
                "attrs": dict(self.attrs or {})}


def _open() -> list:
    """This thread's stack of open spans."""
    stack = getattr(_local, "open", None)
    if stack is None:
        stack = _local.open = []
    return stack


def span(name: str):
    """A context manager that records `name` from entry to exit while
    tracing is on; the shared no-op otherwise."""
    if not _on:
        return _NO_SPAN
    return Span(name)


def event(name: str, at_ns: int, **attrs) -> None:
    """A point record at `at_ns` (epoch ns), a child of the span open on
    this thread. Call it only while tracing() is true."""
    ev = Span(name)
    ev.start_ns = ev.end_ns = at_ns
    ev.attrs = attrs
    _records.append(ev)


def tracing() -> bool:
    return _on


def start() -> None:
    """Drop every record and turn tracing on."""
    global _on, _started_ns
    _records.clear()
    _started_ns = time.time_ns()
    _on = True


def stop() -> dict:
    """Turn tracing off and take the records: {"spans": [dict, in close
    order], "start_ns", "stop_ns"}."""
    global _on
    _on = False
    out = {"spans": [r.as_dict() for r in _records],
           "start_ns": _started_ns, "stop_ns": time.time_ns()}
    _records.clear()
    return out


@contextlib.contextmanager
def paused() -> Iterator[None]:
    """Record nothing inside: work that belongs to no request (warm-up)."""
    global _on
    was, _on = _on, False
    try:
        yield
    finally:
        _on = was


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None) -> Iterator[str]:
    """Capture a torch.profiler trace of the enclosed region (CPU
    activity, and CUDA activity when a card is present) and write it to
    `log_dir/trace.json` as a Chrome trace. Default log dir: a
    `whisper_tpu_torch_trace` directory under the temporary directory.
    Yields the log dir."""
    from torch.profiler import ProfilerActivity, profile

    log_dir = log_dir or os.path.join(tempfile.gettempdir(),
                                      "whisper_tpu_torch_trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def rtfx(audio_seconds: float, wall_seconds: float) -> float:
    """Real-time factor: audio seconds transcribed per wall-clock second."""
    return audio_seconds / max(wall_seconds, 1e-12)
