"""Tracing and timing (whisper_tpu/utils/profiling.py).

  * PhaseTimer — context-managed wall-clock phases. A phase whose `sync`
    holds CUDA tensors ends after `torch.cuda.synchronize()` on their
    devices (JAX's `block_until_ready`), so a phase times the device work
    it enqueued, not the enqueue.
  * trace() — a torch.profiler capture of the enclosed region, written as
    a Chrome trace (`trace.json`, viewable in Perfetto) into its log dir.
  * rtfx() — audio-seconds per wall-second.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import tempfile
import time
from typing import Any, Iterator, Optional

import torch


@dataclasses.dataclass
class TimingReport:
    phases: dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def total_s(self) -> float:
        return sum(self.phases.values())

    def as_dict(self) -> dict[str, float]:
        d = dict(self.phases)
        d["total_s"] = self.total_s
        return d

    def __str__(self) -> str:
        parts = [f"{k}={v * 1e3:.1f}ms" for k, v in self.phases.items()]
        return " ".join(parts) + f" total={self.total_s * 1e3:.1f}ms"


def _cuda_devices(tree: Any, out: set) -> set:
    """The CUDA devices of the tensors in a tree of tensors, dicts, lists,
    tuples (named tuples included) and dataclasses."""
    if isinstance(tree, torch.Tensor):
        if tree.is_cuda:
            out.add(tree.device)
    elif isinstance(tree, dict):
        for v in tree.values():
            _cuda_devices(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _cuda_devices(v, out)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            _cuda_devices(getattr(tree, f.name), out)
    return out


def block_until_ready(tree: Any) -> Any:
    """Wait for the device work behind every CUDA tensor of `tree`; CPU
    tensors and other values need no wait. Returns `tree`."""
    for dev in _cuda_devices(tree, set()):
        torch.cuda.synchronize(dev)
    return tree


class PhaseTimer:
    """Accumulating per-phase timer.

    with timer.phase("encode", sync=enc_out):
        enc_out.copy_(encoder_forward(...))

    The phase's end time is taken after a synchronize on the devices of
    the CUDA tensors in `sync`, so asynchronous launches do not make
    phases look free.
    """

    def __init__(self):
        self.report = TimingReport()

    def _add(self, name: str, seconds: float) -> None:
        self.report.phases[name] = self.report.phases.get(name, 0.0) + seconds

    @contextlib.contextmanager
    def phase(self, name: str, sync: Any = None) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            block_until_ready(sync)
            self._add(name, time.perf_counter() - t0)

    def timed(self, name: str, fn, *args, **kwargs):
        """Run fn, wait for its result's device work, record the phase,
        return the result."""
        t0 = time.perf_counter()
        out = block_until_ready(fn(*args, **kwargs))
        self._add(name, time.perf_counter() - t0)
        return out


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
