"""Runtime utilities (whisper_tpu/utils): per-phase timers with device
sync, torch.profiler trace capture, RTFx, the text-quality metrics
(metrics.py) and the roofline cost model (perf_model.py)."""

from whisper_tpu_torch.utils.profiling import (
    PhaseTimer,
    TimingReport,
    rtfx,
    trace,
)

__all__ = ["PhaseTimer", "TimingReport", "rtfx", "trace"]
