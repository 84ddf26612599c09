"""Runtime utilities (whisper_tpu/utils): the in-program tracer and a
torch.profiler trace capture (profiling.py), RTFx, the text-quality
metrics (metrics.py) and the roofline cost model (perf_model.py)."""

from whisper_tpu_torch.utils.profiling import rtfx, trace

__all__ = ["rtfx", "trace"]
