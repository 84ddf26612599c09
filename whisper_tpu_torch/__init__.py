"""whisper_tpu_torch — the PyTorch/CUDA port of whisper_tpu for one NVIDIA
H100.

The JAX package (`whisper_tpu`) is the reference: every module here keeps
its counterpart's name, public function names and tensor layouts (q is
(B, T, H, D); K/V and the caches are head-major (L, B, H, S, D); linear
weights are stored (in, out)), so a reader can put the two side by side.

Covered so far: greedy transcription with every model of the family
(tiny to large-v3-turbo), unquantized, in fp32 (token-parity mode) and
bf16 —
  - audio.py         <- whisper_tpu/audio.py (log-mel frontend, 80 or 128
                        bins)
  - weights.py       <- whisper_tpu/weights.py + models/whisper.py init
  - models/whisper.py<- whisper_tpu/models/whisper.py (encoder with the
                        fused tail or the tail-off branch, prefill, the
                        in-place T==1 decode step)
  - ops/             <- whisper_tpu/ops: the three Pallas kernels on these
                        paths (encoder_block_tail, flash_attention,
                        cache_append_rows) as hand-written CUDA C++ kernels
                        for sm_90a, each with a plain PyTorch twin, and the
                        attention size dispatch
  - decode.py        <- whisper_tpu/decode.py (greedy only)
  - pipeline.py, cli.py

The package imports torch and never jax. It reuses the jax-free modules of
whisper_tpu: config, tokenizer.
"""

from whisper_tpu.config import CONFIGS, WhisperConfig, get_config

__all__ = ["WhisperConfig", "CONFIGS", "get_config", "WhisperPipeline"]


def __getattr__(name):
    if name == "WhisperPipeline":
        from whisper_tpu_torch.pipeline import WhisperPipeline
        return WhisperPipeline
    raise AttributeError(name)
