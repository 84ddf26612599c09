"""whisper_tpu_torch — the PyTorch/CUDA port of whisper_tpu for one NVIDIA
H100.

The JAX package (`whisper_tpu`) is the reference: every module here keeps
its counterpart's name, public function names and tensor layouts (q is
(B, T, H, D); K/V and the caches are head-major (L, B, H, S, D); linear
weights are stored (in, out)), so a reader can put the two side by side.

Covered so far, for every model of the family (tiny to large-v3-turbo),
in fp32 (token-parity mode) and bf16, greedy, beam-search and sampled
decoding, also with the int8 serving stack (weight-only int8, int8
cross/self/full KV caches, the serving policy), up to the serving layer
(the dynamic batcher, the long-form driver, the HTTP/SSE server):
  - config.py        <- whisper_tpu/config.py (WhisperConfig, CONFIGS)
  - tokenizer.py     <- whisper_tpu/tokenizer.py, with its own copy of the
                        bundled table (assets/vocab.txt)
  - audio.py         <- whisper_tpu/audio.py (log-mel frontend, 80 or 128
                        bins)
  - weights.py       <- whisper_tpu/weights.py (HF state_dict,
                        safetensors, npz, flat-bin) + models/whisper.py
                        init
  - models/whisper.py<- whisper_tpu/models/whisper.py (encoder with the
                        fused tail or the tail-off branch, prefill, the
                        in-place T==1 decode step, the ragged step)
  - ops/             <- whisper_tpu/ops: the Pallas kernels on these
                        paths (encoder_block_tail, flash_attention,
                        cache_append_rows, cache_append_rows_ragged,
                        decode_attention_q8_bh / decode_attention_q8) as
                        hand-written CUDA C++ kernels for sm_90a, each with
                        a plain PyTorch twin, and the attention size
                        dispatch
  - decode_rules.py  <- whisper_tpu/decode_rules.py (suppression and
                        timestamp rules)
  - decode.py        <- whisper_tpu/decode.py (greedy and temperature
                        sampling with the rules, beam search,
                        detect_language)
  - serving_continuous.py <- whisper_tpu/serving_continuous.py (the
                        continuous-batching engine, seeded sampling)
  - pipeline.py, cli.py (one window with the temperature fallback, and
                        long-form `transcribe`: seek, conditioning, the
                        VAD gate; the JAX CLI's flags)
  - alignment.py     <- whisper_tpu/alignment.py (word timestamps)
  - formats.py       <- whisper_tpu/formats.py (SRT, VTT, TSV, JSON)
  - speculative.py   <- whisper_tpu/speculative.py (draft-and-verify
                        greedy decoding)
  - native.py        <- whisper_tpu/native.py (its own ctypes binding of
                        native/whisper_native.cpp: WAV decoding, the
                        resampler, MappedWeights, NativeDetokenizer)
  - serving.py       <- whisper_tpu/serving.py (BatchedTranscriber, the
                        dynamic batcher)
  - serving_longform.py <- whisper_tpu/serving_longform.py
                        (LongFormDriver: long files chained window by
                        window through the continuous engine)
  - server.py        <- whisper_tpu/server.py (the HTTP/SSE daemon,
                        `python -m whisper_tpu_torch.server`)
  - utils/           <- whisper_tpu/utils (metrics, profiling, the
                        roofline cost model with the H100's peaks)
  - train.py         <- whisper_tpu/train.py (the teacher-forced loss and
                        the train step, fp32, on torch.optim.AdamW with
                        optax's clip and schedule; gradients through the
                        tail and flash kernels, ops/grad.py)

The package imports torch, and neither jax nor anything of whisper_tpu.
"""

from whisper_tpu_torch.config import CONFIGS, WhisperConfig, get_config

__all__ = ["WhisperConfig", "CONFIGS", "get_config", "WhisperPipeline",
           "BatchedTranscriber", "ContinuousBatcher", "QueueFull",
           "LongFormDriver", "TranscriptionServer", "Tokenizer",
           "DecodeOptions", "speculative_decode", "spec_transcribe_window",
           "TrainBatch", "loss_fn", "make_optimizer", "train_step"]

# name -> module, imported on first access (whisper_tpu/__init__.py:31-53)
_LAZY = {
    "WhisperPipeline": "whisper_tpu_torch.pipeline",
    "BatchedTranscriber": "whisper_tpu_torch.serving",
    "ContinuousBatcher": "whisper_tpu_torch.serving_continuous",
    "QueueFull": "whisper_tpu_torch.serving_continuous",
    "LongFormDriver": "whisper_tpu_torch.serving_longform",
    "TranscriptionServer": "whisper_tpu_torch.server",
    "Tokenizer": "whisper_tpu_torch.tokenizer",
    "DecodeOptions": "whisper_tpu_torch.decode_rules",
    "speculative_decode": "whisper_tpu_torch.speculative",
    "spec_transcribe_window": "whisper_tpu_torch.speculative",
    "TrainBatch": "whisper_tpu_torch.train",
    "loss_fn": "whisper_tpu_torch.train",
    "make_optimizer": "whisper_tpu_torch.train",
    "train_step": "whisper_tpu_torch.train",
}


def __getattr__(name):
    if name in _LAZY:
        import importlib
        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module 'whisper_tpu_torch' has no attribute "
                         f"{name!r}")
