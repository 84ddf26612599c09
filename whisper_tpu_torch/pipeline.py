"""End-to-end transcription on one device (whisper_tpu/pipeline.py:64
WhisperPipeline, the single-window greedy part, with the decode rules).

The pipeline owns the params on its device in the compute dtype and runs
mel -> encoder -> prefill -> greedy loop. It defaults to `cuda` and
raises when CUDA is absent: only an explicit `device="cpu"` runs the
plain CPU versions of the kernels.

Quantization. `quant="auto"` applies the JAX package's serving policy
(config.apply_serving_quant, with `batch_hint` as the effective decode
rows) and gives exactly the config the JAX pipeline would; `quant="off"`
runs the config as given, quant flags included. The port's default is
"off", where the JAX pipeline's is "auto": every gate of that policy was
set by TPU measurements, and the port's own policy waits for the H100's
A/Bs (ROADMAP Queue 1 item 8). With `weight_quant` the decoder weights
are quantized after the cast to the compute dtype, as in JAX.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from whisper_tpu_torch.config import (
    WhisperConfig,
    apply_serving_quant,
    get_config,
)
from whisper_tpu_torch.tokenizer import Tokenizer, build_prompt
from whisper_tpu_torch import weights as weights_lib
from whisper_tpu_torch.audio import log_mel_spectrogram, pad_or_trim
from whisper_tpu_torch.decode import DecodeResult, encode, greedy_decode
from whisper_tpu_torch.decode_rules import DecodeOptions, non_speech_tokens
from whisper_tpu_torch.models.whisper import (
    compute_dtype,
    quantize_weights_wq,
)


@dataclasses.dataclass
class Transcription:
    text: str
    tokens: list[int]
    timings: dict[str, float]


def resolve_device(device) -> torch.device:
    """torch.device(device), refusing a CUDA device when CUDA is absent."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch.cuda is not "
                           "available; pass device='cpu' to run the plain "
                           "CPU versions")
    return device


class WhisperPipeline:
    def __init__(self, cfg: WhisperConfig | str, params,
                 device="cuda", tokenizer: Optional[Tokenizer] = None,
                 quant: str = "off", batch_hint: Optional[int] = None):
        """params: a params tree of CPU or device tensors (fp32). The
        pipeline casts it by the JAX package's rule (rank >= 2 leaves take
        the compute dtype, weights.to_device) and moves it to `device`.
        quant: "off" (default) or "auto" (the JAX serving policy, see the
        module docstring); batch_hint: effective decode rows (batch x beam
        width) for the policy's small-batch gate, None for batched
        serving."""
        if quant not in ("auto", "off"):
            raise ValueError(f"quant must be 'auto' or 'off', got {quant!r}")
        self.cfg = get_config(cfg) if isinstance(cfg, str) else cfg
        if quant == "auto":
            self.cfg = apply_serving_quant(self.cfg, batch=batch_hint)
        self.device = resolve_device(device)
        dtype = compute_dtype(self.cfg)
        self.params = weights_lib.to_device(
            params, self.device, None if dtype == torch.float32 else dtype)
        if self.cfg.weight_quant:
            self.params = quantize_weights_wq(self.params, self.cfg)
        self.tokenizer = tokenizer or Tokenizer(config=self.cfg)

    # ---- constructors (model: family name or a WhisperConfig) ----
    @staticmethod
    def _config(model, dtype: str) -> WhisperConfig:
        cfg = get_config(model) if isinstance(model, str) else model
        return cfg.replace(compute_dtype=dtype)

    @classmethod
    def from_flat_bin(cls, path: str, model="tiny", dtype: str = "float32",
                      device="cuda", vocab_path: Optional[str] = None,
                      quant: str = "off", batch_hint: Optional[int] = None
                      ) -> "WhisperPipeline":
        """Load a reference-format headerless fp32 weight blob. vocab_path:
        the model's vocab.txt (default: the bundled 51,865-entry table,
        which large-v3 and turbo outgrow)."""
        cfg = cls._config(model, dtype)
        tokenizer = Tokenizer(vocab_path, config=cfg)
        return cls(cfg, weights_lib.from_flat_bin_path(path, cfg), device,
                   tokenizer, quant, batch_hint)

    @classmethod
    def from_random(cls, model="tiny", seed: int = 0, dtype: str = "float32",
                    device="cuda", vocab_path: Optional[str] = None,
                    quant: str = "off", batch_hint: Optional[int] = None
                    ) -> "WhisperPipeline":
        """Random weights from a numpy seed, for benchmarks and tests."""
        cfg = cls._config(model, dtype)
        tokenizer = Tokenizer(vocab_path, config=cfg)
        return cls(cfg, weights_lib.init_params(cfg, seed), device, tokenizer,
                   quant, batch_hint)

    @classmethod
    def from_params(cls, params, model="tiny", dtype: str = "float32",
                    device="cuda", vocab_path: Optional[str] = None,
                    quant: str = "off", batch_hint: Optional[int] = None
                    ) -> "WhisperPipeline":
        """A params tree of the port's tensors (weights.from_jax_params
        converts the JAX package's tree)."""
        cfg = cls._config(model, dtype)
        return cls(cfg, params, device, Tokenizer(vocab_path, config=cfg),
                   quant, batch_hint)

    # ---- decode options ----
    def make_options(self, timestamps: bool = False,
                     suppress_nonspeech: bool = False) -> DecodeOptions:
        """The standard rule stack for greedy decoding (:142); sampling and
        beam options come with their strategies (ROADMAP Queue 1 item 9)."""
        suppress = (non_speech_tokens(self.cfg, self.tokenizer)
                    if suppress_nonspeech else ())
        return DecodeOptions(suppress_tokens=suppress,
                             suppress_blank=suppress_nonspeech,
                             timestamps=timestamps)

    # ---- inference ----
    def prompt(self, batch: int, language: str = "en",
               task: str = "transcribe", timestamps: bool = False
               ) -> torch.Tensor:
        ids = build_prompt(self.cfg, language, task, timestamps=timestamps)
        return torch.tensor([ids] * batch, dtype=torch.long,
                            device=self.device)

    def transcribe_batch(self, audio: np.ndarray, language: str = "en",
                         max_new: Optional[int] = None,
                         logit_bias: Optional[torch.Tensor] = None,
                         opts: Optional[DecodeOptions] = None
                         ) -> DecodeResult:
        """audio: (B, n_samples) fp32, one 30 s window per row (pad_or_trim
        first); opts: the rule stack (make_options). Returns the
        DecodeResult on the pipeline's device."""
        audio = np.asarray(audio, dtype=np.float32)
        if audio.ndim != 2 or audio.shape[1] != self.cfg.n_samples:
            raise ValueError(f"transcribe_batch takes (B, {self.cfg.n_samples})"
                             f" audio, got {audio.shape}")
        wav = torch.from_numpy(audio).to(self.device)
        mel = log_mel_spectrogram(wav, self.cfg)
        enc_out = encode(self.params, self.cfg, mel)
        timestamps = bool(opts and opts.timestamps)
        return greedy_decode(self.params, self.cfg, enc_out,
                             self.prompt(audio.shape[0], language,
                                         timestamps=timestamps),
                             max_new=max_new, logit_bias=logit_bias,
                             opts=opts)

    def transcribe_window(self, audio: np.ndarray, language: str = "en",
                          max_new: Optional[int] = None) -> Transcription:
        """Greedy transcription of one <= 30 s window."""
        t0 = time.perf_counter()
        wav = pad_or_trim(audio, self.cfg.n_samples)[None]
        mel = log_mel_spectrogram(torch.from_numpy(wav).to(self.device),
                                  self.cfg)
        enc_out = encode(self.params, self.cfg, mel)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t1 = time.perf_counter()
        res = greedy_decode(self.params, self.cfg, enc_out,
                            self.prompt(1, language), max_new=max_new)
        ids = res.tokens[0, :int(res.lengths[0])].tolist()
        t2 = time.perf_counter()
        text = self.tokenizer.decode(ids)
        t3 = time.perf_counter()
        return Transcription(text=text, tokens=ids,
                             timings={"mel_s": t1 - t0, "decode_s": t2 - t1,
                                      "detok_s": t3 - t2, "total_s": t3 - t0})


def load_wav(path: str, target_rate: int = 16_000) -> np.ndarray:
    """WAV file -> mono fp32 at target_rate (whisper_tpu/pipeline.py:348
    load_wav; linear-interpolation resampling)."""
    import wave

    with wave.open(path, "rb") as w:
        rate, n = w.getframerate(), w.getnframes()
        width, channels = w.getsampwidth(), w.getnchannels()
        raw = w.readframes(n)
    if width == 2:
        x = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif width == 4:
        x = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif width == 1:
        x = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0
             ) / 128.0
    else:
        raise ValueError(f"unsupported WAV sample width {width}")
    if channels > 1:
        x = x.reshape(-1, channels).mean(axis=1)
    if rate != target_rate:
        t_old = np.arange(len(x)) / rate
        t_new = np.arange(int(len(x) * target_rate / rate)) / target_rate
        x = np.interp(t_new, t_old, x).astype(np.float32)
    return x
