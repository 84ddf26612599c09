"""End-to-end transcription on one device (whisper_tpu/pipeline.py:64
WhisperPipeline): one window (greedy, beam search and sampling with the
decode rules, language detection, openai/whisper's temperature fallback
with its gates, word timestamps), and long-form audio by `transcribe`
(fixed 30 s windows, or seeking by the last closed segment when
timestamps are on; conditioning on the previous window's text, an
initial prompt, and the energy VAD gate).

The pipeline owns the params on its device in the compute dtype and runs
mel -> encoder -> prefill -> decode loop. It defaults to `cuda` and
raises when CUDA is absent: only an explicit `device="cpu"` runs the
plain CPU versions of the kernels.

Quantization. `quant="auto"` applies the JAX package's serving policy
(config.apply_serving_quant, with `batch_hint` as the effective decode
rows) and gives exactly the config the JAX pipeline would; `quant="off"`
runs the config as given, quant flags included. The port's default is
"off", where the JAX pipeline's is "auto": every gate of that policy was
set by TPU measurements, and the port's own policy waits for the H100's
A/Bs (ROADMAP Queue 1 item 6). With `weight_quant` the decoder weights
are quantized after the cast to the compute dtype, as in JAX.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence

import numpy as np
import torch

from whisper_tpu_torch.config import (
    WhisperConfig,
    apply_serving_quant,
    get_config,
)
from whisper_tpu_torch.tokenizer import (
    LANGUAGES,
    Tokenizer,
    build_prompt,
    split_segments,
)
from whisper_tpu_torch import weights as weights_lib
from whisper_tpu_torch.alignment import find_alignment_heads
from whisper_tpu_torch.alignment import word_timestamps as align_words
from whisper_tpu_torch.audio import (
    energy_vad,
    log_mel_spectrogram,
    pad_or_trim,
)
from whisper_tpu_torch.decode import (
    DecodeResult,
    decode_from_encoder,
    detect_language,
    encode,
)
from whisper_tpu_torch.decode_rules import DecodeOptions, non_speech_tokens
from whisper_tpu_torch.models.whisper import (
    compute_dtype,
    quantize_weights_wq,
)

# openai/whisper fallback thresholds (:40-43): a decode is rejected, and
# retried at the next temperature, when its text is degenerate-repetitive
# (gzip compression ratio > 2.4) or the model is unconfident (mean
# chosen-token logprob < -1.0)
COMPRESSION_RATIO_THRESHOLD = 2.4
LOGPROB_THRESHOLD = -1.0
NO_SPEECH_THRESHOLD = 0.6
FALLBACK_TEMPERATURES = (0.0, 0.2, 0.4, 0.6, 0.8, 1.0)


def compression_ratio(text: str) -> float:
    """Degenerate-repetition detector (:46, openai/whisper semantics)."""
    import zlib
    data = text.encode("utf-8")
    if not data:
        return 0.0
    return len(data) / len(zlib.compress(data))


@dataclasses.dataclass
class Transcription:
    text: str
    tokens: list[int]
    timings: dict[str, float]
    words: Optional[list] = None       # [alignment.WordTiming] on request
    segments: Optional[list] = None    # [{start, end, text}] with timestamps


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
                 quant: str = "off", batch_hint: Optional[int] = None,
                 alignment_heads: Optional[Sequence[tuple]] = None):
        """params: a params tree of CPU or device tensors (fp32). The
        pipeline casts it by the JAX package's rule (rank >= 2 leaves take
        the compute dtype, weights.to_device) and moves it to `device`.
        quant: "off" (default) or "auto" (the JAX serving policy, see the
        module docstring); batch_hint: effective decode rows (batch x beam
        width) for the policy's small-batch gate, None for batched
        serving. alignment_heads: the official (layer, head) table of word
        alignment, None for the upper half of the decoder layers."""
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
        self.alignment_heads = alignment_heads

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
        which large-v3 and turbo outgrow). An alignment-heads sidecar
        beside the file is read (alignment.find_alignment_heads)."""
        cfg = cls._config(model, dtype)
        tokenizer = Tokenizer(vocab_path, config=cfg)
        return cls(cfg, weights_lib.from_flat_bin_path(path, cfg), device,
                   tokenizer, quant, batch_hint,
                   alignment_heads=find_alignment_heads(path))

    @classmethod
    def from_npz(cls, path: str, model="tiny", dtype: str = "float32",
                 device="cuda", vocab_path: Optional[str] = None,
                 quant: str = "off", batch_hint: Optional[int] = None
                 ) -> "WhisperPipeline":
        """Load an npz written by either package's save_npz (:121), and
        the alignment-heads sidecar beside it, if any."""
        cfg = cls._config(model, dtype)
        return cls(cfg, weights_lib.load_npz(path, cfg), device,
                   Tokenizer(vocab_path, config=cfg), quant, batch_hint,
                   alignment_heads=find_alignment_heads(path))

    @classmethod
    def from_random(cls, model="tiny", seed: int = 0, dtype: str = "float32",
                    device="cuda", vocab_path: Optional[str] = None,
                    quant: str = "off", batch_hint: Optional[int] = None,
                    alignment_heads: Optional[Sequence[tuple]] = None
                    ) -> "WhisperPipeline":
        """Random weights from a numpy seed, for benchmarks and tests."""
        cfg = cls._config(model, dtype)
        tokenizer = Tokenizer(vocab_path, config=cfg)
        return cls(cfg, weights_lib.init_params(cfg, seed), device, tokenizer,
                   quant, batch_hint, alignment_heads=alignment_heads)

    @classmethod
    def from_params(cls, params, model="tiny", dtype: str = "float32",
                    device="cuda", vocab_path: Optional[str] = None,
                    quant: str = "off", batch_hint: Optional[int] = None,
                    alignment_heads: Optional[Sequence[tuple]] = None
                    ) -> "WhisperPipeline":
        """A params tree of the port's tensors (weights.from_jax_params
        converts the JAX package's tree)."""
        cfg = cls._config(model, dtype)
        return cls(cfg, params, device, Tokenizer(vocab_path, config=cfg),
                   quant, batch_hint, alignment_heads=alignment_heads)

    # ---- decode options ----
    def make_options(self, timestamps: bool = False,
                     suppress_nonspeech: bool = False,
                     temperature: float = 0.0, beam_size: int = 1,
                     length_penalty: Optional[float] = None
                     ) -> DecodeOptions:
        """The standard rule stack with the strategy's options (:142)."""
        suppress = (non_speech_tokens(self.cfg, self.tokenizer)
                    if suppress_nonspeech else ())
        return DecodeOptions(
            suppress_tokens=suppress, suppress_blank=suppress_nonspeech,
            timestamps=timestamps, temperature=temperature,
            beam_size=beam_size, length_penalty=length_penalty)

    # ---- inference ----
    def detect_language(self, enc_out: torch.Tensor) -> str:
        """The most probable language code for the first row of an
        encoder output (:157)."""
        probs = detect_language(self.params, self.cfg, enc_out)
        return LANGUAGES[int(probs[0].argmax())]

    def prompt(self, batch: int, language: str = "en",
               task: str = "transcribe", timestamps: bool = False,
               prev_tokens: Sequence[int] = ()) -> torch.Tensor:
        ids = build_prompt(self.cfg, language, task, timestamps=timestamps,
                           prev_tokens=prev_tokens)
        return torch.tensor([ids] * batch, dtype=torch.long,
                            device=self.device)

    def _encode_audio(self, audio: np.ndarray) -> torch.Tensor:
        """(B, n_samples) fp32 audio -> encoder output on the device."""
        wav = torch.from_numpy(np.ascontiguousarray(audio)).to(self.device)
        return encode(self.params, self.cfg,
                      log_mel_spectrogram(wav, self.cfg))

    def transcribe_batch(self, audio: np.ndarray, language: str = "en",
                         max_new: Optional[int] = None,
                         logit_bias: Optional[torch.Tensor] = None,
                         opts: Optional[DecodeOptions] = None,
                         generator: Optional[torch.Generator] = None
                         ) -> DecodeResult:
        """audio: (B, n_samples) fp32, one 30 s window per row (pad_or_trim
        first); opts: the rule stack and the strategy (make_options):
        beam search when opts.beam_size > 1 (which takes no logit_bias),
        sampling from `generator` (on the pipeline's device) when
        opts.temperature > 0. Returns the DecodeResult on the pipeline's
        device."""
        audio = np.asarray(audio, dtype=np.float32)
        if audio.ndim != 2 or audio.shape[1] != self.cfg.n_samples:
            raise ValueError(f"transcribe_batch takes (B, {self.cfg.n_samples})"
                             f" audio, got {audio.shape}")
        enc_out = self._encode_audio(audio)
        timestamps = bool(opts and opts.timestamps)
        return decode_from_encoder(
            self.params, self.cfg, enc_out,
            self.prompt(audio.shape[0], language, timestamps=timestamps),
            max_new=max_new, opts=opts,
            beam_size=opts.beam_size if opts is not None else 1,
            generator=generator, logit_bias=logit_bias)

    def transcribe_window(self, audio: np.ndarray, language: str = "en",
                          task: str = "transcribe",
                          max_new: Optional[int] = None,
                          opts: Optional[DecodeOptions] = None,
                          prev_tokens: tuple = (),
                          seed: int = 0,
                          fallback_temperatures: Sequence[float] = (),
                          no_speech_threshold: Optional[float] = None,
                          word_timestamps: bool = False,
                          window_offset_s: float = 0.0) -> Transcription:
        """Transcribe one <= 30 s window (:163): language="auto" detects
        the language first; with `fallback_temperatures`, openai/whisper's
        protocol retries at each temperature in turn until the text passes
        the compression-ratio and avg-logprob gates. Beam search
        (opts.beam_size) runs only at temperature 0; temperature i of the
        list samples from a generator seeded seed + i. The silence gate
        drops the text when P(no speech) > no_speech_threshold and the
        avg logprob is below LOGPROB_THRESHOLD. word_timestamps aligns the
        window's text with its audio (alignment.word_timestamps, past the
        prompt and any <|startofprev|> text); word and segment times are
        shifted by window_offset_s."""
        cfg = self.cfg
        t0 = time.perf_counter()
        enc_out = self._encode_audio(pad_or_trim(audio, cfg.n_samples)[None])
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t1 = time.perf_counter()

        if language == "auto":
            language = self.detect_language(enc_out)
        prompt = self.prompt(1, language, task,
                             timestamps=bool(opts and opts.timestamps),
                             prev_tokens=prev_tokens)
        P = prompt.shape[1]
        beam = opts.beam_size if opts is not None else 1
        base = opts or DecodeOptions()
        temps = tuple(fallback_temperatures) or (base.temperature,)

        def strip_prev(ids_full: list) -> tuple[list, int]:
            """Drop the <|startofprev|> region (:197): the gates, the text
            and the alignment read this window's tokens only. Returns (ids
            from SOT, SOT's offset in the buffer)."""
            if prev_tokens and cfg.sot_token in ids_full:
                off = ids_full.index(cfg.sot_token)
                return ids_full[off:], off
            return ids_full, 0

        ids: list[int] = []
        sot_off = 0
        res = None
        for ti, temp in enumerate(temps):
            generator = None
            if temp > 0:
                generator = torch.Generator(device=self.device)
                generator.manual_seed(seed + ti)
            res = decode_from_encoder(
                self.params, cfg, enc_out, prompt, max_new=max_new,
                opts=base._replace(temperature=float(temp)),
                beam_size=beam if temp == 0 else 1, generator=generator)
            ids, sot_off = strip_prev(
                res.tokens[0, :int(res.lengths[0])].tolist())
            if len(temps) == 1:
                break
            avg_lp = float(res.avg_logprob(P)[0])
            if (compression_ratio(self.tokenizer.decode(ids))
                    <= COMPRESSION_RATIO_THRESHOLD
                    and avg_lp >= LOGPROB_THRESHOLD):
                break
        t2 = time.perf_counter()
        if (no_speech_threshold is not None
                and float(res.no_speech_prob[0]) > no_speech_threshold
                and float(res.avg_logprob(P)[0]) < LOGPROB_THRESHOLD):
            ids = []
        text = self.tokenizer.decode(ids)
        words = segments = None
        if word_timestamps and ids:
            secs = min(len(audio) / cfg.sample_rate, cfg.chunk_length_s)
            words = align_words(self.params, cfg, self.tokenizer, ids,
                                enc_out, audio_seconds=max(secs, 1.0),
                                alignment_heads=self.alignment_heads,
                                prompt_len=P - sot_off)
            for w in words:
                w.start += window_offset_s
                w.end += window_offset_s
        if opts is not None and opts.timestamps and ids:
            segments = split_segments(cfg, ids, self.tokenizer,
                                      window_offset_s=window_offset_s)
        t3 = time.perf_counter()
        return Transcription(
            text=text, tokens=ids,
            timings={"mel_s": t1 - t0, "decode_s": t2 - t1,
                     "detok_s": t3 - t2, "total_s": t3 - t0},
            words=words, segments=segments)

    def transcribe(self, audio: np.ndarray, language: str = "en",
                   task: str = "transcribe",
                   max_new: Optional[int] = None,
                   opts: Optional[DecodeOptions] = None,
                   condition_on_previous: bool = False,
                   fallback_temperatures: Sequence[float] = (),
                   initial_prompt: Optional[str] = None,
                   word_timestamps: bool = False,
                   no_speech_threshold: Optional[float] = None,
                   vad_threshold_db: Optional[float] = None,
                   seed: int = 0) -> Transcription:
        """Long-form audio (:270): one transcribe_window per 30 s window.
        With timestamp decoding (opts.timestamps) a window starts where
        the previous one's last closed segment ended (openai/whisper's
        seek), at least 1 s further on; otherwise windows are a fixed
        30 s apart. initial_prompt conditions the first window through
        <|startofprev|>; condition_on_previous conditions each later one on
        the previous window's text tokens (the last n_text_ctx // 2 - 8).
        vad_threshold_db skips a window that audio.energy_vad finds silent
        (no mel, encoder or decode). Texts, tokens, words, segments and
        timings are concatenated or summed over the windows. seed: every
        window's sampling seed (transcribe_window's; JAX's transcribe
        passes none, so its windows take 0, the default here)."""
        cfg = self.cfg
        audio = np.asarray(audio, dtype=np.float32).reshape(-1)
        texts, all_ids = [], []
        all_words: list = []
        all_segments: list = []
        prev: tuple = (tuple(self.tokenizer.encode(initial_prompt))
                       if initial_prompt else ())
        timings = {"mel_s": 0.0, "decode_s": 0.0, "detok_s": 0.0,
                   "total_s": 0.0}
        seek = 0
        use_seek = bool(opts and opts.timestamps)
        while seek < max(len(audio), 1):
            offset_s = seek / cfg.sample_rate
            chunk = audio[seek:seek + cfg.n_samples]
            if vad_threshold_db is not None and not energy_vad(
                    chunk, cfg.sample_rate, threshold_db=vad_threshold_db):
                seek += cfg.n_samples
                if len(chunk) < cfg.n_samples:
                    break
                continue
            r = self.transcribe_window(
                chunk, language, task, max_new=max_new, opts=opts,
                prev_tokens=prev,
                fallback_temperatures=fallback_temperatures,
                no_speech_threshold=no_speech_threshold,
                seed=seed, word_timestamps=word_timestamps,
                window_offset_s=offset_s)
            texts.append(r.text)
            all_ids.extend(r.tokens)
            all_words.extend(r.words or ())
            all_segments.extend(r.segments or ())
            if condition_on_previous:
                gen = [t for t in r.tokens if t < cfg.eot_token]
                prev = tuple(gen[-(cfg.n_text_ctx // 2 - 8):])
            for k in timings:
                timings[k] += r.timings[k]
            advance_s = float(cfg.chunk_length_s)
            if use_seek and r.segments:
                last_end = r.segments[-1].get("end")
                if last_end is not None:
                    advance_s = max(last_end - offset_s, 1.0)
            seek += int(round(advance_s * cfg.sample_rate))
            if len(chunk) < cfg.n_samples:
                break                       # that was the final window
        return Transcription(text="".join(texts), tokens=all_ids,
                             timings=timings, words=all_words or None,
                             segments=all_segments or None)


def load_wav(path: str, target_rate: int = 16_000) -> np.ndarray:
    """WAV file -> mono fp32 at target_rate (whisper_tpu/pipeline.py:348
    load_wav): FFT resampling with scipy.signal.resample, as JAX does
    (:369-376), and linear interpolation only where scipy is missing."""
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
        try:
            from scipy.signal import resample
            x = resample(x, int(len(x) * target_rate / rate)).astype(
                np.float32)
        except ImportError:
            t_old = np.arange(len(x)) / rate
            t_new = np.arange(int(len(x) * target_rate / rate)) / target_rate
            x = np.interp(t_new, t_old, x).astype(np.float32)
    return x
