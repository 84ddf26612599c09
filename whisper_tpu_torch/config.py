"""Model configuration for the Whisper family (whisper_tpu/config.py:20-242).

The port's own copy of the JAX package's table: the same dataclass with
every field, in the same order and with the same defaults, the same
CONFIGS and get_config, so that a config of either package describes the
same model (tests/test_torch_config_tokenizer.py holds the two equal).
The port reads a config only through its attributes, so a
whisper_tpu.config.WhisperConfig handed to it works the same.

The int8 fields drive the port's int8 serving stack as they drive the
JAX package's: weight_quant, kv_cache_quant, cross_kv_quant and
self_kv_quant in greedy decoding, beam search and the continuous engine;
encoder_quant (the int8 projections) and, where the fused tail runs
(every Whisper width), encoder_mlp_quant and encoder_qkv_quant (the
tail's int8 form) in the encoder (models/whisper.py encoder_forward).
Where the tail is off (WHISPER_TPU_FUSED_ENCODER=0, the "reference"
backend) the two tail flags are no-ops, as in JAX's tail-off branch;
fp32 ignores the encoder flags. fused_step drives the greedy loop
as in the JAX package: True (or WHISPER_TPU_FUSED=1) takes the fused
decoder step (decode._fused_step_enabled), False the unfused one; None
is the auto policy: off on the CPU, as JAX's, and on a CUDA device the
fused step wherever its kernel takes the decode.
`apply_serving_quant` is the JAX
package's serving policy (:244), answer for answer: every gate in it was
set by TPU measurements, so the port's pipeline applies it only when
asked (`quant="auto"`; the default is "off").
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional


@dataclasses.dataclass(frozen=True)
class WhisperConfig:
    name: str
    # Audio frontend
    sample_rate: int = 16_000
    n_fft: int = 400
    hop_length: int = 160
    chunk_length_s: int = 30
    n_mels: int = 80
    # Encoder
    n_audio_ctx: int = 1500
    d_model: int = 384
    n_heads: int = 6
    n_audio_layers: int = 4
    # Decoder
    n_text_layers: int = 4
    n_text_ctx: int = 448
    vocab_size: int = 51_865
    multilingual: bool = True
    # Numerics: "float32" is the token-parity mode, "bfloat16" serving
    compute_dtype: str = "float32"
    ln_eps: float = 1e-5
    # Attention backend: "reference" | "pallas" | "pallas_interpret" |
    # "auto"; None defers to WHISPER_TPU_ATTN, then "auto" (the port honours
    # it as the JAX package does: ops/attention.py, models/whisper.py)
    attn_backend: Optional[str] = None
    # int8 KV cache (self + cross) with per-vector scales
    kv_cache_quant: bool = False
    # int8 cross cache only
    cross_kv_quant: bool = False
    # int8 self cache only
    self_kv_quant: bool = False
    # weight-only int8 decoder weights, per-output-column scales
    weight_quant: bool = False
    # int8 encoder matmuls at the XLA level
    encoder_quant: bool = False
    # int8 fc1/fc2 inside the fused encoder tail
    encoder_mlp_quant: bool = False
    # int8 fused-QKV projection in front of the fused tail
    encoder_qkv_quant: bool = False
    # fused whole-step decoder kernel: None = auto (CUDA: on where it fits)
    fused_step: Optional[bool] = None
    # Special-token layout: large-v3 adds a 100th language token, shifting
    # every task token by +1 while eot stays at 50257.
    eot_token: int = 50_257          # <|endoftext|>; 50256 for .en models
    n_languages: int = 99            # 100 for the large-v3 family

    # ---- derived static shapes ----
    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def d_ff(self) -> int:
        return 4 * self.d_model

    @property
    def n_frames(self) -> int:
        """Mel frames per 30 s window (3000)."""
        return self.chunk_length_s * self.sample_rate // self.hop_length

    @property
    def n_samples(self) -> int:
        """Audio samples per window (480_000 at 16 kHz / 30 s)."""
        return self.chunk_length_s * self.sample_rate

    @property
    def n_freqs(self) -> int:
        return self.n_fft // 2 + 1

    # ---- special token ids (vocab.txt line - 1) ----
    @property
    def sot_token(self) -> int:
        return self.eot_token + 1      # 50258 <|startoftranscript|>

    @property
    def first_language_token(self) -> int:
        return self.sot_token + 1      # 50259 == <|en|>

    @property
    def translate_token(self) -> int:
        return self.first_language_token + self.n_languages  # 50358

    @property
    def transcribe_token(self) -> int:
        return self.translate_token + 1                      # 50359

    @property
    def sot_prev_token(self) -> int:
        """<|startofprev|>, which prefixes previous-window text: 50361 in
        the v2 vocab, 50362 for large-v3 (the +1 language shift)."""
        return self.transcribe_token + 2                     # 50361

    @property
    def no_speech_token(self) -> int:
        """<|nospeech|>: its prefill probability at the SOT position is
        the openai/whisper silence signal."""
        return self.transcribe_token + 3                     # 50362

    @property
    def no_timestamps_token(self) -> int:
        return self.transcribe_token + 4                     # 50363

    @property
    def timestamp_begin(self) -> int:
        return self.no_timestamps_token + 1  # 50364 == <|0.00|>

    @property
    def max_new_tokens(self) -> int:
        """Default cap on greedy loop tokens after the 4-token prompt and
        the prefill pick."""
        return 195

    def replace(self, **kw) -> "WhisperConfig":
        return dataclasses.replace(self, **kw)


def _cfg(name: str, d_model: int, n_heads: int, enc_layers: int,
         dec_layers: Optional[int] = None, vocab: int = 51_865,
         n_mels: int = 80, multilingual: bool = True,
         eot: int = 50_257, n_languages: int = 99) -> WhisperConfig:
    return WhisperConfig(
        name=name, d_model=d_model, n_heads=n_heads,
        n_audio_layers=enc_layers,
        n_text_layers=dec_layers if dec_layers is not None else enc_layers,
        vocab_size=vocab, n_mels=n_mels, multilingual=multilingual,
        eot_token=eot, n_languages=n_languages,
    )


# Official OpenAI Whisper family dimensions.
CONFIGS: dict[str, WhisperConfig] = {
    "tiny":            _cfg("tiny", 384, 6, 4),
    "tiny.en":         _cfg("tiny.en", 384, 6, 4, vocab=51_864,
                            multilingual=False, eot=50_256),
    "base":            _cfg("base", 512, 8, 6),
    "base.en":         _cfg("base.en", 512, 8, 6, vocab=51_864,
                            multilingual=False, eot=50_256),
    "small":           _cfg("small", 768, 12, 12),
    "small.en":        _cfg("small.en", 768, 12, 12, vocab=51_864,
                            multilingual=False, eot=50_256),
    "medium":          _cfg("medium", 1024, 16, 24),
    "medium.en":       _cfg("medium.en", 1024, 16, 24, vocab=51_864,
                            multilingual=False, eot=50_256),
    "large-v2":        _cfg("large-v2", 1280, 20, 32),
    "large-v3":        _cfg("large-v3", 1280, 20, 32, vocab=51_866,
                            n_mels=128, n_languages=100),
    "large-v3-turbo":  _cfg("large-v3-turbo", 1280, 20, 32, dec_layers=4,
                            vocab=51_866, n_mels=128, n_languages=100),
}


# Aliases openai/whisper accepts (whisper.load_model): "turbo" is the
# official short name for large-v3-turbo; "large" tracks the newest large.
ALIASES: dict[str, str] = {
    "turbo": "large-v3-turbo",
    "large": "large-v3",
}


def get_config(name: str) -> WhisperConfig:
    try:
        return CONFIGS[ALIASES.get(name, name)]
    except KeyError:
        raise ValueError(
            f"unknown model {name!r}; have {sorted(CONFIGS)} "
            f"(+ aliases {sorted(ALIASES)})") from None


def apply_serving_quant(cfg: WhisperConfig,
                        batch: Optional[int] = None) -> WhisperConfig:
    """The JAX package's serving quantization policy (whisper_tpu/config.py
    :244-311), rule for rule:
      * WHISPER_TPU_AUTO_QUANT other than "1" turns the policy off;
      * fp32 (token-parity) mode passes through;
      * a config with any quant flag set explicitly passes through;
      * tiny width (d_model <= 384) at <= 8 effective decode rows (`batch`,
        when known: batch x beam width) keeps quant off;
      * otherwise weight-only int8, int8 cross K/V except at d_model 768,
        the encoder's int8 MLP from d_model 768 and its int8 QKV from 1024,
        and the int8 self cache for d_model >= 1024 with more than four
        decoder layers.
    Its gates were measured on a TPU v5e; the port's own policy awaits the
    H100's A/Bs (PERF.md)."""
    if os.environ.get("WHISPER_TPU_AUTO_QUANT", "1") != "1":
        return cfg
    if str(cfg.compute_dtype).removeprefix("torch.") == "float32":
        return cfg
    if (cfg.weight_quant or cfg.cross_kv_quant or cfg.kv_cache_quant
            or cfg.self_kv_quant
            or cfg.encoder_mlp_quant or cfg.encoder_qkv_quant):
        return cfg
    if batch is not None and batch <= 8 and cfg.d_model <= 384:
        return cfg
    return cfg.replace(weight_quant=True, cross_kv_quant=cfg.d_model != 768,
                       encoder_mlp_quant=cfg.d_model >= 768,
                       encoder_qkv_quant=cfg.d_model >= 1024,
                       self_kv_quant=(cfg.d_model >= 1024
                                      and cfg.n_text_layers > 4))
