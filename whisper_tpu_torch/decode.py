"""Greedy decoding (whisper_tpu/decode.py, the greedy strategy without
decode rules).

The JAX package runs the loop on the device inside one jitted
while_loop. The port drives a Python loop of T==1 steps (decoder_step_ip)
whose tensors never leave the card; the host reads one boolean every
POLL_EVERY steps to stop early once every row has emitted EOT. Results
equal the step-wise loop's: finished rows keep re-emitting EOT (the
buffer's padding) and their sum_logprobs stays frozen
(whisper_tpu/decode.py:297-316), so the steps after the last finish
change nothing.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from whisper_tpu.config import WhisperConfig
from whisper_tpu_torch.models.whisper import (
    compute_dtype,
    decoder_forward,
    decoder_step_ip,
    encoder_forward,
    full_fp32,
    init_kv_cache,
    precompute_cross_kv,
)

POLL_EVERY = 8   # steps between the host's early-exit checks


@dataclasses.dataclass
class DecodeResult:
    tokens: torch.Tensor          # (B, prompt_len + 1 + max_new) int64, EOT-padded
    lengths: torch.Tensor         # (B,) valid tokens incl. prompt and EOT
    sum_logprobs: torch.Tensor    # (B,) chosen-token logprobs, fp32
    no_speech_prob: torch.Tensor  # (B,) P(<|nospeech|>) at the SOT position


def _lengths(tokens: torch.Tensor, P: int, eot: int) -> torch.Tensor:
    """Valid length = up to and including the first EOT after the prompt,
    or the whole buffer when there is none (:147)."""
    is_eot = tokens[:, P:] == eot
    any_eot = is_eot.any(dim=-1)
    first_eot = is_eot.int().argmax(dim=-1)
    gen_len = torch.where(any_eot, first_eot + 1,
                          torch.full_like(first_eot, is_eot.shape[-1]))
    return P + gen_len


def _cache_slots(cfg: WhisperConfig, total: int) -> int:
    """Self-cache slots for a decode capped at `total` positions, rounded
    up to 64 (:180): 128 for the bench's 4 + 89 tokens."""
    return min(cfg.n_text_ctx, -(-total // 64) * 64)


def _greedy_prefill(params, cfg: WhisperConfig, enc_out: torch.Tensor,
                    prompt: torch.Tensor, total: int):
    """Cross-K/V precompute + prompt prefill (:193). Returns (cross_kv,
    cache, tokens, prefill_logits); tokens is the (B, total) EOT-filled
    buffer with the prompt written in."""
    B, P = prompt.shape
    dev = enc_out.device
    cross_kv = precompute_cross_kv(params, cfg, enc_out)
    cache = init_kv_cache(cfg, B, compute_dtype(cfg),
                          _cache_slots(cfg, total), dev)
    tokens = torch.full((B, total), cfg.eot_token, dtype=torch.long,
                        device=dev)
    tokens[:, :P] = prompt
    logits, cache = decoder_forward(params, cfg, prompt, 0, cache, cross_kv)
    return cross_kv, cache, tokens, logits


def _pick(logits: torch.Tensor, logit_bias: Optional[torch.Tensor]):
    """Greedy pick from the last position: (next token (B,), its logprob
    (B,)). torch.argmax, like jnp.argmax, returns the first maximum."""
    lg = logits[:, -1, :]
    if logit_bias is not None:
        lg = lg + logit_bias[None, :]
    nxt = lg.argmax(dim=-1)
    logp = torch.log_softmax(lg.float(), dim=-1)
    return nxt, logp.gather(-1, nxt[:, None])[:, 0]


def _greedy_loop(params, cfg: WhisperConfig, cross_kv, cache, tokens,
                 prefill_logits, prompt, logit_bias, max_new: int
                 ) -> DecodeResult:
    """First pick, no-speech probability, then up to max_new T==1 steps
    (:216), each ending in one in-place append."""
    B, P = prompt.shape
    eot = cfg.eot_token
    first, sum_lp = _pick(prefill_logits, logit_bias)
    tokens[:, P] = first
    finished = first == eot

    # openai/whisper no-speech signal: P(<|nospeech|>) at the SOT position
    sot_idx = (prompt == cfg.sot_token).int().argmax(dim=1)
    sot_logits = prefill_logits[torch.arange(B, device=prompt.device), sot_idx]
    no_speech_prob = torch.softmax(sot_logits.float(), dim=-1
                                   )[:, cfg.no_speech_token]

    for i in range(max_new):
        if i % POLL_EVERY == 0 and bool(finished.all()):
            break
        last = tokens[:, P + i:P + i + 1]
        logits, cache = decoder_step_ip(params, cfg, last, P + i, cache,
                                        cross_kv)
        picked, lp = _pick(logits, logit_bias)
        live = ~finished
        nxt = torch.where(live, picked, torch.full_like(picked, eot))
        sum_lp = sum_lp + torch.where(live, lp, torch.zeros_like(lp))
        tokens[:, P + i + 1] = nxt
        finished = finished | (nxt == eot)
    return DecodeResult(tokens=tokens, lengths=_lengths(tokens, P, eot),
                        sum_logprobs=sum_lp, no_speech_prob=no_speech_prob)


@torch.inference_mode()
def greedy_decode(params, cfg: WhisperConfig, enc_out: torch.Tensor,
                  prompt: torch.Tensor, max_new: Optional[int] = None,
                  logit_bias: Optional[torch.Tensor] = None
                  ) -> DecodeResult:
    """Greedy decode against an encoder output (:364).

    Args:
      enc_out: (B, n_audio_ctx, d_model).
      prompt: (B, P) int64 SOT sequence, on enc_out's device.
      max_new: cap on loop tokens after the prefill pick (default 195).
      logit_bias: optional (vocab,) fp32 additive bias before the argmax
        (the bench bans EOT with -1e9).
    """
    if max_new is None:
        max_new = cfg.max_new_tokens
    total = prompt.shape[1] + 1 + max_new
    with full_fp32(compute_dtype(cfg) == torch.float32):
        cross_kv, cache, tokens, logits = _greedy_prefill(
            params, cfg, enc_out, prompt, total)
        return _greedy_loop(params, cfg, cross_kv, cache, tokens, logits,
                            prompt, logit_bias, max_new)


@torch.inference_mode()
def encode(params, cfg: WhisperConfig, mel: torch.Tensor) -> torch.Tensor:
    """Encoder entry point (:675): (B, n_mels, n_frames) mel -> encoder
    output."""
    with full_fp32(compute_dtype(cfg) == torch.float32):
        return encoder_forward(params, cfg, mel)


def transcribe_tokens(params, cfg: WhisperConfig, mel: torch.Tensor,
                      prompt: torch.Tensor, max_new: Optional[int] = None,
                      logit_bias: Optional[torch.Tensor] = None
                      ) -> DecodeResult:
    """(B, n_mels, n_frames) mel + (B, P) prompt -> tokens (:724)."""
    return greedy_decode(params, cfg, encode(params, cfg, mel), prompt,
                         max_new=max_new, logit_bias=logit_bias)
