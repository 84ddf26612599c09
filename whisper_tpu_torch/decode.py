"""Greedy decoding with the decode rules, and language detection
(whisper_tpu/decode.py: greedy_decode, transcribe_tokens,
detect_language).

The JAX package runs the loop on the device inside one jitted
while_loop. The port drives a Python loop of T==1 steps whose tensors
never leave the card, with the JAX step choice (:256-284): the fused
decoder step when `_fused_step_enabled` (cfg.fused_step or
WHISPER_TPU_FUSED=1, never with int8 weights or caches) — one
fused_decoder_step launch for all layers plus one append — else
decoder_step_ip, or under kv_cache_quant a T==1 decoder_forward. The
host reads one boolean every POLL_EVERY steps to stop early once every
row has emitted EOT. Results
equal the step-wise loop's: finished rows keep re-emitting EOT (the
buffer's padding) and their sum_logprobs stays frozen
(whisper_tpu/decode.py:297-316), so the steps after the last finish
change nothing.

`opts` (decode_rules.DecodeOptions) runs the JAX package's rule stack on
every pick, the first included (:229-232). Temperature sampling and beam
search are not ported yet (ROADMAP Queue 1 item 9) and raise.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch

from whisper_tpu_torch.config import WhisperConfig
from whisper_tpu_torch.decode_rules import DecodeOptions, apply_rules
from whisper_tpu_torch.models.whisper import (
    compute_dtype,
    decoder_forward,
    decoder_step_ip,
    encoder_forward,
    final_logits,
    full_fp32,
    init_kv_cache,
    precompute_cross_kv,
    tok_embed,
)
from whisper_tpu_torch.ops.cache_append import cache_append_rows
from whisper_tpu_torch.ops.decoder_step import (
    fused_decoder_step,
    pack_decoder_weights,
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


def _fused_step_enabled(cfg: WhisperConfig) -> bool:
    """Whether greedy decoding takes the fused decoder step (:41), rule
    for rule: never with int8 weights or caches; WHISPER_TPU_FUSED, when
    set, decides ("1" on, anything else off); then cfg.fused_step; else
    off, the JAX auto policy. Read at every call: the port has no trace
    cache to freeze it."""
    if cfg.kv_cache_quant or cfg.cross_kv_quant or cfg.weight_quant:
        return False
    env = os.environ.get("WHISPER_TPU_FUSED")
    if env is not None:
        return env == "1"
    if cfg.fused_step is not None:
        return cfg.fused_step
    return False


def _cache_slots(cfg: WhisperConfig, total: int) -> int:
    """Self-cache slots for a decode capped at `total` positions, rounded
    up to 64 (:180): 128 for the bench's 4 + 89 tokens; n_text_ctx when
    the fused step is on, as the JAX gate allocates."""
    if _fused_step_enabled(cfg):
        return cfg.n_text_ctx
    return min(cfg.n_text_ctx, -(-total // 64) * 64)


def _make_fused_step(params, cfg: WhisperConfig, cross_kv):
    """The fused step closure (:70): the decoder's operands packed once
    per transcription, then per step the embeddings, one
    fused_decoder_step launch for every layer, one cache_append_rows
    launch writing every layer's new row at `pos` (where JAX writes with
    a dynamic_update_slice), and the logits. The caches keep the port's
    layout: no head-outer copy. step(last (B, 1), pos, cache) ->
    (logits (B, 1, vocab) fp32, cache)."""
    dec = params["decoder"]
    dtype = compute_dtype(cfg)
    packed = pack_decoder_weights(dec["layers"], dtype)

    def step(last, pos, cache):
        h0 = tok_embed(dec, last[:, 0], dtype) + dec["pos_emb"][pos].to(dtype)
        h_out, k_new, v_new = fused_decoder_step(
            h0, packed, cache["k"], cache["v"], cross_kv["k"], cross_kv["v"],
            pos + 1, n_heads=cfg.n_heads, eps=cfg.ln_eps)
        cache_append_rows(cache["k"], cache["v"], k_new, v_new, pos)
        return final_logits(params, cfg, h_out[:, None, :]), cache

    return step


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


def _pick(logits: torch.Tensor, logit_bias: Optional[torch.Tensor],
          opts: Optional[DecodeOptions], cfg: WhisperConfig,
          tokens: torch.Tensor, pos: int, prompt_len: int):
    """Greedy pick from the last position (:226-240): the logit bias, then
    the rules for a next token at `pos`, then argmax. Returns (next token
    (B,), its logprob (B,)). torch.argmax, like jnp.argmax, returns the
    first maximum."""
    lg = logits[:, -1, :]
    if logit_bias is not None:
        lg = lg + logit_bias[None, :]
    if opts is not None:
        lg = apply_rules(lg, tokens, pos, prompt_len, cfg, opts)
    nxt = lg.argmax(dim=-1)
    logp = torch.log_softmax(lg.float(), dim=-1)
    return nxt, logp.gather(-1, nxt[:, None])[:, 0]


def _greedy_loop(params, cfg: WhisperConfig, cross_kv, cache, tokens,
                 prefill_logits, prompt, logit_bias, max_new: int,
                 opts: Optional[DecodeOptions] = None) -> DecodeResult:
    """First pick, no-speech probability, then up to max_new T==1 steps
    (:216). Each step is the fused step when `_fused_step_enabled` and
    the self cache is not int8 (:266-268), else decoder_step_ip (one
    in-place append; it reads an int8 self cache scale-commuted), or a
    T==1 decoder_forward when every cache is int8 (kv_cache_quant)."""
    B, P = prompt.shape
    eot = cfg.eot_token
    first, sum_lp = _pick(prefill_logits, logit_bias, opts, cfg, tokens, P,
                          P)
    tokens[:, P] = first
    finished = first == eot

    # openai/whisper no-speech signal: P(<|nospeech|>) at the SOT position
    sot_idx = (prompt == cfg.sot_token).int().argmax(dim=1)
    sot_logits = prefill_logits[torch.arange(B, device=prompt.device), sot_idx]
    no_speech_prob = torch.softmax(sot_logits.float(), dim=-1
                                   )[:, cfg.no_speech_token]

    if _fused_step_enabled(cfg) and "k_s" not in cache:
        step = _make_fused_step(params, cfg, cross_kv)
    else:
        layer_step = decoder_forward if cfg.kv_cache_quant else decoder_step_ip

        def step(last, pos, cache):
            return layer_step(params, cfg, last, pos, cache, cross_kv)
    for i in range(max_new):
        if i % POLL_EVERY == 0 and bool(finished.all()):
            break
        last = tokens[:, P + i:P + i + 1]
        logits, cache = step(last, P + i, cache)
        picked, lp = _pick(logits, logit_bias, opts, cfg, tokens, P + i + 1,
                           P)
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
                  logit_bias: Optional[torch.Tensor] = None,
                  opts: Optional[DecodeOptions] = None) -> DecodeResult:
    """Greedy decode against an encoder output (:364).

    Args:
      enc_out: (B, n_audio_ctx, d_model).
      prompt: (B, P) int64 SOT sequence, on enc_out's device.
      max_new: cap on loop tokens after the prefill pick (default 195).
      logit_bias: optional (vocab,) fp32 additive bias before the argmax
        (the bench bans EOT with -1e9).
      opts: the rule stack (suppression, timestamps); greedy only.
    """
    if opts is not None and opts.temperature > 0:
        raise NotImplementedError(
            "temperature sampling is not ported yet (ROADMAP Queue 1 item 9)")
    if opts is not None and opts.beam_size > 1:
        raise NotImplementedError(
            "beam search is not ported yet (ROADMAP Queue 1 item 9)")
    if max_new is None:
        max_new = cfg.max_new_tokens
    total = prompt.shape[1] + 1 + max_new
    with full_fp32(compute_dtype(cfg) == torch.float32):
        cross_kv, cache, tokens, logits = _greedy_prefill(
            params, cfg, enc_out, prompt, total)
        return _greedy_loop(params, cfg, cross_kv, cache, tokens, logits,
                            prompt, logit_bias, max_new, opts)


@torch.inference_mode()
def encode(params, cfg: WhisperConfig, mel: torch.Tensor) -> torch.Tensor:
    """Encoder entry point (:675): (B, n_mels, n_frames) mel -> encoder
    output."""
    with full_fp32(compute_dtype(cfg) == torch.float32):
        return encoder_forward(params, cfg, mel)


@torch.inference_mode()
def detect_language(params, cfg: WhisperConfig, enc_out: torch.Tensor
                    ) -> torch.Tensor:
    """Language identification (:701): one decoder pass on a bare
    <|startoftranscript|> prompt, softmax in fp32 over the language-token
    slice of the logits. Returns (B, n_languages) probabilities on
    enc_out's device, index i = tokenizer.LANGUAGES[i]."""
    B = enc_out.shape[0]
    with full_fp32(compute_dtype(cfg) == torch.float32):
        cross_kv = precompute_cross_kv(params, cfg, enc_out)
        cache = init_kv_cache(cfg, B, compute_dtype(cfg),
                              _cache_slots(cfg, 1), enc_out.device)
        sot = torch.full((B, 1), cfg.sot_token, dtype=torch.long,
                         device=enc_out.device)
        logits, _ = decoder_forward(params, cfg, sot, 0, cache, cross_kv)
    first = cfg.first_language_token
    lang = logits[:, -1, first:first + cfg.n_languages]
    return torch.softmax(lang.float(), dim=-1)


def transcribe_tokens(params, cfg: WhisperConfig, mel: torch.Tensor,
                      prompt: torch.Tensor, max_new: Optional[int] = None,
                      logit_bias: Optional[torch.Tensor] = None,
                      opts: Optional[DecodeOptions] = None) -> DecodeResult:
    """(B, n_mels, n_frames) mel + (B, P) prompt -> tokens (:724)."""
    return greedy_decode(params, cfg, encode(params, cfg, mel), prompt,
                         max_new=max_new, logit_bias=logit_bias, opts=opts)
