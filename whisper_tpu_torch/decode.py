"""Decoding strategies: greedy, temperature sampling and beam search with
the decode rules, and language detection (whisper_tpu/decode.py:
greedy_decode, beam_decode, decode_from_encoder, transcribe_tokens,
detect_language).

The JAX package runs each loop on the device inside one jitted
while_loop. The port drives a Python loop of T==1 steps whose tensors
never leave the card, with the JAX step choice (:256-284): the fused
decoder step when `_fused_step_enabled` (cfg.fused_step or
WHISPER_TPU_FUSED=1, never with int8 weights or caches) — one
fused_decoder_step launch for all layers plus one append — else
decoder_step_ip, or under kv_cache_quant a T==1 decoder_forward. The
host reads one boolean every POLL_EVERY steps to stop early once every
row (every beam) has emitted EOT. Results equal the step-wise loop's:
finished rows keep re-emitting EOT (the buffer's padding) and their
sum_logprobs stays frozen (whisper_tpu/decode.py:297-316); finished
beams extend only with EOT at zero cost, and the top-W order keeps them
in place (`_top_w`), so the steps after the last finish change nothing.

`opts` (decode_rules.DecodeOptions) runs the JAX package's rule stack on
every pick, the first included (:229-232). Sampling (opts.temperature >
0) draws from softmax(logits / T) with an explicit torch.Generator on
the logits' device, where JAX takes a PRNG key: the same distribution,
another stream.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch

from whisper_tpu_torch.config import WhisperConfig
from whisper_tpu_torch.decode_rules import NEG, DecodeOptions, apply_rules
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
    tp_group,
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

    def avg_logprob(self, prompt_len: int) -> torch.Tensor:
        """Mean chosen-token logprob over the generated tokens, EOT
        included (:140): the temperature fallback's confidence gate."""
        n = (self.lengths - prompt_len).clamp(min=1).float()
        return self.sum_logprobs / n


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
    (logits (B, 1, vocab) fp32, cache). Raises under tp > 1 (a
    models.whisper.sharded block): every layer's row-parallel sums would
    fall inside the one launch."""
    if tp_group() is not None:
        raise ValueError("the fused decoder step does not run under tp > 1: "
                         "turn cfg.fused_step and WHISPER_TPU_FUSED off")
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


_TINY = torch.finfo(torch.float32).tiny


def gumbel_noise(u: torch.Tensor) -> torch.Tensor:
    """Gumbel noise G = -log(-log U) from fp32 uniforms U in [0, 1 - 2**-24],
    U held to [tiny, 1) first as jax.random.gumbel holds it: G is then
    finite, within about [-4.5, 16.7], at every value U takes, so a masked
    logit (NEG) never outbids a live one."""
    return -torch.log(-torch.log(u.clamp_min(_TINY)))


def sample_gumbel(logits: torch.Tensor, temperature: float,
                  generator: torch.Generator) -> torch.Tensor:
    """One draw per row from softmax(logits / temperature): the Gumbel-max
    form of jax.random.categorical, argmax(l / T + G), U uniform from
    `generator` on the logits' device."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    return (logits.float() / temperature + gumbel_noise(u)).argmax(dim=-1)


def _pick(logits: torch.Tensor, logit_bias: Optional[torch.Tensor],
          opts: Optional[DecodeOptions], cfg: WhisperConfig,
          tokens: torch.Tensor, pos: int, prompt_len: int,
          generator: Optional[torch.Generator] = None):
    """The pick from the last position (:226-240): the logit bias, then
    the rules for a next token at `pos`, then argmax, or at opts.temperature
    > 0 a draw from `generator`. The chosen token's logprob comes from the
    unscaled logits. Returns (next token (B,), its logprob (B,)).
    torch.argmax, like jnp.argmax, returns the first maximum."""
    lg = logits[:, -1, :]
    if logit_bias is not None:
        lg = lg + logit_bias[None, :]
    if opts is not None:
        lg = apply_rules(lg, tokens, pos, prompt_len, cfg, opts)
    if opts is not None and opts.temperature > 0:
        nxt = sample_gumbel(lg, opts.temperature, generator)
    else:
        nxt = lg.argmax(dim=-1)
    logp = torch.log_softmax(lg.float(), dim=-1)
    return nxt, logp.gather(-1, nxt[:, None])[:, 0]


def _no_speech_prob(prefill_logits: torch.Tensor, prompt: torch.Tensor,
                    cfg: WhisperConfig) -> torch.Tensor:
    """openai/whisper's no-speech signal (:248-254): P(<|nospeech|>) at
    the SOT position of the prefill (SOT may follow a <|startofprev|>
    prefix). (B,) fp32."""
    sot_idx = (prompt == cfg.sot_token).int().argmax(dim=1)
    rows = torch.arange(prompt.shape[0], device=prompt.device)
    sot_logits = prefill_logits[rows, sot_idx]
    return torch.softmax(sot_logits.float(), dim=-1)[:, cfg.no_speech_token]


def _layer_step(params, cfg: WhisperConfig, cross_kv):
    """The unfused T==1 step: decoder_step_ip (one in-place append; it
    reads an int8 self cache scale-commuted), or a T==1 decoder_forward
    when every cache is int8 (kv_cache_quant). step(last (N, 1), pos,
    cache) -> (logits (N, 1, vocab) fp32, cache)."""
    layer_step = decoder_forward if cfg.kv_cache_quant else decoder_step_ip

    def step(last, pos, cache):
        return layer_step(params, cfg, last, pos, cache, cross_kv)

    return step


def _greedy_loop(params, cfg: WhisperConfig, cross_kv, cache, tokens,
                 prefill_logits, prompt, logit_bias, max_new: int,
                 opts: Optional[DecodeOptions] = None,
                 generator: Optional[torch.Generator] = None
                 ) -> DecodeResult:
    """First pick, no-speech probability, then up to max_new T==1 steps
    (:216). Each step is the fused step when `_fused_step_enabled` and
    the self cache is not int8 (:266-268), else `_layer_step`'s. At
    opts.temperature > 0 every pick is a draw from `generator`."""
    P = prompt.shape[1]
    eot = cfg.eot_token
    first, sum_lp = _pick(prefill_logits, logit_bias, opts, cfg, tokens, P,
                          P, generator)
    tokens[:, P] = first
    finished = first == eot

    no_speech_prob = _no_speech_prob(prefill_logits, prompt, cfg)

    if _fused_step_enabled(cfg) and "k_s" not in cache:
        step = _make_fused_step(params, cfg, cross_kv)
    else:
        step = _layer_step(params, cfg, cross_kv)
    for i in range(max_new):
        if i % POLL_EVERY == 0 and bool(finished.all()):
            break
        last = tokens[:, P + i:P + i + 1]
        logits, cache = step(last, P + i, cache)
        picked, lp = _pick(logits, logit_bias, opts, cfg, tokens, P + i + 1,
                           P, generator)
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
                  opts: Optional[DecodeOptions] = None,
                  generator: Optional[torch.Generator] = None
                  ) -> DecodeResult:
    """Greedy (or, with opts.temperature > 0 and a generator, sampled)
    decode against an encoder output (:364).

    Args:
      enc_out: (B, n_audio_ctx, d_model).
      prompt: (B, P) int64 SOT sequence, on enc_out's device.
      max_new: cap on loop tokens after the prefill pick (default 195).
      logit_bias: optional (vocab,) fp32 additive bias before the pick
        (the bench bans EOT with -1e9).
      opts: the rule stack (suppression, timestamps) and the temperature;
        opts.beam_size is decode_from_encoder's business, not this one's.
      generator: a torch.Generator on enc_out's device, required iff
        opts.temperature > 0 (JAX's rng key).
    """
    if opts is not None and opts.temperature > 0 and generator is None:
        raise ValueError("temperature sampling needs a torch.Generator")
    if max_new is None:
        max_new = cfg.max_new_tokens
    total = prompt.shape[1] + 1 + max_new
    with full_fp32(compute_dtype(cfg) == torch.float32):
        cross_kv, cache, tokens, logits = _greedy_prefill(
            params, cfg, enc_out, prompt, total)
        return _greedy_loop(params, cfg, cross_kv, cache, tokens, logits,
                            prompt, logit_bias, max_new, opts, generator)


# ---------------------------------------------------------------------------
# beam search (whisper_tpu/decode.py:415-663)
# ---------------------------------------------------------------------------

def _top_w(scores: torch.Tensor, w: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The w largest entries of each row of `scores` (N, M) fp32 as
    (values, indices), in jax.lax.top_k's order: descending, and the lower
    index first among equal values (and +0.0 above -0.0, as XLA's total
    order has it). torch.topk promises no order among ties, so each entry
    gets a distinct int64 key, its value's bits made order-preserving over
    its complemented index, and the top w keys are taken instead. Beam
    search depends on this order: the steps after every beam has finished
    must leave the beams where they are."""
    scores = scores.float()
    bits = scores.view(torch.int32).long()
    ordered = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    idx = torch.arange(scores.shape[-1], device=scores.device)
    keys = ordered * (1 << 32) + ((1 << 32) - 1 - idx)
    top = keys.topk(w, dim=-1).indices
    return scores.gather(-1, top), top


def _beam_gather_cache(cache: dict, flat_src: torch.Tensor, kv_len: int
                       ) -> None:
    """Reorder the self-cache rows to follow their source beams (:415), in
    place: row r of every cache tensor ((L, B·W, H, S, D) values, and
    (L, B·W, H, S, 1) int8 scales) takes row flat_src[r], over the valid
    prefix [0, kv_len) of the S axis only. The gathered prefix is a new
    tensor copied back, so rows that are both read and written do not
    overlap, and the tensors stay the buffers cache_append_rows writes.
    Columns past kv_len keep stale rows: every step writes its column
    before any read reaches it."""
    for c in cache.values():
        head = c[:, :, :, :kv_len]
        head.copy_(head.index_select(1, flat_src))


def _beam_prefill(params, cfg: WhisperConfig, enc_out: torch.Tensor,
                  prompt: torch.Tensor, beam_size: int, total: int):
    """Cross K/V once per audio row, repeated to row b·W + w as jnp.repeat
    does, then the prompt prefill over B·W rows (:454). Returns
    (cross_kv, cache, prefill_logits (B·W, P, vocab))."""
    W = beam_size
    B = prompt.shape[0]
    cross_kv = {name: x.repeat_interleave(W, dim=1) for name, x in
                precompute_cross_kv(params, cfg, enc_out).items()}
    cache = init_kv_cache(cfg, B * W, compute_dtype(cfg),
                          _cache_slots(cfg, total), enc_out.device)
    logits, cache = decoder_forward(params, cfg,
                                    prompt.repeat_interleave(W, dim=0), 0,
                                    cache, cross_kv)
    return cross_kv, cache, logits


def _beam_loop(params, cfg: WhisperConfig, cross_kv, cache,
               prefill_logits: torch.Tensor, prompt: torch.Tensor,
               beam_size: int, max_new: int,
               opts: Optional[DecodeOptions]) -> DecodeResult:
    """First expansion, the beam loop and the ranking (:516). Beams ride
    the batch axis as row b·W + w. The first expansion takes beam 0's top
    W (the beams are identical after the prefill); each step scores the
    W·V candidates sum_lp + lp, finished beams extending only with EOT at
    zero cost, keeps the top W (`_top_w`), gathers the tokens, the
    finished flags and the self cache to follow their source beams. The
    step is `_layer_step`'s: the beam loop never takes the fused step, as
    in JAX. The host reads one boolean every POLL_EVERY steps."""
    B, P = prompt.shape
    W = beam_size
    BW = B * W
    total = P + 1 + max_new
    eot = cfg.eot_token
    V = cfg.vocab_size
    dev = prompt.device
    step = _layer_step(params, cfg, cross_kv)

    def rules(lg, tokens, pos):
        if opts is None:
            return lg
        return apply_rules(lg, tokens.view(BW, total), pos, P, cfg, opts)

    # beams are identical at the prefill: beam 0's row gives the signal
    no_speech_prob = _no_speech_prob(prefill_logits[::W], prompt, cfg)

    tokens = torch.full((B, W, total), eot, dtype=torch.long, device=dev)
    tokens[:, :, :P] = prompt[:, None, :]
    lp0 = torch.log_softmax(
        rules(prefill_logits[:, -1, :], tokens, P).float(), dim=-1)
    sum_lp, tok0 = _top_w(lp0.view(B, W, V)[:, 0], W)          # (B, W)
    tokens[:, :, P] = tok0
    finished = tok0 == eot

    eot_only = torch.full((V,), NEG, dtype=torch.float32, device=dev)
    eot_only[eot] = 0.0
    first_row = torch.arange(B, device=dev)[:, None] * W
    for i in range(max_new):
        if i % POLL_EVERY == 0 and bool(finished.all()):
            break
        last = tokens[:, :, P + i].reshape(BW, 1)
        logits, cache = step(last, P + i, cache)
        lp = torch.log_softmax(rules(logits[:, -1, :], tokens, P + i + 1
                                     ).float(), dim=-1).view(B, W, V)
        lp = torch.where(finished[:, :, None], eot_only, lp)
        sum_lp, flat_idx = _top_w((sum_lp[:, :, None] + lp).view(B, W * V),
                                  W)
        src = flat_idx // V                                     # (B, W)
        new_tok = flat_idx % V
        tokens = tokens.gather(1, src[:, :, None].expand(B, W, total))
        tokens[:, :, P + i + 1] = new_tok
        _beam_gather_cache(cache, (first_row + src).view(BW), P + i + 1)
        finished = finished.gather(1, src) | (new_tok == eot)

    # rank the beams by length-normalized score
    lens = _lengths(tokens.view(BW, total), P, eot).view(B, W)
    gen_len = (lens - P).float()
    if opts is not None and opts.length_penalty is not None:
        norm = ((5.0 + gen_len) / 6.0) ** opts.length_penalty
    else:
        norm = gen_len
    best = (sum_lp / norm.clamp(min=1.0)).argmax(dim=1)         # (B,)
    rows = torch.arange(B, device=dev)
    return DecodeResult(tokens=tokens[rows, best], lengths=lens[rows, best],
                        sum_logprobs=sum_lp[rows, best],
                        no_speech_prob=no_speech_prob)


@torch.inference_mode()
def beam_decode(params, cfg: WhisperConfig, enc_out: torch.Tensor,
                prompt: torch.Tensor, beam_size: int = 5,
                max_new: Optional[int] = None,
                opts: Optional[DecodeOptions] = None) -> DecodeResult:
    """Beam-search decode (:477): the best beam per batch row, ranked by
    score / length, or by Google-NMT ((5 + len) / 6) ** penalty when
    opts.length_penalty is set. Cross K/V is replicated W times, as in
    JAX."""
    if opts is not None and opts.temperature > 0:
        raise ValueError("beam search is deterministic; temperature > 0 is "
                         "incompatible with beam_size > 1 (openai/whisper "
                         "uses best_of sampling instead)")
    if max_new is None:
        max_new = cfg.max_new_tokens
    total = prompt.shape[1] + 1 + max_new
    with full_fp32(compute_dtype(cfg) == torch.float32):
        cross_kv, cache, logits = _beam_prefill(params, cfg, enc_out, prompt,
                                                beam_size, total)
        return _beam_loop(params, cfg, cross_kv, cache, logits, prompt,
                          beam_size, max_new, opts)


def decode_from_encoder(params, cfg: WhisperConfig, enc_out: torch.Tensor,
                        prompt: torch.Tensor, max_new: Optional[int] = None,
                        opts: Optional[DecodeOptions] = None,
                        beam_size: int = 1,
                        generator: Optional[torch.Generator] = None,
                        logit_bias: Optional[torch.Tensor] = None
                        ) -> DecodeResult:
    """Decode against a precomputed encoder output (:681): beam_decode
    when beam_size > 1, else greedy_decode (sampled at opts.temperature >
    0). logit_bias is greedy's only: JAX's beam_decode takes none."""
    if beam_size > 1:
        if logit_bias is not None:
            raise ValueError("beam search takes no logit_bias (the JAX "
                             "beam_decode has none); ban tokens through "
                             "opts.suppress_tokens")
        return beam_decode(params, cfg, enc_out, prompt, beam_size,
                           max_new=max_new, opts=opts)
    return greedy_decode(params, cfg, enc_out, prompt, max_new=max_new,
                         logit_bias=logit_bias, opts=opts,
                         generator=generator)


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
                      opts: Optional[DecodeOptions] = None,
                      beam_size: int = 1,
                      generator: Optional[torch.Generator] = None
                      ) -> DecodeResult:
    """(B, n_mels, n_frames) mel + (B, P) prompt -> tokens (:724)."""
    return decode_from_encoder(params, cfg, encode(params, cfg, mel), prompt,
                               max_new=max_new, opts=opts,
                               beam_size=beam_size, generator=generator,
                               logit_bias=logit_bias)
