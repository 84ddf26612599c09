"""Speculative decoding (whisper_tpu/speculative.py): a small draft model
proposes k tokens, the target model verifies them in one (B, k+1)
decoder pass. The tokens are those of greedy decoding on the target
alone, because the target's argmax is taken at every position and a
draft is accepted only while it matches; what speculation changes is how
often the target's weights are read (once per k+1 positions at full
acceptance).

The JAX package runs the loop as one lax.while_loop; the port runs it
eagerly on the device, with one host read a round (the lockstep
acceptance count m). A round is one draft scan of k T==1
`decoder_forward` calls, one (B, k+1) verify `decoder_forward` on the
target, and, when every draft of the round was accepted (m == k), one
more T==1 draft pass that writes the d_k row the scan never fed. Rows
of rejected drafts leave stale K/V in both caches, which is safe: every
read is masked to the call's own kv_len, and a later round rewrites a
row before it reads it.

Under attn_backend "pallas" the verify's and both prefills' reads go to
the flash kernel and the draft's T==1 reads to decode_attention_bh; under
"auto" at Whisper's sizes they are the plain attention.

A valid pair shares the token space (checked): tiny/base/small drafting
medium/large-v2, or large-v3-turbo drafting large-v3. Greedy only;
`logit_bias` applies to both models' logits.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from whisper_tpu_torch.audio import log_mel_spectrogram, pad_or_trim
from whisper_tpu_torch.config import WhisperConfig
from whisper_tpu_torch.decode import (
    DecodeResult,
    _cache_slots,
    _lengths,
    _no_speech_prob,
    encode,
)
from whisper_tpu_torch.models.whisper import (
    compute_dtype,
    decoder_forward,
    full_fp32,
    init_kv_cache,
    precompute_cross_kv,
)
from whisper_tpu_torch.tokenizer import build_prompt


def _check_pair(t_cfg: WhisperConfig, d_cfg: WhisperConfig) -> None:
    """Draft and target must agree on the token space (:52), or acceptance
    is meaningless and the prompts diverge."""
    for f in ("vocab_size", "eot_token", "sot_token", "n_languages",
              "multilingual"):
        tv, dv = getattr(t_cfg, f), getattr(d_cfg, f)
        if tv != dv:
            raise ValueError(
                f"speculative pair mismatch on {f}: target={tv} draft={dv} "
                f"(pair models with the same vocab/token layout, e.g. "
                f"base->large-v2 or large-v3-turbo->large-v3)")


def _spec_loop(t_params, t_cfg: WhisperConfig, d_params, d_cfg: WhisperConfig,
               t_enc_out, d_enc_out, prompt, logit_bias, k: int,
               max_new: int):
    """The decode (:67-198). Returns (DecodeResult, stats)."""
    B, P = prompt.shape
    dev = prompt.device
    eot = t_cfg.eot_token
    # +k headroom: the last round may overshoot the cap; the result is cut
    # back to greedy's width at the end
    total = P + 1 + max_new + k + 1
    # positions that have an embedding: a round near the end of the
    # context drafts fewer tokens, so that no row past it is written
    n_ctx = min(t_cfg.n_text_ctx, d_cfg.n_text_ctx)

    def biased(logits):
        return logits if logit_bias is None else logits + logit_bias

    t_cross = precompute_cross_kv(t_params, t_cfg, t_enc_out)
    d_cross = precompute_cross_kv(d_params, d_cfg, d_enc_out)
    t_cache = init_kv_cache(t_cfg, B, compute_dtype(t_cfg),
                            _cache_slots(t_cfg, total), dev)
    d_cache = init_kv_cache(d_cfg, B, compute_dtype(d_cfg),
                            _cache_slots(d_cfg, total), dev)
    tokens = torch.full((B, total), eot, dtype=torch.long, device=dev)
    tokens[:, :P] = prompt

    t_logits, _ = decoder_forward(t_params, t_cfg, prompt, 0, t_cache,
                                  t_cross)
    decoder_forward(d_params, d_cfg, prompt, 0, d_cache, d_cross)
    lastl = biased(t_logits[:, -1, :])
    first = lastl.argmax(dim=-1)
    lp = torch.log_softmax(lastl.float(), dim=-1)
    sum_lp = lp.gather(-1, first[:, None])[:, 0]
    tokens[:, P] = first
    finished = first == eot
    no_speech_prob = _no_speech_prob(t_logits, prompt, t_cfg)

    # q: the position of the newest token, whose K/V neither cache holds
    # yet; n: tokens emitted after the first pick (greedy's max_new counts
    # the loop's tokens)
    q = P
    n = rounds = accepted = fills = 0
    while n < max_new and not bool(finished.all()):
        kr = min(k, n_ctx - 1 - q)
        # 1) the draft proposes kr tokens, one T==1 pass each
        last_tok = tokens[:, q]
        cur, drafts = last_tok, []
        for i in range(kr):
            logits, _ = decoder_forward(d_params, d_cfg, cur[:, None], q + i,
                                        d_cache, d_cross)
            cur = biased(logits[:, -1, :]).argmax(dim=-1)
            drafts.append(cur)
        drafts = torch.stack(drafts, dim=1) if drafts else \
            tokens.new_empty((B, 0))                            # (B, kr)
        # 2) the target verifies [last, d_1..d_kr] in one pass
        window = torch.cat([last_tok[:, None], drafts], dim=1)
        v_logits, _ = decoder_forward(t_params, t_cfg, window, q, t_cache,
                                      t_cross)
        v_biased = biased(v_logits)                             # (B, kr+1, V)
        greedy = v_biased.argmax(dim=-1)
        # 3) lockstep acceptance: the leading drafts that match the
        #    target's argmax, the minimum over the live rows
        m_row = torch.cumprod((drafts == greedy[:, :kr]).long(), dim=1).sum(1)
        m = int(torch.where(finished, torch.full_like(m_row, kr),
                            m_row).min())
        # 4) the (kr+1)-wide slab d_1..d_m, g_m, EOT padding; nothing
        #    follows an emitted EOT
        j = torch.arange(kr + 1, device=dev)[None, :]
        gm = greedy[:, m:m + 1]
        dpad = torch.cat([drafts, gm], dim=1)
        slab = torch.where(j < m, dpad,
                           torch.where(j == m, gm, torch.full_like(dpad, eot)))
        is_eot = slab == eot
        after_eot = torch.cumsum(is_eot.long(), dim=1) - is_eot.long() > 0
        slab = torch.where(after_eot | finished[:, None],
                           torch.full_like(slab, eot), slab)
        # the emitted tokens' logprobs under the target: j <= m, not past
        # the cap, not after the row finished
        lps = torch.log_softmax(v_biased.float(), dim=-1)
        tok_lp = lps.gather(-1, slab[:, :, None])[..., 0]
        emit = ((j <= m) & ~finished[:, None] & ~after_eot
                & (n + j < max_new))
        sum_lp = sum_lp + torch.where(emit, tok_lp,
                                      torch.zeros_like(tok_lp)).sum(dim=1)
        # full acceptance leaves d_kr unfed: write its draft row at q + kr,
        # or the next round's draft would read a hole there
        if m == kr and kr > 0:
            decoder_forward(d_params, d_cfg, drafts[:, kr - 1:kr], q + kr,
                            d_cache, d_cross)
            fills += 1
        tokens[:, q + 1:q + kr + 2] = slab
        # only the accepted part (j <= m) can finish a row: past m is
        # padding, which the next round rewrites
        finished = finished | ((slab == eot) & (j <= m)).any(dim=1)
        q += m + 1
        n += m + 1
        rounds += 1
        accepted += m

    tokens = tokens[:, :P + 1 + max_new]
    res = DecodeResult(tokens=tokens, lengths=_lengths(tokens, P, eot),
                       sum_logprobs=sum_lp, no_speech_prob=no_speech_prob)
    return res, {"rounds": rounds, "accepted_drafts": accepted,
                 "draft_fills": fills}


@torch.inference_mode()
def speculative_decode(t_params, t_cfg: WhisperConfig,
                       d_params, d_cfg: WhisperConfig,
                       t_enc_out: torch.Tensor, d_enc_out: torch.Tensor,
                       prompt: torch.Tensor, max_new: Optional[int] = None,
                       k: int = 4, logit_bias: Optional[torch.Tensor] = None,
                       return_stats: bool = False):
    """Greedy decode of the TARGET model, accelerated by a draft model
    (:201). The tokens equal greedy_decode(t_params, t_cfg, ...)'s;
    speculation changes the launches, never the output. prompt: (B, P)
    int64 on the encoder outputs' device (build_prompt gives the same ids
    for both models of a valid pair); k: draft tokens a round.

    return_stats=True also returns {"rounds", "accepted_drafts",
    "draft_fills"} (ints): verify rounds run, draft tokens accepted (the
    acceptance rate is accepted_drafts / (rounds * k)), and the port's
    count of full-acceptance fill passes (JAX gives the first two).

    self_kv_quant is turned off on both configs, as in JAX (:228-231): its
    commuted T==1 arithmetic rounds otherwise than the verify window's
    read, and the tokens would stop being greedy's."""
    if t_cfg.self_kv_quant:
        t_cfg = t_cfg.replace(self_kv_quant=False)
    if d_cfg.self_kv_quant:
        d_cfg = d_cfg.replace(self_kv_quant=False)
    _check_pair(t_cfg, d_cfg)
    if max_new is None:
        max_new = t_cfg.max_new_tokens
    if k < 1:
        raise ValueError("k must be >= 1")
    with full_fp32(compute_dtype(t_cfg) == torch.float32):
        res, stats = _spec_loop(t_params, t_cfg, d_params, d_cfg, t_enc_out,
                                d_enc_out, prompt, logit_bias, int(k),
                                int(max_new))
    return (res, stats) if return_stats else res


def spec_transcribe_window(target, draft, audio: np.ndarray,
                           language: str = "en", task: str = "transcribe",
                           max_new: Optional[int] = None, k: int = 4):
    """One <= 30 s window through the speculative path (:243). target and
    draft: WhisperPipeline instances of a valid pair, on one device. Each
    model computes its own mel and encoder output. The tokens are
    target.transcribe_window's greedy tokens (with self_kv_quant off, see
    speculative_decode). Returns a pipeline Transcription whose timings
    hold encode_s, decode_s, total_s, draft_k, verify_rounds,
    accepted_drafts and draft_fills."""
    from whisper_tpu_torch.pipeline import Transcription

    t_cfg, d_cfg = target.cfg, draft.cfg
    _check_pair(t_cfg, d_cfg)
    dev = target.device
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
        else (lambda: None)
    t0 = time.perf_counter()

    def enc(pipe):
        wav = torch.from_numpy(pad_or_trim(audio, pipe.cfg.n_samples)[None])
        return encode(pipe.params, pipe.cfg,
                      log_mel_spectrogram(wav.to(pipe.device), pipe.cfg))

    t_enc, d_enc = enc(target), enc(draft)
    if language == "auto":
        language = target.detect_language(t_enc)
    prompt = torch.tensor([build_prompt(t_cfg, language, task)],
                          dtype=torch.long, device=dev)
    sync()              # both encoders' time in encode_s
    t1 = time.perf_counter()
    res, stats = speculative_decode(target.params, t_cfg, draft.params, d_cfg,
                                    t_enc, d_enc, prompt, max_new=max_new,
                                    k=k, return_stats=True)
    ids = res.tokens[0, :int(res.lengths[0])].tolist()
    t2 = time.perf_counter()
    return Transcription(
        text=target.tokenizer.decode(ids), tokens=ids,
        timings={"encode_s": t1 - t0, "decode_s": t2 - t1,
                 "total_s": t2 - t0, "draft_k": k,
                 "verify_rounds": stats["rounds"],
                 "accepted_drafts": stats["accepted_drafts"],
                 "draft_fills": stats["draft_fills"]})
