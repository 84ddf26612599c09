"""Logit-processing rules for Whisper decoding (whisper_tpu/decode_rules.py).

The standard openai/whisper rule stack, as functions over (logits,
tokens, position) tensors:

  * suppress_tokens — ban a fixed id set every step (non-speech specials).
  * suppress_blank — ban " " and EOT at the first generated position.
  * timestamp rules — timestamps are monotone, come in pairs, and are
    forced when their total probability beats the best text token.

Each rule is a masked write or an additive bias over the (B, vocab)
logits, computed on the logits' device: `pos` and `prompt_len` may be
Python ints (the lockstep greedy loop) or (B,) tensors (the continuous
engine, where every row is at its own position). Nothing is read back to
the host, and nothing is copied to the device per call (a copy from
pageable host memory would wait for the device): ints become fills, and
the static bias is built once per (config, options, device). NEG is a
large finite negative (not -inf), so rows whose every token is
suppressed stay NaN-free.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from whisper_tpu_torch.config import WhisperConfig

NEG = -1e9


class DecodeOptions(NamedTuple):
    """Static decode-time options (hashable), the JAX package's fields."""
    suppress_tokens: tuple = ()          # extra ids to ban every step
    suppress_blank: bool = True
    timestamps: bool = False
    max_initial_timestamp_index: Optional[int] = 50   # 1.0 s at 0.02 s/step
    temperature: float = 0.0             # 0 => greedy/beam; >0 => sampling
    beam_size: int = 1
    length_penalty: Optional[float] = None  # None => simple length average


def non_speech_tokens(cfg: WhisperConfig, tokenizer=None) -> tuple:
    """The standard openai/whisper non-speech suppression set: punctuation
    runs, music symbols, etc. Computed from the vocab when a tokenizer is
    given; otherwise returns the structural specials only."""
    symbols = ('"', "#", "(", ")", "*", "+", "/", ":", ";", "<", "=", ">",
               "@", "[", "\\", "]", "^", "_", "`", "{", "|", "}", "~", "「",
               "」", "『", "』", "<<", ">>", "<<<", ">>>", "--", "---", "-(",
               "-[", "('", '("', "((", "))", "(((", ")))", "[[", "]]", "{{",
               "}}", "♪♪", "♪♪♪", "♩", "♪", "♫", "♬", "♭", "♮", "♯")
    ids = set()
    if tokenizer is not None:
        lookup = {}
        for tid, tok in enumerate(tokenizer.tokens):
            lookup.setdefault(tok, tid)
        for sym in symbols:
            for cand in (sym, "Ġ" + sym):     # "Ġ" = leading space
                if cand in lookup:
                    ids.add(lookup[cand])
    # structural: sot/task/language/notimestamps specials must never be
    # *generated* (they are prompt-only)
    ids.update(range(cfg.sot_token, cfg.timestamp_begin))
    return tuple(sorted(ids))


@functools.lru_cache(maxsize=16)
def _static_bias(cfg: WhisperConfig, opts: DecodeOptions,
                 device: torch.device) -> torch.Tensor:
    """(vocab,) fp32: NEG at the suppressed ids, and at every timestamp
    when timestamps are off. Cached: callers only read it."""
    bias = torch.zeros(cfg.vocab_size, dtype=torch.float32, device=device)
    if opts.suppress_tokens:
        bias[list(opts.suppress_tokens)] = NEG
    if not opts.timestamps and cfg.timestamp_begin < cfg.vocab_size:
        bias[cfg.timestamp_begin:] = NEG
    return bias


def _column(x, B: int, device) -> torch.Tensor:
    """An int or a (B,) tensor as a (B, 1) int64 column on `device`."""
    if isinstance(x, torch.Tensor):
        return x.long().reshape(B, 1)
    return torch.full((B, 1), int(x), dtype=torch.long, device=device)


def apply_rules(logits: torch.Tensor, tokens: torch.Tensor, pos,
                prompt_len, cfg: WhisperConfig, opts: DecodeOptions,
                blank_token: int = 220) -> torch.Tensor:
    """Apply all active rules to one step's logits (:80).

    Args:
      logits: (B, vocab) fp32, the final position's logits.
      tokens: (B, total) integer, the sequence so far (EOT-padded).
      pos: int, the index in `tokens` where the next token goes, or a
        (B,) tensor for ragged batches.
      prompt_len: int, the SOT prompt's length, or a (B,) tensor.
      opts: DecodeOptions.
      blank_token: id of "Ġ" (space); 220 in the GPT-2/whisper vocab.
    Returns:
      biased logits (B, vocab).
    """
    B, V = logits.shape
    dev = logits.device
    pos = _column(pos, B, dev)
    prompt_len = _column(prompt_len, B, dev)
    logits = logits + _static_bias(cfg, opts, dev)[None, :]

    if opts.suppress_blank:
        first = pos == prompt_len                            # (B, 1)
        vocab_idx = torch.arange(V, device=dev)
        blank_bias = torch.where((vocab_idx == blank_token)
                                 | (vocab_idx == cfg.eot_token), NEG, 0.0)
        logits = torch.where(first, logits + blank_bias[None, :], logits)

    if opts.timestamps:
        logits = _timestamp_rules(logits, tokens, pos, prompt_len, cfg, opts)
    return logits


def _timestamp_rules(logits, tokens, pos, prompt_len, cfg, opts):
    """openai/whisper ApplyTimestampRules, over the batch (:118):
      1. timestamps come in pairs (except directly before EOT): if the last
         token was a timestamp and the one before was not, the next must be
         a timestamp-or-EOT continuation => suppress text; if the last two
         were timestamps, suppress timestamps.
      2. timestamps are non-decreasing.
      3. at the first generated position, only timestamps (and EOT) are
         allowed, capped at max_initial_timestamp.
      4. if total timestamp probability exceeds the best text token, force a
         timestamp.

    pos and prompt_len arrive as (B, 1) int64 columns (see apply_rules).
    """
    B, V = logits.shape
    dev = logits.device
    ts0 = cfg.timestamp_begin
    vocab_idx = torch.arange(V, device=dev)[None, :]        # (1, V)
    is_ts_col = vocab_idx >= ts0
    # text = everything below EOT (EOT itself stays allowed where noted)
    is_text_col = vocab_idx < cfg.eot_token
    tokens = tokens.long()

    def last_tok(offset):
        i = (pos - offset).clamp(min=0)                      # (B, 1)
        return tokens.gather(1, i), (pos - offset) >= prompt_len

    t1, v1 = last_tok(1)
    t2, v2 = last_tok(2)
    last_was_ts = v1 & (t1 >= ts0)                           # (B, 1)
    penult_was_ts = v2 & (t2 >= ts0)

    # rule 1
    logits = torch.where(last_was_ts & penult_was_ts & is_ts_col, NEG, logits)
    logits = torch.where(last_was_ts & ~penult_was_ts & is_text_col, NEG,
                         logits)

    # rule 2: non-decreasing while a pair is open, strictly increasing once
    # it closed; with no timestamp yet, max_ts = ts0 - 1 suppresses nothing
    written = torch.arange(tokens.shape[1], device=dev)[None, :] < pos
    gen = torch.where(written, tokens, -1)
    max_ts = torch.where(gen >= ts0, gen, ts0 - 1).amax(dim=1)    # (B,)
    open_pair = last_was_ts & ~penult_was_ts                 # (B, 1)
    cutoff = torch.where(open_pair, max_ts[:, None], max_ts[:, None] + 1)
    logits = torch.where(is_ts_col & (vocab_idx < cutoff), NEG, logits)

    # rule 3: first generated token must be a timestamp
    first = pos == prompt_len
    allowed_first = is_ts_col | (vocab_idx == cfg.eot_token)
    if opts.max_initial_timestamp_index is not None:
        cap = ts0 + opts.max_initial_timestamp_index
        allowed_first = allowed_first & (vocab_idx <= cap)
    logits = torch.where(first & ~allowed_first, NEG, logits)

    # rule 4: force a timestamp when P(timestamps) > max P(text token)
    logp = torch.log_softmax(logits, dim=-1)
    ts_logprob = torch.logsumexp(
        torch.where(is_ts_col, logp, float("-inf")), dim=-1)
    max_text = torch.where(is_ts_col, float("-inf"), logp).amax(dim=-1)
    force_ts = (ts_logprob > max_text)[:, None]
    # openai masks logits[: timestamp_begin] here — EOT included
    return torch.where(force_ts & ~is_ts_col, NEG, logits)
