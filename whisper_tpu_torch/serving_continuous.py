"""Continuous batching: sequences join and leave a shared decode batch at
token granularity (whisper_tpu/serving_continuous.py).

One lockstep T==1 step (models/whisper.py decoder_step_ragged) runs over
B slots; each slot carries its own position, cache region, cross-attention
state and prompt length. New requests claim a free slot between steps:
their prompts fill the cache in one batched prefill, and the first engine
step recomputes the last prompt position and emits the first token.
Finished slots are harvested and refilled at the next fill.

As in the JAX engine, every per-step shape is fixed at B slots, whatever
the occupancy: rows without a live request flow through the math at a
clamped position and their results are masked out afterwards. So a
request's tokens do not depend on its slot, its companions or when it
arrives, and each step ends in exactly one cache_append_rows_ragged
launch. Nothing in a step reads the device from the host: the host reads
the state once per sync (`_snapshot`).

Differences from the JAX engine, all deliberate:
  * The state's tensors are updated in place (JAX donates and rebuilds
    them); `reset_state` builds them anew.
  * `step_device(k)` runs k single steps; the JAX `lax.scan` form exists
    for XLA.
  * A fill encodes and projects its n joining rows only, where JAX pads
    them to the B slots so that its traced shapes stay fixed; the conv
    stem runs a row at a time (`_encode_rows`), so the tokens are the
    same. The batched prefill still runs over the full slot batch (its
    GEMMs round by their row count, and a pass costs the same host time
    at 1 row as at 32), once for each prompt bucket among the joining
    rows, so that each row prefills in its own bucket. It writes into a
    scratch cache of p_pad slots and copies only the joining rows into the
    state's cache: the port's decoder_forward writes the cache it is given
    in place, where JAX computes a new cache and merges it.
  * Sampling (opts.temperature > 0) adds Gumbel noise that is a hash of
    (the request's seed, its position, the token id) in integer ops on
    the device (`hashed_gumbel`), where JAX folds the position into a
    per-slot PRNG key: the same distribution, another stream, and still
    a function of the request alone, never of its slot or companions.

The int8 caches run as in JAX, in its three modes (decoder_step_ragged):
cross_kv_quant (the serving default, an int8 cross cache), self_kv_quant
(bf16: an int8 self cache read scale-commuted in place, its rows appended
by the ragged kernel on int8) and kv_cache_quant (capacity mode: both
caches int8, each step's rows scattered quantized). Every cache leaf, the
per-vector scales included, is filled and copied per joining row.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from whisper_tpu_torch import weights as weights_lib
from whisper_tpu_torch.audio import log_mel_spectrogram, pad_or_trim
from whisper_tpu_torch.config import WhisperConfig, get_config
from whisper_tpu_torch.decode import detect_language, gumbel_noise
from whisper_tpu_torch.decode_rules import DecodeOptions, apply_rules
from whisper_tpu_torch.models.whisper import (
    compute_dtype,
    decoder_hidden,
    decoder_step_ragged,
    encoder_blocks,
    encoder_input,
    full_fp32,
    init_kv_cache,
    precompute_cross_kv,
)
from whisper_tpu_torch.pipeline import resolve_device
from whisper_tpu_torch.tokenizer import LANGUAGES, Tokenizer, build_prompt
from whisper_tpu_torch.utils import profiling


def _encode_rows(params, cfg: WhisperConfig, mel: torch.Tensor
                 ) -> torch.Tensor:
    """`encode` over a fill's rows, with the conv stem run one row at a
    time. cuDNN picks the stem's convolution by the batch, so a row's stem
    rounds otherwise beside other rows; the blocks after it give a row
    the same values at any row count (their products are cuBLAS GEMMs of
    M = rows x n_audio_ctx, the int8 products and the hand-written
    kernels), so they run over all the rows at once."""
    x = torch.cat([encoder_input(params["encoder"], cfg, mel[i:i + 1])
                   for i in range(mel.shape[0])])
    return encoder_blocks(params, cfg, x)


def _prefill_join(params, cfg: WhisperConfig, cache: dict, cross: dict,
                  prompts: torch.Tensor, slots: torch.Tensor) -> None:
    """Batched prefill for joining slots (:43): ONE decoder pass over the
    full slot batch at positions [0, p_pad), into a scratch cache of p_pad
    slots; then the joining rows' columns [0, p_pad) are copied into the
    state's cache, in place. Live rows' cache is never written. Rows whose
    own prompt is shorter than p_pad get junk K/V in columns [P_r, p_pad),
    which is sound: the engine writes each column at pos == col before any
    read reaches it.

    prompts: (B, p_pad) EOT-padded, row b = slot b; slots: (n,) the
    joining slots' indices on the device. The scratch takes the compute
    dtype, so that init_kv_cache's rule gives it the state cache's layout
    (int8 with scales, or not), and every leaf of it is copied, as JAX
    merges every leaf (:62-69)."""
    B, p_pad = prompts.shape
    scratch = init_kv_cache(cfg, B, compute_dtype(cfg), p_pad,
                            prompts.device)
    decoder_hidden(params, cfg, prompts, 0, scratch, cross)
    for name, leaf in cache.items():
        leaf[:, :, :, :p_pad].index_copy_(
            1, slots, scratch[name].index_select(1, slots))


_MASK32 = 0xFFFFFFFF


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A bijective 32-bit integer hash (two xor-shift-multiply rounds and
    a final xor-shift) of int64 values in [0, 2**32). The multiplier is
    below 2**31, so no int64 product overflows."""
    x = (((x >> 16) ^ x) * 0x45D9F3B) & _MASK32
    x = (((x >> 16) ^ x) * 0x45D9F3B) & _MASK32
    return (x >> 16) ^ x


def hashed_gumbel(seed: torch.Tensor, pos: torch.Tensor, vocab: int
                  ) -> torch.Tensor:
    """(B, vocab) fp32 Gumbel noise, element (b, t) a pure function of
    (seed[b], pos[b], t): a counter-based stream, so a request's draws do
    not depend on its slot or on the other rows. The top 24 bits of the
    hash give U = k * 2**-24, exact in fp32 and at most 1 - 2**-24; G is
    decode.gumbel_noise(U), finite at every k."""
    row = _mix32(_mix32(seed & _MASK32) ^ pos)                 # (B,)
    tok = _mix32(torch.arange(vocab, device=seed.device))       # (vocab,)
    h = _mix32(row[:, None] ^ tok[None, :])
    return gumbel_noise((h >> 8).float() * (1.0 / (1 << 24)))


def _engine_step_impl(params, cfg: WhisperConfig, state: dict,
                      opts: Optional[DecodeOptions] = None) -> dict:
    """One lockstep token for every active slot (:72), in place.

    state: dict with
      tokens (B, total) int64  per-slot token buffer (prompt pre-written)
      pos (B,) int64           tokens written so far (also cache length)
      forced_len (B,) int64    prompt length (teacher-forced region)
      cap (B,) int64           per-row stop position (prompt + 1 + max_new)
      active (B,) bool         slot holds a live request
      finished (B,) bool       slot hit EOT or its cap (awaiting harvest)
      seed (B,) int64          per-slot sampling seed (temperature > 0)
      rows (B,) int64          0..B-1, kept for indexing
      cache {k, v}             (L, B, H, n_text_ctx, D) self-attention cache
                               (int8 with {k_s, v_s} (..., 1) fp32 scales
                               under kv_cache_quant, or self_kv_quant in
                               bf16)
      cross {k, v}             (L, B, H, n_audio_ctx, D) per-slot cross K/V
                               (int8 with scales under kv_cache_quant or
                               cross_kv_quant)

    The same rule stack as greedy_decode runs on the logits when `opts` is
    given, with per-row pos and prompt length; at opts.temperature > 0
    the pick is argmax(l / T + hashed_gumbel(seed, pos)), the row's draw
    from softmax(l / T) keyed by its own seed and position (:107-114)."""
    tokens, pos, rows = state["tokens"], state["pos"], state["rows"]
    run = state["active"] & ~state["finished"]
    # inactive rows still flow through the math (masked out below); clamp
    # their positions for safe indexing
    safe_pos = (pos - 1).clamp(0, cfg.n_text_ctx - 1)
    last = tokens[rows, safe_pos][:, None]                    # (B, 1)

    logits, _ = decoder_step_ragged(params, cfg, last, safe_pos,
                                    state["cache"], state["cross"])
    lg = logits[:, -1, :]
    if opts is not None:
        lg = apply_rules(lg, tokens, pos, state["forced_len"], cfg, opts)
    if opts is not None and opts.temperature > 0:
        lg = lg.float() / opts.temperature + hashed_gumbel(
            state["seed"], pos, lg.shape[-1])
    nxt_model = lg.argmax(dim=-1)

    in_prompt = pos < state["forced_len"]
    at = pos.clamp(0, tokens.shape[1] - 1)
    cur = tokens[rows, at]
    nxt = torch.where(in_prompt, cur, nxt_model)

    # write the generated token (the forced region already holds its own)
    write = run & ~in_prompt
    tokens[rows, at] = torch.where(write, nxt, cur)

    hit_cap = pos + 1 >= state["cap"]
    newly = run & ((write & (nxt == cfg.eot_token)) | hit_cap)
    state["finished"] |= newly
    pos.copy_(torch.where(run, pos + 1, pos))
    return state


class QueueFull(RuntimeError):
    """Admission bound hit: the engine's wait queue is at max_queue.

    Raised by submit() so callers get backpressure at enqueue time instead
    of unbounded latency."""


@dataclasses.dataclass
class _Slot:
    request_id: int
    callback: Optional[Callable]
    on_token: Optional[Callable] = None
    emitted: int = 0                 # tokens already streamed
    cancelled: bool = False          # harvest frees the slot silently


class ContinuousBatcher:
    """Slot-based continuous transcription engine (driven from one thread:
    call submit() / run_until_idle(); results are delivered to callbacks
    or collected from run_until_idle's return).

    Runs on `device` ("cuda" by default; raises when CUDA is absent, as
    pipeline.resolve_device does); device="cpu" runs the kernels' plain
    versions. `params`: a params tree of CPU or device tensors, cast and
    moved as WhisperPipeline does (weights.to_device)."""

    # prompt-length buckets of the batched prefill (:387)
    _P_BUCKETS = (8, 16, 32, 64, 128, 256, 448)

    def __init__(self, params, cfg: WhisperConfig | str, max_slots: int = 8,
                 max_new: Optional[int] = None,
                 tokenizer: Optional[Tokenizer] = None,
                 opts: Optional[DecodeOptions] = None,
                 sync_every: int = 1,
                 max_queue: Optional[int] = None,
                 device="cuda"):
        self.cfg = get_config(cfg) if isinstance(cfg, str) else cfg
        cfg = self.cfg
        self.device = resolve_device(device)
        dtype = compute_dtype(cfg)
        self.params = weights_lib.to_device(
            params, self.device, None if dtype == torch.float32 else dtype)
        self.tokenizer = tokenizer or Tokenizer(config=cfg)
        self.B = int(max_slots)
        self.opts = opts
        # Admission policy: FIFO; nothing running is displaced. max_queue
        # bounds the wait line (submit raises QueueFull beyond it).
        self.max_queue = max_queue
        # device steps per host sync: 1 harvests and streams at token
        # granularity; K > 1 enqueues K steps before reading the state, at
        # the cost of up to K-1 idle steps for rows that finish mid-window
        self.sync_every = max(1, int(sync_every))
        self._timestamps = bool(opts and opts.timestamps)
        self.base_p = len(build_prompt(cfg, timestamps=self._timestamps))
        self.max_new = max_new or cfg.max_new_tokens
        # total sized for the worst prompt (base + up to max_prev tokens of
        # <|startofprev|> conditioning), clamped to the context window
        self.max_prev = cfg.n_text_ctx // 2 - self.base_p - 1
        self.total = cfg.n_text_ctx
        self.state = self._fresh_state()
        self._slots: list[Optional[_Slot]] = [None] * self.B
        # queue entries: (rid, audio, (language, task), callback, on_token,
        #                 seed, prev, t_submit)
        self._queue: list[tuple] = []
        self._next_id = 0
        self._results: dict[int, list[int]] = {}
        # queue-wait telemetry (seconds from submit to slot entry) over a
        # bounded window of recent waits
        self._waits: list[float] = []
        self._max_wait_s = 0.0
        self._served = 0

    def _fresh_state(self) -> dict:
        """A zeroed device state (see _engine_step_impl), as JAX builds it
        (:233): the self cache by init_kv_cache's rule; the cross cache
        int8 under kv_cache_quant or cross_kv_quant, its scales starting at
        1e-10."""
        cfg = self.cfg
        dev, B = self.device, self.B
        dtype = compute_dtype(cfg)
        cache = init_kv_cache(cfg, B, dtype, cfg.n_text_ctx, dev)
        L, _, H, _, D = cache["k"].shape
        cross_shape = (L, B, H, cfg.n_audio_ctx, D)

        def full(value, dt):
            return torch.full((B,), value, dtype=dt, device=dev)

        if cfg.kv_cache_quant or cfg.cross_kv_quant:
            def scales():
                return torch.full(cross_shape[:-1] + (1,), 1e-10,
                                  dtype=torch.float32, device=dev)
            cross = {"k": torch.zeros(cross_shape, dtype=torch.int8,
                                      device=dev),
                     "k_s": scales(),
                     "v": torch.zeros(cross_shape, dtype=torch.int8,
                                      device=dev),
                     "v_s": scales()}
        else:
            cross = {name: torch.zeros(cross_shape, dtype=dtype, device=dev)
                     for name in ("k", "v")}

        return {
            "tokens": torch.full((B, self.total), cfg.eot_token,
                                 dtype=torch.long, device=dev),
            "pos": full(0, torch.long),
            "forced_len": full(0, torch.long),
            "cap": full(self.total, torch.long),
            "active": full(False, torch.bool),
            "finished": full(False, torch.bool),
            "seed": full(0, torch.long),
            "rows": torch.arange(B, device=dev),
            "cache": cache,
            "cross": cross,
        }

    def reset_state(self) -> None:
        """Discard all device state and clear every slot."""
        self.state = self._fresh_state()
        self._slots = [None] * self.B

    def warmup(self, buckets: Optional[tuple] = None) -> None:
        """Drive one throwaway request per prompt bucket through the normal
        fill -> step -> harvest path (:275), then reset all state and
        telemetry; the tracer records none of it. Default buckets: the
        smallest and the largest. On the card this builds the kernels and
        settles cuBLAS's and the caching allocator's first-call work
        before traffic."""
        if buckets is None:
            buckets = (self._P_BUCKETS[0], self._P_BUCKETS[-1])
        base = len(build_prompt(self.cfg, "en", "transcribe",
                                timestamps=self._timestamps))
        audio = np.zeros((self.cfg.n_samples,), np.float32)
        saved_max_new = self.max_new
        self.max_new = 1                    # shapes don't depend on it
        try:
            with profiling.paused():
                for pb in sorted(set(buckets)):
                    prev_len = pb - base - 1    # +1 for <|startofprev|>
                    prev = ([self.cfg.eot_token] * prev_len
                            if prev_len > 0 else None)
                    self.submit(audio, prev_tokens=prev, admitted=True)
                self.run_until_idle()
        finally:
            self.max_new = saved_max_new
            self.reset_state()
            self._queue.clear()
            self._results.clear()
            self._waits.clear()
            self._max_wait_s = 0.0
            self._served = 0

    # ---- client API ----
    def submit(self, audio: np.ndarray, language: str = "en",
               task: str = "transcribe",
               callback: Optional[Callable] = None,
               on_token: Optional[Callable] = None,
               seed: Optional[int] = None,
               prev_tokens: Optional[list] = None,
               admitted: bool = False) -> int:
        """Queue a request; returns its id (:314). Final tokens go to
        callback(request_id, token_ids) and run_until_idle()'s dict;
        on_token(request_id, token_id) streams each generated token as it
        is committed. `seed` fixes this request's sampling stream when
        opts.temperature > 0 (default: the request id). `prev_tokens` prepends <|startofprev|> conditioning
        (one batched prefill at slot fill, whatever its length). Raises
        QueueFull when max_queue is set and the wait line is at the bound,
        except for `admitted` submits (follow-up windows of a file already
        in service). language="auto" resolves at slot fill."""
        if (not admitted and self.max_queue is not None
                and len(self._queue) >= self.max_queue):
            raise QueueFull(
                f"engine queue is at max_queue={self.max_queue} "
                f"({self.B} slots all busy); retry later")
        rid = self._next_id
        self._next_id += 1
        prev = list(prev_tokens or [])
        if len(prev) > self.max_prev:
            prev = prev[-self.max_prev:]
        self._queue.append((rid, np.asarray(audio, np.float32),
                            (language, task), callback, on_token,
                            rid if seed is None else int(seed), prev,
                            time.monotonic(), time.time_ns()))
        return rid

    def cancel(self, rid: int) -> str:
        """Best-effort cancel (:352): "queued" (removed before touching the
        device), "active" (its slot is marked finished: the row idles from
        the next step and the harvest frees it without delivering results),
        or "done" (already finished or unknown: no-op)."""
        for i, req in enumerate(self._queue):
            if req[0] == rid:
                del self._queue[i]
                return "queued"
        for b, slot in enumerate(self._slots):
            if slot is not None and slot.request_id == rid:
                slot.cancelled = True
                slot.callback = None
                slot.on_token = None
                self.state["finished"][b] = True
                return "active"
        return "done"

    def queue_stats(self) -> dict:
        """Admission telemetry: queue depth, served count, and queue wait
        (submit -> slot entry) max and median in seconds."""
        waits = self._waits
        return {
            "depth": len(self._queue),
            "served": self._served,
            "max_wait_s": self._max_wait_s,
            "p50_wait_s": float(np.median(waits)) if waits else 0.0,
        }

    # ---- engine ----
    def _to_device(self, array: np.ndarray) -> torch.Tensor:
        """A host array on the engine's device. On the card the copy goes
        through pinned memory, so it does not wait for the queued steps."""
        t = torch.from_numpy(np.ascontiguousarray(array))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    @torch.inference_mode()
    def _fill_free_slots(self) -> int:
        """Claim free slots for queued requests (:389). The n joining
        requests share ONE (n, ...) mel, encoder and cross K/V pass over
        their own windows, whatever the slot count (`_encode_rows`), and a
        batched prefill (_prefill_join) for each of their prompt buckets;
        only the joining rows' state, cross K/V and cache columns are
        written, by their slot indices. Returns the number of requests
        that joined."""
        free = [b for b in range(self.B) if self._slots[b] is None]
        if not free or not self._queue:
            return 0
        with profiling.span("engine.fill") as sp:
            return self._fill(free, sp)

    def _fill(self, free: list, sp) -> int:
        """The fill inside its span `sp`: each part in a span of its own,
        an `admit` event per request taken (its id and submit time); the
        span's `bucket` is the largest of its rows' prefill buckets, its
        `rows` the windows encoded."""
        cfg = self.cfg
        take = self._queue[:len(free)]
        del self._queue[:len(take)]
        now = time.monotonic()
        for req in take:
            w = now - req[7]
            self._waits.append(w)
            self._max_wait_s = max(self._max_wait_s, w)
        if len(self._waits) > 1024:          # bounded telemetry window
            del self._waits[:-1024]
        if sp:
            for req in take:
                profiling.event("admit", sp.start_ns, rid=req[0],
                                submit_ns=req[8])

        n = len(take)
        slots = free[:n]
        with profiling.span("fill.audio"):
            audio = np.zeros((n, cfg.n_samples), np.float32)
            for i, req in enumerate(take):
                audio[i] = pad_or_trim(req[1], cfg.n_samples)
            wav = self._to_device(audio)
        s = self.state
        idx = self._to_device(np.asarray(slots, np.int64))
        with full_fp32(compute_dtype(cfg) == torch.float32):
            with profiling.span("fill.mel"):
                mel = log_mel_spectrogram(wav, cfg)
            del wav                     # freed before the encoder runs
            with profiling.span("fill.encode"):
                enc = _encode_rows(self.params, cfg, mel)
            del mel
            # a row at a time: a decoder pass rounds by its row count
            lang = {i: int(detect_language(self.params, cfg,
                                           enc[i:i + 1])[0].argmax())
                    for i, req in enumerate(take) if req[2][0] == "auto"}
            with profiling.span("fill.cross_kv"):
                cross = precompute_cross_kv(self.params, cfg, enc)
                for name, leaf in s["cross"].items():
                    leaf.index_copy_(1, idx, cross[name].to(leaf.dtype))
            del enc, cross

            prompts = []
            rows_np = np.full((n, self.total), cfg.eot_token, np.int64)
            pos_v = np.zeros((n,), np.int64)
            cap_v = np.zeros((n,), np.int64)
            seed_v = np.zeros((n,), np.int64)
            for i, (rid, _, (language, task), cb, on_tok, seed, prev,
                    _t, _t_ns) in enumerate(take):
                if language == "auto":
                    language = LANGUAGES[lang[i]]
                prompt = build_prompt(cfg, language, task,
                                      timestamps=self._timestamps,
                                      prev_tokens=prev)
                P = len(prompt)
                prompts.append(prompt)
                rows_np[i, :P] = prompt
                # the prefill fills cache cols [0, P); the first engine step
                # recomputes position P-1 and emits the first token
                pos_v[i] = P
                cap_v[i] = min(self.total, P + 1 + self.max_new)
                seed_v[i] = seed & _MASK32
                self._slots[slots[i]] = _Slot(rid, cb, on_tok, emitted=P)

            s["tokens"].index_copy_(0, idx, self._to_device(rows_np))
            pos_t = self._to_device(pos_v)
            s["pos"].index_copy_(0, idx, pos_t)
            s["forced_len"].index_copy_(0, idx, pos_t)
            s["cap"].index_copy_(0, idx, self._to_device(cap_v))
            s["seed"].index_copy_(0, idx, self._to_device(seed_v))
            s["active"].index_fill_(0, idx, True)
            s["finished"].index_fill_(0, idx, False)

            # one batched prefill for each prompt bucket of the joining rows
            p_pads = [next(pb for pb in self._P_BUCKETS
                           if pb >= min(len(p), self._P_BUCKETS[-1]))
                      for p in prompts]
            with profiling.span("fill.prefill"):
                for p_pad in sorted(set(p_pads)):
                    tok_pad = np.full((self.B, p_pad), cfg.eot_token,
                                      np.int64)
                    joining = [(b, p) for b, p, q in zip(slots, prompts,
                                                         p_pads) if q == p_pad]
                    for b, p in joining:
                        tok_pad[b, :min(len(p), p_pad)] = p[:p_pad]
                    rows = np.asarray([b for b, _ in joining], np.int64)
                    _prefill_join(self.params, cfg, s["cache"], s["cross"],
                                  self._to_device(tok_pad),
                                  self._to_device(rows))
        if sp:
            sp["bucket"] = max(p_pads)
            sp["rows"] = n
        return n

    def _snapshot(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(finished, pos, tokens) on the host, in ONE device read."""
        s = self.state
        with profiling.span("sync.read"):
            packed = torch.cat([s["finished"].long()[:, None],
                                s["pos"][:, None], s["tokens"]],
                               dim=1).cpu().numpy()
        return packed[:, 0].astype(bool), packed[:, 1], packed[:, 2:]

    def _stream(self, snap=None) -> None:
        """Emit newly committed tokens to per-request on_token callbacks."""
        if not any(s is not None and s.on_token for s in self._slots):
            return
        _, pos, tokens = snap if snap is not None else self._snapshot()
        for b in range(self.B):
            slot = self._slots[b]
            if slot is None or slot.on_token is None:
                continue
            while slot.emitted < pos[b]:
                slot.on_token(slot.request_id, int(tokens[b, slot.emitted]))
                slot.emitted += 1

    def _harvest(self, snap=None) -> None:
        """Deliver finished requests and free their slots."""
        finished, pos, tokens = snap if snap is not None else self._snapshot()
        if not finished.any():
            return
        for b in range(self.B):
            slot = self._slots[b]
            if slot is None or not finished[b]:
                continue
            if not slot.cancelled:
                ids = tokens[b, :pos[b]].tolist()
                self._results[slot.request_id] = ids
                if slot.callback:
                    slot.callback(slot.request_id, ids)
                self._served += 1
            self._slots[b] = None
        # every finished row was just freed, and no step ran since the
        # snapshot: clear them on the device, without a host copy
        s = self.state
        s["active"] &= ~s["finished"]
        s["finished"].zero_()

    def step_device(self, k: int = 1) -> int:
        """Fill slots and enqueue k lockstep tokens; no host read (the
        fill reads language probabilities only for language="auto").
        Returns the number of requests that joined."""
        admitted = self._fill_free_slots()
        with torch.inference_mode(), \
                full_fp32(compute_dtype(self.cfg) == torch.float32):
            for _ in range(k):
                with profiling.span("engine.token"):
                    self.state = _engine_step_impl(self.params, self.cfg,
                                                   self.state, self.opts)
        return admitted

    def sync(self) -> None:
        """Read back the device state once: stream new tokens, harvest
        finished requests."""
        if all(s is None for s in self._slots):
            return
        with profiling.span("engine.sync"):
            snap = self._snapshot()
            self._stream(snap)
            self._harvest(snap)

    def step(self) -> None:
        """Fill slots, run one lockstep token, stream, harvest."""
        with profiling.span("engine.step") as sp:
            admitted = self.step_device()
            if sp:
                sp["admitted"] = admitted
            self.sync()

    def run_until_idle(self, max_steps: int = 100_000) -> dict[int, list[int]]:
        """Drive until queue and slots are empty; returns {request_id: ids}.

        With sync_every=K > 1, K device steps are enqueued per host read;
        token results are identical (finished rows idle until the next
        harvest)."""
        steps = 0
        k = self.sync_every
        while (self._queue or any(s is not None for s in self._slots)) \
                and steps < max_steps:
            for _ in range(min(k, max_steps - steps)):
                self.step_device()
                steps += 1
            self.sync()
        return dict(self._results)

    def decode_text(self, rid: int) -> str:
        return self.tokenizer.decode(self._results[rid])
