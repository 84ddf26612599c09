"""Open-loop arrivals into the continuous-batching engine
(`whisper_tpu_torch.serving_continuous.ContinuousBatcher`), driven in
process through its public calls: `submit` with `on_token` and a
callback, `step`, `queue_stats`, `warmup`.

The schedule. `n = rate x seconds` requests; their inter-arrival gaps
are the n quantiles of an exponential distribution (a Poisson process's
gaps), put in an order drawn from the seed and scaled so the last falls
inside the window. Half the requests carry the plain prompt; the other
half are long-form continuations whose `<|startofprev|>` text has
lengths evenly spaced over the mix's range, also in an order from the
seed. So every seed offers the same sizes and arrivals in another order,
and the seed does not change the work. Token ids of the previous text,
the audio and which request is which kind come from the seed.

The window. Requests are submitted when due, between engine steps (a
step that fills takes the time of a 32-row encode); the engine steps
while any request is outstanding. After `seconds` no request is due;
the engine drains what it holds, for at most the cell's `drain_s`. A
request's time to first token runs from its due time to the host
receiving its first token (`on_token`); its gaps are between its
consecutive tokens. A refused request (QueueFull) or one unfinished
when the drain ends counts as failed, with a time to first token of
(drain end - due): it misses any limit. With --trace 1 a stretch of the
window (the cell's `trace`) runs under `torch.profiler`; the host's
steps and waits are recorded to name the device's idle gaps.
"""

from __future__ import annotations

import collections
import time
from typing import Optional

import numpy as np

from portbench import costs, stats, trace, weights

BUCKETS = (8, 16, 32, 64, 128, 256, 448)   # the engine's prefill buckets


def prompt_ids(cfg: dict, prev: Optional[list]) -> list:
    """The prompt the engine builds for English transcription without
    timestamps, from the configuration's token ids."""
    ids = [cfg["prev_sot_token_id"], *prev] if prev else []
    return ids + [cfg["decoder_start_token_id"], cfg["lang_en_token_id"],
                  cfg["transcribe_token_id"], cfg["no_timestamps_token_id"]]


def schedule(traffic: dict, rate: float, seconds: float, seed: int) -> list:
    """The requests of one run: [{due (s from the window's start), prev
    (ids or None), clip (index into the audio pool)}], by due time."""
    n = max(1, int(round(rate * seconds)))
    rng = np.random.default_rng(weights.subseed(seed, "schedule"))
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n)
    rng.shuffle(gaps)
    due = np.cumsum(gaps)
    due *= seconds * n / (n + 1) / due[-1]
    n_long = int(round(n * (1.0 - traffic["plain_share"])))
    lo, hi = traffic["prev_tokens"]
    lengths = np.round(np.linspace(lo, hi, n_long)).astype(int)
    rng.shuffle(lengths)
    long_at = set(rng.permutation(n)[:n_long].tolist())
    id_lo, id_hi = traffic["prev_ids"]
    clips = rng.integers(0, traffic["clips"], size=n)
    reqs, k = [], 0
    for i in range(n):
        prev = None
        if i in long_at:
            prev = rng.integers(id_lo, id_hi, size=int(lengths[k])).tolist()
            k += 1
        reqs.append({"due": float(due[i]), "prev": prev,
                     "clip": int(clips[i])})
    return reqs


def buckets_of(cfg: dict, traffic: dict) -> tuple:
    """The prefill buckets the mix reaches: a fill pads to the bucket of
    its longest joining prompt, the plain prompt's or a continuation's."""
    lo, hi = traffic["prev_tokens"]
    lengths = [len(prompt_ids(cfg, None))] + [
        len(prompt_ids(cfg, [0] * n)) for n in range(lo, hi + 1)]
    return tuple(sorted({next(b for b in BUCKETS if b >= p)
                         for p in lengths}))


class Program:
    """The engine under test, built as the server builds it."""

    def __init__(self, ctx):
        import torch

        from whisper_tpu_torch.decode_rules import DecodeOptions
        from whisper_tpu_torch.serving_continuous import (
            ContinuousBatcher,
            QueueFull,
        )
        cell, cfg, tr = ctx.cell, ctx.config, ctx.traffic
        pipe = pipeline(ctx)
        self.banned = [cfg["eos_token_id"]] if "eot" in tr["ban"] else []
        opts = DecodeOptions(suppress_tokens=tuple(self.banned),
                             suppress_blank=False, timestamps=False)
        self.engine = ContinuousBatcher(
            pipe.params, pipe.cfg, max_slots=cell["slots"],
            max_new=tr["max_new"], tokenizer=pipe.tokenizer, opts=opts,
            sync_every=cell["sync_every"], max_queue=cell["max_queue"],
            device=ctx.device)
        del pipe
        self.QueueFull = QueueFull
        self.clips = weights.audio_pool(
            tr["clips"], tr["audio_s"] * cfg["sampling_rate"],
            cfg["sampling_rate"], ctx.seed, ctx.device)
        self.engine.warmup(buckets_of(cfg, tr))
        if ctx.trace:
            trace.Capture.prime()
        if ctx.device == "cuda":
            torch.cuda.synchronize()


def pipeline(ctx):
    """`WhisperPipeline.from_params` on weights drawn from the seed, in the
    cell's dtype and quant policy; for a vocabulary one longer than the
    bundled table (large-v3's), the table with <|yue|>, the 100th
    language, at 50358, written for the tokenizer to read under TMPDIR."""
    import tempfile

    import torch

    from whisper_tpu_torch.pipeline import WhisperPipeline
    from whisper_tpu_torch.tokenizer import Tokenizer
    cell, cfg = ctx.cell, ctx.config
    params = weights.make(cfg, ctx.seed, ctx.device,
                          getattr(torch, cell["dtype"]))
    tokens = Tokenizer().tokens
    with tempfile.TemporaryDirectory() as tmp:
        vocab = None
        if cfg["vocab_size"] == len(tokens) + 1:
            tokens.insert(50_358, "<|yue|>")
            vocab = f"{tmp}/vocab.txt"
            with open(vocab, "w", encoding="utf-8") as f:
                f.write("\n".join(tokens) + "\n")
        pipe = WhisperPipeline.from_params(
            params, cell["model"], dtype=cell["dtype"], device=ctx.device,
            vocab_path=vocab, quant=cell["quant"])
    check_model(pipe.cfg, cfg)
    return pipe


def check_model(pcfg, cfg: dict) -> None:
    """The program's preset has the configuration file's sizes."""
    got = {"d_model": pcfg.d_model, "heads": pcfg.n_heads,
           "encoder_layers": pcfg.n_audio_layers,
           "decoder_layers": pcfg.n_text_layers, "mels": pcfg.n_mels,
           "vocab": pcfg.vocab_size, "eot": pcfg.eot_token,
           "no_timestamps": pcfg.no_timestamps_token}
    want = {"d_model": cfg["d_model"],
            "heads": cfg["encoder_attention_heads"],
            "encoder_layers": cfg["encoder_layers"],
            "decoder_layers": cfg["decoder_layers"],
            "mels": cfg["num_mel_bins"], "vocab": cfg["vocab_size"],
            "eot": cfg["eos_token_id"],
            "no_timestamps": cfg["no_timestamps_token_id"]}
    if got != want:
        raise SystemExit(f"the program's preset {pcfg.name} is {got}, the "
                         f"configuration file says {want}")


def setup(ctx) -> Program:
    return Program(ctx)


def teardown(prog: Program) -> None:
    prog.engine = None


def window(ctx, prog: Program, rate: Optional[float] = None,
           seconds: Optional[float] = None) -> dict:
    """Drive the schedule through the engine; the observations."""
    import torch

    rate = ctx.cell["rate"] if rate is None else rate
    seconds = ctx.seconds if seconds is None else seconds
    eng, cfg, cell = prog.engine, ctx.config, ctx.cell
    reqs = schedule(ctx.traffic, rate, seconds, ctx.seed)
    for r in reqs:
        r.update(prompt=prompt_ids(cfg, r["prev"]), toks=[], refused=False,
                 ids=None, admit=None, sent=None)
    by_rid, fifo = {}, collections.deque()
    steps: list[tuple[float, float, int]] = []
    depth_samples: list[tuple[float, int]] = []
    clock = time.perf_counter
    live = [0]
    in_slots = 0

    def on_token(rid, _tok):
        by_rid[rid]["toks"].append(clock())

    def on_done(rid, ids):
        by_rid[rid]["ids"] = ids
        live[0] -= 1

    tr_cfg = cell["trace"]
    cap = trace.Capture() if ctx.trace else None
    spans: list[tuple[float, float, str]] = []
    t0 = clock()
    close, give_up = t0 + seconds, t0 + seconds + cell["drain_s"]
    i, n = 0, len(reqs)
    while True:
        now = clock()
        if cap is not None:
            cap.at(now - t0, tr_cfg["at_s"], tr_cfg["length_s"])
        while i < n and t0 + reqs[i]["due"] <= now:
            r = reqs[i]
            i += 1
            r["sent"] = now
            try:
                rid = eng.submit(prog.clips[r["clip"]], callback=on_done,
                                 on_token=on_token, prev_tokens=r["prev"])
            except prog.QueueFull:
                r["refused"] = True
                continue
            by_rid[rid] = r
            fifo.append(r)
            live[0] += 1
        if live[0] > 0:
            d0 = eng.queue_stats()["depth"]
            ts = clock()
            eng.step()
            te = clock()
            admitted = d0 - eng.queue_stats()["depth"]
            for _ in range(admitted):
                fifo.popleft()["admit"] = ts
            steps.append((ts, te, admitted))
            spans.append((ts, te, "step.fill" if admitted else "step.token"))
            depth = eng.queue_stats()["depth"]
            depth_samples.append((te - t0, depth))
            in_slots = max(in_slots, live[0] - depth)
        elif i >= n:
            break
        else:
            ws = clock()
            time.sleep(max(0.0, min(t0 + reqs[i]["due"] - ws, 0.05)))
            spans.append((ws, clock(), "wait for arrivals"))
        if clock() > give_up:
            break
    if cap is not None:
        cap.stop()
    t_end = clock()
    left = [rid for rid, r in by_rid.items() if r["ids"] is None]
    for rid in left:        # leave the engine empty for a next window
        eng.cancel(rid)
    if left:
        eng.run_until_idle()
    if ctx.device == "cuda":
        torch.cuda.synchronize()

    failed = 0
    unfinished = 0
    for r in reqs:
        r["due_abs"] = t0 + r["due"]
        if r["refused"] or r["ids"] is None:
            failed += 1
            unfinished += 0 if r["refused"] else 1
            r["ttft"] = t_end - r["due_abs"]
        else:
            r["ttft"] = r["toks"][0] - r["due_abs"]
    obs = {"kind": "open_loop", "rate": rate, "seconds": seconds,
           "attempted": n, "failed": failed, "requests": reqs,
           "steps": steps, "slots": eng.B, "t0": t0, "t_end": t_end,
           "depth": depth_samples, "drain_s": t_end - close,
           "counts": {"unfinished": unfinished,
                      "prompt_mismatch": sum(
                          1 for r in reqs if r["ids"] is not None
                          and r["ids"][:len(r["prompt"])] != r["prompt"])}}
    late = [r["sent"] - r["due_abs"] for r in reqs if r["sent"] is not None]
    fill_run, run = 0, 0
    for _, _, admitted in steps:
        run = run + 1 if admitted else 0
        fill_run = max(fill_run, run)
    ctx.note(f"open loop: {n} requests at {rate!r}/s over {seconds!r} s, "
             f"{failed} failed ({unfinished} unfinished), drain "
             f"{obs['drain_s']!r} s, submit lateness p95 "
             f"{float(np.percentile(late, 95)) * 1e3!r} ms; samples: ttft "
             f"{n}, gaps {sum(max(0, len(r['toks']) - 1) for r in reqs)}")
    # a burst of fills advances live requests one token a fill, so the
    # slots fill up and arrivals wait for one to free: the TTFT tail
    ctx.note(f"engine: slots in use at most {in_slots} of {eng.B}, longest "
             f"run of fills {fill_run}, queue depth at most "
             f"{max((d for _, d in depth_samples), default=0)}")
    # the host-timed layer metrics read the window up to a second before
    # the traced stretch: tracing slows the steps, and the backlog it
    # leaves lasts past its end
    lo = cap.lo_perf - 1.0 if cap is not None and cap.done else close
    obs["untraced"] = [(t0, max(t0, min(close, lo)))]
    obs["useful_flops"] = useful_flops(cfg, reqs, *obs["untraced"][0])
    if cap is not None and cap.done:
        obs["trace"] = cap.reduce(spans, {"tail": [
            *cell["tail_kernels"], cell["tail_grid"]["kernel"]]})
        stats.reckon_tail(obs["trace"], cfg, cell)
        ctx.note(stats.kernels_note(obs["trace"]))
    return obs


def useful_flops(cfg: dict, reqs: list, lo: float, hi: float) -> float:
    """The model FLOPs of the useful work between host times lo and hi:
    each joining row's encoder, cross K/V and prompt prefill (no logits)
    for fills that started then, and one T==1 step at its kv length for
    each token received then. The padded rows of a fill are not counted."""
    flops = 0.0
    for r in reqs:
        p = len(r["prompt"])
        if r["admit"] is not None and lo <= r["admit"] < hi:
            flops += (costs.encoder_flops(cfg, 1)
                      + costs.cross_kv_flops(cfg, 1)
                      + costs.prefill_flops(cfg, p, logits=False))
        for j, t in enumerate(r["toks"]):
            if lo <= t < hi:
                flops += costs.decode_step_flops(cfg, p + j)
    return flops


def sample(ctx, prog: Program, obs: dict) -> dict:
    """Finished requests for the reference: the one with the longest
    prompt, then others drawn from the seed, `sample.requests` in all."""
    done = [r for r in obs["requests"] if r["ids"] is not None]
    rng = np.random.default_rng(weights.subseed(ctx.seed, "sample"))
    want = min(ctx.cell["sample"]["requests"], len(done))
    longest = max(range(len(done)), key=lambda j: len(done[j]["prompt"]),
                  default=None)
    pick = [] if longest is None else [longest]
    rest = [j for j in rng.permutation(len(done)).tolist() if j != longest]
    pick += rest[:max(0, want - 1)]
    chosen = [done[j] for j in pick]
    return {"audio": np.stack([prog.clips[r["clip"]] for r in chosen])
            if chosen else np.zeros((0, 1), np.float32),
            "prompts": [r["prompt"] for r in chosen],
            "served": [r["ids"][len(r["prompt"]):] for r in chosen],
            "banned_ids": prog.banned,
            "banned_from": ctx.config["no_timestamps_token_id"] + 1}
