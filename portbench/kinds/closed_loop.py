"""A closed loop of back-to-back batches through
`whisper_tpu_torch.pipeline.WhisperPipeline.transcribe_batch`: each batch
is `batch` 30 s windows with the plain prompt, decoded greedily for
`max_new` steps with the banned ids at -1e9 in `logit_bias` (fixed work:
every row runs to its cap).

The window runs whole batches: it ends when the first batch that
finishes after `seconds` finishes, and a batch is complete when its
tokens are on the host. The batches cycle through a pool of distinct
audio batches drawn from the seed at set-up.

With --trace 1 every batch calls the public functions that
`transcribe_batch` calls, in its order (the audio to the device,
`log_mel_spectrogram`, `decode.encode`, `decode.decode_from_encoder`
with the prompt of `WhisperPipeline.prompt`), timed on the host with a
device sync after the front end and encoder and after the decode; one
batch of the window (the cell's `trace.batch`) runs under
`torch.profiler`, and the per-layer medians leave it out.
"""

from __future__ import annotations

import time

import numpy as np

from portbench import costs, stats, trace, weights
from portbench.kinds.open_loop import pipeline, prompt_ids


class Program:
    """The pipeline under test and its inputs."""

    def __init__(self, ctx):
        import torch
        cell, cfg, tr = ctx.cell, ctx.config, ctx.traffic
        self.pipe = pipeline(ctx)
        self.banned = [cfg["eos_token_id"]] if "eot" in tr["ban"] else []
        self.bias = torch.zeros(cfg["vocab_size"], dtype=torch.float32,
                                device=ctx.device)
        self.bias[self.banned] = -1e9
        samples = tr["audio_s"] * cfg["sampling_rate"]
        b = cell["batch"]
        pool = weights.audio_pool(tr["pool_batches"] * b, samples,
                                  cfg["sampling_rate"], ctx.seed, ctx.device)
        self.pool = pool.reshape(tr["pool_batches"], b, samples)
        self.max_new = tr["max_new"]
        self.prompt = prompt_ids(cfg, None)
        # the window's shapes and kernels, once: the prefill and two T==1
        # steps at the cell's batch (every later step runs the same ones)
        self.pipe.transcribe_batch(self.pool[0], max_new=2,
                                   logit_bias=self.bias).tokens.cpu()
        if ctx.trace:
            trace.Capture.prime()

    def batch(self, audio: np.ndarray) -> np.ndarray:
        """One batch as a user runs it; the tokens on the host."""
        res = self.pipe.transcribe_batch(audio, max_new=self.max_new,
                                         logit_bias=self.bias)
        return res.tokens.cpu().numpy()

    def batch_spans(self, audio: np.ndarray) -> tuple:
        """The same batch through transcribe_batch's calls, synchronised
        after the front end and encoder and after the decode: (tokens on
        the host, start, end of the encoder, end of the decode)."""
        import torch

        from whisper_tpu_torch.audio import log_mel_spectrogram
        from whisper_tpu_torch.decode import decode_from_encoder, encode
        pipe = self.pipe
        sync = (torch.cuda.synchronize if pipe.device.type == "cuda"
                else (lambda: None))
        t0 = time.perf_counter()
        wav = torch.from_numpy(np.ascontiguousarray(audio)).to(pipe.device)
        enc = encode(pipe.params, pipe.cfg, log_mel_spectrogram(wav, pipe.cfg))
        sync()
        t1 = time.perf_counter()
        res = decode_from_encoder(
            pipe.params, pipe.cfg, enc, pipe.prompt(audio.shape[0]),
            max_new=self.max_new, opts=None, beam_size=1, generator=None,
            logit_bias=self.bias)
        tokens = res.tokens.cpu().numpy()
        return tokens, t0, t1, time.perf_counter()


def setup(ctx) -> Program:
    return Program(ctx)


def teardown(prog: Program) -> None:
    prog.pipe = None
    prog.bias = None


def window(ctx, prog: Program) -> dict:
    """Whole batches until the first that finishes after `seconds`."""
    import torch
    cell, cfg = ctx.cell, ctx.config
    traced_batch = cell["trace"]["batch"] if ctx.trace else -1
    batches = []
    t0 = time.perf_counter()
    k = 0
    while True:
        audio = prog.pool[k % len(prog.pool)]
        cap = trace.Capture() if k == traced_batch else None
        if cap is not None:
            cap.start()
        ts = time.perf_counter()
        bt = {"pool": k % len(prog.pool), "encoder_s": None,
              "decode_s": None, "trace": None}
        if ctx.trace:
            bt["tokens"], a, b, c = prog.batch_spans(audio)
            bt["encoder_s"], bt["decode_s"] = b - a, c - b
            spans = [(a, b, "encoder"), (b, c, "decode")]
        else:
            bt["tokens"] = prog.batch(audio)
        te = time.perf_counter()
        if cap is not None:
            cap.stop()
            bt["trace"] = cap.reduce(
                spans, {"tail": [*cell["tail_kernels"],
                                 cell["tail_grid"]["kernel"]]},
                {"fused_step": cell["fused_kernel"]}
                if "fused_kernel" in cell else None)
        bt["start"], bt["end"] = ts, te
        batches.append(bt)
        k += 1
        if te - t0 >= ctx.seconds:
            break
    t_end = batches[-1]["end"]
    if ctx.device == "cuda":
        torch.cuda.synchronize()
    b = cell["batch"]
    prompt = np.asarray(prog.prompt)
    p = len(prompt)
    mismatch = sum(int((bt["tokens"][:, :p] != prompt).any(axis=1).sum())
                   for bt in batches)
    steps = prog.max_new
    obs = {"kind": "closed_loop", "attempted": b * len(batches), "failed": 0,
           "batches": batches, "t0": t0, "t_end": t_end,
           "audio_s": len(batches) * b * ctx.traffic["audio_s"],
           "rows": b, "generated": steps + 1,
           "batch_flops": costs.batch_flops(cfg, b, p, steps),
           "counts": {"prompt_mismatch": mismatch}}
    tr = next((bt["trace"] for bt in batches if bt["trace"]), None)
    if tr is not None:
        stats.reckon_tail(tr, cfg, cell)
        if "fused_kernel" in cell:
            stats.reckon_fused(tr, cfg, cell, p, steps)
        obs["trace"] = tr
        ctx.note(stats.kernels_note(tr))
    ctx.note(f"closed loop: {len(batches)} batches of {b} in "
             f"{t_end - t0!r} s; batch walls "
             f"{[round(bt['end'] - bt['start'], 4) for bt in batches]}")
    return obs


def sample(ctx, prog: Program, obs: dict) -> dict:
    """`sample.rows` rows of the window's batches, drawn from the seed
    without replacement (every row has the same length)."""
    rng = np.random.default_rng(weights.subseed(ctx.seed, "sample"))
    n_rows = obs["rows"]
    every = len(obs["batches"]) * n_rows
    pick = rng.permutation(every)[:min(ctx.cell["sample"]["rows"], every)]
    p = len(prog.prompt)
    audio, prompts, served = [], [], []
    for j in sorted(pick.tolist()):
        bt, row = obs["batches"][j // n_rows], j % n_rows
        audio.append(prog.pool[bt["pool"]][row])
        prompts.append(list(prog.prompt))
        served.append(bt["tokens"][row, p:].tolist())
    return {"audio": np.stack(audio), "prompts": prompts, "served": served,
            "banned_ids": prog.banned, "banned_from": None}
