"""Batched serving: a dynamic request batcher over one device
(whisper_tpu/serving.py).

Concurrent transcription requests are queued, grouped into batches of a
fixed size (`max_batch`, partial batches padded with silence rows), run
through mel + encoder + greedy decode, and scattered back to per-request
futures.

As in JAX:
  * The batch shape is fixed at max_batch whatever the load, and
    `batch_size` reports the real rows. With the padding a request's
    tokens do not depend on how many others share its batch, and a
    WHISPER_TPU_IP_CROSS=bgN cross read sees the batch that N divides.
  * The language/task prompt is data (a (B, P) token tensor), so one
    batch mixes languages; requests whose prompt length differs from the
    batch's fail loudly.
  * One worker thread owns the device: it is the only thread that
    launches device work, on its current stream. Callers only submit and
    wait.
  * max_wait_ms bounds the added latency: the batcher launches early when
    the queue goes quiet.

The batcher runs on `device` ("cuda" by default; raises when CUDA is
absent, as pipeline.resolve_device does); device="cpu" runs the kernels'
plain versions. A request's language and task are checked on the
caller's thread (ValueError there), so a bad request never reaches the
worker. A failure inside a batch, a kernel's included, fails every
request of that batch and leaves the worker serving.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from concurrent.futures import Future
from typing import Optional

import numpy as np
import torch

from whisper_tpu_torch import weights as weights_lib
from whisper_tpu_torch.audio import log_mel_spectrogram, pad_or_trim
from whisper_tpu_torch.config import WhisperConfig, get_config
from whisper_tpu_torch.decode import transcribe_tokens
from whisper_tpu_torch.decode_rules import DecodeOptions
from whisper_tpu_torch.models.whisper import compute_dtype
from whisper_tpu_torch.pipeline import resolve_device
from whisper_tpu_torch.tokenizer import Tokenizer, build_prompt


@dataclasses.dataclass
class ServeResult:
    text: str
    tokens: list[int]
    queued_s: float         # time spent waiting for a batch slot
    batch_size: int         # how many real requests shared the batch


@dataclasses.dataclass
class _Request:
    audio: np.ndarray
    language: str
    task: str
    future: Future
    t_submit: float


class BatchedTranscriber:
    """Dynamic batcher over one device.

    Usage:
        bt = BatchedTranscriber(params, "tiny", max_batch=8)
        fut = bt.submit(audio)           # a concurrent.futures.Future
        print(fut.result().text)
        bt.close()

    `params`: a params tree of CPU or device tensors, cast and moved as
    ContinuousBatcher does (weights.to_device); a pipeline's params (with
    its serving quantization) pass through unchanged.
    """

    def __init__(self, params, cfg: WhisperConfig | str,
                 tokenizer: Optional[Tokenizer] = None,
                 max_batch: int = 8, max_wait_ms: float = 10.0,
                 max_new: Optional[int] = None,
                 opts: Optional[DecodeOptions] = None,
                 device="cuda"):
        self.cfg = get_config(cfg) if isinstance(cfg, str) else cfg
        self.device = resolve_device(device)
        dtype = compute_dtype(self.cfg)
        self.params = weights_lib.to_device(
            params, self.device, None if dtype == torch.float32 else dtype)
        self.tokenizer = tokenizer or Tokenizer(config=self.cfg)
        self.max_batch = int(max_batch)
        self.max_wait_s = max_wait_ms / 1e3
        self.max_new = max_new
        self.opts = opts
        self._timestamps = bool(opts and opts.timestamps)
        self._q: "queue.Queue[Optional[_Request]]" = queue.Queue()
        self._closed = False
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    # ---- client API ----
    def submit(self, audio: np.ndarray, language: str = "en",
               task: str = "transcribe") -> Future:
        """Queue one request. Audio longer than a 30 s window is split
        into per-window requests (each batches with whatever else
        arrives) and the returned future joins them in order, not
        truncated. Windows are independent (openai's
        condition_on_previous_text=False); the continuous engine's
        long-form driver is the conditioned path."""
        if self._closed:
            raise RuntimeError("transcriber is closed")
        build_prompt(self.cfg, language, task, timestamps=self._timestamps)
        audio = np.asarray(audio, np.float32).reshape(-1)
        n = self.cfg.n_samples
        if len(audio) <= n:
            return self._submit_window(audio, language, task)
        futs = [self._submit_window(audio[s:s + n], language, task)
                for s in range(0, len(audio), n)]
        out: Future = Future()

        def join():
            try:
                rs = [f.result() for f in futs]
                out.set_result(ServeResult(
                    text="".join(r.text for r in rs),
                    tokens=[t for r in rs for t in r.tokens],
                    queued_s=max(r.queued_s for r in rs),
                    batch_size=rs[0].batch_size))
            except Exception as e:
                if not out.done():
                    out.set_exception(e)

        threading.Thread(target=join, daemon=True).start()
        return out

    def _submit_window(self, audio: np.ndarray, language: str,
                       task: str) -> Future:
        fut: Future = Future()
        self._q.put(_Request(audio, language, task, fut,
                             time.perf_counter()))
        return fut

    def transcribe(self, audio: np.ndarray, language: str = "en",
                   task: str = "transcribe") -> ServeResult:
        return self.submit(audio, language, task).result()

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self._q.put(None)
            self._worker.join(timeout=60)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ---- worker ----
    def _collect(self) -> list[_Request]:
        """Block for one request, then drain up to max_batch within the
        max_wait_ms grace window."""
        first = self._q.get()
        if first is None:
            return []
        batch = [first]
        deadline = time.perf_counter() + self.max_wait_s
        while len(batch) < self.max_batch:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            try:
                r = self._q.get(timeout=remaining)
            except queue.Empty:
                break
            if r is None:
                self._q.put(None)     # re-post the sentinel for _run
                break
            batch.append(r)
        return batch

    def _run(self) -> None:
        while True:
            batch = self._collect()
            if not batch:
                return
            try:
                self._serve(batch)
            except Exception as e:      # propagate to every waiter
                for r in batch:
                    if not r.future.done():
                        r.future.set_exception(e)

    def _serve(self, batch: list[_Request]) -> None:
        cfg = self.cfg
        t0 = time.perf_counter()
        B = self.max_batch
        prompt_rows = [build_prompt(cfg, r.language, r.task,
                                    timestamps=self._timestamps)
                       for r in batch]
        # Mixed prompt lengths cannot share a batch. Rather than decode a
        # request under another request's prompt, fail the odd ones out
        # loudly; resubmitted, they land in a batch of their own.
        P = len(prompt_rows[0])
        kept, kept_rows = [], []
        for r, row in zip(batch, prompt_rows):
            if len(row) != P:
                r.future.set_exception(ValueError(
                    f"prompt length {len(row)} (language={r.language!r}, "
                    f"task={r.task!r}) differs from the batch's {P}; "
                    "resubmit — it will run in its own batch"))
            else:
                kept.append(r)
                kept_rows.append(row)
        batch, prompt_rows = kept, kept_rows
        if not batch:
            return
        n = len(batch)
        audio = np.zeros((B, cfg.n_samples), np.float32)
        # pad rows take the first real prompt
        prompts = np.tile(np.asarray(prompt_rows[0], np.int64), (B, 1))
        for i, (r, row) in enumerate(zip(batch, prompt_rows)):
            prompts[i] = row
            audio[i] = pad_or_trim(r.audio, cfg.n_samples)
        res = self._transcribe_batch(
            torch.from_numpy(audio).to(self.device),
            torch.from_numpy(prompts).to(self.device))
        tokens = res.tokens.cpu().numpy()
        lengths = res.lengths.cpu().numpy()
        for i, r in enumerate(batch):
            ids = tokens[i, :int(lengths[i])].tolist()
            r.future.set_result(ServeResult(
                text=self.tokenizer.decode(ids), tokens=ids,
                queued_s=t0 - r.t_submit, batch_size=n))

    def _transcribe_batch(self, audio: torch.Tensor, prompts: torch.Tensor):
        cfg = self.cfg
        mel = log_mel_spectrogram(audio, cfg)
        return transcribe_tokens(self.params, cfg, mel, prompts,
                                 max_new=self.max_new, opts=self.opts)
