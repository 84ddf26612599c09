"""HTTP serving daemon: a REST front over the dynamic batcher or the
continuous engine (whisper_tpu/server.py), stdlib-only (http.server):

    python -m whisper_tpu_torch.server --flat-bin weights.bin --port 9000
    curl -s -X POST --data-binary @clip.wav -H 'Content-Type: audio/wav' \
        'http://localhost:9000/v1/audio/transcriptions?language=en'

Endpoints
    POST /v1/audio/transcriptions   body = WAV bytes (any sample rate /
        channels — decoded and resampled by the native loader), or JSON
        {"audio_b64": ..., "language": ..., "task": ...}. Query params
        language/task override. Returns {"text", "tokens", "queued_s",
        "batch_size"}. With `stream=1` or `Accept: text/event-stream`
        (continuous engine only, else 501): server-sent events, one per
        committed token, then a final one with the whole result.
    GET  /healthz                   {"status": "ok", "model": ...}
    GET  /v1/stats                  request counters, the batcher's
        config, and the continuous engine's queue_stats().

Concurrency model: HTTP threads (ThreadingHTTPServer) block on futures;
one device thread (BatchedTranscriber's worker, or ContinuousEngine's
pump) launches all device work. Errors propagate per request as HTTP
4xx/5xx, never killing the engine; a full admission queue answers 503
with Retry-After.

The server runs on `--device` ("cuda" by default; it refuses to start
when CUDA is absent); `--device cpu` runs the kernels' plain versions.
A CUDA fault inside a kernel (an illegal address, a device-side assert)
poisons the process's CUDA context: requests then fail until the process
is restarted.
"""

from __future__ import annotations

import argparse
import base64
import concurrent.futures
import dataclasses
import json
import queue
import tempfile
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from whisper_tpu_torch.config import get_config
from whisper_tpu_torch.native import load_audio
from whisper_tpu_torch.pipeline import WhisperPipeline, resolve_device
from whisper_tpu_torch.serving import BatchedTranscriber
from whisper_tpu_torch.serving_continuous import ContinuousBatcher, QueueFull
from whisper_tpu_torch.serving_longform import LongFormDriver
from whisper_tpu_torch.tokenizer import build_prompt


class _Stats:
    def __init__(self):
        self.lock = threading.Lock()
        self.received = 0
        self.completed = 0
        self.failed = 0

    def snapshot(self) -> dict:
        with self.lock:
            return {"received": self.received, "completed": self.completed,
                    "failed": self.failed,
                    "in_flight": self.received - self.completed - self.failed}


def _decode_wav_bytes(data: bytes, sample_rate: int) -> np.ndarray:
    """WAV bytes -> mono float32 @ sample_rate via the native loader
    (falls back to the pure-Python WAV path inside load_audio)."""
    with tempfile.NamedTemporaryFile(suffix=".wav") as f:
        f.write(data)
        f.flush()
        return load_audio(f.name, sample_rate)


def make_handler(transcriber, cfg, stats: _Stats):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *a):        # quiet by default
            pass

        def _json(self, code: int, obj: dict) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            path = urlparse(self.path).path
            if path == "/healthz":
                self._json(200, {"status": "ok", "model": cfg.name})
            elif path == "/v1/stats":
                extra = {}
                b = getattr(transcriber, "_b", None)
                if b is not None and hasattr(b, "queue_stats"):
                    extra["queue"] = b.queue_stats()   # continuous engine
                self._json(200, {**stats.snapshot(),
                                 "max_batch": transcriber.max_batch,
                                 "max_wait_ms": transcriber.max_wait_s * 1e3,
                                 **extra})
            else:
                self._json(404, {"error": f"no such path: {path}"})

        def do_POST(self):
            url = urlparse(self.path)
            if url.path != "/v1/audio/transcriptions":
                self._json(404, {"error": f"no such path: {url.path}"})
                return
            with stats.lock:
                stats.received += 1
            try:
                n = int(self.headers.get("Content-Length", 0))
                raw = self.rfile.read(n)
                q = {k: v[0] for k, v in parse_qs(url.query).items()}
                ctype = self.headers.get("Content-Type", "")
                language, task = q.get("language", "en"), \
                    q.get("task", "transcribe")
                if ctype.startswith("application/json"):
                    req = json.loads(raw)
                    audio = _decode_wav_bytes(
                        base64.b64decode(req["audio_b64"]), cfg.sample_rate)
                    language = req.get("language", language)
                    task = req.get("task", task)
                else:
                    audio = _decode_wav_bytes(raw, cfg.sample_rate)
            except Exception as e:          # malformed request
                with stats.lock:
                    stats.failed += 1
                self._json(400, {"error": f"bad request: {e}"})
                return
            stream = (q.get("stream", "") in ("1", "true")
                      or "text/event-stream" in
                      (self.headers.get("Accept") or ""))
            if stream:
                if not hasattr(transcriber, "transcribe_stream"):
                    with stats.lock:
                        stats.failed += 1
                    self._json(501, {"error": "streaming requires the "
                                     "continuous engine (--engine "
                                     "continuous)"})
                    return
                self._sse(audio, language, task)
                return
            try:
                res = transcriber.transcribe(audio, language, task)
                with stats.lock:
                    stats.completed += 1
                self._json(200, {"text": res.text, "tokens": res.tokens,
                                 "queued_s": res.queued_s,
                                 "batch_size": res.batch_size})
            except Exception as e:          # engine-side failure
                with stats.lock:
                    stats.failed += 1
                if isinstance(e, QueueFull):   # admission bound: backpressure
                    self.send_response(503)
                    self.send_header("Retry-After", "1")
                    body = json.dumps({"error": str(e)}).encode()
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                self._json(500, {"error": str(e)})

        def _sse(self, audio, language, task):
            """Server-sent-events response: one `data:` event per generated
            token as the continuous engine commits it, then a final event
            with the full result. Connection: close delimits the stream
            (no Content-Length on purpose)."""
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.send_header("Connection", "close")
            self.end_headers()

            def emit(obj: dict):
                self.wfile.write(
                    b"data: " + json.dumps(obj).encode() + b"\n\n")
                self.wfile.flush()

            try:
                for ev in transcriber.transcribe_stream(audio, language,
                                                        task):
                    emit(ev)
                with stats.lock:
                    stats.completed += 1
            except Exception as e:
                with stats.lock:
                    stats.failed += 1
                try:
                    emit({"error": str(e)})
                except Exception:
                    pass
            self.close_connection = True

    return Handler


class ContinuousEngine:
    """Adapter exposing the BatchedTranscriber interface on top of the
    slot-based ContinuousBatcher: a pump thread drives step() whenever work
    exists, HTTP threads submit() and block on a per-request future.
    Requests join/leave the shared decode batch at TOKEN granularity, so a
    long transcript never holds a batch hostage (serving_continuous.py).

    The pump thread is the only thread that launches device work once
    the engine serves (warmup() runs on its caller's thread before that,
    under the pump lock); HTTP threads only submit, wait and detokenize."""

    REQUEST_TIMEOUT_S = 600.0

    def __init__(self, batcher):
        self._b = batcher
        self.max_batch = batcher.B
        self.max_wait_s = 0.0
        self._lock = threading.Lock()
        self._wake = queue.Queue()
        self._pending: list = []          # futures not yet resolved
        self._closed = False
        # audio > one 30 s window is chained through the long-form driver
        # (window k+1 submitted at window k's harvest, prev-text
        # conditioning) instead of being silently truncated; windows of
        # long files interleave with short requests in the slot batch
        self._lf = LongFormDriver(batcher, condition_on_previous=True,
                                  retain_results=False)
        self._pump = threading.Thread(target=self._run, daemon=True)
        self._pump.start()

    def transcribe(self, audio: np.ndarray, language: str = "en",
                   task: str = "transcribe"):
        if self._closed:
            raise RuntimeError("engine is closed")
        # validate BEFORE enqueueing: a bad request must fail on THIS
        # thread (an error reply to this request alone), never inside the
        # shared pump thread
        build_prompt(self._b.cfg, language if language != "auto" else "en",
                     task)
        fut: "concurrent.futures.Future" = concurrent.futures.Future()
        t0 = time.perf_counter()

        def done(rid, ids):
            if fut.done():                 # already failed by the pump
                return
            occupancy = sum(s is not None for s in self._b._slots)
            fut.set_result(_Result(
                text=self._b.tokenizer.decode(ids), tokens=ids,
                queued_s=time.perf_counter() - t0, batch_size=occupancy))

        def done_lf(fid, res):
            if fut.done():
                return
            occupancy = sum(s is not None for s in self._b._slots)
            fut.set_result(_Result(
                text=res.text, tokens=res.tokens,
                queued_s=time.perf_counter() - t0, batch_size=occupancy))

        lf_fid = None
        with self._lock:
            if len(audio) > self._b.cfg.n_samples:
                lf_fid = self._lf.submit(audio, language, task,
                                         callback=done_lf)
            else:
                self._b.submit(audio, language, task, callback=done)
            self._pending.append(fut)
        self._wake.put(None)
        try:
            return fut.result(timeout=self.REQUEST_TIMEOUT_S)
        finally:
            with self._lock:
                if fut in self._pending:
                    self._pending.remove(fut)
                if lf_fid is not None and not fut.done():
                    # timed out: stop chaining the abandoned file's
                    # windows (they would occupy a slot forever)
                    self._lf.cancel(lf_fid)

    def transcribe_stream(self, audio: np.ndarray, language: str = "en",
                          task: str = "transcribe"):
        """Generator of SSE-ready event dicts: {"token", "text_delta"} per
        committed token, then {"done": True, "text", "tokens"}. Tokens are
        streamed as the slot engine commits them — the HTTP thread consumes
        a queue fed by the pump thread's on_token callback."""
        if self._closed:
            raise RuntimeError("engine is closed")
        build_prompt(self._b.cfg, language if language != "auto" else "en",
                     task)
        events: "queue.Queue" = queue.Queue()
        fut: "concurrent.futures.Future" = concurrent.futures.Future()

        def on_token(rid, tid):
            events.put(("token", tid))

        def done(rid, ids):
            if not fut.done():
                fut.set_result(ids)

        def done_lf(fid, res):
            if not fut.done():
                fut.set_result(res.tokens)

        lf_fid = None
        with self._lock:
            if len(audio) > self._b.cfg.n_samples:
                lf_fid = self._lf.submit(audio, language, task,
                                         callback=done_lf,
                                         on_token=on_token)
            else:
                self._b.submit(audio, language, task, callback=done,
                               on_token=on_token)
            self._pending.append(fut)      # pump faults fail this future
        self._wake.put(None)
        tok = self._b.tokenizer
        emitted: list = []
        text_so_far = ""
        deadline = time.monotonic() + self.REQUEST_TIMEOUT_S
        try:
            while True:
                try:
                    kind, tid = events.get(timeout=0.1)
                except queue.Empty:
                    if fut.done():
                        break
                    if time.monotonic() > deadline:
                        raise TimeoutError("request timed out")
                    continue
                emitted.append(tid)
                text = tok.decode(emitted)
                delta, text_so_far = text[len(text_so_far):], text
                yield {"token": int(tid), "text_delta": delta}
            ids = fut.result(timeout=0)    # re-raises pump faults
            yield {"done": True, "text": tok.decode(ids), "tokens": ids}
        finally:
            with self._lock:
                if fut in self._pending:
                    self._pending.remove(fut)
                if lf_fid is not None and not fut.done():
                    # client disconnected or timed out mid-stream: stop
                    # chaining the abandoned file's windows
                    self._lf.cancel(lf_fid)

    def _reset_slots(self):
        """Recover service after a step() fault: a poisoned in-flight slot
        would otherwise stay busy=True forever (step() re-raising on every
        pump iteration turns one bad request into a permanent outage while
        /healthz still reports ok). Rebuilds the device state from scratch:
        the steps update it in place, so a failed step may have left it
        half written. Called with self._lock held.

        This recovers from a fault raised in Python (a kernel wrapper's
        refusal, a failed allocation). A CUDA fault in a kernel (an illegal
        address, a device-side assert) poisons the process's CUDA context:
        every later launch fails too, no reset helps, and the process must
        be restarted."""
        try:
            self._b.reset_state()
        except Exception:
            # even allocation failed; clear the slots so the pump doesn't
            # spin on busy=True, and let the next fill retry the alloc
            self._b._slots = [None] * self._b.B

    def _run(self):
        while not self._closed:
            with self._lock:
                busy = (bool(self._b._queue)
                        or any(s is not None for s in self._b._slots))
            if busy:
                try:
                    with self._lock:
                        # sync_every=K > 1: K steps enqueued per host
                        # readback; tokens stream in bursts of K
                        for _ in range(getattr(self._b, "sync_every", 1)):
                            self._b.step_device()
                        self._b.sync()
                except Exception as e:     # engine fault: fail the pending
                    with self._lock:      # requests, keep the pump alive
                        for fut in self._pending:
                            if not fut.done():
                                fut.set_exception(e)
                        self._pending.clear()
                        self._b._queue.clear()
                        self._reset_slots()
                        # drop in-flight long-form chains too (their
                        # futures are already failed; a fresh driver
                        # avoids leaking dead per-file state)
                        self._lf = LongFormDriver(
                            self._b, condition_on_previous=True,
                            retain_results=False)
                    time.sleep(0.05)       # no hot spin on persistent faults
            else:
                try:                       # idle: sleep until a submit
                    self._wake.get(timeout=0.2)
                except queue.Empty:
                    pass

    def warmup(self, buckets: Optional[tuple] = None) -> None:
        """ContinuousBatcher.warmup under the pump lock, before opening to
        traffic: on the card it builds the kernels and settles cuBLAS's
        and the caching allocator's first-call work, which would otherwise
        stall every live stream the first time traffic reaches them."""
        with self._lock:
            self._b.warmup(buckets)

    def close(self):
        self._closed = True
        self._wake.put(None)
        self._pump.join(timeout=30)


@dataclasses.dataclass
class _Result:
    text: str
    tokens: list
    queued_s: float
    batch_size: int


class TranscriptionServer:
    """Owns the HTTP server + batcher pair; serve_forever() or use as a
    context manager (tests bind port 0 and read .port)."""

    def __init__(self, transcriber, cfg, host: str = "0.0.0.0",
                 port: int = 9000):
        self.transcriber = transcriber
        self.stats = _Stats()
        self.httpd = ThreadingHTTPServer(
            (host, port), make_handler(transcriber, cfg, self.stats))
        self.port = self.httpd.server_address[1]

    def serve_forever(self):
        self.httpd.serve_forever()

    def __enter__(self):
        self._t = threading.Thread(target=self.httpd.serve_forever,
                                   daemon=True)
        self._t.start()
        return self

    def __exit__(self, *exc):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.transcriber.close()


def main(argv: Optional[list] = None) -> int:
    p = argparse.ArgumentParser(prog="whisper_tpu_torch.server")
    p.add_argument("--model", default="tiny")
    p.add_argument("--weights", help="npz checkpoint")
    p.add_argument("--flat-bin", help="reference-format weight blob")
    p.add_argument("--random-weights", action="store_true")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=9000)
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--max-wait-ms", type=float, default=10.0)
    p.add_argument("--max-new", type=int, default=None)
    p.add_argument("--sync-every", type=int, default=1,
                   help="continuous engine: device steps per host readback "
                        "(>1 enqueues K steps a read; tokens stream in "
                        "bursts of K)")
    p.add_argument("--max-queue", type=int, default=64,
                   help="continuous engine admission bound: submits beyond "
                        "this queue depth get HTTP 503 + Retry-After "
                        "(backpressure beats unbounded latency); 0 = "
                        "unbounded")
    p.add_argument("--engine", choices=["dynamic", "continuous"],
                   default="dynamic",
                   help="dynamic: whole-request batches (serving.py); "
                        "continuous: token-granular slot engine "
                        "(serving_continuous.py) — long transcripts never "
                        "hold a batch hostage")
    p.add_argument("--dtype", choices=["float32", "bfloat16"],
                   default="bfloat16",
                   help="serving default is bfloat16 with the int8 serving "
                        "quantization applied (quant='auto'); float32 = "
                        "token-parity mode")
    p.add_argument("--no-quant", action="store_true",
                   help="bf16 without the int8 serving defaults "
                        "(weight-only int8 + int8 cross-KV)")
    p.add_argument("--no-warmup", action="store_true",
                   help="continuous engine: skip the startup warmup (one "
                        "throwaway request in the smallest and the largest "
                        "prompt bucket); the first traffic then pays the "
                        "kernels' build and first-call costs")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain "
                        "versions of the kernels)")
    args = p.parse_args(argv)

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        p.error(str(e))
    cfg = get_config(args.model)
    # the JAX server's default: the serving policy unless --no-quant, given
    # explicitly (the port pipeline's own default is "off")
    load = dict(dtype=args.dtype, device=device,
                quant="off" if args.no_quant else "auto")
    if args.flat_bin:
        pipe = WhisperPipeline.from_flat_bin(args.flat_bin, cfg, **load)
    elif args.weights:
        pipe = WhisperPipeline.from_npz(args.weights, cfg, **load)
    elif args.random_weights:
        pipe = WhisperPipeline.from_random(cfg, **load)
    else:
        p.error("need one of --weights / --flat-bin / --random-weights")

    if args.engine == "continuous":
        bt = ContinuousEngine(ContinuousBatcher(
            pipe.params, pipe.cfg, max_slots=args.max_batch,
            max_new=args.max_new, tokenizer=pipe.tokenizer,
            sync_every=args.sync_every,
            max_queue=args.max_queue or None, device=device))
        if not args.no_warmup:
            print("warming up the engine ...", flush=True)
            bt.warmup()
    else:
        bt = BatchedTranscriber(pipe.params, pipe.cfg, pipe.tokenizer,
                                max_batch=args.max_batch,
                                max_wait_ms=args.max_wait_ms,
                                max_new=args.max_new, device=device)
    srv = TranscriptionServer(bt, pipe.cfg, args.host, args.port)
    card = (f", {torch.cuda.get_device_name(device)}"
            if device.type == "cuda" else "")
    print(f"serving {pipe.cfg.name} on {args.host}:{srv.port} "
          f"(device={device}{card})", flush=True)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.httpd.server_close()
        bt.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
