"""The port's HTTP/SSE daemon (whisper_tpu_torch/server.py) on the CPU,
over real sockets: side by side with JAX's server on the same weights
(tokens and text of WAV bodies at 16 and 22.05 kHz and of JSON-b64, SSE
event sequences, status codes, the health and stats keys); the port
counterparts of tests/test_server.py and of tests/test_continuous.py's
fault-recovery and warmup tests; `main` with every flag of JAX's; and the
thread safety the device threads rely on (full_fp32's process-global TF32
flags, the kernel library's first load)."""

import base64
import concurrent.futures as cf
import io
import json
import re
import sys
import threading
import time
import urllib.error
import urllib.request
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_tpu import server as jax_server
from whisper_tpu.models.whisper import init_params
from whisper_tpu.serving import BatchedTranscriber as JaxTranscriber
from whisper_tpu.serving_continuous import ContinuousBatcher as JaxBatcher
from whisper_tpu_torch import server
from whisper_tpu_torch import weights as weights_lib
from whisper_tpu_torch.models import whisper as tm
from whisper_tpu_torch.ops import _build
from whisper_tpu_torch.server import ContinuousEngine, TranscriptionServer
from whisper_tpu_torch.serving import BatchedTranscriber
from whisper_tpu_torch.serving_continuous import ContinuousBatcher
from whisper_tpu_torch.utils import profiling
from whisper_tpu_torch.weights import from_jax_params

torch.set_num_threads(2)

SOT = [50258, 50259, 50359, 50363]
TRANSCRIBE = "/v1/audio/transcriptions"


@pytest.fixture(scope="module")
def nano(small_cfg):
    """The nano config under a name of its own, with the JAX init plus
    seeded noise (so the tokens depend on the audio)."""
    cfg = small_cfg.replace(name="torch-server-nano")
    rng = np.random.RandomState(3)
    tree = jax.tree.map(
        lambda x: (np.asarray(x) + 0.05 * rng.randn(*np.shape(x))
                   ).astype(np.float32),
        init_params(cfg, jax.random.PRNGKey(0)))
    return cfg, tree, from_jax_params(tree)


def _wav_bytes(seconds=1.0, freq=330.0, sr=16000):
    t = np.arange(int(sr * seconds)) / sr
    x = (0.3 * np.sin(2 * np.pi * freq * t) * 32000).astype(np.int16)
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(x.tobytes())
    return buf.getvalue()


def _call(port, path, data=None, ctype="audio/wav", headers=None):
    """(status, headers, body bytes) of one request; GET without data."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=data,
        headers={"Content-Type": ctype, **(headers or {})},
        method="GET" if data is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _post(port, path, data, ctype="audio/wav"):
    status, _, body = _call(port, path, data, ctype)
    return status, json.loads(body)


def _events(port, path, data, headers=None):
    """The data: events of an SSE response, in order."""
    status, hdrs, body = _call(port, path, data, headers=headers)
    assert status == 200
    assert hdrs["Content-Type"].startswith("text/event-stream")
    return [json.loads(line[6:]) for line in body.decode().splitlines()
            if line.startswith("data: ")]


@pytest.fixture(scope="module")
def servers(nano):
    """Four servers on the same weights: {"jax", "port"} x {"dynamic",
    "continuous"}, each with max_batch / max_slots 2 and max_new 4."""
    cfg, tree, params = nano
    jparams = jax.tree.map(jnp.asarray, tree)
    made = {
        ("jax", "dynamic"): jax_server.TranscriptionServer(
            JaxTranscriber(jparams, cfg, max_batch=2, max_new=4), cfg,
            host="127.0.0.1", port=0),
        ("jax", "continuous"): jax_server.TranscriptionServer(
            jax_server.ContinuousEngine(JaxBatcher(jparams, cfg, max_slots=2,
                                                   max_new=4)), cfg,
            host="127.0.0.1", port=0),
        ("port", "dynamic"): TranscriptionServer(
            BatchedTranscriber(params, cfg, max_batch=2, max_new=4,
                               device="cpu"), cfg, host="127.0.0.1", port=0),
        ("port", "continuous"): TranscriptionServer(
            ContinuousEngine(ContinuousBatcher(params, cfg, max_slots=2,
                                               max_new=4, device="cpu")),
            cfg, host="127.0.0.1", port=0),
    }
    for s in made.values():
        s.__enter__()
    yield {k: s.port for k, s in made.items()}
    for s in made.values():
        s.__exit__(None, None, None)


def _bodies():
    b64 = base64.b64encode(_wav_bytes(freq=440.0)).decode()
    return {
        "wav16": (_wav_bytes(), "audio/wav", "?language=en"),
        "wav22050": (_wav_bytes(1.3, 523.0, sr=22_050), "audio/wav",
                     "?language=de&task=translate"),
        "json_b64": (json.dumps({"audio_b64": b64, "language": "fr",
                                 "task": "transcribe"}).encode(),
                     "application/json", ""),
        "long31": (_wav_bytes(31.0, 250.0), "audio/wav", ""),
    }


# ---- side by side with JAX's server ----

@pytest.mark.parametrize("engine", ["dynamic", "continuous"])
@pytest.mark.parametrize("body", list(_bodies()))
def test_responses_match_jax(servers, engine, body):
    data, ctype, query = _bodies()[body]
    want = _post(servers["jax", engine], TRANSCRIBE + query, data, ctype)
    got = _post(servers["port", engine], TRANSCRIBE + query, data, ctype)
    assert got[0] == want[0] == 200
    assert got[1]["tokens"] == want[1]["tokens"]
    assert got[1]["text"] == want[1]["text"]
    assert set(got[1]) == set(want[1])
    assert got[1]["tokens"][0] == SOT[0]
    if body == "long31":
        assert got[1]["tokens"].count(SOT[0]) == 2


@pytest.mark.parametrize("how", ["query", "accept"])
@pytest.mark.parametrize("body", ["wav16", "long31"])
def test_sse_events_match_jax(servers, how, body):
    data, _, query = _bodies()[body]
    path, headers = TRANSCRIBE + query, None
    if how == "query":
        path += ("&" if query else "?") + "stream=1"
    else:
        headers = {"Accept": "text/event-stream"}
    want = _events(servers["jax", "continuous"], path, data, headers)
    got = _events(servers["port", "continuous"], path, data, headers)
    assert got == want
    assert got[-1]["done"] is True and len(got) > 1


def _codes(port):
    junk = _call(port, TRANSCRIBE, b"not a wav")[0]
    no_b64 = _call(port, TRANSCRIBE, b'{"language": "en"}',
                   "application/json")[0]
    get404 = _call(port, "/nope")[0]
    post404 = _call(port, "/nope", b"", "text/plain")[0]
    stream = _call(port, TRANSCRIBE + "?stream=1", _wav_bytes())[0]
    return junk, no_b64, get404, post404, stream


def test_status_codes_match_jax(servers, nano):
    """400 (a malformed body), 404 (GET and POST), 501 (SSE on the dynamic
    engine), and 503 with Retry-After when the admission queue is full."""
    assert _codes(servers["port", "dynamic"]) == \
        _codes(servers["jax", "dynamic"]) == (400, 400, 404, 404, 501)
    cfg, tree, params = nano
    full = {
        "jax": jax_server.TranscriptionServer(
            jax_server.ContinuousEngine(JaxBatcher(
                jax.tree.map(jnp.asarray, tree), cfg, max_slots=1, max_new=3,
                max_queue=0)), cfg, host="127.0.0.1", port=0),
        "port": TranscriptionServer(
            ContinuousEngine(ContinuousBatcher(params, cfg, max_slots=1,
                                               max_new=3, max_queue=0,
                                               device="cpu")), cfg,
            host="127.0.0.1", port=0)}
    got = {}
    for name, s in full.items():
        with s:
            status, hdrs, body = _call(s.port, TRANSCRIBE, _wav_bytes())
            got[name] = (status, hdrs.get("Retry-After"),
                         sorted(json.loads(body)))
    assert got["port"] == got["jax"] == (503, "1", ["error"])


@pytest.mark.parametrize("engine", ["dynamic", "continuous"])
def test_health_and_stats_keys_match_jax(servers, engine):
    for path in ("/healthz", "/v1/stats"):
        want = json.loads(_call(servers["jax", engine], path)[2])
        got = json.loads(_call(servers["port", engine], path)[2])
        assert set(got) == set(want)
        if "queue" in want:
            assert set(got["queue"]) == set(want["queue"])
        if path == "/healthz":
            assert got == want


# ---- the port counterparts of tests/test_server.py ----

@pytest.fixture()
def port_dyn(servers):
    return servers["port", "dynamic"]


@pytest.fixture()
def port_cont(servers):
    return servers["port", "continuous"]


def test_healthz(port_dyn):
    status, _, body = _call(port_dyn, "/healthz")
    assert status == 200 and json.loads(body)["status"] == "ok"


def test_transcribe_wav_body(port_dyn):
    status, body = _post(port_dyn, TRANSCRIBE + "?language=en", _wav_bytes())
    assert status == 200
    assert body["tokens"][:4] == SOT
    assert isinstance(body["text"], str) and body["batch_size"] >= 1


def test_transcribe_json_b64(port_dyn):
    payload = json.dumps({
        "audio_b64": base64.b64encode(_wav_bytes(freq=440.0)).decode(),
        "language": "en", "task": "transcribe"}).encode()
    status, body = _post(port_dyn, TRANSCRIBE, payload, "application/json")
    assert status == 200 and body["tokens"][0] == SOT[0]


def test_bad_request_does_not_kill_engine(port_dyn):
    assert _call(port_dyn, TRANSCRIBE, b"not a wav")[0] == 400
    assert _post(port_dyn, TRANSCRIBE, _wav_bytes())[0] == 200


def test_dynamic_engine_bad_language_fails_cleanly(port_dyn):
    """A bad language fails this request with a 500 from the caller's
    thread (the dynamic batcher checks it at submit) and the worker goes
    on serving."""
    status, body = _post(port_dyn, TRANSCRIBE + "?language=zz", _wav_bytes())
    assert status == 500 and "unknown language" in body["error"]
    assert _post(port_dyn, TRANSCRIBE, _wav_bytes())[0] == 200


def test_stats_counts(port_dyn):
    _post(port_dyn, TRANSCRIBE, _wav_bytes())
    assert _call(port_dyn, TRANSCRIBE, b"junk")[0] == 400
    body = json.loads(_call(port_dyn, "/v1/stats")[2])
    assert body["completed"] >= 1 and body["failed"] >= 1
    assert body["in_flight"] == 0
    assert body["max_batch"] == 2


def test_unknown_path_404(port_dyn):
    assert _call(port_dyn, "/nope", b"", "text/plain")[0] == 404


def test_continuous_engine_transcribes(port_cont):
    status, body = _post(port_cont, TRANSCRIBE + "?language=en",
                         _wav_bytes())
    assert status == 200
    assert body["tokens"][:4] == SOT
    assert body["batch_size"] >= 1


def test_continuous_engine_concurrent(port_cont):
    """Two concurrent requests share the slot engine and both complete."""
    with cf.ThreadPoolExecutor(2) as ex:
        futs = [ex.submit(_post, port_cont, TRANSCRIBE,
                          _wav_bytes(freq=300 + 100 * i)) for i in range(2)]
        for f in futs:
            status, body = f.result(timeout=180)
            assert status == 200 and body["tokens"][0] == SOT[0]


def test_continuous_engine_bad_language_fails_cleanly(port_cont):
    """A bad language fails this request with a 5xx, on the HTTP thread,
    and leaves the pump alive."""
    status, _ = _post(port_cont, TRANSCRIBE + "?language=zz", _wav_bytes())
    assert status in (400, 500)
    status, body = _post(port_cont, TRANSCRIBE + "?language=en",
                         _wav_bytes())
    assert status == 200 and body["tokens"][0] == SOT[0]


def test_streaming_sse_endpoint(nano):
    """POST ?stream=1 against the continuous engine: one event per token,
    then a done event whose tokens end with the streamed ones."""
    cfg, _, params = nano
    eng = ContinuousEngine(ContinuousBatcher(params, cfg, max_slots=2,
                                             max_new=5, device="cpu"))
    with TranscriptionServer(eng, cfg, host="127.0.0.1", port=0) as s:
        events = _events(s.port, TRANSCRIBE + "?stream=1", _wav_bytes())
    final = events[-1]
    assert final.get("done") is True
    toks = [e["token"] for e in events[:-1]]
    assert len(toks) == 1 + 5                  # no EOT: first pick + max_new
    assert final["tokens"][:4] == SOT
    assert final["tokens"][-len(toks):] == toks
    assert final["text"] == "".join(e["text_delta"] for e in events[:-1])


def test_streaming_rejected_on_dynamic_engine(port_dyn):
    assert _call(port_dyn, TRANSCRIBE + "?stream=1", _wav_bytes())[0] == 501


def test_continuous_engine_longform_audio(port_cont):
    """Audio past one window goes through the long-form driver: both
    windows' tokens come back."""
    status, body = _post(port_cont, TRANSCRIBE + "?language=en",
                         _wav_bytes(seconds=31.0))
    assert status == 200
    assert body["tokens"].count(SOT[0]) == 2
    assert len(body["tokens"]) == 2 * (4 + 1 + 4)


def test_admission_503_and_queue_stats(nano):
    cfg, _, params = nano
    eng = ContinuousEngine(ContinuousBatcher(params, cfg, max_slots=1,
                                             max_new=3, max_queue=0,
                                             device="cpu"))
    with TranscriptionServer(eng, cfg, host="127.0.0.1", port=0) as s:
        status, hdrs, _ = _call(s.port, TRANSCRIBE, _wav_bytes())
        assert status == 503 and hdrs.get("Retry-After") is not None
        stats = json.loads(_call(s.port, "/v1/stats")[2])
    assert "queue" in stats
    for key in ("depth", "served", "max_wait_s", "p50_wait_s"):
        assert key in stats["queue"]


# ---- tests/test_continuous.py:175 and :414 on the server's engine ----

def test_engine_fault_recovery(nano):
    """One poisoned step fails the pending requests, resets the slots,
    and the next request is served."""
    cfg, _, params = nano
    b = ContinuousBatcher(params, cfg, max_slots=2, max_new=4, device="cpu")
    eng = ContinuousEngine(b)
    real_step = b.step_device
    fail = {"on": True}

    def step_device(k=1):
        if fail["on"]:
            raise RuntimeError("poisoned step")
        real_step(k)

    b.step_device = step_device
    try:
        audio = np.random.RandomState(0).randn(24_000).astype(np.float32)
        with pytest.raises(RuntimeError, match="poisoned step"):
            eng.transcribe(audio * 0.1)
        assert all(s is None for s in b._slots)
        assert not eng._pending and not b._queue
        fail["on"] = False
        assert eng.transcribe(audio * 0.1).tokens[:4] == SOT
    finally:
        eng.close()
    assert not eng._pump.is_alive()


def test_warmup_then_exact_traffic(nano):
    """warmup() drives the smallest and the largest prompt bucket, then
    leaves the engine empty with zeroed telemetry and the tracer with no
    record; served tokens equal a
    fresh engine's."""
    cfg, _, params = nano
    audio = (np.random.RandomState(7).randn(24_000) * 0.1).astype(np.float32)
    solo = ContinuousBatcher(params, cfg, max_slots=2, max_new=6,
                             device="cpu")
    r0 = solo.submit(audio)
    ref = solo.run_until_idle()[r0]
    b = ContinuousBatcher(params, cfg, max_slots=2, max_new=6, device="cpu")
    eng = ContinuousEngine(b)
    try:
        profiling.start()
        try:
            eng.warmup()
        finally:
            records = profiling.stop()
        assert all(s is None for s in b._slots) and not b._queue
        assert b.queue_stats()["served"] == 0 and b.max_new == 6
        assert not records["spans"]
        assert eng.transcribe(audio).tokens == ref
    finally:
        eng.close()


def test_client_timeout_cancels_the_long_form_chain(nano, monkeypatch):
    """A long request whose client gives up stops chaining its windows
    (tests/test_server.py's timeout path, server.py:277-284)."""
    cfg, _, params = nano
    b = ContinuousBatcher(params, cfg, max_slots=1, max_new=4, device="cpu")
    eng = ContinuousEngine(b)
    monkeypatch.setattr(ContinuousEngine, "REQUEST_TIMEOUT_S", 0.0)
    try:
        with pytest.raises(cf.TimeoutError):
            eng.transcribe(np.zeros(int(2.5 * cfg.n_samples), np.float32))
        deadline = time.monotonic() + 120

        def busy():                    # read under the pump's lock
            with eng._lock:
                return (b.queue_stats()["served"] == 0 or bool(b._queue)
                        or any(s is not None for s in b._slots))

        while busy() and time.monotonic() < deadline:
            time.sleep(0.05)
        assert not busy()
        assert b.queue_stats()["served"] == 1   # the first window only
        assert not eng._lf._files
    finally:
        eng.close()


# ---- main ----

def _flags(main, capsys) -> set:
    with pytest.raises(SystemExit) as e:
        main(["--help"])
    assert e.value.code == 0
    return set(re.findall(r"--[a-z][a-z-]*", capsys.readouterr().out))


def test_main_takes_every_jax_flag(capsys):
    want = _flags(jax_server.main, capsys)
    got = _flags(server.main, capsys)
    assert len(want) >= 16 and "--sync-every" in want
    assert got - want == {"--device"}
    assert want <= got


def test_main_refuses_cuda_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("CUDA is present")
    with pytest.raises(SystemExit) as e:
        server.main(["--random-weights", "--port", "0"])
    assert e.value.code == 2
    assert "device='cpu'" in capsys.readouterr().err


@pytest.mark.parametrize("case", ["continuous_random_fp32",
                                  "dynamic_flat_bin_bf16_auto",
                                  "continuous_npz_no_warmup"])
def test_main_serves(nano, tmp_path, monkeypatch, capsys, case):
    """main end to end at nano width (get_config patched to the nano
    config): every JAX flag set, one request through it, then the serving
    loop ends and main closes the engine and returns 0."""
    cfg, _, params = nano
    monkeypatch.setattr(server, "get_config", lambda name: cfg)
    common = ["--model", "tiny", "--host", "127.0.0.1", "--port", "0",
              "--max-new", "3", "--device", "cpu"]
    if case == "continuous_random_fp32":
        argv = common + ["--random-weights", "--engine", "continuous",
                         "--max-batch", "2", "--sync-every", "2",
                         "--max-queue", "4", "--dtype", "float32"]
    elif case == "dynamic_flat_bin_bf16_auto":
        path = tmp_path / "w.bin"
        path.write_bytes(weights_lib.to_flat_bin(params, cfg))
        argv = common + ["--flat-bin", str(path), "--max-batch", "2",
                         "--max-wait-ms", "5"]
    else:
        path = tmp_path / "w.npz"
        weights_lib.save_npz(str(path), params)
        argv = common + ["--weights", str(path), "--engine", "continuous",
                         "--no-warmup", "--no-quant", "--max-queue", "0"]
    replies = []

    def serve_forever(self):
        t = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        t.start()
        try:
            replies.append(_post(self.port, TRANSCRIBE, _wav_bytes()))
            if "continuous" in case:
                replies.append(_events(self.port, TRANSCRIBE + "?stream=1",
                                       _wav_bytes())[-1])
        finally:
            self.httpd.shutdown()
            t.join(timeout=30)

    monkeypatch.setattr(TranscriptionServer, "serve_forever", serve_forever)
    assert server.main(argv) == 0
    out = capsys.readouterr().out
    assert re.search(r"serving torch-server-nano on 127\.0\.0\.1:\d+ "
                     r"\(device=cpu\)", out)
    assert ("warming up" in out) == (case == "continuous_random_fp32")
    status, body = replies[0]
    assert status == 200 and body["tokens"][:4] == SOT
    assert len(body["tokens"]) == 4 + 1 + 3
    if "continuous" in case:
        assert replies[1]["done"] and replies[1]["tokens"][:4] == SOT


# ---- thread safety of the device threads' shared state ----

def test_full_fp32_blocks_count_across_threads(monkeypatch):
    """fp32 blocks of several threads overlap: inside any of them TF32 is
    off, and the caller's settings come back only when the last closes
    (two fp32 servers in one process must not switch TF32 back on under
    each other)."""
    matmul = torch.backends.cuda.matmul
    saved = (matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    old_interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    bad = []
    matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        barrier = threading.Barrier(8)

        def worker(seed):
            rng = np.random.RandomState(seed)
            barrier.wait()
            for _ in range(200):
                with tm.full_fp32(True):
                    with tm.full_fp32(bool(rng.randint(2))):
                        if matmul.allow_tf32 or \
                                torch.backends.cudnn.allow_tf32:
                            bad.append(seed)
                        time.sleep(rng.rand() * 1e-4)

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        assert not bad
        assert matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
        assert tm._fp32_depth == 0
    finally:
        sys.setswitchinterval(old_interval)
        matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def test_kernel_library_loads_once_under_racing_first_calls(monkeypatch):
    calls = []

    def slow_load():
        calls.append(threading.get_ident())
        time.sleep(0.05)
        return object()

    monkeypatch.setattr(_build, "_library", None)
    monkeypatch.setattr(_build, "_load_library", slow_load)
    barrier = threading.Barrier(8)

    def first_call():
        barrier.wait()
        return _build.load_library()

    with cf.ThreadPoolExecutor(8) as ex:
        libs = [f.result(timeout=60) for f in
                [ex.submit(first_call) for _ in range(8)]]
    assert len(calls) == 1
    assert all(lib is libs[0] for lib in libs)
