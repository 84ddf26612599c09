"""The port's in-program tracer (whisper_tpu_torch/utils/profiling.py) and
its spans in the continuous engine and the greedy decode loop, on the CPU
with a nano model: off, it records nothing and costs no allocation and no
clock read; on, the spans nest as the layers do, every admitted request
appears once, the decode loop's steps and polls are counted, and the
spans share torch.profiler's clock."""

import math
import sys
import threading
import time
import tracemalloc

import jax
import numpy as np
import pytest
import torch

from whisper_tpu.config import get_config
from whisper_tpu.models.whisper import init_params
from whisper_tpu_torch import decode
from whisper_tpu_torch.audio import log_mel_spectrogram
from whisper_tpu_torch.pipeline import WhisperPipeline
from whisper_tpu_torch.serving_continuous import ContinuousBatcher
from whisper_tpu_torch.utils import profiling
from whisper_tpu_torch.weights import from_jax_params, to_device

torch.set_num_threads(2)

SOT = [50258, 50259, 50359, 50363]
FILL_PARTS = ("fill.audio", "fill.mel", "fill.encode", "fill.cross_kv",
              "fill.prefill")


@pytest.fixture(scope="module")
def nano():
    """A 2 + 2 layer model of width 64 under a name of its own, the JAX
    init plus seeded noise so that tokens depend on the audio."""
    cfg = get_config("tiny").replace(
        name="torch-tracing-nano", d_model=64, n_heads=2,
        n_audio_layers=2, n_text_layers=2,
        n_audio_ctx=1500, n_text_ctx=448)
    rng = np.random.RandomState(3)
    np_tree = jax.tree.map(
        lambda x: (np.asarray(x) + 0.02 * rng.randn(*np.shape(x))
                   ).astype(np.float32),
        init_params(cfg, jax.random.PRNGKey(0)))
    return cfg, from_jax_params(np_tree)


@pytest.fixture(autouse=True)
def _tracer_off():
    """Every test leaves the process's tracer off and empty."""
    yield
    if profiling.tracing():
        profiling.stop()


def _audio(seed, seconds=1.0):
    rng = np.random.RandomState(seed)
    return (rng.randn(int(seconds * 16_000)) * 0.1).astype(np.float32)


def _engine(nano, **kw):
    cfg, params = nano
    return ContinuousBatcher(params, cfg, device="cpu", **kw)


def _drive(eng, schedule):
    """schedule: per step, the submits made before it as
    [(audio seed, prev tokens or None)]; then steps until idle. Returns
    {rid: tokens}."""
    rids = []
    for submits in schedule:
        for seed, prev in submits:
            rids.append(eng.submit(_audio(seed), prev_tokens=prev))
        eng.step()
    while eng._queue or any(s is not None for s in eng._slots):
        eng.step()
    return {rid: eng._results[rid] for rid in rids}


SCHEDULE = [[(1, None), (2, list(range(700, 720)))], [],
            [(3, list(range(900, 1020)))], [(4, None)], []]


def _traced(fn):
    profiling.start()
    try:
        out = fn()
    finally:
        records = profiling.stop()
    return out, records


def _by_name(spans, name):
    return [sp for sp in spans if sp["name"] == name]


def test_span_off_is_one_shared_no_op_without_allocation_or_clock(
        monkeypatch):
    assert not profiling.tracing()
    assert profiling.span("a") is profiling.span("b")

    def no_clock():
        raise AssertionError("a span read the clock while tracing was off")

    monkeypatch.setattr(profiling.time, "time_ns", no_clock)
    with profiling.span("warm") as sp:
        sp["x"] = 1
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        for _ in range(2000):
            with profiling.span("engine.step") as sp:
                if sp:
                    sp["admitted"] = 1
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    only = [tracemalloc.Filter(True, profiling.__file__)]
    grown = [d for d in after.filter_traces(only).compare_to(
        before.filter_traces(only), "lineno") if d.size_diff > 0]
    assert grown == []
    assert not profiling._records


def test_tracer_records_parents_attributes_and_stops():
    profiling.start()
    with profiling.span("outer") as outer:
        outer["k"] = "v"
        with profiling.span("inner"):
            profiling.event("point", 123, rid=7)
        with profiling.paused():
            with profiling.span("hidden") as hidden:
                hidden["k"] = "lost"
    records = profiling.stop()
    assert not profiling.tracing()
    spans = {sp["name"]: sp for sp in records["spans"]}
    assert set(spans) == {"outer", "inner", "point"}
    assert spans["outer"]["parent"] == 0
    assert spans["inner"]["parent"] == spans["outer"]["id"]
    assert spans["point"]["parent"] == spans["inner"]["id"]
    assert spans["point"]["start_ns"] == spans["point"]["end_ns"] == 123
    assert spans["point"]["attrs"] == {"rid": 7}
    assert spans["outer"]["attrs"] == {"k": "v"}
    assert (spans["outer"]["start_ns"] <= spans["inner"]["start_ns"]
            <= spans["inner"]["end_ns"] <= spans["outer"]["end_ns"])
    assert records["start_ns"] <= spans["outer"]["start_ns"]
    assert spans["outer"]["end_ns"] <= records["stop_ns"]
    assert profiling.stop()["spans"] == []


def test_tracing_off_records_nothing_and_tokens_match_on(nano):
    off = _drive(_engine(nano, max_slots=3, max_new=5), SCHEDULE)
    assert not profiling._records
    on, records = _traced(
        lambda: _drive(_engine(nano, max_slots=3, max_new=5), SCHEDULE))
    assert records["spans"]
    assert list(on.values()) == list(off.values())


def test_fill_parts_nest_inside_the_fill_inside_the_step(nano):
    eng = _engine(nano, max_slots=3, max_new=4)
    _, records = _traced(lambda: _drive(eng, SCHEDULE))
    spans = records["spans"]
    by_id = {sp["id"]: sp for sp in spans}
    fills = _by_name(spans, "engine.fill")
    assert len(fills) == 3
    for fill in fills:
        step = by_id[fill["parent"]]
        assert step["name"] == "engine.step"
        admits = [sp for sp in spans if sp["parent"] == fill["id"]
                  and sp["name"] == "admit"]
        assert step["attrs"]["admitted"] == len(admits) > 0
        assert step["start_ns"] <= fill["start_ns"] <= fill["end_ns"] \
            <= step["end_ns"]
        parts = [sp for sp in spans if sp["parent"] == fill["id"]
                 and sp["name"] != "admit"]
        assert [sp["name"] for sp in parts] == list(FILL_PARTS)
        for a, b in zip(parts, parts[1:]):
            assert a["end_ns"] <= b["start_ns"]
        assert fill["start_ns"] <= parts[0]["start_ns"]
        assert parts[-1]["end_ns"] <= fill["end_ns"]
    for step in _by_name(spans, "engine.step"):
        kids = sorted(sp["name"] for sp in spans
                      if sp["parent"] == step["id"])
        assert kids == (["engine.fill"] if step["attrs"]["admitted"]
                        else []) + ["engine.sync", "engine.token"]
    for read in _by_name(spans, "sync.read"):
        assert by_id[read["parent"]]["name"] == "engine.sync"


def test_each_admitted_request_is_in_one_fill_and_one_admit_event(nano):
    eng = _engine(nano, max_slots=2, max_new=3)
    out, records = _traced(lambda: _drive(eng, SCHEDULE))
    spans = records["spans"]
    fills = {sp["id"]: sp for sp in _by_name(spans, "engine.fill")}
    admits = _by_name(spans, "admit")
    assert sorted(a["attrs"]["rid"] for a in admits) == sorted(out)
    for a in admits:
        fill = fills[a["parent"]]
        assert a["start_ns"] == fill["start_ns"]
        assert a["attrs"]["submit_ns"] <= fill["start_ns"]
    assert {a["parent"] for a in admits} == set(fills)
    # each fill encodes the windows of the requests it admits, no more
    rows = {i: sum(a["parent"] == i for a in admits) for i in fills}
    assert {i: sp["attrs"]["rows"] for i, sp in fills.items()} == rows
    assert max(rows.values()) == 2


@pytest.mark.parametrize("prompts,buckets", [
    ([None, 20, 120, 200], [8, 32, 128, 256]),
    ([219, 3, None], [256, 8, 8]),
])
def test_fill_bucket_is_the_prefill_bucket(nano, prompts, buckets):
    """The `bucket` attribute of each fill is the prefill bucket of its
    longest joining prompt (4 tokens plus <|startofprev|> and the
    previous text), one request a fill."""
    eng = _engine(nano, max_slots=1, max_new=2)
    schedule = [[(i, None if n is None else list(range(600, 600 + n)))]
                for i, n in enumerate(prompts)]

    def run():
        for submits in schedule:
            for seed, prev in submits:
                eng.submit(_audio(seed), prev_tokens=prev)
            eng.run_until_idle()

    _, records = _traced(run)
    got = [sp["attrs"]["bucket"]
           for sp in _by_name(records["spans"], "engine.fill")]
    assert got == buckets


@pytest.mark.parametrize("max_new", [1, 8, 9, 13])
def test_decode_steps_and_polls_are_counted(nano, max_new):
    """With EOT banned every row runs max_new steps: one decode.step span
    a step and one decode.poll every POLL_EVERY steps, all inside the
    decode after its prefill."""
    cfg, params = nano
    params = to_device(params, torch.device("cpu"), None)
    mel = log_mel_spectrogram(torch.from_numpy(
        np.stack([_audio(5, 30.0), _audio(6, 30.0)])), cfg)
    enc = decode.encode(params, cfg, mel)
    bias = torch.zeros(cfg.vocab_size)
    bias[cfg.eot_token] = -1e9
    prompt = torch.tensor([SOT, SOT])
    res, records = _traced(lambda: decode.greedy_decode(
        params, cfg, enc, prompt, max_new=max_new, logit_bias=bias))
    spans = records["spans"]
    steps, polls = _by_name(spans, "decode.step"), \
        _by_name(spans, "decode.poll")
    assert len(steps) == max_new
    assert len(polls) == math.ceil(max_new / decode.POLL_EVERY)
    prefill, = _by_name(spans, "decode.prefill")
    assert prefill["end_ns"] <= min(sp["start_ns"] for sp in steps + polls)
    assert all(sp["parent"] == 0 for sp in steps + polls + [prefill])
    assert int(res.lengths.min()) == len(SOT) + 1 + max_new


def test_decode_stops_at_the_poll_after_every_row_ends(nano):
    """A forced EOT at the first pick ends the loop at the first poll:
    one decode.poll span and no decode.step."""
    cfg, params = nano
    params = to_device(params, torch.device("cpu"), None)
    mel = log_mel_spectrogram(torch.from_numpy(_audio(5, 30.0)[None]), cfg)
    enc = decode.encode(params, cfg, mel)
    bias = torch.full((cfg.vocab_size,), -1e9)
    bias[cfg.eot_token] = 0.0
    _, records = _traced(lambda: decode.greedy_decode(
        params, cfg, enc, torch.tensor([SOT]), max_new=20, logit_bias=bias))
    spans = records["spans"]
    assert len(_by_name(spans, "decode.poll")) == 1
    assert _by_name(spans, "decode.step") == []


def test_transcribe_batch_traces_its_decode(nano):
    cfg, params = nano
    pipe = WhisperPipeline.from_params(params, cfg, device="cpu")
    audio = np.stack([_audio(8, 30.0), _audio(9, 30.0)])
    res, records = _traced(lambda: pipe.transcribe_batch(audio, max_new=3))
    untraced = pipe.transcribe_batch(audio, max_new=3)
    assert torch.equal(res.tokens, untraced.tokens)
    names = [sp["name"] for sp in sorted(records["spans"],
                                         key=lambda sp: sp["start_ns"])]
    assert names[:2] == ["decode.prefill", "decode.poll"]
    assert names.count("decode.step") == 3


def test_spans_share_the_profilers_clock(nano):
    """Under a CPU-activity torch.profiler capture the aten ops of each
    traced engine step lie inside that step's span: the spans' stamps and
    kineto's are one clock. Kineto stamps CPU ops with the TSC converted
    to epoch ns by a calibration that a loaded host can put tens of µs
    off, so each span is widened by 1 ms, half the 2 ms kept between
    steps: an op still cannot fall to a neighbouring step."""
    eng = _engine(nano, max_slots=2, max_new=3)
    eng.submit(_audio(1))
    eng.submit(_audio(2))
    act = torch.profiler.ProfilerActivity
    profiling.start()
    try:
        with torch.profiler.profile(activities=[act.CPU]) as prof:
            for _ in range(3):
                time.sleep(0.002)
                eng.step()
    finally:
        records = profiling.stop()
    steps = _by_name(records["spans"], "engine.step")
    assert len(steps) == 3
    ops = [(e.start_ns(), e.end_ns(), e.name())
           for e in prof.profiler.kineto_results.events()
           if e.name().startswith("aten::")]
    assert ops
    slack = 1_000_000
    for start, end, name in ops:
        inside = [sp for sp in steps if sp["start_ns"] - slack <= start
                  and end <= sp["end_ns"] + slack]
        assert len(inside) == 1, (name, start, end)
    for sp in steps:
        assert any(sp["start_ns"] <= s < sp["end_ns"] for s, _, _ in ops)


def test_submits_from_two_threads_lose_no_record(nano):
    """Two threads submit while the driving thread steps with spans open
    (as the server's HTTP threads do, one submit at a time under a lock):
    every request is delivered, is in exactly one fill and has exactly
    one admit event."""
    eng = _engine(nano, max_slots=4, max_new=2)
    lock = threading.Lock()
    rids: list = []
    per_thread = 12

    def client(base):
        for i in range(per_thread):
            with lock:
                rids.append(eng.submit(_audio(base + i, 0.25)))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    profiling.start()
    try:
        threads = [threading.Thread(target=client, args=(100 * k,))
                   for k in (1, 2)]
        for t in threads:
            t.start()
        steps = 0
        while steps < 400 and (any(t.is_alive() for t in threads)
                               or eng._queue
                               or any(s is not None for s in eng._slots)):
            eng.step()
            steps += 1
        for t in threads:
            t.join(timeout=30)
    finally:
        records = profiling.stop()
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert len(rids) == 2 * per_thread == len(set(rids))
    assert sorted(eng._results) == sorted(rids)
    spans = records["spans"]
    fills = {f["id"] for f in _by_name(spans, "engine.fill")}
    admits = _by_name(spans, "admit")
    assert sorted(a["attrs"]["rid"] for a in admits) == sorted(rids)
    assert all(a["parent"] in fills for a in admits)
    for sp in spans:
        assert sp["start_ns"] <= sp["end_ns"]
