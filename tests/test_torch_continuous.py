"""The port's continuous-batching engine (whisper_tpu_torch/
serving_continuous.py) on the CPU: against the JAX engine on the same
weights and schedule, and the port counterparts of tests/test_continuous.py.

Key invariant, as in JAX: a request's tokens do not depend on which slot
it occupies, what else shares the batch, or when it arrives, so results
are compared for exact equality. The nano config has a name of its own,
so the JAX engine's jitted stages traced here are this file's alone."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_tpu.config import get_config
from whisper_tpu.models.whisper import init_params
from whisper_tpu.serving_continuous import ContinuousBatcher as JaxBatcher
from whisper_tpu.serving_continuous import QueueFull as JaxQueueFull
from whisper_tpu_torch.decode import transcribe_tokens
from whisper_tpu_torch.decode_rules import DecodeOptions
from whisper_tpu_torch.models import whisper as tm
from whisper_tpu_torch.serving_continuous import ContinuousBatcher, QueueFull
from whisper_tpu_torch.tokenizer import build_prompt
from whisper_tpu_torch.utils import profiling
from whisper_tpu_torch.weights import from_jax_params

torch.set_num_threads(2)

SOT = [50258, 50259, 50359, 50363]


@pytest.fixture(scope="module")
def nano():
    """tests/test_continuous.py's nano config under its own name, with
    the JAX init plus seeded noise (non-zero biases and LayerNorm
    parameters make the tokens depend on the audio)."""
    cfg = get_config("tiny").replace(
        name="torch-cont-nano", d_model=64, n_heads=2,
        n_audio_layers=2, n_text_layers=2,
        n_audio_ctx=1500, n_text_ctx=448)
    rng = np.random.RandomState(1)
    np_tree = jax.tree.map(
        lambda x: (np.asarray(x) + 0.02 * rng.randn(*np.shape(x))
                   ).astype(np.float32),
        init_params(cfg, jax.random.PRNGKey(0)))
    return cfg, np_tree, from_jax_params(np_tree)


def _audio(seed, seconds=1.5):
    rng = np.random.RandomState(seed)
    return (rng.randn(int(seconds * 16_000)) * 0.1).astype(np.float32)


def _engine(nano, **kw):
    cfg, _, params = nano
    return ContinuousBatcher(params, cfg, device="cpu", **kw)


def _drive(eng, queue_full):
    """One schedule for both engines: a warm-up, more requests than slots,
    prompts in the 8, 32 and 128 buckets, language="auto", QueueFull and
    an admitted submit past it, a queued and an active cancel."""
    eng.warmup()
    events = []
    rids = [eng.submit(_audio(1)),
            eng.submit(_audio(2), prev_tokens=list(range(700, 720))),
            eng.submit(_audio(3), language="auto"),
            eng.submit(_audio(4), prev_tokens=list(range(900, 1020))),
            eng.submit(_audio(5))]
    try:
        eng.submit(_audio(6))
        events.append("accepted")
    except queue_full:
        events.append("queue_full")
    rids.append(eng.submit(_audio(7), admitted=True))
    events.append(eng.cancel(rids[4]))
    eng.step()
    events.append(eng.cancel(rids[0]))
    rids.append(eng.submit(_audio(8), language="auto",
                           prev_tokens=[500, 501]))
    out = eng.run_until_idle()
    return rids, out, events, eng.queue_stats()


def test_engine_matches_jax_engine(nano):
    """The same submit schedule through the JAX engine and the port's, on
    the same weights: equal result dicts, events and served counts."""
    cfg, np_tree, _ = nano
    kw = dict(max_slots=3, max_new=5, sync_every=4, max_queue=5)
    jeng = JaxBatcher(jax.tree.map(jnp.asarray, np_tree), cfg, **kw)
    want = _drive(jeng, JaxQueueFull)
    got = _drive(_engine(nano, **kw), QueueFull)
    rids, out, events, stats = got
    assert rids == want[0]
    assert out == want[1]
    assert events == want[2] == ["queue_full", "queued", "active"]
    assert stats["served"] == want[3]["served"] == 5
    assert stats["depth"] == want[3]["depth"] == 0
    assert rids[0] not in out and rids[4] not in out
    # one request that the cap ends (prompt, first pick, 5 more; no EOT)
    assert any(len(ids) == ids.index(cfg.sot_token) + 4 + 1 + 5
               and ids[-1] != cfg.eot_token for ids in out.values())
    # the language="auto" requests carry a detected language token
    for rid in (rids[2], rids[-1]):
        sot = out[rid].index(cfg.sot_token)
        assert (cfg.first_language_token <= out[rid][sot + 1]
                < cfg.first_language_token + cfg.n_languages)


def test_single_request_completes(nano):
    cfg = nano[0]
    eng = _engine(nano, max_slots=2, max_new=6)
    rid = eng.submit(_audio(0))
    ids = eng.run_until_idle()[rid]
    assert ids[0] == cfg.sot_token
    assert ids[:4] == SOT
    assert len(ids) <= 4 + 1 + 6
    assert isinstance(eng.decode_text(rid), str)


def test_schedule_independence(nano):
    """Same audio -> same tokens regardless of slot, arrival order and
    batch companions."""
    cfg = nano[0]
    solo = _engine(nano, max_slots=1, max_new=6)
    r0 = solo.submit(_audio(42))
    ref = solo.run_until_idle()[r0]

    crowd = _engine(nano, max_slots=3, max_new=6)
    others = [crowd.submit(_audio(s)) for s in (1, 2)]
    mine = crowd.submit(_audio(42))          # lands in the last slot
    late = crowd.submit(_audio(3))           # queued, joins when a slot frees
    out = crowd.run_until_idle()
    assert out[mine] == ref
    for rid in (*others, late):
        assert out[rid][0] == cfg.sot_token


def test_join_leaves_live_rows_untouched(nano):
    """A slot fills (with a 128-bucket prompt) while another is mid-decode:
    the live slot's tokens equal its solo run, so neither the batched
    prefill nor the cross K/V write reached its row."""
    solo = _engine(nano, max_slots=2, max_new=8)
    r0 = solo.submit(_audio(31))
    ref = solo.run_until_idle()[r0]

    eng = _engine(nano, max_slots=2, max_new=8)
    live = eng.submit(_audio(31))
    for _ in range(4):
        eng.step()
    cache_before = eng.state["cache"]["k"][:, 0, :, :4].clone()
    joiner = eng.submit(_audio(32), prev_tokens=list(range(800, 900)))
    eng.step()                                # fills slot 1
    assert torch.equal(eng.state["cache"]["k"][:, 0, :, :4], cache_before)
    out = eng.run_until_idle()
    assert out[live] == ref
    assert out[joiner][1:101] == list(range(800, 900))


def test_one_ragged_append_per_step_over_all_slots(nano, monkeypatch):
    """Every step ends in exactly one ragged append, over all B slots,
    busy or not: rows without a live request flow through the math."""
    calls = []
    real = tm.cache_append_rows_ragged

    def counting(ck, cv, kn, vn, pos):
        calls.append((tuple(kn.shape), pos.clone()))
        return real(ck, cv, kn, vn, pos)

    monkeypatch.setattr(tm, "cache_append_rows_ragged", counting)
    eng = _engine(nano, max_slots=3, max_new=3)
    eng.submit(_audio(0))
    steps = 0
    while eng._queue or any(s is not None for s in eng._slots):
        eng.step()
        steps += 1
    assert len(calls) == steps
    cfg = nano[0]
    for shape, pos in calls:
        assert shape == (cfg.n_text_layers, 3, cfg.n_heads, cfg.head_dim)
        assert pos.shape == (3,)


def test_one_host_read_per_sync(nano, monkeypatch):
    eng = _engine(nano, max_slots=2, max_new=6, sync_every=3)
    reads, syncs = [], []
    real_snap, real_sync = eng._snapshot, eng.sync
    monkeypatch.setattr(eng, "_snapshot",
                        lambda: reads.append(1) or real_snap())
    monkeypatch.setattr(eng, "sync", lambda: syncs.append(1) or real_sync())
    eng.submit(_audio(1), on_token=lambda r, t: None)
    eng.submit(_audio(2))
    eng.run_until_idle()
    assert 0 < len(reads) == len(syncs)


def test_slots_are_reused(nano):
    eng = _engine(nano, max_slots=2, max_new=4)
    rids = [eng.submit(_audio(s)) for s in range(5)]
    out = eng.run_until_idle()
    assert set(out) == set(rids)
    for rid in rids:
        assert out[rid][:4] == SOT


def test_auto_language_resolves_at_slot_fill(nano):
    cfg = nano[0]
    eng = _engine(nano, max_slots=1, max_new=3)
    rid = eng.submit(_audio(5), language="auto")
    lang_tok = eng.run_until_idle()[rid][1]
    assert (cfg.first_language_token <= lang_tok
            < cfg.first_language_token + cfg.n_languages)


def test_callbacks_fire(nano):
    eng = _engine(nano, max_slots=2, max_new=3)
    got = {}
    eng.submit(_audio(7), callback=lambda rid, ids: got.update({rid: ids}))
    assert got == eng.run_until_idle()


def test_streaming_tokens_match_final(nano):
    """on_token streams exactly the generated suffix, in order."""
    eng = _engine(nano, max_slots=2, max_new=5)
    streamed: list[int] = []
    rid = eng.submit(_audio(11), on_token=lambda r, t: streamed.append(t))
    out = eng.run_until_idle()
    assert streamed == out[rid][4:]
    assert len(streamed) >= 1


def test_cap_terminates(nano):
    """Even when the model never emits EOT, the per-request cap finishes
    every slot."""
    eng = _engine(nano, max_slots=2, max_new=3)
    rids = [eng.submit(_audio(s)) for s in range(2)]
    out = eng.run_until_idle(max_steps=200)
    for rid in rids:
        assert len(out[rid]) <= 4 + 1 + 3


def _greedy_ref(nano, audio, prompt, max_new, opts=None):
    from whisper_tpu_torch.audio import log_mel_spectrogram, pad_or_trim
    cfg, _, params = nano
    from whisper_tpu_torch.weights import to_device
    mel = log_mel_spectrogram(
        torch.from_numpy(pad_or_trim(audio, cfg.n_samples))[None], cfg)
    ref = transcribe_tokens(to_device(params, "cpu"), cfg, mel,
                            torch.tensor([prompt]), max_new=max_new,
                            opts=opts)
    return ref.tokens[0, :int(ref.lengths[0])].tolist()


def test_rules_active_matches_greedy_decode(nano):
    """The engine runs the same rule stack as greedy decoding: identical
    request, identical opts, identical tokens."""
    cfg = nano[0]
    opts = DecodeOptions(suppress_blank=True, suppress_tokens=(100, 200))
    a = _audio(21)
    eng = _engine(nano, max_slots=2, max_new=6, opts=opts)
    rid = eng.submit(a)
    cont = eng.run_until_idle()[rid]
    assert cont == _greedy_ref(nano, a, build_prompt(cfg), 6, opts)
    assert 100 not in cont[4:] and 200 not in cont[4:]


def test_timestamps_mode_in_continuous(nano):
    """opts.timestamps flows through: the prompt omits <|notimestamps|>
    and the first generated token is a timestamp (or EOT); the tokens are
    greedy decoding's under the same rules."""
    cfg = nano[0]
    opts = DecodeOptions(timestamps=True)
    eng = _engine(nano, max_slots=1, max_new=5, opts=opts)
    rid = eng.submit(_audio(13))
    ids = eng.run_until_idle()[rid]
    assert cfg.no_timestamps_token not in ids[:3]
    assert ids[3] >= cfg.timestamp_begin or ids[3] == cfg.eot_token
    assert ids == _greedy_ref(nano, _audio(13),
                              build_prompt(cfg, timestamps=True), 5, opts)


def test_long_prompt_joins_in_constant_steps(nano):
    """A 200-token <|startofprev|> prompt costs one batched prefill, not
    ~200 lockstep steps."""
    cfg = nano[0]
    eng = _engine(nano, max_slots=2, max_new=4)
    prev = [1000 + i for i in range(200)]
    rid = eng.submit(_audio(3), prev_tokens=prev)
    steps = 0
    profiling.start()
    try:
        while (eng._queue or any(s is not None for s in eng._slots)) \
                and steps < 50:
            eng.step()
            steps += 1
    finally:
        spans = profiling.stop()["spans"]
    ids = eng._results[rid]
    assert ids[0] == cfg.sot_prev_token
    assert ids[1:6] == prev[:5]
    assert steps <= 10, steps
    assert [sp["attrs"]["bucket"] for sp in spans
            if sp["name"] == "engine.fill"] == [256]


def test_prefill_matches_teacher_forced_reference(nano):
    """The batched-prefill join gives greedy decoding's tokens for the
    same <|startofprev|> prompt (fp32)."""
    cfg = nano[0]
    prev = [700 + i for i in range(30)]
    audio = _audio(21)
    eng = _engine(nano, max_slots=1, max_new=6)
    rid = eng.submit(audio, prev_tokens=prev)
    cont = eng.run_until_idle()[rid]
    assert cont == _greedy_ref(nano, audio,
                               build_prompt(cfg, prev_tokens=prev), 6)


@pytest.mark.parametrize("n", [1, 2, 3])
def test_fill_runs_over_its_joining_rows_only(nano, monkeypatch, n):
    """A fill of n joining requests beside a live slot runs the log-mel,
    the encoder blocks and the cross K/V over exactly n rows in a 4-slot
    engine, and the conv stem once a row; the prefill runs over the slot
    batch once for each prompt bucket, copying the rows of that bucket."""
    from whisper_tpu_torch import serving_continuous as sc
    rows = {"mel": [], "stem": [], "blocks": [], "cross_kv": [],
            "prefill": [], "prefill_cross": []}

    def recorder(key, real, measure):
        def recorded(*args):
            rows[key].append(measure(args))
            return real(*args)
        return recorded

    for key, name, measure in (
            ("mel", "log_mel_spectrogram", lambda a: a[0].shape[0]),
            ("stem", "encoder_input", lambda a: a[2].shape[0]),
            ("blocks", "encoder_blocks", lambda a: a[2].shape[0]),
            ("cross_kv", "precompute_cross_kv", lambda a: a[2].shape[0]),
            ("prefill", "_prefill_join",
             lambda a: (tuple(a[4].shape), a[5].tolist())),
            ("prefill_cross", "decoder_hidden",
             lambda a: {leaf.shape[1] for leaf in a[5].values()})):
        monkeypatch.setattr(sc, name, recorder(key, getattr(sc, name),
                                               measure))
    eng = _engine(nano, max_slots=4, max_new=4)
    eng.submit(_audio(50))
    eng.step()                                # one live slot
    for i in range(n):
        eng.submit(_audio(51 + i),
                   prev_tokens=list(range(700, 720)) if i else None)
    eng.step()
    passes = [((4, 8), [0]), ((4, 8), [1])]
    if n > 1:                                 # 25-token prompts
        passes.append(((4, 32), list(range(2, 1 + n))))
    assert rows == {"mel": [1, n], "stem": [1] * (1 + n),
                    "blocks": [1, n], "cross_kv": [1, n], "prefill": passes,
                    "prefill_cross": [{4}] * len(passes)}
    eng.run_until_idle()


@pytest.mark.parametrize("prevs", [
    [None] * 6,
    [20, 120, 20, 120, 120, 20],
], ids=["plain", "prev_32_128"])
def test_fills_of_1_2_3_rows_match_a_solo_engine(nano, prevs):
    """Requests that join in fills of 1, 2 and 3 rows (each fill beside
    live slots) give a solo engine's tokens for the same audio and
    prompt: plain prompts, and <|startofprev|> prompts in the 32 and 128
    prefill buckets."""
    prev = [None if k is None else list(range(600, 600 + k)) for k in prevs]
    solo = _engine(nano, max_slots=1, max_new=6)
    ref = []
    for i in range(6):
        rid = solo.submit(_audio(60 + i), prev_tokens=prev[i])
        ref.append(solo.run_until_idle()[rid])

    eng = _engine(nano, max_slots=6, max_new=6)
    rids = []
    profiling.start()
    try:
        for group in ((0,), (1, 2), (3, 4, 5)):
            rids += [eng.submit(_audio(60 + i), prev_tokens=prev[i])
                     for i in group]
            eng.step()
            eng.step()
        out = eng.run_until_idle()
    finally:
        spans = profiling.stop()["spans"]
    assert [sp["attrs"]["rows"] for sp in spans
            if sp["name"] == "engine.fill"] == [1, 2, 3]
    assert [out[rid] for rid in rids] == ref


def test_each_joining_row_prefills_in_its_own_bucket(nano, monkeypatch):
    """A fill of a plain prompt and a 120-token <|startofprev|> prompt
    prefills them in the 8 and 128 buckets, each in a pass of its own; the
    plain request gives its solo tokens, as when it fills alone."""
    from whisper_tpu_torch import serving_continuous as sc
    widths = []
    real = sc._prefill_join

    def recorded(*args):
        widths.append(args[4].shape[1])
        return real(*args)

    solo = _engine(nano, max_slots=2, max_new=6)
    rid = solo.submit(_audio(70))
    ref = solo.run_until_idle()[rid]
    monkeypatch.setattr(sc, "_prefill_join", recorded)
    eng = _engine(nano, max_slots=2, max_new=6)
    plain = eng.submit(_audio(70))
    eng.submit(_audio(71), prev_tokens=list(range(600, 720)))
    out = eng.run_until_idle()
    assert widths == [8, 128]
    assert out[plain] == ref


def test_sync_every_batched_drive_matches_token_granularity(nano):
    ref_eng = _engine(nano, max_slots=2, max_new=6)
    rids = [ref_eng.submit(_audio(s)) for s in (7, 8, 9)]
    ref = ref_eng.run_until_idle()
    k_eng = _engine(nano, max_slots=2, max_new=6, sync_every=5)
    krids = [k_eng.submit(_audio(s)) for s in (7, 8, 9)]
    out = k_eng.run_until_idle()
    for a, b in zip(rids, krids):
        assert ref[a] == out[b]


def test_scanned_multistep_matches_single_steps(nano):
    """step_device(k > 1) runs k single steps: the same tokens."""
    ref_eng = _engine(nano, max_slots=2, max_new=6)
    r0 = ref_eng.submit(_audio(21))
    ref = ref_eng.run_until_idle()[r0]
    eng = _engine(nano, max_slots=2, max_new=6)
    rid = eng.submit(_audio(21))
    while any(s is not None for s in eng._slots) or eng._queue:
        eng.step_device(3)
        eng.sync()
    assert eng._results[rid] == ref


def test_admission_queue_full_and_stats(nano):
    eng = _engine(nano, max_slots=1, max_new=3, max_queue=2)
    first = eng.submit(_audio(0))
    eng.step()                              # first claims the slot
    rids = [first] + [eng.submit(_audio(s)) for s in (1, 2)]
    assert eng.queue_stats()["depth"] == 2
    with pytest.raises(QueueFull, match="max_queue"):
        eng.submit(_audio(9))
    extra = eng.submit(_audio(10), admitted=True)
    out = eng.run_until_idle()
    assert set(out) == {*rids, extra}
    st = eng.queue_stats()
    assert st["depth"] == 0 and st["served"] == 4
    assert st["max_wait_s"] >= st["p50_wait_s"] >= 0.0
    assert st["max_wait_s"] > 0.0


def test_cancel_queued_and_active(nano):
    eng = _engine(nano, max_slots=1, max_new=16)
    got = []
    first = eng.submit(_audio(0), callback=lambda r, ids: got.append(r))
    queued = eng.submit(_audio(1), callback=lambda r, ids: got.append(r))
    third = eng.submit(_audio(2), callback=lambda r, ids: got.append(r))
    assert eng.cancel(queued) == "queued"
    eng.step()
    assert eng.cancel(first) == "active"
    out = eng.run_until_idle()
    assert queued not in out and first not in out
    assert third in out and got == [third]
    assert eng.cancel(12345) == "done"


def test_warmup_compiles_and_resets(nano):
    solo = _engine(nano, max_slots=2, max_new=6)
    r0 = solo.submit(_audio(7))
    ref = solo.run_until_idle()[r0]
    eng = _engine(nano, max_slots=2, max_new=6)
    profiling.start()
    try:
        eng.warmup()
    finally:
        records = profiling.stop()
    assert all(s is None for s in eng._slots) and not eng._queue
    q = eng.queue_stats()
    assert q["served"] == 0 and q["depth"] == 0
    assert eng.max_new == 6
    assert not records["spans"]
    rid = eng.submit(_audio(7))
    assert eng.run_until_idle()[rid] == ref


def test_bf16_engine_runs_on_cpu(nano):
    cfg, _, params = nano
    eng = ContinuousBatcher(params, cfg.replace(compute_dtype="bfloat16"),
                            max_slots=2, max_new=4, device="cpu")
    assert eng.state["cache"]["k"].dtype == torch.bfloat16
    rids = [eng.submit(_audio(s)) for s in (1, 2, 3)]
    out = eng.run_until_idle()
    for rid in rids:
        assert out[rid][:4] == SOT
        assert all(0 <= t < cfg.vocab_size for t in out[rid])


def test_refuses_what_is_not_ported(nano):
    """Sampling and the int8 caches are accepted (the int8 caches were
    refused before they were ported): with each int8 flag the fp32
    engine's state has the JAX engine's leaves, shapes and dtypes (fp32
    ignores self_kv_quant, as JAX's init_kv_cache does). Without a card
    the default device raises."""
    cfg, np_tree, params = nano
    ContinuousBatcher(params, cfg, device="cpu",
                      opts=DecodeOptions(temperature=1.0))
    jparams = jax.tree.map(jnp.asarray, np_tree)
    for flag in ("kv_cache_quant", "cross_kv_quant", "self_kv_quant"):
        qcfg = cfg.replace(**{flag: True})
        eng = ContinuousBatcher(params, qcfg, device="cpu")
        jeng = JaxBatcher(jparams, qcfg)
        for part in ("cache", "cross"):
            assert {n: (tuple(a.shape), str(a.dtype).split(".")[-1])
                    for n, a in eng.state[part].items()} == \
                {n: (a.shape, str(a.dtype))
                 for n, a in jeng.state[part].items()}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="not available"):
            ContinuousBatcher(params, cfg)       # device="cuda" by default
