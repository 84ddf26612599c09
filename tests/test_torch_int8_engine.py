"""The continuous engine on int8 caches in the port: the ragged append on
int8 rows (ops/cache_append.py), decoder_step_ragged's three int8
branches (models/whisper.py: the scale-commuted int8 self cache read in
place, capacity mode's quantizing scatter, the int8 cross read) and the
engine (serving_continuous.py) under cross_kv_quant, self_kv_quant and
kv_cache_quant, against the JAX package on the CPU with inputs from a
numpy seed: the intent of tests/test_continuous.py:251, :301 and :336.

Decoder tests run at d_model 128 with 2 heads (head_dim 64, the kernels')
over 200 audio positions. The engine tests use a nano config under a name
of their own, so the JAX engine's jitted stages traced here are this
file's alone."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_tpu.config import apply_serving_quant as jax_serving_quant
from whisper_tpu.config import get_config
from whisper_tpu.models import whisper as jm
from whisper_tpu.ops.cache_append import (
    cache_append_rows_ragged as jax_append_ragged,
)
from whisper_tpu.serving_continuous import ContinuousBatcher as JaxBatcher
from whisper_tpu.weights import to_device as jax_to_device
from whisper_tpu_torch.config import apply_serving_quant
from whisper_tpu_torch.models import whisper as tm
from whisper_tpu_torch.ops.cache_append import (
    cache_append_rows_ragged,
    set_rows,
)
from whisper_tpu_torch.serving_continuous import ContinuousBatcher
from whisper_tpu_torch.weights import from_jax_params, to_device

torch.set_num_threads(2)

SOT = [50258, 50259, 50359, 50363]


def _jitter(tree, seed):
    rng = np.random.RandomState(seed)
    return jax.tree.map(
        lambda x: (np.asarray(x) + 0.02 * rng.randn(*np.shape(x))
                   ).astype(np.float32), tree)


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.array(jnp.asarray(x).astype(jnp.float32))


# ---------------------------------------------------------------------------
# the ragged append on int8 rows
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pos", [(0, 31, 5, 5, 17, 0), (3, 32, 31, -1, 8, 8)])
def test_ragged_int8_plain_matches_jax_kernel(pos):
    """int8 caches and rows (the engine's self_kv_quant step): the plain
    version against the JAX kernel in interpret mode, bit for bit and in
    place, repeated positions included. A row at 32 or -1 (outside
    [0, 32)) keeps its cache, the port's contract at every dtype
    (tests/test_torch_cache_append.py): the JAX kernel instead writes such
    a row at its position modulo S inside its clamped window (here 0 and
    31), and the JAX step's scatter drops 32 and wraps -1, so those rows
    are held to the contract. The engine passes no such position."""
    rng = np.random.RandomState(sum(pos) + 40)
    L, B, H, S, D = 3, 6, 4, 32, 64
    ck, cv = (rng.randint(-127, 128, (L, B, H, S, D)).astype(np.int8)
              for _ in range(2))
    kn, vn = (rng.randint(-127, 128, (L, B, H, D)).astype(np.int8)
              for _ in range(2))
    jk, jv = jax_append_ragged(*(jnp.asarray(a) for a in (ck, cv, kn, vn)),
                               jnp.asarray(pos, jnp.int32), interpret=True)
    tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    ptrs = (tk.data_ptr(), tv.data_ptr())
    before = cache_append_rows_ragged.launches
    ok, ov = cache_append_rows_ragged(tk, tv, torch.from_numpy(kn),
                                      torch.from_numpy(vn), torch.tensor(pos))
    assert cache_append_rows_ragged.launches == before
    assert (ok.data_ptr(), ov.data_ptr()) == ptrs and ok.dtype == torch.int8
    for b, p in enumerate(pos):
        if 0 <= p < S:
            np.testing.assert_array_equal(ok[:, b].numpy(), np.asarray(jk)[:, b])
            np.testing.assert_array_equal(ov[:, b].numpy(), np.asarray(jv)[:, b])
        else:
            np.testing.assert_array_equal(ok[:, b].numpy(), ck[:, b])
            np.testing.assert_array_equal(ov[:, b].numpy(), cv[:, b])


# ---------------------------------------------------------------------------
# decoder_step_ragged on int8 caches
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def qcfg(small_cfg):
    return small_cfg.replace(name="q8-ragged-nano", d_model=128, n_heads=2,
                             n_audio_ctx=200, n_text_ctx=64)


@pytest.fixture(scope="module")
def qtree(qcfg):
    return _jitter(jm.init_params(qcfg, jax.random.PRNGKey(0)), 1)


def _q8_cache(rng, shape):
    """int8 values with per-vector scales of a written cache."""
    return (rng.randint(-127, 128, shape).astype(np.int8),
            (np.abs(rng.randn(*shape[:-1], 1)) * 0.02 + 1e-3
             ).astype(np.float32))


# (mode flags, dtype, JAX's backend)
_MODES = {
    "q8_self_bf16": ({"self_kv_quant": True, "cross_kv_quant": True,
                      "weight_quant": True}, "bfloat16", None),
    "capacity_bf16": ({"kv_cache_quant": True}, "bfloat16", None),
    "capacity_fp32": ({"kv_cache_quant": True}, "float32", None),
    "cross_bf16": ({"cross_kv_quant": True}, "bfloat16", None),
    "cross_fp32": ({"cross_kv_quant": True}, "float32", None),
    "cross_fp32_pallas": ({"cross_kv_quant": True}, "float32",
                          "pallas_interpret"),
}


def _step_inputs(cfg, qtree, seed):
    """Both sides' params, self cache, cross cache, tokens and positions
    for one ragged step: the caches drawn from the seed in the layouts
    cfg asks for (int8 with scales, or the compute dtype)."""
    rng = np.random.RandomState(seed)
    dtype = cfg.compute_dtype
    L, H, D, B = cfg.n_text_layers, cfg.n_heads, cfg.head_dim, 3
    jp = jax.tree.map(jnp.asarray, qtree)
    tp = to_device(from_jax_params(qtree), "cpu",
                   torch.bfloat16 if dtype == "bfloat16" else None)
    if dtype == "bfloat16":
        jp = jax_to_device(jp, jnp.bfloat16)
    if cfg.weight_quant:
        jp = jm.quantize_weights_wq(jp, cfg)
        tp = tm.quantize_weights_wq(tp, cfg)

    def cache(S, q8):
        shape = (L, B, H, S, D)
        if q8:
            k, ks = _q8_cache(rng, shape)
            v, vs = _q8_cache(rng, shape)
            return {"k": k, "k_s": ks, "v": v, "v_s": vs}
        return {n: (rng.randn(*shape) * 0.5).astype(np.float32)
                for n in ("k", "v")}

    fp32 = dtype == "float32"
    self_q8 = cfg.kv_cache_quant or (cfg.self_kv_quant and not fp32)
    cross_q8 = cfg.kv_cache_quant or cfg.cross_kv_quant
    sc, xc = cache(cfg.n_text_ctx, self_q8), cache(cfg.n_audio_ctx, cross_q8)

    def side(tree, make):
        return {n: make(a) if a.dtype != np.float32 or n.endswith("_s")
                else make(a, dtype) for n, a in tree.items()}

    def jmk(a, dt=None):
        return jnp.asarray(a, jnp.dtype(dt)) if dt else jnp.asarray(a)

    def tmk(a, dt=None):
        t = torch.from_numpy(a.copy())
        return t.to(getattr(torch, dt)) if dt else t

    tokens = rng.randint(0, cfg.vocab_size, (B, 1))
    pos = np.array([5, cfg.n_text_ctx - 1, 0])
    return (jp, side(sc, jmk), side(xc, jmk), tp, side(sc, tmk),
            side(xc, tmk), tokens, pos)


@pytest.mark.parametrize("mode", sorted(_MODES))
def test_decoder_step_ragged_int8_matches_jax(qcfg, qtree, mode):
    """One ragged step (rows at 5, the last slot and 0) on the same int8
    caches, per mode: the logits (fp32 atol 1e-4, as the unquantized
    ragged step; bf16 atol 0.05 on logits of order 1, the bf16 step's
    one-ulp roundings of the hidden state) with the same argmax; the self
    cache it writes in place: each row's new K/V at pos[b], every other
    slot bit for bit as it was. The new rows: in fp32 the projections
    differ in their last bits (sums in another order), so scales within
    rtol 1e-6 and int8 values within one step where a value sits on a
    rounding boundary; in bf16 the two frameworks may round a projection to
    neighbouring bf16 values, and a one-ulp move of a vector's largest
    value moves its scale by up to 0.4% (half an int8 step at 127) on top
    of the value's own half step, so int8 values within two steps and
    scales within rtol 1e-2."""
    flags, dtype, backend = _MODES[mode]
    cfg = qcfg.replace(compute_dtype=dtype, **flags)
    jp, jsc, jxc, tp, tsc, txc, tokens, pos = _step_inputs(cfg, qtree, 7)
    jl, jc = jm.decoder_step_ragged(
        jp, cfg.replace(attn_backend=backend), jnp.asarray(tokens, jnp.int32),
        jnp.asarray(pos, jnp.int32), jsc, jxc)
    before = {n: t.clone() for n, t in tsc.items()}
    ptrs = {n: t.data_ptr() for n, t in tsc.items()}
    tl, tc = tm.decoder_step_ragged(tp, cfg.replace(attn_backend=backend),
                                    torch.from_numpy(tokens),
                                    torch.from_numpy(pos), tsc, txc)
    assert {n: t.data_ptr() for n, t in tc.items()} == ptrs
    assert set(tc) == set(jc)
    atol = 1e-4 if dtype == "float32" else 0.05
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=atol)
    assert (tl[:, -1].argmax(-1).numpy()
            == np.asarray(jl)[:, -1].argmax(-1)).all()
    S = cfg.n_text_ctx
    for name in tc:
        got, want = _f32(tc[name]), _f32(jc[name])
        for b, p in enumerate(pos):
            keep = np.arange(S) != p
            assert torch.equal(tc[name][:, b][:, :, keep],
                               before[name][:, b][:, :, keep])
            if name.endswith("_s"):
                np.testing.assert_allclose(
                    got[:, b, :, p], want[:, b, :, p],
                    rtol=1e-2 if dtype == "bfloat16" else 1e-6)
            elif tc[name].dtype == torch.int8:
                steps = np.abs(got[:, b, :, p] - want[:, b, :, p]).max()
                assert steps <= (2 if dtype == "bfloat16" else 1)
            else:
                np.testing.assert_allclose(got[:, b, :, p], want[:, b, :, p],
                                           atol=atol)


def test_decoder_step_ragged_fp32_int8_cross_reads_the_q8_kernel(
        qcfg, qtree, monkeypatch):
    """fp32 with an int8 cross cache: every layer's cross read is T==1 and
    not ragged, so under "pallas_interpret" it goes to
    decode_attention_q8_bh (its plain version on the CPU), as JAX's
    multi_head_attention_quant routes it; under "auto" at 200 positions it
    is dequantized, as in JAX."""
    from whisper_tpu_torch.ops import attention
    calls = []
    real = attention.decode_attention_q8_bh

    def counting(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(attention, "decode_attention_q8_bh", counting)
    for backend, want in (("pallas_interpret", qcfg.n_text_layers),
                          (None, 0)):
        calls.clear()
        cfg = qcfg.replace(cross_kv_quant=True, attn_backend=backend)
        _, _, _, tp, tsc, txc, tokens, pos = _step_inputs(cfg, qtree, 8)
        tm.decoder_step_ragged(tp, cfg, torch.from_numpy(tokens),
                               torch.from_numpy(pos), tsc, txc)
        assert len(calls) == want


def test_q8_self_step_appends_int8_rows_in_one_launch(qcfg, qtree,
                                                      monkeypatch):
    """The in-place int8 branch ends in ONE ragged append, on the int8
    caches, with the rows quantized; the scale rows are written beside
    it. Capacity mode appends nothing (its scatter writes the rows)."""
    seen = []
    real = cache_append_rows_ragged

    def spy(ck, cv, kn, vn, pos):
        seen.append((ck.dtype, kn.dtype, tuple(kn.shape)))
        return real(ck, cv, kn, vn, pos)

    monkeypatch.setattr(tm, "cache_append_rows_ragged", spy)
    for flags, n in (({"self_kv_quant": True}, 1), ({"kv_cache_quant": True},
                                                     0)):
        seen.clear()
        cfg = qcfg.replace(compute_dtype="bfloat16", **flags)
        _, _, _, tp, tsc, txc, tokens, pos = _step_inputs(cfg, qtree, 9)
        tm.decoder_step_ragged(tp, cfg, torch.from_numpy(tokens),
                               torch.from_numpy(pos), tsc, txc)
        L, H, D = cfg.n_text_layers, cfg.n_heads, cfg.head_dim
        assert seen == [(torch.int8, torch.int8, (L, 3, H, D))] * n


def test_set_rows_writes_each_row_at_its_position():
    """set_rows on a (L, B, H, S, 1) scale cache and on one layer's
    (B, H, S, D) slice: row b lands at pos[b], rows outside [0, S) and
    every other slot keep their values."""
    rng = np.random.RandomState(0)
    for shape in ((2, 4, 3, 10, 1), (4, 3, 10, 8)):
        cache = torch.from_numpy(rng.randn(*shape).astype(np.float32))
        new = torch.from_numpy(rng.randn(*shape[:-2], shape[-1]).astype(
            np.float32))
        pos = torch.tensor([0, 9, 10, -1])
        want = cache.clone()
        for b, p in enumerate(pos.tolist()):
            if 0 <= p < 10:
                want[..., b, :, p, :] = new[..., b, :, :]
        set_rows(cache, new, pos)
        assert torch.equal(cache, want)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def enano():
    """tests/test_continuous.py's nano config under its own name, with a
    3 s window (150 audio positions), the JAX init plus seeded noise."""
    cfg = get_config("tiny").replace(
        name="torch-i8-engine-nano", d_model=64, n_heads=2,
        n_audio_layers=2, n_text_layers=2, chunk_length_s=3,
        n_audio_ctx=150, n_text_ctx=448)
    tree = _jitter(jm.init_params(cfg, jax.random.PRNGKey(0)), 1)
    return cfg, tree


def _audio(seed, seconds=1.5):
    rng = np.random.RandomState(seed)
    return (rng.randn(int(seconds * 16_000)) * 0.1).astype(np.float32)


def _engine_params(cfg, tree):
    """Both engines' params as the JAX tests build them: the compute-dtype
    cast, then the weight quantization when cfg asks for it."""
    jp = jax.tree.map(jnp.asarray, tree)
    tp = from_jax_params(tree)
    if cfg.compute_dtype == "bfloat16":
        jp = jax_to_device(jp, jnp.bfloat16)
        tp = to_device(tp, "cpu", torch.bfloat16)
    if cfg.weight_quant:
        jp = jm.quantize_weights_wq(jp, cfg)
        tp = tm.quantize_weights_wq(tp, cfg)
    return jp, tp


def _run(eng, seeds):
    rids = [eng.submit(_audio(s)) for s in seeds]
    out = eng.run_until_idle()
    return [out[r] for r in rids]


def _configs(cfg):
    """The engine's int8 configurations: fp32 with the int8 cross cache and
    in capacity mode; bf16 under the serving default (the JAX server's
    quant="auto": weight-only int8 and the int8 cross cache), with the int8
    self cache added (tests/test_continuous.py:336), and in capacity mode."""
    bf = cfg.replace(compute_dtype="bfloat16")
    serving = apply_serving_quant(bf)
    assert serving == jax_serving_quant(bf)
    assert serving.weight_quant and serving.cross_kv_quant
    return {"fp32_cross": cfg.replace(cross_kv_quant=True),
            "fp32_capacity": cfg.replace(kv_cache_quant=True),
            "bf16_serving": serving,
            "bf16_serving_sq": serving.replace(self_kv_quant=True),
            "bf16_capacity": bf.replace(kv_cache_quant=True)}


@pytest.mark.parametrize("name", ["fp32_cross", "fp32_capacity",
                                  "bf16_serving", "bf16_serving_sq",
                                  "bf16_capacity"])
def test_engine_int8_matches_jax_engine(enano, name):
    """Three requests through two slots (one joins as another leaves), on
    both engines with the same int8 configuration: every request's tokens
    identical to the JAX engine's, its state's leaves JAX's. (In bf16 the
    port rounds each op where XLA fuses; at this seed no step's pick is a
    near tie, so the tokens agree; the step's logits are held to JAX's in
    test_decoder_step_ragged_int8_matches_jax.)"""
    cfg0, tree = enano
    cfg = _configs(cfg0)[name]
    jp, tp = _engine_params(cfg, tree)
    kw = dict(max_slots=2, max_new=6)
    jeng = JaxBatcher(jp, cfg, **kw)
    teng = ContinuousBatcher(tp, cfg, device="cpu", **kw)
    for part in ("cache", "cross"):
        assert {n: (tuple(a.shape), str(a.dtype).split(".")[-1])
                for n, a in teng.state[part].items()} == \
            {n: (a.shape, str(a.dtype)) for n, a in jeng.state[part].items()}
    want = _run(jeng, (11, 12, 13))
    got = _run(teng, (11, 12, 13))
    assert got == want
    for ids in got:
        assert ids[:4] == SOT and len(ids) == 4 + 1 + 6


@pytest.mark.parametrize("name", ["fp32_cross", "fp32_capacity",
                                  "bf16_serving", "bf16_serving_sq",
                                  "bf16_capacity"])
def test_engine_int8_solo_equals_crowded(enano, name):
    """A request's tokens alone in the engine equal its tokens arriving
    third into a crowd, beside requests mid-decode: neither its slot nor
    its companions change them, on int8 caches too."""
    cfg0, tree = enano
    cfg = _configs(cfg0)[name]
    _, tp = _engine_params(cfg, tree)
    solo = ContinuousBatcher(tp, cfg, max_slots=3, max_new=7, device="cpu")
    ref = _run(solo, (21,))[0]
    crowd = ContinuousBatcher(tp, cfg, max_slots=3, max_new=7, device="cpu")
    crowd.submit(_audio(22))
    crowd.submit(_audio(23))
    for _ in range(3):
        crowd.step()
    mine = crowd.submit(_audio(21))
    crowd.submit(_audio(24))
    assert crowd.run_until_idle()[mine] == ref


def test_engine_fills_every_cross_and_cache_leaf(enano):
    """A fill writes every leaf of the joining rows: the int8 cross values
    and their scales (none left at 1e-10), and the prefill's self-cache
    values and scales in columns [0, prompt length); the other slot's
    rows stay as they were."""
    cfg0, tree = enano
    cfg = _configs(cfg0)["bf16_capacity"]
    _, tp = _engine_params(cfg, tree)
    eng = ContinuousBatcher(tp, cfg, max_slots=2, max_new=3, device="cpu")
    eng.submit(_audio(31))
    eng._fill_free_slots()
    s = eng.state
    for part in ("cross", "cache"):
        assert set(s[part]) == {"k", "k_s", "v", "v_s"}
    P = int(s["pos"][0])
    for name in ("k_s", "v_s"):
        assert bool((s["cross"][name][:, 0] > 1e-10).all())
        assert bool((s["cache"][name][:, 0, :, :P] > 1e-10).all())
        assert bool((s["cross"][name][:, 1] == np.float32(1e-10)).all())
        assert bool((s["cache"][name][:, 1] == np.float32(1e-10)).all())
    for name in ("k", "v"):
        assert bool(s["cross"][name][:, 0].any())
        assert not bool(s["cross"][name][:, 1].any())
        assert not bool(s["cache"][name][:, 1].any())
