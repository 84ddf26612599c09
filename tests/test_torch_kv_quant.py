"""int8 KV caches in the port (whisper_tpu_torch/models/whisper.py
quantize_kv, init_kv_cache, precompute_cross_kv, the quantizing append,
_att_cross_q8, _self_attention_extra_q8, decoder_step_ip's q8 branches;
ops/attention.py multi_head_attention_quant; ops/decode_attention.py)
against the JAX package on the CPU: the intent of tests/test_kv_quant.py
and tests/test_self_kv_quant.py, plus greedy tokens for each int8
configuration and the routes that are not ported.

Decoder tests run at d_model 128 with 2 heads (head_dim 64, the kernel's)
over 200 audio positions (not a multiple of the JAX kernel's 128-key
tile)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_tpu.decode import greedy_decode as jax_greedy_decode
from whisper_tpu.models import whisper as jm
from whisper_tpu.ops.decode_attention import (
    decode_attention_q8 as jax_q8,
    decode_attention_q8_bh as jax_q8_bh,
)
from whisper_tpu.tokenizer import build_prompt
from whisper_tpu.weights import to_device as jax_to_device
from whisper_tpu_torch.decode import _greedy_prefill, greedy_decode
from whisper_tpu_torch.models import whisper as tm
from whisper_tpu_torch.ops import attention, decode_attention
from whisper_tpu_torch.ops.decode_attention import (
    decode_attention_q8,
    decode_attention_q8_bh,
    decode_attention_q8_plain,
)
from whisper_tpu_torch.weights import from_jax_params, to_device

torch.set_num_threads(2)


def _jitter(tree, seed):
    """JAX init params plus seeded noise: non-zero biases and LayerNorms."""
    rng = np.random.RandomState(seed)
    return jax.tree.map(
        lambda x: (np.asarray(x) + 0.02 * rng.randn(*np.shape(x))
                   ).astype(np.float32), tree)


def _f32(x) -> np.ndarray:
    """A JAX or torch array as fp32 numpy (bf16 included)."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.array(jnp.asarray(x).astype(jnp.float32))


def _within_bf16_ulp(got, want, ulps: int = 1) -> None:
    """|got - want| <= ulps x one bf16 ulp of want (8 significant bits):
    two fp32 results that differ in their last bits may round to
    neighbouring bf16 values."""
    got, want = _f32(got), _f32(want)
    exp = np.floor(np.log2(np.maximum(np.abs(want), 1e-30)))
    ulp = np.where(want == 0, 0.0, 2.0 ** (exp - 7))
    bad = np.abs(got - want) > ulps * ulp
    assert not bad.any(), (f"{bad.sum()} of {bad.size} beyond {ulps} bf16 "
                           f"ulp; max abs err {np.abs(got - want).max()}")


@pytest.fixture(scope="module")
def qcfg(small_cfg):
    return small_cfg.replace(name="q8-nano", d_model=128, n_heads=2,
                             n_audio_ctx=200, n_text_ctx=64)


@pytest.fixture(scope="module")
def qtree(qcfg):
    return _jitter(jm.init_params(qcfg, jax.random.PRNGKey(0)), 1)


def _params(np_tree, cfg):
    """Both packages' params for cfg: the compute-dtype cast, then the
    weight quantization when cfg asks for it (the JAX pipeline's order)."""
    bf16 = cfg.compute_dtype == "bfloat16"
    jp = jax.tree.map(jnp.asarray, np_tree)
    tp = to_device(from_jax_params(np_tree), "cpu",
                   torch.bfloat16 if bf16 else None)
    if bf16:
        jp = jax_to_device(jp, jnp.bfloat16)
    if cfg.weight_quant:
        jp = jm.quantize_weights_wq(jp, cfg)
        tp = tm.quantize_weights_wq(tp, cfg)
    return jp, tp


def _enc(cfg, B=2, seed=2):
    enc = np.random.RandomState(seed).randn(B, cfg.n_audio_ctx, cfg.d_model
                                            ).astype(np.float32)
    if cfg.compute_dtype == "bfloat16":
        return jnp.asarray(enc, jnp.bfloat16), torch.from_numpy(enc).bfloat16()
    return jnp.asarray(enc), torch.from_numpy(enc)


# ---------------------------------------------------------------------------
# quantize_kv and the int8 layouts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_bit_equal_to_jax(dtype):
    """int8 values bit for bit, scales equal, over fp32 and bf16 rows; a
    zero vector takes the 1e-10 floor; the input is left as it was."""
    x = np.random.RandomState(0).randn(2, 3, 50, 64).astype(np.float32) * 3
    x[0, 1, 7] = 0.0
    jx = jnp.asarray(x, jnp.dtype(dtype))
    tx = torch.from_numpy(_f32(jx))
    if dtype == "bfloat16":
        tx = tx.bfloat16()
    jq, js = jm.quantize_kv(jx)
    tq, ts = tm.quantize_kv(tx)
    assert tq.dtype == torch.int8 and ts.shape == (2, 3, 50, 1)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert float(ts[0, 1, 7]) == np.float32(1e-10)
    np.testing.assert_array_equal(_f32(tx), _f32(jx))       # not in place


@pytest.mark.parametrize("dtype,flags,int8", [
    ("float32", {"kv_cache_quant": True}, True),
    ("bfloat16", {"kv_cache_quant": True}, True),
    ("bfloat16", {"self_kv_quant": True}, True),
    ("float32", {"self_kv_quant": True}, False),    # fp32 ignores it
    ("bfloat16", {"cross_kv_quant": True}, False),
])
def test_init_kv_cache_layout_matches_jax(qcfg, dtype, flags, int8):
    cfg = qcfg.replace(compute_dtype=dtype, **flags)
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    got = tm.init_kv_cache(cfg, 2, tdt, 64, "cpu")
    want = jm.init_kv_cache(cfg, 2, jnp.dtype(dtype), 64)
    assert set(got) == set(want) == ({"k", "k_s", "v", "v_s"} if int8
                                     else {"k", "v"})
    for name in got:
        assert tuple(got[name].shape) == want[name].shape
        np.testing.assert_array_equal(_f32(got[name]), _f32(want[name]))
    assert got["k"].dtype == (torch.int8 if int8 else tdt)


def test_precompute_cross_kv_int8_matches_jax(qcfg, qtree):
    """The int8 cross cache: the fp32 K/V agree to 1e-4, so an int8 value
    may sit one step off where it lies on a rounding boundary; the scales
    agree to 1e-5."""
    cfg = qcfg.replace(cross_kv_quant=True)
    jp, tp = _params(qtree, cfg)
    jenc, tenc = _enc(cfg)
    want = jm.precompute_cross_kv(jp, cfg, jenc)
    got = tm.precompute_cross_kv(tp, cfg, tenc)
    assert set(got) == {"k", "k_s", "v", "v_s"}
    for name in ("k", "v"):
        assert got[name].dtype == torch.int8
        d = np.abs(got[name].numpy().astype(np.int32)
                   - np.asarray(want[name]).astype(np.int32))
        assert d.max() <= 1 and (d > 0).mean() < 1e-3
        np.testing.assert_allclose(got[name + "_s"].numpy(),
                                   np.asarray(want[name + "_s"]), rtol=1e-5)


# ---------------------------------------------------------------------------
# decode_attention_q8(_bh): the plain version against the Pallas kernels
# ---------------------------------------------------------------------------

def _q8_inputs(B=2, H=3, S=200, D=64, seed=0):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, 1, H, D).astype(np.float32)
    k8, ks = jm.quantize_kv(jnp.asarray(rng.randn(B, H, S, D) * 2.0,
                                        jnp.float32))
    v8, vs = jm.quantize_kv(jnp.asarray(rng.randn(B, H, S, D), jnp.float32))
    return q, k8, ks, v8, vs


@pytest.mark.parametrize("which", ["bh", "per_head"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kv_len", [0, 1, 77, 200])
def test_decode_q8_plain_matches_jax_interpret(which, dtype, kv_len):
    """Against the JAX kernels in interpret mode, S = 200 (not a multiple
    of their 128-key tile): fp32 to 1e-5 (online against two-pass softmax,
    fp32 sums in other orders); bf16 within one bf16 ulp of the output;
    kv_len 0 gives zeros."""
    q, k8, ks, v8, vs = _q8_inputs()
    jq = jnp.asarray(q, jnp.dtype(dtype))
    jfn, tfn = ((jax_q8_bh, decode_attention_q8_bh) if which == "bh"
                else (jax_q8, decode_attention_q8))
    want = jfn(jq, k8, ks, v8, vs, kv_len, interpret=True)
    tq = torch.from_numpy(_f32(jq))
    if dtype == "bfloat16":
        tq = tq.bfloat16()
    t = [torch.from_numpy(np.asarray(a)) for a in (k8, ks, v8, vs)]
    before = tfn.launches
    got = tfn(tq, *t, kv_len)
    assert tfn.launches == before                 # the CPU runs no kernel
    assert got.dtype == tq.dtype and tuple(got.shape) == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=0)
    else:
        _within_bf16_ulp(got, want)
    if kv_len == 0:
        assert not got.any()


def test_decode_q8_plain_zero_rows_are_not_nan():
    q, k8, ks, v8, vs = (torch.from_numpy(np.asarray(a))
                         for a in _q8_inputs(S=16))
    out = decode_attention_q8_plain(q, k8, ks, v8, vs, 0)
    assert torch.isfinite(out).all() and not out.any()
    # a fully valid row is a plain softmax average of the dequantized V
    full = decode_attention_q8_plain(q, k8, ks, v8, vs)
    s = torch.einsum("bthd,bhsd->bhts", q * 0.125, k8.float() * ks)
    want = torch.einsum("bhts,bhsd->bthd", torch.softmax(s, -1),
                        v8.float() * vs)
    torch.testing.assert_close(full, want, atol=1e-6, rtol=1e-6)


def test_decode_q8_refuses_bad_arguments():
    q, k8, ks, v8, vs = (torch.from_numpy(np.asarray(a))
                         for a in _q8_inputs(S=16))
    with pytest.raises(ValueError, match="one query token"):
        decode_attention_q8_bh(q.expand(2, 2, 3, 64), k8, ks, v8, vs)
    with pytest.raises(ValueError, match="kv_len"):
        decode_attention_q8_bh(q, k8, ks, v8, vs, 17)
    with pytest.raises(ValueError, match="expected"):
        decode_attention_q8(q, k8, ks[:, :, :8], v8, vs)
    with pytest.raises(ValueError, match="no kernel for device"):
        decode_attention_q8(*(t.to("meta") for t in (q, k8, ks, v8, vs)))


def test_quant_attention_routes_long_t1_reads_to_the_kernel(monkeypatch):
    """multi_head_attention_quant: a T==1 read of >= 4096 slots goes to
    decode_attention_q8_bh (its plain version on the CPU); a shorter one
    or a T > 1 read dequantizes into multi_head_attention. Both agree
    with JAX's multi_head_attention_quant (its CPU route dequantizes)."""
    from whisper_tpu.ops.attention import multi_head_attention_quant as jmq
    calls = []
    real = decode_attention.decode_attention_q8_bh

    def counting(*a, **kw):
        calls.append(a[1].shape[2])
        return real(*a, **kw)

    monkeypatch.setattr(attention, "decode_attention_q8_bh", counting)
    rng = np.random.RandomState(4)
    for T, S, kv_len, causal in ((1, 4096, 3000, False), (1, 300, 120, True),
                                 (4, 300, 4, True)):
        q = rng.randn(1, T, 2, 64).astype(np.float32)
        k8, ks = jm.quantize_kv(jnp.asarray(rng.randn(1, 2, S, 64),
                                            jnp.float32))
        v8, vs = jm.quantize_kv(jnp.asarray(rng.randn(1, 2, S, 64),
                                            jnp.float32))
        q_offset = kv_len - T
        want = jmq(jnp.asarray(q), k8, ks, v8, vs, kv_len, causal=causal,
                   q_offset=q_offset, backend="reference")
        got = attention.multi_head_attention_quant(
            torch.from_numpy(q), *(torch.from_numpy(np.asarray(a))
                                   for a in (k8, ks, v8, vs)),
            kv_len, causal=causal, q_offset=q_offset)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    assert calls == [4096]


def test_quant_attention_keeps_ragged_t1_reads_off_the_kernel(monkeypatch):
    """A T==1 read of >= 4096 slots with a per-row kv_len dequantizes into
    multi_head_attention, as JAX's `not ragged` gate (:141-148) has it, and
    agrees with JAX; it never reaches decode_attention_q8_bh, whose kv_len
    is one length for the whole batch."""
    from whisper_tpu.ops.attention import multi_head_attention_quant as jmq

    def refuse(*a, **kw):
        raise AssertionError("a ragged read reached decode_attention_q8_bh")

    monkeypatch.setattr(attention, "decode_attention_q8_bh", refuse)
    rng = np.random.RandomState(5)
    lens = np.array([4096, 2500, 1], np.int32)
    q = rng.randn(3, 1, 2, 64).astype(np.float32)
    k8, ks = jm.quantize_kv(jnp.asarray(rng.randn(3, 2, 4096, 64),
                                        jnp.float32))
    v8, vs = jm.quantize_kv(jnp.asarray(rng.randn(3, 2, 4096, 64),
                                        jnp.float32))
    want = jmq(jnp.asarray(q), k8, ks, v8, vs, jnp.asarray(lens),
               backend="reference")
    got = attention.multi_head_attention_quant(
        torch.from_numpy(q), *(torch.from_numpy(np.asarray(a))
                               for a in (k8, ks, v8, vs)),
        torch.from_numpy(lens).long().view(3, 1, 1, 1))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


# ---------------------------------------------------------------------------
# the scale-commuted bf16 reads
# ---------------------------------------------------------------------------

# Tolerance of the two commuted reads: the products are exact in fp32 and
# summed in other orders; bf16(p * scale) may round one element the other
# way at a tie, and the output rounds to bf16 once: two bf16 ulps.

def test_att_cross_q8_matches_jax():
    q, k8, ks, v8, vs = _q8_inputs(B=2, H=2, S=200, seed=5)
    jq = jnp.asarray(q, jnp.bfloat16)
    cross = {"k": k8, "k_s": ks, "v": v8, "v_s": vs}
    want = jm._att_cross_q8(jq, cross, 64, jnp.bfloat16, mxu_t=0)
    got = tm._att_cross_q8(torch.from_numpy(_f32(jq)).bfloat16(),
                           {n: torch.from_numpy(np.asarray(a))
                            for n, a in cross.items()}, 64, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    _within_bf16_ulp(got, want, ulps=2)


@pytest.mark.parametrize("pos", [0, 1, 40, 63])
def test_self_attention_extra_q8_matches_jax(pos):
    rng = np.random.RandomState(pos)
    B, H, S, D = 2, 2, 64, 64
    q = jnp.asarray(rng.randn(B, 1, H, D), jnp.bfloat16)
    k8, ks = jm.quantize_kv(jnp.asarray(rng.randn(B, H, S, D), jnp.float32))
    v8, vs = jm.quantize_kv(jnp.asarray(rng.randn(B, H, S, D), jnp.float32))
    k_new = jnp.asarray(rng.randn(B, H, 1, D), jnp.bfloat16)
    v_new = jnp.asarray(rng.randn(B, H, 1, D), jnp.bfloat16)
    mask = (jnp.arange(S) < pos)[None, None, None, :]
    want = jm._self_attention_extra_q8(q, k8, ks, v8, vs, k_new, v_new, mask,
                                       D, jnp.bfloat16, mxu_t=0)

    def bf16(a):
        return torch.from_numpy(_f32(a)).bfloat16()

    def same(a):
        return torch.from_numpy(np.asarray(a))

    got = tm._self_attention_extra_q8(bf16(q), same(k8), same(ks), same(v8),
                                      same(vs), bf16(k_new), bf16(v_new),
                                      pos, D, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    _within_bf16_ulp(got, want, ulps=2)


# ---------------------------------------------------------------------------
# decoder steps over int8 caches
# ---------------------------------------------------------------------------

def _prefill(cfg, qtree, B=2):
    """Cross K/V and the prompt prefill on both sides."""
    jp, tp = _params(qtree, cfg)
    jenc, tenc = _enc(cfg, B)
    dt = cfg.compute_dtype
    tdt = torch.bfloat16 if dt == "bfloat16" else torch.float32
    prompt = np.tile(build_prompt(cfg), (B, 1))
    jcross = jm.precompute_cross_kv(jp, cfg, jenc)
    jl, jcache = jm.decoder_forward(jp, cfg, jnp.asarray(prompt, jnp.int32),
                                    jnp.int32(0),
                                    jm.init_kv_cache(cfg, B, jnp.dtype(dt),
                                                     64), jcross)
    tcross = tm.precompute_cross_kv(tp, cfg, tenc)
    tl, tcache = tm.decoder_forward(tp, cfg, torch.from_numpy(prompt), 0,
                                    tm.init_kv_cache(cfg, B, tdt, 64, "cpu"),
                                    tcross)
    return dict(jp=jp, tp=tp, jl=jl, tl=tl, jcache=jcache, tcache=tcache,
                jcross=jcross, tcross=tcross, P=prompt.shape[1])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kv_cache_quant_prefill_matches_jax(qcfg, qtree, dtype):
    """decoder_forward quantizes each new row into the int8 caches in
    place and reads them dequantized: logits to 1e-4 in fp32 (to a few
    bf16 ulps of the O(1) values in bf16) with the same argmax; the int8
    rows within one step of JAX's, the scales to 1e-5 (1e-2 in bf16, where
    the rows themselves are bf16, and two int8 steps), the slots past the
    prompt untouched."""
    cfg = qcfg.replace(compute_dtype=dtype, kv_cache_quant=True)
    p = _prefill(cfg, qtree)
    fp32 = dtype == "float32"
    np.testing.assert_allclose(p["tl"].numpy(), np.asarray(p["jl"]),
                               atol=1e-4 if fp32 else 0.05)
    assert (p["tl"][:, -1].argmax(-1).numpy()
            == np.asarray(p["jl"][:, -1]).argmax(-1)).all()
    P = p["P"]
    for name in ("k", "v"):
        got, want = p["tcache"][name], np.asarray(p["jcache"][name])
        assert got.dtype == torch.int8
        # bf16 rows may differ by a bf16 ulp (1/256 of the row's max, half
        # an int8 step at the top), and the scale with them: two steps
        assert np.abs(got.numpy().astype(int) - want.astype(int)).max() \
            <= (1 if fp32 else 2)
        np.testing.assert_allclose(p["tcache"][name + "_s"].numpy(),
                                   np.asarray(p["jcache"][name + "_s"]),
                                   rtol=1e-5 if fp32 else 1e-2)
        assert not got[:, :, :, P:].any()
        assert (p["tcache"][name + "_s"][:, :, :, P:] == np.float32(1e-10)
                ).all()


@pytest.mark.parametrize("backend", [None, "pallas_interpret"])
def test_step_ip_fp32_int8_cross_matches_jax(qcfg, qtree, backend,
                                             monkeypatch):
    """fp32 mode with an int8 cross cache: every layer's cross read goes
    to decode_attention_q8_bh (its plain version here), against JAX's
    step on its dequant route and on its interpret-mode q8 kernel: logits
    and self cache to 1e-4, same argmax."""
    cfg = qcfg.replace(cross_kv_quant=True)
    p = _prefill(cfg, qtree)
    P = p["P"]
    last = np.argmax(np.asarray(p["jl"])[:, -1:], axis=-1)
    jl, jc = jm.decoder_step_ip(p["jp"], cfg.replace(attn_backend=backend),
                                jnp.asarray(last, jnp.int32), jnp.int32(P),
                                p["jcache"], p["jcross"])
    calls = []
    real = tm.decode_attention_q8_bh
    monkeypatch.setattr(tm, "decode_attention_q8_bh",
                        lambda *a: calls.append(1) or real(*a))
    tl, tc = tm.decoder_step_ip(p["tp"], cfg, torch.from_numpy(last), P,
                                p["tcache"], p["tcross"])
    assert len(calls) == cfg.n_text_layers
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    assert (tl[:, -1].argmax(-1).numpy()
            == np.asarray(jl[:, -1]).argmax(-1)).all()
    for name in ("k", "v"):
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                   atol=1e-4)


def test_step_ip_bf16_int8_self_and_cross_matches_jax(qcfg, qtree):
    """bf16 with weight-only int8 and int8 self and cross caches: the
    commuted reads, the int8 append in place and the scale rows at pos;
    logits to a few bf16 ulps of the O(1) values with JAX's argmax
    (JAX at mxu_t=0, the port's T==1 form)."""
    cfg = qcfg.replace(compute_dtype="bfloat16", weight_quant=True,
                       cross_kv_quant=True, self_kv_quant=True)
    p = _prefill(cfg, qtree)
    P = p["P"]
    last = np.argmax(np.asarray(p["jl"])[:, -1:], axis=-1)
    jl, jc = jm.decoder_step_ip(p["jp"], cfg, jnp.asarray(last, jnp.int32),
                                jnp.int32(P), p["jcache"], p["jcross"],
                                mxu_t=0)
    ptr = p["tcache"]["k"].data_ptr()
    tl, tc = tm.decoder_step_ip(p["tp"], cfg, torch.from_numpy(last), P,
                                p["tcache"], p["tcross"])
    assert tc["k"].data_ptr() == ptr and tc["k"].dtype == torch.int8
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=0.05)
    assert (tl[:, -1].argmax(-1).numpy()
            == np.asarray(jl[:, -1]).argmax(-1)).all()
    for name in ("k", "v"):
        row = np.abs(tc[name][:, :, :, P].numpy().astype(int)
                     - np.asarray(jc[name][:, :, :, P]).astype(int))
        # bf16 rows of a step whose input carries the bf16 rounding
        # difference: a few bf16 ulps, so two int8 steps and 2% of a scale
        assert row.max() <= 2
        np.testing.assert_allclose(tc[name + "_s"][:, :, :, P].numpy(),
                                   np.asarray(jc[name + "_s"][:, :, :, P]),
                                   rtol=2e-2)
        assert not tc[name][:, :, :, P + 1:].any()


def test_step_ip_refuses_int8_self_cache_in_fp32(qcfg):
    cache = tm.init_kv_cache(qcfg.replace(kv_cache_quant=True), 1,
                             torch.float32, 64, "cpu")
    with pytest.raises(ValueError, match="bf16 serving mode only"):
        tm.decoder_step_ip({"decoder": {}}, qcfg, torch.zeros((1, 1),
                                                              dtype=torch.long),
                           4, cache, {})


# ---------------------------------------------------------------------------
# greedy decoding: the port's tokens equal JAX's for each int8 configuration
# ---------------------------------------------------------------------------

# bf16 near-tie bound: the port's bf16 logits sit within ~0.015 of the
# jitted JAX's at this width (XLA keeps fp32 between the ops of a fusion
# where the eager port rounds each op to bf16), so a top-2 margin below
# 0.05, the bf16 logits tolerance of these tests, is a tie either may break.
_NEAR_TIE = 0.05


# Each JAX greedy_decode call takes a decode cap no other test uses with its
# config: the JAX stages are jitted on (cfg, total, max_new).
@pytest.mark.parametrize("dtype,flags,max_new", [
    ("float32", {"cross_kv_quant": True}, 21),
    ("bfloat16", {"weight_quant": True, "cross_kv_quant": True,
                  "self_kv_quant": True}, 23),
    ("float32", {"kv_cache_quant": True}, 25),
    ("bfloat16", {"kv_cache_quant": True}, 27),
    ("bfloat16", {}, 29),        # unquantized: the same rule holds
])
def test_greedy_tokens_match_jax(qcfg, qtree, dtype, flags, max_new):
    """fp32: the port's greedy tokens and lengths equal JAX's. bf16: the
    port's free-running tokens equal JAX's at least up to JAX's first near
    tie; then, teacher-forced on JAX's tokens through the port's own
    prefill and step, every pick where JAX's top-2 margin is not a near tie
    equals JAX's, and at a near tie the port's pick is within the tie bound
    of JAX's best logit. The unquantized case holds the same rule."""
    cfg = qcfg.replace(compute_dtype=dtype, **flags)
    jp, tp = _params(qtree, cfg)
    jenc, tenc = _enc(cfg, seed=7)
    prompt = np.tile(build_prompt(cfg), (2, 1))
    P = prompt.shape[1]
    want = jax_greedy_decode(jp, cfg, jenc, jnp.asarray(prompt, jnp.int32),
                             max_new=max_new)
    got = greedy_decode(tp, cfg, tenc, torch.from_numpy(prompt),
                        max_new=max_new)
    w, g = np.array(want.tokens), got.tokens.numpy()
    if dtype == "float32":
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(got.lengths.numpy(),
                                      np.asarray(want.lengths))
        return
    # JAX's logits for each pick, teacher-forced on its own tokens
    jl, _ = jm.decoder_forward(jp, cfg, jnp.asarray(w[:, :-1]), jnp.int32(0),
                               jm.init_kv_cache(cfg, 2, jnp.bfloat16, 64),
                               jm.precompute_cross_kv(jp, cfg, jenc))
    jl = _f32(jl)[:, P - 1:]                       # (2, 1 + max_new, vocab)
    top2 = np.sort(jl, axis=-1)[..., -2:]
    tie = top2[..., 1] - top2[..., 0] < _NEAR_TIE
    # the port's picks through its own prefill and steps on JAX's tokens
    with torch.inference_mode():
        cross, cache, _, logits = _greedy_prefill(
            tp, cfg, tenc, torch.from_numpy(prompt), w.shape[1])
        picks = [logits[:, -1].argmax(-1)]
        step = tm.decoder_forward if cfg.kv_cache_quant else tm.decoder_step_ip
        for i in range(max_new):
            last = torch.from_numpy(w[:, P + i:P + i + 1])
            logits, cache = step(tp, cfg, last, P + i, cache, cross)
            picks.append(logits[:, -1].argmax(-1))
    picks = torch.stack(picks, 1).numpy()
    for b in range(2):
        n_tie = int(np.argmax(tie[b])) if tie[b].any() else tie.shape[1]
        diff = np.nonzero(g[b, P:] != w[b, P:])[0]
        # free-running: no divergence before JAX's first near tie
        assert not diff.size or diff[0] >= n_tie, (b, int(diff[0]), n_tie)
        sure = ~tie[b]
        np.testing.assert_array_equal(picks[b][sure], w[b, P:][sure])
        near = jl[b][tie[b]]
        gap = near.max(-1) - near[np.arange(len(near)), picks[b][tie[b]]]
        assert (gap < _NEAR_TIE).all(), gap
    # the exact check is not vacuous: near ties are rare at this width
    # the exact check is not vacuous. Measured at this seed (near ties per
    # row of 1 + max_new picks; first free-running divergence): wq+cq+sq
    # 7 and 6 of 24 (step 16; none), kv_cache_quant 2 and 2 of 28 (step 0;
    # none), unquantized 9 and 2 of 30 (step 5; step 0). JAX's first pick
    # is a near tie in every case, so the free-running check alone could
    # pass at step 0; the teacher-forced one checks every later step.
    assert (~tie).sum() >= 0.7 * tie.size, tie.sum(-1)


def test_fp32_ignores_self_kv_quant(qcfg, qtree):
    """fp32 token-parity mode keeps full-precision self caches with
    self_kv_quant set: the same tokens and cache as without it."""
    _, tp = _params(qtree, qcfg)
    _, tenc = _enc(qcfg, seed=8)
    prompt = torch.tensor([build_prompt(qcfg)] * 2)
    runs = [greedy_decode(tp, qcfg.replace(self_kv_quant=sq), tenc, prompt,
                          max_new=6) for sq in (False, True)]
    assert torch.equal(runs[0].tokens, runs[1].tokens)
    cache = tm.init_kv_cache(qcfg.replace(self_kv_quant=True), 2,
                             torch.float32, 64, "cpu")
    assert set(cache) == {"k", "v"} and cache["k"].dtype == torch.float32


# ---------------------------------------------------------------------------
# the encoder's int8 flags and the engine's int8 caches (once refused, now
# ported: tests/test_torch_int8_encoder.py, tests/test_torch_int8_engine.py
# hold them to JAX in full)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def short_enc(small_cfg):
    """A 3 s-window nano model (150 audio positions), its mel, and the same
    weights as a JAX tree."""
    from whisper_tpu_torch.weights import init_params
    cfg = small_cfg.replace(chunk_length_s=3, n_audio_ctx=150)
    mel = torch.from_numpy(np.random.RandomState(9).randn(
        1, cfg.n_mels, cfg.n_frames).astype(np.float32))
    params = init_params(cfg, 0)
    jtree = jax.tree.map(lambda t: jnp.asarray(t.numpy()), params)
    return cfg, params, mel, jtree


@pytest.mark.parametrize("flag", ["encoder_quant", "encoder_mlp_quant",
                                  "encoder_qkv_quant"])
def test_encoder_int8_routes_raise_where_jax_takes_them(short_enc, flag,
                                                        monkeypatch):
    """Each encoder int8 flag where JAX takes it, against JAX (these routes
    raised before they were ported). bf16 with the tail (nano width, as
    tiny and base): encoder_quant runs its int8 projections and
    encoder_mlp_quant the tail's int8 form (encoder_qkv_quant with it, as
    the serving policy sets both), within 3% of JAX's largest output (the
    measured gap is 1.1%; tests/test_torch_int8_encoder.py states why) and
    unlike the bf16 output. fp32 ignores all three, as in JAX: equal to no
    flag. With the tail off (WHISPER_TPU_FUSED_ENCODER=0) the two tail
    flags are no-ops, as in JAX, and encoder_quant, which bypasses the
    tail, gives what it gives with the tail on."""
    cfg, params, mel, jtree = short_enc
    p16 = to_device(params, "cpu", torch.bfloat16)
    flags = {flag: True}
    if flag == "encoder_qkv_quant":
        flags["encoder_mlp_quant"] = True
    cfg16 = cfg.replace(compute_dtype="bfloat16", **flags)
    got = tm.encoder_forward(p16, cfg16, mel)
    backend = None if flag == "encoder_quant" else "pallas_interpret"
    want = _f32(jm.encoder_forward(
        jax_to_device(jtree, jnp.bfloat16),
        cfg16.replace(attn_backend=backend), jnp.asarray(mel.numpy(),
                                                         jnp.bfloat16)))
    assert np.abs(_f32(got) - want).max() / np.abs(want).max() < 0.03
    plain16 = tm.encoder_forward(p16, cfg.replace(compute_dtype="bfloat16"),
                                 mel)
    assert not torch.equal(got, plain16)
    p32 = to_device(params, "cpu")
    assert torch.equal(tm.encoder_forward(p32, cfg.replace(**flags), mel),
                       tm.encoder_forward(p32, cfg, mel))
    monkeypatch.setenv("WHISPER_TPU_FUSED_ENCODER", "0")
    off = tm.encoder_forward(p16, cfg16, mel)
    if flag == "encoder_quant":
        assert torch.equal(off, got)
    else:
        assert torch.equal(off, tm.encoder_forward(
            p16, cfg.replace(compute_dtype="bfloat16"), mel))


@pytest.mark.parametrize("flag", ["kv_cache_quant", "cross_kv_quant",
                                  "self_kv_quant"])
def test_engine_int8_caches_raise(short_enc, flag):
    """The bf16 engine on each int8 cache (refused before the port had
    the ragged int8 append): its state has the JAX engine's leaves,
    shapes and dtypes, with every scale starting at 1e-10, and two
    requests through one slot run to their cap."""
    from whisper_tpu.serving_continuous import ContinuousBatcher as JaxBatcher
    from whisper_tpu_torch.serving_continuous import ContinuousBatcher
    cfg, params, _, jtree = short_enc
    cfg = cfg.replace(compute_dtype="bfloat16", **{flag: True})
    eng = ContinuousBatcher(params, cfg, max_slots=1, max_new=3,
                            device="cpu")
    jeng = JaxBatcher(jax_to_device(jtree, jnp.bfloat16), cfg, max_slots=1,
                      max_new=3)
    for part in ("cache", "cross"):
        assert {n: (tuple(a.shape), str(a.dtype).split(".")[-1])
                for n, a in eng.state[part].items()} == \
            {n: (a.shape, str(a.dtype)) for n, a in jeng.state[part].items()}
        for n, a in eng.state[part].items():
            if n.endswith("_s"):
                assert bool((a == np.float32(1e-10)).all())
    audio = np.random.RandomState(4).randn(16_000).astype(np.float32) * 0.1
    rids = [eng.submit(audio), eng.submit(audio)]
    out = eng.run_until_idle()
    assert out[rids[0]] == out[rids[1]]
    assert out[rids[0]][:4] == build_prompt(cfg) and len(out[rids[0]]) == 8
