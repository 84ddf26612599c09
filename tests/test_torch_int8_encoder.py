"""The encoder's int8 paths in the port (whisper_tpu_torch/models/whisper.py
linear_i8dyn, qkv_fused_i8dyn, encoder_forward's encoder_quant,
encoder_mlp_quant and encoder_qkv_quant branches; ops/encoder_layer.py
encoder_block_tail_q8 and its plain version) against the JAX package on
the CPU, with inputs from a numpy seed. The JAX fused tail runs in
interpret mode (attn_backend "pallas_interpret"), as
tests/test_encoder_quant.py runs it; the port's tail runs its plain
version on the CPU. The CUDA kernel is held to its plain version on the
card (tests/test_torch_kernels_cuda.py, chip_smoke.py tail_int8_checks)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_tpu.models import whisper as jm
from whisper_tpu.ops.encoder_layer import encoder_block_tail as jax_tail
from whisper_tpu.ops.encoder_layer import pack_tail_misc, pad_tail_weights
from whisper_tpu.weights import to_device as jax_to_device
from whisper_tpu_torch.models import whisper as tm
from whisper_tpu_torch.ops import encoder_layer
from whisper_tpu_torch.ops.encoder_layer import (
    encoder_block_tail_q8,
    encoder_block_tail_q8_plain,
    int8_matmul,
)
from whisper_tpu_torch.weights import from_jax_params, to_device

torch.set_num_threads(2)


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.array(jnp.asarray(x).astype(jnp.float32))


def _bf16_ulps(got, want) -> np.ndarray:
    """|got - want| in bf16 ulps of want (8 significant bits)."""
    got, want = _f32(got), _f32(want)
    exp = np.floor(np.log2(np.maximum(np.abs(want), 1e-30)))
    return np.abs(got - want) / 2.0 ** (exp - 7)


# ---------------------------------------------------------------------------
# linear_i8dyn and qkv_fused_i8dyn
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("K", [96, 1280])
@pytest.mark.parametrize("bias", ["bfloat16", "float32"])
@pytest.mark.parametrize("prequant", [False, True])
def test_linear_i8dyn_matches_jax(K, bias, prequant):
    """The row quantization and the int32 accumulator bit for bit (K 1,280
    is turbo's fc1 depth: K x 127^2 passes 2^24, where an fp32 product of
    int8 values would round); the output equal to JAX's, its dtype by
    JAX's promotion (a bf16 bias gives bf16, an fp32 one fp32). Weights
    quantized inside the call, or given as {"w", "w_s"}."""
    rng = np.random.RandomState(K)
    x = rng.randn(2, 19, K).astype(np.float32)
    x[0, 3] = 0.0                                     # the 1e-10 floor
    w = (rng.randn(K, 48) * 0.05).astype(np.float32)
    b = (rng.randn(48) * 0.1).astype(np.float32)
    jx, jw = jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    jb = jnp.asarray(b, jnp.dtype(bias))
    tx = torch.from_numpy(_f32(jx)).bfloat16()
    tw = torch.from_numpy(_f32(jw)).bfloat16()
    tb = torch.from_numpy(_f32(jb)).to(getattr(torch, bias))
    jp, tp = {"w": jw, "b": jb}, {"w": tw, "b": tb}
    if prequant:
        q, s = jm._quant_cols(jw)
        jp = {"w": q, "w_s": s, "b": jb}
        tp = {"w": torch.from_numpy(np.array(q)),
              "w_s": torch.from_numpy(np.array(s)), "b": tb}

    jxq, jsx = jm._rowquant_dyn(jx)
    txq, tsx = encoder_layer.rowquant(tx.float())
    np.testing.assert_array_equal(txq.numpy(), np.asarray(jxq))
    np.testing.assert_array_equal(tsx.numpy(), np.asarray(jsx))
    jwq, _ = jm._quant_cols(jw)
    jacc = jax.lax.dot_general(jxq, jwq, (((2,), (0,)), ((), ())),
                               preferred_element_type=jnp.int32)
    tacc = int8_matmul(txq, torch.from_numpy(np.array(jwq)))
    assert tacc.dtype == torch.int32
    np.testing.assert_array_equal(tacc.numpy(), np.asarray(jacc))

    want = jm.linear_i8dyn(jx, jp, jnp.bfloat16)
    got = tm.linear_i8dyn(tx, tp, torch.bfloat16)
    assert str(got.dtype).split(".")[1] == str(want.dtype)
    assert _bf16_ulps(got, want).max() <= 1.0


def test_qkv_fused_i8dyn_matches_jax():
    """One linear_i8dyn over the port's fused qkv linear gives JAX's three
    per-part quantizations side by side: q, k, v within one bf16 ulp."""
    rng = np.random.RandomState(5)
    d, H = 128, 2
    y = jnp.asarray(rng.randn(2, 23, d), jnp.bfloat16)
    attn = {n: {"w": jnp.asarray(rng.randn(d, d) * 0.05, jnp.bfloat16),
                "b": jnp.asarray(rng.randn(d) * 0.1, jnp.bfloat16)}
            for n in "qkv"}
    want = jm.qkv_fused_i8dyn(y, attn, H, jnp.bfloat16)
    fused = {"qkv": {n: torch.from_numpy(np.concatenate(
        [_f32(attn[p][n]) for p in "qkv"], axis=-1)).bfloat16()
        for n in ("w", "b")}}
    got = tm.qkv_fused_i8dyn(torch.from_numpy(_f32(y)).bfloat16(), fused, H,
                             torch.bfloat16)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        assert _bf16_ulps(g, w).max() <= 1.0


# ---------------------------------------------------------------------------
# the tail's int8 form
# ---------------------------------------------------------------------------

def _tail_inputs(seed, B, T, H, D, ff):
    rng = np.random.RandomState(seed)
    d = H * D
    f = lambda *s, scale=1.0, shift=0.0: (  # noqa: E731
        rng.randn(*s) * scale + shift).astype(np.float32)
    return {"q": f(B, T, H, D), "k": f(B, H, T, D), "v": f(B, H, T, D),
            "h": f(B, T, d), "wo": f(d, d, scale=0.1), "o_b": f(d, scale=0.1),
            "fc1_w": f(d, ff, scale=0.1), "fc1_b": f(ff, scale=0.1),
            "fc2_w": f(ff, d, scale=0.1), "fc2_b": f(d, scale=0.1),
            "ln_g": f(d, scale=0.2, shift=1.0), "ln_b": f(d, scale=0.1)}


def _jax_tail_q8(x, H, o_q):
    """The JAX kernel's int8 form in interpret mode, its operands prepared
    as encoder_forward prepares them (:511-562): per-column int8 fc1/fc2,
    and the PADDED wo quantized under o_q."""
    bf = jnp.bfloat16
    j = {k: jnp.asarray(v, bf) for k, v in x.items()}
    f1q, f1s = jm._quant_cols(j["fc1_w"])
    f2q, f2s = jm._quant_cols(j["fc2_w"])
    wo = pad_tail_weights(j["wo"], H, bf)
    wo_s = None
    if o_q:
        wo, wo_s = jm._quant_cols(wo)
    lp = {"attn": {"o": {"b": j["o_b"]}}, "fc1": {"b": j["fc1_b"]},
          "fc2": {"b": j["fc2_b"]}, "mlp_ln": {"g": j["ln_g"], "b": j["ln_b"]}}
    out = jax_tail(j["q"], j["k"], j["v"], j["h"], wo, f1q, f2q,
                   pack_tail_misc(lp, f1s, f2s, wo_s), interpret=True)
    return _f32(out)


def _torch_tail_q8(x, o_q):
    """The port's operands: the UNPADDED wo, every matrix K-major."""
    t = {k: torch.from_numpy(v).bfloat16() for k, v in x.items()}
    f1q, f1s = tm._quant_cols(t["fc1_w"])
    f2q, f2s = tm._quant_cols(t["fc2_w"])
    if o_q:
        woq, wo_s = tm._quant_cols(t["wo"])
        wo_t = woq.t().contiguous()
    else:
        wo_t, wo_s = t["wo"].t().contiguous(), None
    return (t["q"], t["k"], t["v"], t["h"], wo_t, f1q.t().contiguous(),
            f2q.t().contiguous(), t["o_b"], t["fc1_b"], t["fc2_b"],
            t["ln_g"], t["ln_b"], f1s, f2s, wo_s)


def test_unpadded_wo_quantizes_as_jax_pads_it():
    """JAX quantizes the o-projection with each head's rows padded to 128
    lanes (zero rows); the zero rows change no column's maximum, so the
    port's unpadded quantization gives the same int8 rows and scales."""
    x = _tail_inputs(3, 1, 8, 2, 32, 128)
    wo = jnp.asarray(x["wo"], jnp.bfloat16)
    jq, js = jm._quant_cols(pad_tail_weights(wo, 2, jnp.bfloat16))
    tq, ts = tm._quant_cols(torch.from_numpy(x["wo"]).bfloat16())
    live = np.asarray(jq).reshape(2, 128, -1)[:, :32].reshape(64, -1)
    np.testing.assert_array_equal(tq.numpy(), live)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert not np.asarray(jq).reshape(2, 128, -1)[:, 32:].any()


# atol 0.06 (rtol 2e-2): the bf16 tail test's bound (two bf16 ulps of the
# O(4) outputs, tests/test_torch_encoder_layer.py), kept for the int8 form:
# where the two attentions round a sum to neighbouring bf16 values, a
# row's quantization may move one value by one int8 step, which moves the
# row's products by a weight times the row scale, well inside it. Measured
# here: at most 0.0234 (one ulp).
@pytest.mark.parametrize("o_q", [True, False])
@pytest.mark.parametrize("T", [40, 50])
def test_plain_q8_tail_matches_jax_kernel(o_q, T):
    """The plain int8 form against the JAX kernel's (mlp_q, and o_q or the
    WHISPER_TPU_ENC_I8O=0 bf16 o-projection) in interpret mode; T = 50 is
    no multiple of the JAX kernel's 16-row q-block."""
    x = _tail_inputs(T, 2, T, 2, 32, 256)
    want = _jax_tail_q8(x, 2, o_q)
    out = encoder_block_tail_q8_plain(*_torch_tail_q8(x, o_q))
    assert out.dtype == torch.bfloat16 and out.shape == (2, T, 64)
    np.testing.assert_allclose(out.float().numpy(), want, atol=0.06,
                               rtol=2e-2)


def _wide_inputs(seed, T, H):
    """_tail_inputs at a Whisper width (B = 1, d = 64 H, ff = 4 d) with the
    matrices at its scale per fan-in (0.8 / sqrt(fan-in), 0.1 at 64): the
    outputs stay O(4), as at nano width, where the tolerance is one
    bf16 ulp."""
    d, ff = 64 * H, 256 * H
    x = _tail_inputs(seed, 1, T, H, 64, ff)
    rng = np.random.RandomState(seed + 1)
    for name, fan_in, shape in (("wo", d, (d, d)), ("fc1_w", d, (d, ff)),
                                ("fc2_w", ff, (ff, d))):
        x[name] = (rng.randn(*shape) * 0.8 / np.sqrt(fan_in)).astype(
            np.float32)
    return x


# small, medium and large (d = 768, 1024, 1280), the widths the serving
# policy runs the int8 form at; T = 50 is no multiple of the JAX kernel's
# 16-row q-block. Tolerance as above; measured here: at most 0.03125.
@pytest.mark.parametrize("H", [12, 16, 20])
@pytest.mark.parametrize("T", [24, 50])
@pytest.mark.parametrize("o_q", [True, False])
def test_plain_q8_tail_matches_jax_kernel_at_whisper_widths(H, T, o_q):
    x = _wide_inputs(H + T, T, H)
    want = _jax_tail_q8(x, H, o_q)
    out = encoder_block_tail_q8_plain(*_torch_tail_q8(x, o_q))
    assert out.dtype == torch.bfloat16 and out.shape == (1, T, 64 * H)
    np.testing.assert_allclose(out.float().numpy(), want, atol=0.06,
                               rtol=2e-2)


def test_q8_wrapper_runs_plain_on_cpu_and_counts_no_launch():
    args = _torch_tail_q8(_tail_inputs(7, 1, 16, 2, 32, 128), True)
    before = encoder_block_tail_q8.launches
    got = encoder_block_tail_q8(*args)
    assert encoder_block_tail_q8.launches == before
    assert torch.equal(got, encoder_block_tail_q8_plain(*args))
    with pytest.raises(ValueError, match="no kernel for device"):
        encoder_block_tail_q8(*(None if a is None else a.to("meta")
                                for a in args))


def _kernel_args(B=1, T=24, H=6, ff=1536, o_q=True):
    x = _tail_inputs(1, B, T, H, 64, ff)
    return list(_torch_tail_q8(x, o_q))


def test_q8_kernel_checks_accept_supported_shapes():
    for H, ff, o_q in ((6, 1536, True), (8, 2048, False), (12, 3072, True),
                       (16, 4096, False), (20, 5120, True)):
        args = _kernel_args(H=H, ff=ff, o_q=o_q)
        encoder_layer._check_q8(*args[:7], tuple(args[7:12]),
                                tuple(args[12:]))


@pytest.mark.parametrize("bad,match", [
    ("fp32", "bf16 only"), ("fc1_bf16", "fc1_t"), ("wo_int8_no_scale",
                                                   "wo_t"),
    ("head_dim", "head_dim 64"), ("wide", "up to 1280"),
    ("ff", "multiple of 64"), ("strided", "not contiguous"),
    ("scale_shape", "fc2_s")])
def test_q8_kernel_checks_reject(bad, match):
    args = _kernel_args()
    if bad == "fp32":
        args[:4] = [a.float() for a in args[:4]]
    elif bad == "fc1_bf16":
        args[5] = args[5].bfloat16()
    elif bad == "wo_int8_no_scale":
        args[14] = None
    elif bad == "head_dim":
        x = _tail_inputs(1, 1, 24, 12, 32, 1536)
        args = list(_torch_tail_q8(x, True))
    elif bad == "wide":
        args = _kernel_args(H=21, ff=5376)      # d = 1,344
    elif bad == "ff":
        args = _kernel_args(ff=1540)
    elif bad == "strided":
        args[3] = args[3].transpose(1, 2).contiguous().transpose(1, 2)
    elif bad == "scale_shape":
        args[13] = args[13][:-1]
    with pytest.raises((ValueError, TypeError), match=match):
        encoder_layer._check_q8(*args[:7], tuple(args[7:12]),
                                tuple(args[12:]))


@pytest.mark.parametrize("d", range(64, 1281, 64))
def test_q8_tail_smem_by_width(d):
    """The int8 form's tiles stream both operands: their ring (three
    stages of 128 rows and 128 columns by 128 bytes of k, and the swizzle
    atom) holds no row whole, so neither d nor ff enters, and every width
    up to 1,280 fits the sm_90 opt-in limit."""
    need = encoder_layer.tail_smem_bytes(d, 4 * d, q8=True)
    assert need == 3 * 2 * 128 * 128 + 1024
    assert need == encoder_layer.tail_smem_bytes(d, 64, q8=True)
    assert encoder_layer.tail_fits_smem(d, 4 * d, torch.device("cpu"),
                                        q8=True)


# ---------------------------------------------------------------------------
# encoder_forward's int8 paths
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def enc16(small_cfg):
    """A bf16 nano encoder on both sides (3 s window: 150 positions), the
    JAX init plus seeded noise, the weights cast as both pipelines cast
    them, and one mel."""
    cfg = small_cfg.replace(name="i8-enc-nano", chunk_length_s=3,
                            n_audio_ctx=150, compute_dtype="bfloat16")
    rng = np.random.RandomState(1)
    tree = jax.tree.map(lambda a: (np.asarray(a) + 0.02 * rng.randn(
        *np.shape(a))).astype(np.float32),
        jm.init_params(cfg, jax.random.PRNGKey(0)))
    jp = jax_to_device(jax.tree.map(jnp.asarray, tree), jnp.bfloat16)
    tp = to_device(from_jax_params(tree), "cpu", torch.bfloat16)
    mel = (np.random.RandomState(9).randn(2, cfg.n_mels, cfg.n_frames)
           * 0.5).astype(np.float32)
    return cfg, jp, tp, mel


def _encode_both(enc16, jax_backend=None, **flags):
    cfg, jp, tp, mel = enc16
    c = cfg.replace(**flags)
    want = _f32(jm.encoder_forward(jp, c.replace(attn_backend=jax_backend),
                                   jnp.asarray(mel, jnp.bfloat16)))
    got = tm.encoder_forward(tp, c, torch.from_numpy(mel))
    return got, want


# Tolerance against JAX, bf16: 3% of the largest output (the JAX package
# bounds its int8 encoders against its bf16 one at 5%). The port rounds
# every op in bf16 where XLA keeps fused sums in fp32: the unquantized bf16
# encoder already differs from JAX's by 0.82% of its largest output here,
# and the int8 paths quantize rows those roundings touch. Measured here:
# at most 1.09%.
_ENC_REL = 0.03


def _rel(got, want) -> float:
    return float(np.abs(_f32(got) - want).max() / np.abs(want).max())


def test_encoder_quant_matches_jax(enc16):
    """encoder_quant: the four projections through linear_i8dyn, the tail
    bypassed (the port takes no tail launch), against JAX's."""
    got, want = _encode_both(enc16, encoder_quant=True)
    assert got.dtype == torch.bfloat16
    assert _rel(got, want) < _ENC_REL
    plain, _ = _encode_both(enc16)
    assert not torch.equal(got, plain)


@pytest.mark.parametrize("i8o,qkv", [("1", False), ("0", False),
                                     ("1", True)])
def test_encoder_mlp_quant_matches_jax(enc16, i8o, qkv, monkeypatch):
    """encoder_mlp_quant through the tail's int8 form, with the int8
    o-projection (WHISPER_TPU_ENC_I8O's default) or without it, and with
    encoder_qkv_quant's int8 QKV in front: against the JAX tail in
    interpret mode with the same flags. Each changes the output."""
    monkeypatch.setenv("WHISPER_TPU_ENC_I8O", i8o)
    calls = []
    real = encoder_layer.encoder_block_tail_q8_plain

    def counting(*args, **kw):
        calls.append(args[14] is not None)
        return real(*args, **kw)

    monkeypatch.setattr(encoder_layer, "encoder_block_tail_q8_plain",
                        counting)
    got, want = _encode_both(enc16, "pallas_interpret",
                             encoder_mlp_quant=True, encoder_qkv_quant=qkv)
    cfg = enc16[0]
    assert calls == [i8o == "1"] * cfg.n_audio_layers
    assert _rel(got, want) < _ENC_REL
    plain, _ = _encode_both(enc16, "pallas_interpret")
    assert not torch.equal(got, plain)


def test_encoder_forward_small_width_runs_the_int8_tail_as_jax(monkeypatch):
    """Small's width (d 768, 12 heads, ff 3,072), one encoder layer, a 1 s
    window (50 positions), bf16 under the serving policy's encoder flags
    (apply_serving_quant: encoder_mlp_quant from d = 768): the port runs
    the tail's int8 form (its plain version on the CPU, once, with the int8
    o-projection) and matches JAX's encoder_forward with its tail in
    interpret mode, within _ENC_REL."""
    from whisper_tpu.config import get_config
    from whisper_tpu_torch.config import apply_serving_quant
    monkeypatch.delenv("WHISPER_TPU_ENC_I8O", raising=False)
    monkeypatch.delenv("WHISPER_TPU_FUSED_ENCODER", raising=False)
    base = get_config("small").replace(
        name="i8-small-1l", n_audio_layers=1, n_text_layers=1,
        chunk_length_s=1, n_audio_ctx=50, compute_dtype="bfloat16")
    flags = apply_serving_quant(base, batch=32)
    assert flags.encoder_mlp_quant and not flags.encoder_qkv_quant
    cfg = base.replace(encoder_mlp_quant=True)
    rng = np.random.RandomState(4)
    tree = jax.tree.map(lambda a: (np.asarray(a) + 0.02 * rng.randn(
        *np.shape(a))).astype(np.float32),
        jm.init_params(cfg, jax.random.PRNGKey(1)))
    jp = jax_to_device(jax.tree.map(jnp.asarray, tree), jnp.bfloat16)
    tp = to_device(from_jax_params(tree), "cpu", torch.bfloat16)
    mel = (np.random.RandomState(5).randn(1, cfg.n_mels, cfg.n_frames)
           * 0.5).astype(np.float32)
    calls = []
    real = encoder_layer.encoder_block_tail_q8_plain

    def counting(*args, **kw):
        calls.append(args[14] is not None)
        return real(*args, **kw)

    monkeypatch.setattr(encoder_layer, "encoder_block_tail_q8_plain",
                        counting)
    assert tm._encoder_tail_mode(cfg, torch.device("cpu"), True) == "tail"
    got = tm.encoder_forward(tp, cfg, torch.from_numpy(mel))
    want = _f32(jm.encoder_forward(
        jp, cfg.replace(attn_backend="pallas_interpret"),
        jnp.asarray(mel, jnp.bfloat16)))
    assert calls == [True]
    assert got.shape == (1, 50, 768)
    assert _rel(got, want) < _ENC_REL


@pytest.mark.parametrize("name,flag", [("WHISPER_TPU_ENC_I8", "encoder_quant"),
                                       ("WHISPER_TPU_ENC_I8K",
                                        "encoder_mlp_quant"),
                                       ("WHISPER_TPU_ENC_I8Q",
                                        "encoder_qkv_quant")])
def test_encoder_int8_env_overrides(name, flag, monkeypatch):
    """Each flag's environment variable overrides it as JAX reads it: "1"
    on, any other value off, unset the config's field."""
    getter = {"encoder_quant": tm._encoder_i8,
              "encoder_mlp_quant": tm._encoder_i8k,
              "encoder_qkv_quant": tm._encoder_i8q}[flag]
    jgetter = {"encoder_quant": jm._encoder_i8,
               "encoder_mlp_quant": jm._encoder_i8k,
               "encoder_qkv_quant": jm._encoder_i8q}[flag]
    from whisper_tpu_torch.config import get_config
    for env in (None, "1", "0", "yes"):
        if env is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, env)
        for on in (False, True):
            cfg = get_config("tiny").replace(**{flag: on})
            assert getter(cfg) == jgetter(cfg)


def test_encoder_quant_bypasses_the_tail(enc16, monkeypatch):
    """encoder_quant runs no tail, in either form (JAX :506)."""
    def boom(*args, **kw):
        raise AssertionError("the tail ran under encoder_quant")

    monkeypatch.setattr(tm, "encoder_block_tail", boom)
    monkeypatch.setattr(tm, "encoder_block_tail_q8", boom)
    cfg, _, tp, mel = enc16
    tm.encoder_forward(tp, cfg.replace(encoder_quant=True,
                                       encoder_mlp_quant=True),
                       torch.from_numpy(mel))
