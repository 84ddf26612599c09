"""Port model functions (whisper_tpu_torch/models/whisper.py) against the
JAX model at nano width, fp32, on the same converted weights."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_tpu.config import CONFIGS
from whisper_tpu.models import whisper as jm
from whisper_tpu.tokenizer import build_prompt
from whisper_tpu_torch.models import whisper as tm
from whisper_tpu_torch.ops import attention, encoder_layer
from whisper_tpu_torch.weights import from_jax_params, to_device

torch.set_num_threads(2)


def _jitter(tree, seed):
    """JAX init params plus seeded noise, so biases and LayerNorm
    parameters are non-zero and the tests see them."""
    rng = np.random.RandomState(seed)
    return jax.tree.map(
        lambda x: (np.asarray(x) + 0.02 * rng.randn(*np.shape(x))
                   ).astype(np.float32), tree)


@pytest.fixture(scope="module")
def nano(small_cfg):
    np_tree = _jitter(jm.init_params(small_cfg, jax.random.PRNGKey(0)), 1)
    jparams = jax.tree.map(jnp.asarray, np_tree)
    return small_cfg, jparams, to_device(from_jax_params(np_tree), "cpu")


@pytest.fixture(scope="module")
def prefilled(nano):
    """Encoder output -> cross K/V -> prompt prefill, on both sides."""
    cfg, jparams, tparams = nano
    rng = np.random.RandomState(2)
    B = 2
    enc = rng.randn(B, cfg.n_audio_ctx, cfg.d_model).astype(np.float32)
    prompt = np.tile(build_prompt(cfg), (B, 1))
    P = prompt.shape[1]
    jcross = jm.precompute_cross_kv(jparams, cfg, jnp.asarray(enc))
    jcache = jm.init_kv_cache(cfg, B, s_max=64)
    jlogits, jcache = jm.decoder_forward(jparams, cfg,
                                         jnp.asarray(prompt, jnp.int32),
                                         jnp.int32(0), jcache, jcross)
    tcross = tm.precompute_cross_kv(tparams, cfg, torch.from_numpy(enc))
    tcache = tm.init_kv_cache(cfg, B, torch.float32, 64, "cpu")
    tlogits, tcache = tm.decoder_forward(tparams, cfg,
                                         torch.from_numpy(prompt), 0,
                                         tcache, tcross)
    return dict(cfg=cfg, jparams=jparams, tparams=tparams, P=P,
                jcross=jcross, jcache=jcache, jlogits=jlogits,
                tcross=tcross, tcache=tcache, tlogits=tlogits)


# atol 5e-4 / rtol 1e-4: tests/test_encoder_layer.py:87's bound for two
# fp32 encoders (two conv layers, two blocks over 1500 positions, a final
# LayerNorm) that sum in different orders.
@pytest.mark.parametrize("backend", ["reference", "pallas_interpret"])
def test_encoder_forward_matches_jax(nano, backend):
    cfg, jparams, tparams = nano
    mel = (np.random.RandomState(3).randn(1, cfg.n_mels, cfg.n_frames)
           * 0.5).astype(np.float32)
    want = np.asarray(jm.encoder_forward(
        jparams, cfg.replace(attn_backend=backend), jnp.asarray(mel)))
    got = tm.encoder_forward(tparams, cfg, torch.from_numpy(mel))
    assert got.shape == (1, cfg.n_audio_ctx, cfg.d_model)
    np.testing.assert_allclose(got.numpy(), want, atol=5e-4, rtol=1e-4)


def test_conv_stem_matches_jax(nano):
    cfg, jparams, tparams = nano
    mel = (np.random.RandomState(4).randn(1, cfg.n_mels, cfg.n_frames)
           * 0.5).astype(np.float32)
    want = np.asarray(jm.conv_stem(jparams["encoder"], cfg, jnp.asarray(mel)))
    got = tm.conv_stem(tparams["encoder"], cfg, torch.from_numpy(mel))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


# atol 1e-4 below: single fp32 decoder passes (two layers, logits over a
# 51,865-token vocab) summed in another order than XLA's.
def test_precompute_cross_kv_matches_jax(prefilled):
    for name in ("k", "v"):
        np.testing.assert_allclose(prefilled["tcross"][name].numpy(),
                                   np.asarray(prefilled["jcross"][name]),
                                   atol=1e-4)


def test_prefill_logits_and_cache_match_jax(prefilled):
    np.testing.assert_allclose(prefilled["tlogits"].numpy(),
                               np.asarray(prefilled["jlogits"]), atol=1e-4)
    for name in ("k", "v"):
        np.testing.assert_allclose(prefilled["tcache"][name].numpy(),
                                   np.asarray(prefilled["jcache"][name]),
                                   atol=1e-4)


@pytest.mark.parametrize("backend", [None, "pallas_interpret"])
def test_decoder_step_ip_matches_jax(prefilled, backend):
    """One T==1 step after the prefill: logits and both caches, against
    the JAX step on its plain-DUS path and on its interpret-mode append
    kernel."""
    p = prefilled
    cfg, P = p["cfg"], p["P"]
    last = np.argmax(np.asarray(p["jlogits"])[:, -1:], axis=-1)
    jl, jc = jm.decoder_step_ip(p["jparams"], cfg.replace(attn_backend=backend),
                                jnp.asarray(last, jnp.int32), jnp.int32(P),
                                p["jcache"], p["jcross"])
    tcache = {k: v.clone() for k, v in p["tcache"].items()}
    ptr = tcache["k"].data_ptr()
    tl, tc = tm.decoder_step_ip(p["tparams"], cfg, torch.from_numpy(last), P,
                                tcache, p["tcross"])
    assert tc["k"].data_ptr() == ptr          # appended in place
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    for name in ("k", "v"):
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                   atol=1e-4)
    assert (tl[:, -1].argmax(-1).numpy()
            == np.asarray(jl[:, -1]).argmax(-1)).all()


def test_decoder_step_ip_bf16_argmax_matches_jax(nano, prefilled):
    """bf16 serving mode: same step, bf16 weights by the JAX placement
    rule; the argmax must agree with JAX bf16."""
    from whisper_tpu.weights import to_device as jax_to_device
    p = prefilled
    cfg = p["cfg"].replace(compute_dtype="bfloat16")
    P = p["P"]
    jparams = jax_to_device(p["jparams"], jnp.bfloat16)
    tparams = to_device(p["tparams"], "cpu", torch.bfloat16)
    last = np.argmax(np.asarray(p["jlogits"])[:, -1:], axis=-1)
    jcross = jax.tree.map(lambda x: x.astype(jnp.bfloat16), p["jcross"])
    jcache = jax.tree.map(lambda x: x.astype(jnp.bfloat16), p["jcache"])
    jl, _ = jm.decoder_step_ip(jparams, cfg, jnp.asarray(last, jnp.int32),
                               jnp.int32(P), jcache, jcross)
    tcross = {k: torch.from_numpy(np.array(v.astype(jnp.float32))
                                  ).bfloat16() for k, v in jcross.items()}
    tcache = {k: torch.from_numpy(np.array(v.astype(jnp.float32))
                                  ).bfloat16() for k, v in jcache.items()}
    tl, tc = tm.decoder_step_ip(tparams, cfg, torch.from_numpy(last), P,
                                tcache, tcross)
    assert tl.dtype == torch.float32 and tc["k"].dtype == torch.bfloat16
    # bf16 logits agree to a few bf16 ulps of the O(1) values
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=0.05)
    assert (tl[:, -1].argmax(-1).numpy()
            == np.asarray(jl[:, -1]).argmax(-1)).all()


def test_full_fp32_scopes_tf32_off_and_restores(nano):
    """TF32 is off inside full_fp32() and the caller's settings come back
    after it, also when an entry point runs inside it."""
    cfg, _, tparams = nano
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = (matmul.allow_tf32, cudnn.allow_tf32)
    try:
        matmul.allow_tf32, cudnn.allow_tf32 = True, True
        with tm.full_fp32():
            assert not matmul.allow_tf32 and not cudnn.allow_tf32
        with tm.full_fp32(on=False):
            assert matmul.allow_tf32 and cudnn.allow_tf32
        mel = torch.zeros(1, cfg.n_mels, cfg.n_frames)
        from whisper_tpu_torch.decode import encode
        encode(tparams, cfg, mel)
        assert matmul.allow_tf32 and cudnn.allow_tf32
    finally:
        matmul.allow_tf32, cudnn.allow_tf32 = saved


def test_to_device_fuses_self_attention_qkv_once(nano):
    """to_device replaces each self-attention's q/k/v linears with one
    (L, d, 3d) `qkv` linear in q, k, v column order, and leaves a placed
    tree's fused linear as it is."""
    cfg, jparams, tparams = nano
    for part in ("encoder", "decoder"):
        attn = tparams[part]["layers"]["attn"]
        assert set(attn) == {"qkv", "o"}
        ja = jparams[part]["layers"]["attn"]
        want_w = np.concatenate([np.asarray(ja[n]["w"]) for n in "qkv"], -1)
        want_b = np.concatenate([np.asarray(ja[n]["b"]) for n in "qkv"], -1)
        np.testing.assert_array_equal(attn["qkv"]["w"].numpy(), want_w)
        np.testing.assert_array_equal(attn["qkv"]["b"].numpy(), want_b)
    again = to_device(tparams, "cpu")
    assert torch.equal(again["decoder"]["layers"]["attn"]["qkv"]["w"],
                       tparams["decoder"]["layers"]["attn"]["qkv"]["w"])
    assert "cross_attn" in again["decoder"]["layers"]


# Shared memory of the tail kernel's MLP launches against the 232,448 B
# that one sm_90 block may opt into: the tiles' rings (three 32 KB stages
# and the swizzle atom on the tensor cores, 48 KB in fp32), the same at
# every width.
_TAIL_SMEM = dict.fromkeys(CONFIGS, 99_328)


# the int8 form (encoder_mlp_quant): the tensor-core ring
_TAIL_SMEM_Q8 = {"tiny": 99_328, "base": 99_328, "small": 99_328,
                 "medium": 99_328, "large-v2": 99_328, "large-v3": 99_328,
                 "large-v3-turbo": 99_328}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_encoder_tail_gate_table(name):
    """Every model takes the tail kernel, in either form. The CPU answers
    with the sm_90 limit, as the H100 would."""
    cfg = CONFIGS[name]
    assert encoder_layer.tail_smem_bytes(cfg.d_model, cfg.d_ff) \
        == _TAIL_SMEM[name]
    assert encoder_layer.tail_smem_bytes(cfg.d_model, cfg.d_ff, q8=True) \
        == _TAIL_SMEM_Q8[name.split(".")[0]]
    for q8 in (False, True):
        assert tm._encoder_tail_mode(cfg, torch.device("cpu"), q8) == "tail"


@pytest.mark.parametrize("d", range(64, 1281, 64))
def test_encoder_tail_smem_by_width(d):
    """The MLP launches' shared memory: 128 x 128 tiles that stream both
    operands hold no row whole, so neither d nor ff enters; the larger
    ring is the tensor cores' (three stages of 128 rows and 128 columns by
    128 bytes of k, and the swizzle atom). Every width up to 1,280 fits
    the sm_90 opt-in limit."""
    need = encoder_layer.tail_smem_bytes(d, 4 * d)
    assert need == encoder_layer.tail_smem_bytes(d, 64)
    assert need <= encoder_layer.SM90_SMEM_OPTIN
    assert encoder_layer.tail_fits_smem(d, 4 * d, torch.device("cpu"))
    assert need == 3 * 2 * 128 * 128 + 1024
    assert need > 3 * (128 * 16 + 16 * 128) * 4         # the fp32 ring


@pytest.mark.parametrize("d", [1344, 1536, 2048])
def test_encoder_tail_gate_refuses_past_the_widest_row(d):
    """Past d = 1,280 (LN2 holds a row in registers) the gate answers
    'off' in both forms, whatever the shared memory."""
    for q8 in (False, True):
        assert not encoder_layer.tail_fits_smem(d, 4 * d,
                                                torch.device("cpu"), q8)


# JAX's gate on its chip (jax.default_backend() == "tpu"), full-size
# window: WHISPER_TPU_FUSED_ENCODER "0" turns the tail off, "1" on at
# any size, unset leaves the size and VMEM gates (tail_fits_vmem), which
# take every width in bf16 and the int8 forms but not d = 1,280 in fp32
# (the port runs it: its tiles hold no row whole, so no width is
# refused).
@pytest.mark.parametrize("env", [None, "0", "1"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mlp_q", [False, True])
def test_encoder_tail_switch_matches_jax(env, dtype, mlp_q, monkeypatch):
    if env is None:
        monkeypatch.delenv("WHISPER_TPU_FUSED_ENCODER", raising=False)
    else:
        monkeypatch.setenv("WHISPER_TPU_FUSED_ENCODER", env)
    monkeypatch.delenv("WHISPER_TPU_ATTN", raising=False)
    monkeypatch.delenv("WHISPER_TPU_ENC_I8O", raising=False)
    monkeypatch.setattr(jm.jax, "default_backend", lambda: "tpu")
    for name in ("tiny", "base", "small", "medium", "large-v2",
                 "large-v3-turbo"):
        cfg = CONFIGS[name].replace(compute_dtype=dtype)
        want = jm._encoder_tail_mode(cfg, 1, cfg.n_audio_ctx, mlp_q)
        got = tm._encoder_tail_mode(cfg, torch.device("cpu"), mlp_q)
        divergence = (env is None and dtype == "float32" and not mlp_q
                      and cfg.d_model == 1280)
        assert want == ("off" if divergence or env == "0" else "pallas")
        assert got == ("off" if env == "0" else "tail")
    for backend in ("reference", "pallas"):
        cfg = CONFIGS["tiny"].replace(attn_backend=backend)
        assert (tm._encoder_tail_mode(cfg, torch.device("cpu"), mlp_q)
                == "off") == (backend == "reference" or env == "0")


@pytest.mark.parametrize("backend", ["reference", "pallas_interpret"])
def test_encoder_tail_off_matches_jax(nano, backend, monkeypatch):
    """The tail-off branch (attention through the flash route, the
    o-projection, LN2, the MLP), reached at nano width through the JAX
    package's own WHISPER_TPU_FUSED_ENCODER=0 switch, which both sides
    read, against the JAX tail-off encoder: with its plain attention, and
    with its flash kernel in interpret mode. Tolerance as
    test_encoder_forward_matches_jax."""
    cfg, jparams, tparams = nano
    monkeypatch.setenv("WHISPER_TPU_FUSED_ENCODER", "0")
    assert tm._encoder_tail_mode(cfg, torch.device("cpu")) == "off"
    calls = []
    real_flash = attention.flash_attention

    def counting_flash(*args, **kw):
        calls.append(1)
        return real_flash(*args, **kw)

    monkeypatch.setattr(attention, "flash_attention", counting_flash)
    mel = (np.random.RandomState(3).randn(1, cfg.n_mels, cfg.n_frames)
           * 0.5).astype(np.float32)
    want = np.asarray(jm.encoder_forward(
        jparams, cfg.replace(attn_backend=backend), jnp.asarray(mel)))
    got = tm.encoder_forward(tparams, cfg, torch.from_numpy(mel))
    assert len(calls) == cfg.n_audio_layers      # 18 MB of scores: flash
    np.testing.assert_allclose(got.numpy(), want, atol=5e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# decoder_step_ragged: the continuous engine's step, every row at its own
# position
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", [None, "pallas_interpret"])
@pytest.mark.parametrize("pos", [(4, 17), (0, 63), (9, 9)])
def test_decoder_step_ragged_matches_jax(prefilled, backend, pos):
    """One T==1 step with a per-row position, after the prefill: logits
    within fp32 tolerance (atol 1e-4, as the ip step) and the updated
    caches: the new rows to the same tolerance, every other row bit for
    bit, written in place. Against the JAX step's plain scatter and its
    interpret-mode ragged append kernel."""
    p = prefilled
    cfg = p["cfg"]
    last = np.argmax(np.asarray(p["jlogits"])[:, -1:], axis=-1)
    pos_np = np.asarray(pos, np.int32)
    jl, jc = jm.decoder_step_ragged(
        p["jparams"], cfg.replace(attn_backend=backend),
        jnp.asarray(last, jnp.int32), jnp.asarray(pos_np), p["jcache"],
        p["jcross"])
    tcache = {k: v.clone() for k, v in p["tcache"].items()}
    before = {k: v.clone() for k, v in tcache.items()}
    ptr = tcache["k"].data_ptr()
    tl, tc = tm.decoder_step_ragged(p["tparams"], cfg, torch.from_numpy(last),
                                    torch.from_numpy(pos_np).long(), tcache,
                                    p["tcross"])
    assert tc["k"].data_ptr() == ptr
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    assert (tl[:, -1].argmax(-1).numpy()
            == np.asarray(jl[:, -1]).argmax(-1)).all()
    S = tc["k"].shape[3]
    for name in ("k", "v"):
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                   atol=1e-4)
        for b, pb in enumerate(pos):
            keep = torch.arange(S) != pb
            assert torch.equal(tc[name][:, b][:, :, keep],
                               before[name][:, b][:, :, keep])


def test_decoder_step_ragged_equal_positions_is_the_ip_step(prefilled):
    """With every row at the same position the ragged step is the scalar
    step: the same caches bit for bit, and logits to 1e-5 (the ragged
    step's cross-attention goes through mha_reference, the scalar step's
    through its own einsum, as in JAX)."""
    p = prefilled
    cfg, P = p["cfg"], p["P"]
    last = torch.from_numpy(np.argmax(np.asarray(p["jlogits"])[:, -1:], -1))
    ca = {k: v.clone() for k, v in p["tcache"].items()}
    cb = {k: v.clone() for k, v in p["tcache"].items()}
    la, _ = tm.decoder_step_ip(p["tparams"], cfg, last, P, ca, p["tcross"])
    lb, _ = tm.decoder_step_ragged(p["tparams"], cfg, last,
                                   torch.full((2,), P), cb, p["tcross"])
    torch.testing.assert_close(lb, la, atol=1e-5, rtol=0)
    for name in ("k", "v"):
        assert torch.equal(ca[name], cb[name])


def test_decoder_step_ragged_refuses_int8_caches(prefilled):
    """int8 caches (refused before the engine's int8 path was ported): the
    prefilled fp32 caches quantized per vector, one capacity-mode ragged
    step (kv_cache_quant: the quantizing per-row scatter, then the
    dequantized read) against JAX's on the same int8 caches. Logits
    within fp32 tolerance (atol 1e-4, as the unquantized ragged step)."""
    p = prefilled
    cfg = p["cfg"].replace(kv_cache_quant=True)
    last = np.argmax(np.asarray(p["jlogits"])[:, -1:], axis=-1)
    pos = np.asarray((4, 17))
    tcache, jcache = {}, {}
    for name in ("k", "v"):
        q, sc = tm.quantize_kv(p["tcache"][name])
        tcache[name], tcache[name + "_s"] = q, sc
        jcache[name], jcache[name + "_s"] = (jnp.asarray(q.numpy()),
                                             jnp.asarray(sc.numpy()))
    jl, jc = jm.decoder_step_ragged(
        p["jparams"], cfg, jnp.asarray(last, jnp.int32),
        jnp.asarray(pos, jnp.int32), jcache, p["jcross"])
    tl, tc = tm.decoder_step_ragged(p["tparams"], cfg, torch.from_numpy(last),
                                    torch.from_numpy(pos), tcache,
                                    p["tcross"])
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    assert set(tc) == set(jc) == {"k", "k_s", "v", "v_s"}
