"""Port model functions (whisper_tpu_torch/models/whisper.py) against the
JAX model at nano width, fp32, on the same converted weights."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_tpu.models import whisper as jm
from whisper_tpu.tokenizer import build_prompt
from whisper_tpu_torch.models import whisper as tm
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
