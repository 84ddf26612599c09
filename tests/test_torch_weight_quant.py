"""Weight-only int8 in the port (whisper_tpu_torch/models/whisper.py
_quant_cols, quantize_weights_wq, the int8 branches of linear, tok_embed
and final_logits; weights.from_jax_params/to_device on int8 trees)
against the JAX package on the CPU: the intent of
tests/test_weight_quant.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_tpu.models import whisper as jm
from whisper_tpu.tokenizer import build_prompt
from whisper_tpu.weights import to_device as jax_to_device
from whisper_tpu_torch.models import whisper as tm
from whisper_tpu_torch.weights import from_jax_params, to_device

torch.set_num_threads(2)


def _jitter(tree, seed):
    """JAX init params plus seeded noise: non-zero biases and LayerNorms."""
    rng = np.random.RandomState(seed)
    return jax.tree.map(
        lambda x: (np.asarray(x) + 0.02 * rng.randn(*np.shape(x))
                   ).astype(np.float32), tree)


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32)
                      if jnp.asarray(x).dtype == jnp.bfloat16 else x)


@pytest.fixture(scope="module")
def wq(small_cfg):
    """One nano tree, quantized by each package after the bf16 cast (the
    JAX pipeline's order): (cfg, JAX bf16 tree, JAX int8 tree, the port's
    bf16 tree, the port's int8 tree)."""
    cfg = small_cfg.replace(compute_dtype="bfloat16", weight_quant=True)
    np_tree = _jitter(jm.init_params(cfg, jax.random.PRNGKey(0)), 1)
    j16 = jax_to_device(jax.tree.map(jnp.asarray, np_tree), jnp.bfloat16)
    jq = jm.quantize_weights_wq(j16, cfg)
    t16 = to_device(from_jax_params(np_tree), "cpu", torch.bfloat16)
    return cfg, j16, jq, t16, tm.quantize_weights_wq(t16, cfg)


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
@pytest.mark.parametrize("shape", [(64, 96), (3, 128, 40)])
def test_quant_cols_bit_equal_to_jax(dtype, shape):
    """int8 values bit for bit and scales equal, over fp32 and bf16
    weights, with and without a leading layer axis; a zero column takes
    the 1e-10 floor."""
    w = np.random.RandomState(len(shape)).randn(*shape).astype(np.float32)
    w[..., 3] = 0.0
    jw = jnp.asarray(w, jnp.dtype(dtype))
    tw = torch.from_numpy(_np(jw).copy()).to(
        torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    jq, js = jm._quant_cols(jw)
    tq, ts = tm._quant_cols(tw)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert float(ts[..., 3].max()) == np.float32(1e-10)


def test_quantize_weights_bit_equal_to_jax(wq):
    """Every quantized leaf equals JAX's: the fused qkv is q, k and v
    quantized one by one, its scales the three vectors concatenated."""
    _, _, jq, _, tq = wq
    jl, tl = jq["decoder"]["layers"], tq["decoder"]["layers"]
    qkv = tl["attn"]["qkv"]
    np.testing.assert_array_equal(
        qkv["w"].numpy(),
        np.concatenate([np.asarray(jl["attn"][n]["w"]) for n in "qkv"], -1))
    np.testing.assert_array_equal(
        qkv["w_s"].numpy(),
        np.concatenate([np.asarray(jl["attn"][n]["w_s"]) for n in "qkv"], -1))
    pairs = [(tl["attn"]["o"], jl["attn"]["o"]),
             (tl["cross_attn"]["q"], jl["cross_attn"]["q"]),
             (tl["cross_attn"]["o"], jl["cross_attn"]["o"]),
             (tl["fc1"], jl["fc1"]), (tl["fc2"], jl["fc2"])]
    for t, j in pairs:
        assert t["w"].dtype == torch.int8 and t["w_s"].dtype == torch.float32
        np.testing.assert_array_equal(t["w"].numpy(), np.asarray(j["w"]))
        np.testing.assert_array_equal(t["w_s"].numpy(), np.asarray(j["w_s"]))
    for n in ("k", "v"):       # read once per transcription: not quantized
        assert "w_s" not in tl["cross_attn"][n]
        assert tl["cross_attn"][n]["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(tq["decoder"]["tok_emb"].numpy(),
                                  np.asarray(jq["decoder"]["tok_emb"]))
    np.testing.assert_array_equal(tq["decoder"]["tok_emb_s"].numpy(),
                                  np.asarray(jq["decoder"]["tok_emb_s"]))
    assert "w_s" not in tq["encoder"]["layers"]["fc1"]


def test_fused_qkv_quantizes_as_its_parts(wq):
    """Quantizing before the fusion (q, k, v apart) and after it (the
    fused linear) gives the same int8 values and scales."""
    cfg, _, _, t16, tq = wq
    apart = {part: dict(sub) for part, sub in t16.items()}
    layers = dict(apart["decoder"]["layers"])
    w = layers["attn"]["qkv"]["w"]
    b = layers["attn"]["qkv"]["b"]
    d = w.shape[1]
    layers["attn"] = {n: {"w": w[..., i * d:(i + 1) * d],
                          "b": b[..., i * d:(i + 1) * d]}
                      for i, n in enumerate("qkv")} | {
        "o": layers["attn"]["o"]}
    apart["decoder"]["layers"] = layers
    qa = tm.quantize_weights_wq(apart, cfg)["decoder"]["layers"]["attn"]
    fused = tq["decoder"]["layers"]["attn"]["qkv"]
    for key in ("w", "w_s"):
        assert torch.equal(fused[key],
                           torch.cat([qa[n][key] for n in "qkv"], dim=-1))


def test_quantize_weights_refuses_fp32(small_cfg):
    params = to_device(from_jax_params(jax.tree.map(
        np.asarray, jm.init_params(small_cfg, jax.random.PRNGKey(0)))), "cpu")
    with pytest.raises(ValueError, match="serving-mode"):
        tm.quantize_weights_wq(params, small_cfg)


def test_quantize_weights_keeps_an_int8_tree(wq):
    cfg, _, _, _, tq = wq
    again = tm.quantize_weights_wq(tq, cfg)
    assert again["decoder"]["tok_emb"] is tq["decoder"]["tok_emb"]
    assert again["decoder"]["layers"]["fc1"] is tq["decoder"]["layers"]["fc1"]


def test_int8_linear_is_the_dequantized_linear(wq):
    """linear, tok_embed and final_logits on the int8 tree are bit for bit
    the same functions on JAX's dequantize_weights_wq tree (the numerics
    oracle of tests/test_weight_quant.py)."""
    cfg, _, jq, _, tq = wq
    deq = jax.tree.map(np.asarray, jm.dequantize_weights_wq(jq, jnp.bfloat16))
    deq_t = to_device(from_jax_params(jax.tree.map(_np, deq)), "cpu",
                      torch.bfloat16)
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(2, 3, cfg.d_model).astype(np.float32)
                         ).bfloat16()
    lq = tm.layer_index(tq["decoder"]["layers"], 1)
    ld = tm.layer_index(deq_t["decoder"]["layers"], 1)
    for name in ("fc1", "cross_attn"):
        pq = lq[name] if name == "fc1" else lq[name]["q"]
        pd = ld[name] if name == "fc1" else ld[name]["q"]
        assert torch.equal(tm.linear(x, pq), tm.linear(x, pd))
    assert torch.equal(tm.qkv_fused(x, lq["attn"], cfg.n_heads)[0],
                       tm.qkv_fused(x, ld["attn"], cfg.n_heads)[0])
    toks = torch.tensor([[50258, 7, 400], [3, 50363, 12]])
    assert torch.equal(tm.tok_embed(tq["decoder"], toks, torch.bfloat16),
                       tm.tok_embed(deq_t["decoder"], toks, torch.bfloat16))
    assert torch.equal(tm.final_logits(tq, cfg, x),
                       tm.final_logits(deq_t, cfg, x))


def test_jax_int8_tree_converts_and_gives_jax_prefill_logits(wq):
    """from_jax_params keeps a quantized JAX tree's int8 leaves and fp32
    scales; to_device keeps both (its bf16 cast would otherwise take the
    (L, out) scales) and concatenates the fused qkv's scales. The prefill
    logits then agree with JAX's on that tree (bf16 logits to a few bf16
    ulps of the O(1) values, as the unquantized bf16 step test), with the
    same argmax."""
    cfg, _, jq, _, tq = wq
    conv = to_device(from_jax_params(jax.tree.map(_np, jq)), "cpu",
                     torch.bfloat16)
    for a, b in ((conv["decoder"]["layers"]["attn"]["qkv"],
                  tq["decoder"]["layers"]["attn"]["qkv"]),
                 (conv["decoder"]["layers"]["fc2"],
                  tq["decoder"]["layers"]["fc2"])):
        assert a["w"].dtype == torch.int8 and a["w_s"].dtype == torch.float32
        assert torch.equal(a["w"], b["w"]) and torch.equal(a["w_s"], b["w_s"])
    assert conv["decoder"]["tok_emb_s"].dtype == torch.float32
    B = 2
    enc = np.random.RandomState(2).randn(B, cfg.n_audio_ctx, cfg.d_model
                                         ).astype(np.float32)
    prompt = np.tile(build_prompt(cfg), (B, 1))
    jenc = jnp.asarray(enc, jnp.bfloat16)
    jcross = jm.precompute_cross_kv(jq, cfg, jenc)
    jl, _ = jm.decoder_forward(jq, cfg, jnp.asarray(prompt, jnp.int32),
                               jnp.int32(0),
                               jm.init_kv_cache(cfg, B, jnp.bfloat16, 64),
                               jcross)
    tenc = torch.from_numpy(enc).bfloat16()
    tcross = tm.precompute_cross_kv(conv, cfg, tenc)
    tl, _ = tm.decoder_forward(conv, cfg, torch.from_numpy(prompt), 0,
                               tm.init_kv_cache(cfg, B, torch.bfloat16, 64,
                                                "cpu"), tcross)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=0.05)
    assert (tl[:, -1].argmax(-1).numpy()
            == np.asarray(jl[:, -1]).argmax(-1)).all()
