"""The port's checkpoint loaders (whisper_tpu_torch/weights.py:
from_hf_state_dict, from_safetensors, to_flat_bin, save_npz/load_npz,
param_shapes; WhisperPipeline.from_npz) against the JAX package's, on the
CPU, from a nano WhisperForConditionalGeneration built from a config."""

import sys

import jax
import numpy as np
import pytest
import torch

from whisper_tpu.models.whisper import init_params as jax_init_params
from whisper_tpu import weights as jax_weights
from whisper_tpu_torch import weights
from whisper_tpu_torch.config import get_config
from whisper_tpu_torch.pipeline import WhisperPipeline

torch.set_num_threads(2)

# nano widths with tiny's vocab, audio context and special-token layout
# (two layers a side, so the stacking is exercised; a 32-token context)
CFG = get_config("tiny").replace(
    name="ckpt-torch-nano", d_model=64, n_heads=2, n_audio_layers=2,
    n_text_layers=2, n_text_ctx=32)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _assert_same(got, want):
    """Port tree (torch) against a JAX-side tree (numpy): same paths, fp32,
    equal bit for bit."""
    got, want = _leaves(got), _leaves(want)
    assert got.keys() == want.keys()
    for name, w in want.items():
        assert got[name].dtype == torch.float32, name
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(w),
                                      err_msg=name)


@pytest.fixture(scope="module")
def hf_state():
    """A seeded nano HF Whisper's state_dict (torch tensors): non-zero
    biases and LayerNorm parameters, so no slot is left at its init."""
    from transformers import WhisperConfig, WhisperForConditionalGeneration
    torch.manual_seed(0)
    hf_cfg = WhisperConfig(
        vocab_size=CFG.vocab_size, num_mel_bins=CFG.n_mels,
        d_model=CFG.d_model, encoder_layers=CFG.n_audio_layers,
        decoder_layers=CFG.n_text_layers,
        encoder_attention_heads=CFG.n_heads,
        decoder_attention_heads=CFG.n_heads,
        encoder_ffn_dim=CFG.d_ff, decoder_ffn_dim=CFG.d_ff,
        max_source_positions=CFG.n_audio_ctx,
        max_target_positions=CFG.n_text_ctx)
    model = WhisperForConditionalGeneration(hf_cfg).eval()
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.01 * torch.randn_like(p))
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


@pytest.mark.parametrize("kind", ["torch", "numpy"])
def test_hf_state_dict_matches_jax(hf_state, kind):
    state = (hf_state if kind == "torch"
             else {k: v.numpy() for k, v in hf_state.items()})
    _assert_same(weights.from_hf_state_dict(state, CFG),
                 jax_weights.from_hf_state_dict(state, CFG))


def test_hf_state_dict_k_bias_zero_and_transposed(hf_state):
    got = weights.from_hf_state_dict(hf_state, CFG)
    attn = got["decoder"]["layers"]["cross_attn"]
    assert torch.equal(attn["k"]["b"], torch.zeros(CFG.n_text_layers,
                                                   CFG.d_model))
    want = hf_state["model.decoder.layers.1.encoder_attn.q_proj.weight"]
    assert torch.equal(attn["q"]["w"][1], want.t())


@pytest.mark.parametrize("layout", ["prefixed", "bare"])
def test_safetensors_matches_jax(hf_state, tmp_path, layout):
    from safetensors.numpy import save_file
    state = {k: v.numpy() for k, v in hf_state.items()}
    if layout == "bare":
        state = {k.removeprefix("model."): v for k, v in state.items()
                 if k.startswith("model.")}
    path = str(tmp_path / "model.safetensors")
    save_file(state, path)
    _assert_same(weights.from_safetensors(path, CFG),
                 jax_weights.from_safetensors(path, CFG))


def test_safetensors_missing_package_names_it(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "safetensors.numpy", None)
    with pytest.raises(ImportError, match="'safetensors'"):
        weights.from_safetensors(str(tmp_path / "x.safetensors"), CFG)


@pytest.fixture(scope="module")
def jax_tree():
    return jax.tree.map(np.asarray,
                        jax_init_params(CFG, jax.random.PRNGKey(4)))


@pytest.mark.parametrize("leaves", ["torch", "numpy"])
def test_to_flat_bin_bytes_equal_jax(jax_tree, leaves):
    tree = (weights.from_jax_params(jax_tree) if leaves == "torch"
            else jax_tree)
    blob = weights.to_flat_bin(tree, CFG)
    assert blob == jax_weights.to_flat_bin(jax_tree, CFG)
    _assert_same(weights.from_flat_bin(blob, CFG), jax_tree)


def test_npz_keys_equal_jax(jax_tree, tmp_path):
    weights.save_npz(str(tmp_path / "port.npz"),
                     weights.from_jax_params(jax_tree))
    jax_weights.save_npz(str(tmp_path / "jax.npz"), jax_tree)
    with np.load(tmp_path / "port.npz") as a, \
            np.load(tmp_path / "jax.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        assert "['decoder']['layers']['attn']['k']['w']" in a.files
        for key in b.files:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_npz_loads_across_packages(jax_tree, tmp_path, writer):
    path = str(tmp_path / "w.npz")
    if writer == "port":
        weights.save_npz(path, weights.from_jax_params(jax_tree))
        _assert_same(weights.from_jax_params(
            jax_weights.load_npz(path, CFG)), jax_tree)
    else:
        jax_weights.save_npz(path, jax_tree)
    _assert_same(weights.load_npz(path, CFG), jax_tree)


def test_npz_int8_leaves_stay_int8(jax_tree, tmp_path):
    tree = weights.from_jax_params(jax_tree)
    tree["decoder"]["tok_emb"] = torch.ones(CFG.vocab_size, CFG.d_model,
                                            dtype=torch.int8)
    weights.save_npz(str(tmp_path / "q.npz"), tree)
    with np.load(tmp_path / "q.npz") as a:
        assert a["['decoder']['tok_emb']"].dtype == np.int8


def test_load_npz_checks_shapes_and_keys(jax_tree, tmp_path):
    path = str(tmp_path / "w.npz")
    jax_weights.save_npz(path, jax_tree)
    with pytest.raises(ValueError, match=r"\['decoder'\]\['pos_emb'\] has "
                                         r"shape \(32, 64\)"):
        weights.load_npz(path, CFG.replace(n_text_ctx=48))
    with pytest.raises(ValueError, match="has shape"):
        weights.load_npz(path, CFG.replace(n_text_layers=3))
    flat = dict(np.load(path))
    del flat["['decoder']['ln']['g']"]
    np.savez(tmp_path / "short.npz", **flat)
    with pytest.raises(ValueError, match=r"no array \['decoder'\]\['ln'\]"):
        weights.load_npz(str(tmp_path / "short.npz"), CFG)


@pytest.mark.parametrize("name", ["nano", "tiny", "large-v3-turbo"])
def test_param_shapes_match_jax_template(name):
    cfg = CFG if name == "nano" else get_config(name)
    want = jax.tree_util.tree_flatten_with_path(
        jax_weights._param_shapes_template(cfg))[0]
    got = dict(weights._keystr_leaves(weights.param_shapes(cfg)))
    assert len(got) == len(want)
    for path, leaf in want:
        assert got[jax.tree_util.keystr(path)] == leaf.shape


def test_pipeline_from_npz_runs_the_loaded_weights(jax_tree, tmp_path):
    path = str(tmp_path / "w.npz")
    jax_weights.save_npz(path, jax_tree)
    a = WhisperPipeline.from_npz(path, CFG, device="cpu")
    b = WhisperPipeline.from_params(weights.from_jax_params(jax_tree), CFG,
                                    device="cpu")
    audio = np.random.RandomState(2).randn(1, CFG.n_samples
                                           ).astype(np.float32) * 0.1
    ra = a.transcribe_batch(audio, max_new=3)
    rb = b.transcribe_batch(audio, max_new=3)
    assert torch.equal(ra.tokens, rb.tokens)
    assert torch.equal(ra.sum_logprobs, rb.sum_logprobs)
