"""The port's serving quantization policy and its switches
(whisper_tpu_torch/config.py apply_serving_quant, pipeline.py `quant`,
cli.py quant flags) against the JAX package's, on the CPU: the intent of
tests/test_serving_quant_defaults.py."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from whisper_tpu import config as jconfig
from whisper_tpu.models.whisper import init_params as jax_init_params
from whisper_tpu.pipeline import WhisperPipeline as JaxPipeline
from whisper_tpu_torch import cli
from whisper_tpu_torch import config as tconfig
from whisper_tpu_torch.pipeline import WhisperPipeline
from whisper_tpu_torch.weights import from_jax_params

torch.set_num_threads(2)

_FLAGS = ("weight_quant", "cross_kv_quant", "kv_cache_quant",
          "self_kv_quant", "encoder_mlp_quant", "encoder_qkv_quant")
_BATCHES = (None, 1, 8, 9, 32)


def _same(tcfg, jcfg) -> None:
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(jconfig.CONFIGS))
def test_policy_matches_jax(name, dtype):
    """Every config, dtype and batch hint, plain and with each quant flag
    set explicitly: the port's answer is the JAX package's."""
    base_t = tconfig.CONFIGS[name].replace(compute_dtype=dtype)
    base_j = jconfig.CONFIGS[name].replace(compute_dtype=dtype)
    for flags in [{}] + [{f: True} for f in _FLAGS]:
        for batch in _BATCHES:
            got = tconfig.apply_serving_quant(base_t.replace(**flags), batch)
            want = jconfig.apply_serving_quant(base_j.replace(**flags), batch)
            _same(got, want)


def test_policy_kill_switch(monkeypatch):
    monkeypatch.setenv("WHISPER_TPU_AUTO_QUANT", "0")
    for name in ("tiny", "medium", "large-v3-turbo"):
        cfg = tconfig.CONFIGS[name].replace(compute_dtype="bfloat16")
        assert tconfig.apply_serving_quant(cfg, 32) is cfg
        _same(cfg, jconfig.apply_serving_quant(
            jconfig.CONFIGS[name].replace(compute_dtype="bfloat16"), 32))


def test_policy_takes_a_torch_dtype_for_fp32():
    cfg = tconfig.CONFIGS["tiny"].replace(compute_dtype=torch.float32)
    assert tconfig.apply_serving_quant(cfg, 32) is cfg


@pytest.fixture(scope="module")
def nano(small_cfg):
    np_tree = jax.tree.map(np.asarray,
                           jax_init_params(small_cfg, jax.random.PRNGKey(0)))
    return small_cfg, np_tree


@pytest.mark.parametrize("batch_hint", [None, 4, 32])
def test_pipeline_auto_gives_the_jax_config(nano, batch_hint):
    """quant="auto" on the port's pipeline gives the JAX pipeline's cfg for
    the same batch hint, and quantizes the weights when that cfg says so."""
    cfg, np_tree = nano
    cfg16 = cfg.replace(compute_dtype="bfloat16")
    want = JaxPipeline(cfg16, jax.tree.map(np.asarray, np_tree),
                       quant="auto", batch_hint=batch_hint).cfg
    pipe = WhisperPipeline(cfg16, from_jax_params(np_tree), device="cpu",
                           quant="auto", batch_hint=batch_hint)
    _same(pipe.cfg, want)
    dec = pipe.params["decoder"]
    assert ("tok_emb_s" in dec) == want.weight_quant
    if want.weight_quant:
        assert dec["tok_emb"].dtype == torch.int8
        assert dec["layers"]["attn"]["qkv"]["w_s"].dtype == torch.float32


def test_pipeline_default_is_off(nano):
    """The port's default quant is "off": the cfg as given, unquantized
    weights, for every constructor."""
    cfg, np_tree = nano
    cfg16 = cfg.replace(compute_dtype="bfloat16")
    for pipe in (WhisperPipeline(cfg16, from_jax_params(np_tree),
                                 device="cpu"),
                 WhisperPipeline.from_params(from_jax_params(np_tree), cfg,
                                             dtype="bfloat16", device="cpu"),
                 WhisperPipeline.from_random(cfg, dtype="bfloat16",
                                             device="cpu")):
        assert pipe.cfg == cfg16
        assert "tok_emb_s" not in pipe.params["decoder"]
        assert pipe.params["decoder"]["tok_emb"].dtype == torch.bfloat16


def test_pipeline_constructors_take_quant_and_hint(nano):
    cfg, np_tree = nano
    for pipe in (WhisperPipeline.from_params(
                     from_jax_params(np_tree), cfg, dtype="bfloat16",
                     device="cpu", quant="auto", batch_hint=32),
                 WhisperPipeline.from_random(cfg, dtype="bfloat16",
                                             device="cpu", quant="auto",
                                             batch_hint=32)):
        assert pipe.cfg.weight_quant and pipe.cfg.cross_kv_quant
    small = WhisperPipeline.from_random(cfg, dtype="bfloat16", device="cpu",
                                        quant="auto", batch_hint=8)
    assert not small.cfg.weight_quant          # tiny width at <= 8 rows
    with pytest.raises(ValueError, match="quant must be"):
        WhisperPipeline.from_random(cfg, device="cpu", quant="on")


def test_pipeline_weight_quant_refuses_fp32(nano):
    cfg, np_tree = nano
    with pytest.raises(ValueError, match="serving-mode"):
        WhisperPipeline(cfg.replace(weight_quant=True),
                        from_jax_params(np_tree), device="cpu")


@pytest.fixture
def nano_cli(nano, monkeypatch, tmp_path):
    """The nano model under a test name in the port's own table, and a
    short clip."""
    from test_torch_decode import _write_wav
    cfg, _ = nano
    monkeypatch.setitem(tconfig.CONFIGS, "quant-nano", cfg)
    wav = tmp_path / "clip.wav"
    _write_wav(wav, seconds=1.0)
    return ["--model", "quant-nano", "--random-weights", "--audio", str(wav),
            "--max-new", "2", "--device", "cpu"]


@pytest.mark.parametrize("flags", [
    ["--dtype", "bfloat16", "--weight-quant", "--cross-kv-quant",
     "--self-kv-quant"],
    ["--kv-quant"],
    ["--cross-kv-quant"],
])
def test_cli_quant_flags(nano_cli, flags, capsys):
    assert cli.main(nano_cli + flags) == 0
    assert "tokens: [50258, 50259, 50359, 50363," in capsys.readouterr().out


def test_cli_weight_quant_refuses_fp32(nano_cli):
    with pytest.raises(ValueError, match="serving-mode"):
        cli.main(nano_cli + ["--weight-quant"])
