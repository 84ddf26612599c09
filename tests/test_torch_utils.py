"""The port's utils (whisper_tpu_torch/utils) against the JAX package's:
the text metrics on seeded strings, the roofline cost model over every
config and quant flag at the same peaks, and the trace on the CPU (the
tracer's tests are in test_torch_tracing.py)."""

import json

import numpy as np
import pytest
import torch

from whisper_tpu.config import CONFIGS as JAX_CONFIGS
from whisper_tpu.config import get_config as jax_get_config
from whisper_tpu.utils import metrics as jax_metrics
from whisper_tpu.utils import perf_model as jax_pm
from whisper_tpu_torch.config import CONFIGS, get_config
from whisper_tpu_torch.utils import metrics, perf_model, rtfx, trace

torch.set_num_threads(2)

_WORDS = ["the", "cat", "sat", "on", "mat", "Hello,", "world!", "it's",
          "don't", "A", "b", "ünïcödé", "  ", "42", "x-y", "Ω"]


def _sentence(rng, n):
    return " ".join(rng.choice(_WORDS) for _ in range(n))


@pytest.mark.parametrize("seed", range(6))
def test_metrics_equal_jax(seed):
    rng = np.random.RandomState(seed)
    for _ in range(20):
        ref = _sentence(rng, rng.randint(0, 12))
        hyp = _sentence(rng, rng.randint(0, 12))
        assert metrics.normalize_text(ref) == jax_metrics.normalize_text(ref)
        for norm in (True, False):
            assert metrics.wer(ref, hyp, norm) == jax_metrics.wer(ref, hyp,
                                                                  norm)
            assert metrics.cer(ref, hyp, norm) == jax_metrics.cer(ref, hyp,
                                                                  norm)
        a = rng.randint(0, 30, size=rng.randint(0, 25)).tolist()
        b = rng.randint(0, 30, size=rng.randint(0, 25)).tolist()
        assert metrics.edit_distance(a, b) == jax_metrics.edit_distance(a, b)
        assert metrics.token_er(a, b) == jax_metrics.token_er(a, b)


def test_metrics_known_values():
    assert metrics.edit_distance(list("kitten"), list("sitting")) == 3
    assert metrics.wer("the cat sat", "the cat sat") == 0.0
    assert metrics.wer("", "") == 0.0 and metrics.wer("", "x") == 1.0
    assert metrics.cer("abc", "abd") == pytest.approx(1 / 3)
    assert metrics.token_er([], []) == 0.0


_QUANT = [{}, {"kv_cache_quant": True}, {"self_kv_quant": True},
          {"cross_kv_quant": True}, {"weight_quant": True},
          {"weight_quant": True, "cross_kv_quant": True,
           "self_kv_quant": True}]


@pytest.mark.parametrize("name", sorted(JAX_CONFIGS))
def test_perf_model_equals_jax(name):
    """Every config, compute dtype and quant flag: flops, bytes and
    floor_s equal JAX's given JAX's peaks, and the per-phase costs too."""
    assert sorted(CONFIGS) == sorted(JAX_CONFIGS)
    for dtype in ("float32", "bfloat16"):
        for flags in _QUANT:
            cfg = get_config(name).replace(compute_dtype=dtype, **flags)
            jcfg = jax_get_config(name).replace(compute_dtype=dtype, **flags)
            for batch, prompt, gen in ((1, 4, 9), (32, 4, 89), (8, 132, 33)):
                got = perf_model.workload_cost(
                    cfg, batch, prompt, gen, peak=jax_pm.V5E_PEAK_BF16_FLOPS,
                    bw=jax_pm.V5E_HBM_BYTES_PER_S)
                want = jax_pm.workload_cost(jcfg, batch, prompt, gen)
                assert (got.flops, got.hbm_bytes, got.floor_s) == \
                    (want.flops, want.hbm_bytes, want.floor_s)
            db = 2 if dtype == "bfloat16" else 4
            assert perf_model.encoder_cost(cfg, 3, db) == \
                jax_pm.encoder_cost(jcfg, 3, db)
            assert perf_model.prefill_cost(cfg, 3, 7, db) == \
                jax_pm.prefill_cost(jcfg, 3, 7, db)
            assert perf_model.decode_cost(cfg, 3, 7, 5, db, 1, 1, 1) == \
                jax_pm.decode_cost(jcfg, 3, 7, 5, db, 1, 1, 1)


def test_perf_model_h100_peaks():
    """The default peaks are the H100 SXM's, by compute dtype."""
    assert perf_model.H100_PEAK_BF16_FLOPS == 989e12
    assert perf_model.H100_PEAK_FP32_FLOPS == 67e12
    assert perf_model.H100_HBM_BYTES_PER_S == 3.35e12
    for dtype, peak in (("bfloat16", 989e12), ("float32", 67e12)):
        cfg = get_config("large-v3-turbo").replace(compute_dtype=dtype)
        got = perf_model.workload_cost(cfg, 32, 4, 89)
        want = perf_model.workload_cost(cfg, 32, 4, 89, peak=peak,
                                        bw=3.35e12)
        assert got == want
        assert got.sol_frac(got.floor_s) == 1.0
        assert got.mfu(1.0) == got.flops / 989e12


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path / "tr")) as log_dir:
        torch.ones(64, 64) @ torch.ones(64, 64)
    with open(f"{log_dir}/trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)


def test_rtfx_and_report():
    assert rtfx(30.0, 0.75) == 40.0
    assert rtfx(30.0, 0.0) > 1e6
