"""The plain reference against the port's CPU path at tiny's width, its
quantizers against the port's, and the imports: nothing the benchmark
runs loads JAX or the JAX package, and the reference loads nothing of the
program either."""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import harness, weights
from portbench.reference import model as ref
from portbench.tests.conftest import TINY

PB = harness.ROOT / "portbench"


@pytest.fixture(scope="module")
def tiny():
    from whisper_tpu_torch.config import get_config
    cfg = {**harness.load_json(PB / "configs" / "medium.json"), **TINY}
    audio = torch.from_numpy(weights.audio_pool(2, 480_000, 16_000, 5,
                                                "cpu"))
    return cfg, get_config("tiny"), audio


def test_shapes_are_the_ports(tiny):
    from whisper_tpu_torch.weights import param_shapes
    for name in ("large-v3-turbo", "medium"):
        from whisper_tpu_torch.config import get_config
        cfg = harness.load_json(PB / "configs" / f"{name}.json")
        assert weights.shapes(cfg) == param_shapes(get_config(name))


def test_weights_come_from_the_seed(tiny):
    cfg, _, _ = tiny
    a = weights.make(cfg, 2 ** 31 + 5, "cpu", torch.bfloat16)
    b = weights.make(cfg, 2 ** 31 + 5, "cpu", torch.bfloat16)
    c = weights.make(cfg, 2 ** 31 + 6, "cpu", torch.bfloat16)
    la, lb, lc = (dict(weights.leaves(t)) for t in (a, b, c))
    assert all(torch.equal(la[k], lb[k]) for k in la)
    assert not torch.equal(la["decoder/tok_emb"], lc["decoder/tok_emb"])
    assert la["decoder/tok_emb"].dtype == torch.bfloat16
    assert la["encoder/conv1/b"].dtype == torch.float32
    assert float(la["decoder/tok_emb"].float().std()) == pytest.approx(
        0.02, rel=0.02)
    assert torch.equal(la["encoder/layers/attn_ln/g"],
                       torch.ones_like(la["encoder/layers/attn_ln/g"]))


def test_log_mel_matches_the_port(tiny):
    from whisper_tpu_torch.audio import log_mel_spectrogram
    cfg, pcfg, audio = tiny
    got = ref.log_mel(audio, 80)
    assert (got - log_mel_spectrogram(audio, pcfg)).abs().max() < 1e-4


def test_fp32_encoder_and_decoder_match_the_port(tiny):
    from whisper_tpu_torch.decode import encode
    from whisper_tpu_torch.models import whisper as mw
    from whisper_tpu_torch.weights import to_device
    cfg, pcfg, audio = tiny
    w = weights.make(cfg, 9, "cpu", torch.float32)
    p = to_device(w, "cpu")
    mel = ref.log_mel(audio, 80)
    enc = ref.encoder(w, cfg, mel, {})
    assert (encode(p, pcfg, mel) - enc).abs().max() < 1e-4
    tok = torch.tensor([[50258, 50259, 50359, 50363, 400, 500, 600]] * 2)
    want = ref.decoder_logits(w, cfg, enc, tok, {})
    for cross_q, policy in ((False, {}), (True, {"cross_bits": 8})):
        c = pcfg.replace(cross_kv_quant=cross_q)
        cache = mw.init_kv_cache(c, 2, torch.float32, 64, "cpu")
        cross = mw.precompute_cross_kv(p, c, enc)
        got, _ = mw.decoder_forward(p, c, tok, 0, cache, cross)
        want = ref.decoder_logits(w, cfg, enc, tok, policy)
        err = (got - want).abs().max()
        assert err < 1e-4
    # the int8 cross K/V moved the logits ten times further than the
    # reference's int8 of them lies from the port's
    plain = ref.decoder_logits(w, cfg, enc, tok, {})
    assert (got - plain).abs().max() > 10 * err


def test_quantizers_are_the_ports():
    from whisper_tpu_torch.models import whisper as mw
    from whisper_tpu_torch.ops.encoder_layer import rowquant
    g = torch.Generator().manual_seed(3)
    w = (torch.randn(3, 96, 40, generator=g) * 0.02).bfloat16()
    q, s = mw._quant_cols(w)
    assert torch.equal(ref.fake_quant(w.float(), -2, 8),
                       q.float() * s.unsqueeze(-2))
    x = torch.randn(7, 96, generator=g)
    q, s = rowquant(x)
    assert torch.equal(ref.fake_quant(x, -1, 8), q.float() * s)
    q, s = mw.quantize_kv(x.view(7, 6, 16))
    assert torch.equal(ref.fake_quant(x.view(7, 6, 16), -1, 8),
                       q.float() * s)
    emb = mw.quantize_weights_wq(
        {"decoder": {"tok_emb": w[0], "layers": {
            "attn": {}, "cross_attn": {"q": {"w": w, "b": w[:, 0]},
                                       "o": {"w": w, "b": w[:, 0]}},
            "fc1": {"w": w, "b": w[:, 0]}, "fc2": {"w": w, "b": w[:, 0]}}}},
        type("C", (), {"compute_dtype": "bfloat16"})())["decoder"]
    assert torch.equal(ref.fake_quant(w[0].float(), -1, 8),
                       emb["tok_emb"].float() * emb["tok_emb_s"][:, None])
    assert ref.fake_quant(x, -1, None) is x


def test_int4_is_coarser_than_int8():
    x = torch.randn(64, 256)
    e8 = (ref.fake_quant(x, -1, 8) - x).abs().mean()
    e4 = (ref.fake_quant(x, -1, 4) - x).abs().mean()
    assert e4 > 10 * e8


# ---- imports ----------------------------------------------------------------

def imports_of(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in PB.rglob("*.py"):
        if "tests" in path.parts:
            continue
        assert not imports_of(path) & set(harness.FORBIDDEN), path


def test_the_reference_imports_nothing_of_the_program():
    for path in [*(PB / "reference").glob("*.py"),
                 *(PB / "tests" / "toy_lm" / "reference").glob("*.py")]:
        got = imports_of(path)
        assert not got & {"whisper_tpu_torch", *harness.FORBIDDEN}, path
        assert got <= {"__future__", "math", "typing", "numpy", "torch",
                       "portbench"}, path


def test_a_run_loads_no_jax_module():
    """What a run imports on the chip (the harness, both kinds, every
    model type's and metric reader's file, the reference, and the port's
    modules the kinds call),
    loaded in a fresh interpreter: no top-level name is jax, jaxlib, flax
    or whisper_tpu, compared whole."""
    code = (
        "import sys; from pathlib import Path\n"
        "from portbench import harness, run, sweep, control, trace\n"
        "from portbench.kinds import open_loop, closed_loop\n"
        "from portbench.reference import model, check\n"
        "for d in ('metrics', 'models'):\n"
        "    for p in (harness.ROOT / 'portbench' / d).glob('*.py'):\n"
        "        harness.load_module(p)\n"
        "import whisper_tpu_torch.pipeline, whisper_tpu_torch.decode\n"
        "import whisper_tpu_torch.serving_continuous\n"
        "import whisper_tpu_torch.decode_rules, whisper_tpu_torch.audio\n"
        "assert 'whisper_tpu_torch' in sys.modules\n"
        "print(harness.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                         capture_output=True, text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "USE_FLAX": "0"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_are_compared_whole(monkeypatch):
    before = harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxtyping_like", object())
    monkeypatch.setitem(sys.modules, "whisper_tpu_torch_x", object())
    assert harness.forbidden_modules() == before
    monkeypatch.setitem(sys.modules, "flax_like.jax", object())
    monkeypatch.setitem(sys.modules, "whisper_tpu.config_x", object())
    assert harness.forbidden_modules() == sorted(
        before + ["whisper_tpu.config_x"])


def test_served_logits_run_once_over_prompt_and_served(tiny):
    """served_logits reads the logits at the positions that chose each
    served token: the same as one decoder pass over the sequence."""
    cfg, _, audio = tiny
    w = weights.make(cfg, 4, "cpu", torch.float32)
    prompts = [[50258, 50259, 50359, 50363], [50361, 9, 50258, 50259,
                                              50359, 50363]]
    served = [[11, 12, 13], [21, 22]]
    got = ref.served_logits(w, cfg, audio.numpy(), prompts, served, {},
                            "cpu")
    enc = ref.encoder(w, cfg, ref.log_mel(audio, 80), {})
    for i in range(2):
        seq = torch.tensor([prompts[i] + served[i]])
        full = ref.decoder_logits(w, cfg, enc[i:i + 1], seq, {})[0]
        p = len(prompts[i])
        assert torch.allclose(got[i], full[p - 1:p - 1 + len(served[i])],
                              atol=1e-4)
    assert np.isfinite(got[0].numpy()).all()
