"""Port greedy decoding, pipeline and CLI (whisper_tpu_torch/decode.py,
pipeline.py, cli.py) against the JAX package, on the CPU."""

import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_golden_seeded import GOLDEN_HZ, GOLDEN_SEED, GOLDEN_TOKENS

from whisper_tpu.config import get_config
from whisper_tpu.decode import greedy_decode as jax_greedy_decode
from whisper_tpu.models.whisper import init_params as jax_init_params
from whisper_tpu.tokenizer import build_prompt
from whisper_tpu_torch import cli, decode
from whisper_tpu_torch.audio import log_mel_spectrogram
from whisper_tpu_torch.decode import _lengths, greedy_decode, transcribe_tokens
from whisper_tpu_torch.pipeline import WhisperPipeline
from whisper_tpu_torch.weights import from_jax_params, to_device

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def nano(small_cfg):
    np_tree = jax.tree.map(np.asarray,
                           jax_init_params(small_cfg, jax.random.PRNGKey(0)))
    rng = np.random.RandomState(1)
    B = 2
    enc = rng.randn(B, small_cfg.n_audio_ctx, small_cfg.d_model
                    ).astype(np.float32)
    prompt = np.tile(build_prompt(small_cfg), (B, 1))
    return (small_cfg, np_tree, to_device(from_jax_params(np_tree), "cpu"),
            enc, prompt)


def _eot_bias(cfg, value):
    bias = np.zeros(cfg.vocab_size, np.float32)
    bias[cfg.eot_token] = value
    return bias


@pytest.mark.parametrize("eot_bias", [0.0, -1e9, 1e9])
def test_greedy_matches_jax(nano, eot_bias):
    """Tokens and lengths equal; sum_logprobs and no_speech_prob to 1e-4
    (fp32 log-softmax sums of the same logits, which agree to 1e-4).

    max_new=14 is a cap no other test decodes nano with: the JAX stages
    are jitted on (cfg, total, max_new) and read their loop-step mode at
    trace time, so a cap shared with a test that overrides that mode
    could hand this test a prefill traced under the override."""
    cfg, np_tree, tparams, enc, prompt = nano
    bias = _eot_bias(cfg, eot_bias)
    want = jax_greedy_decode(jax.tree.map(jnp.asarray, np_tree), cfg,
                             jnp.asarray(enc), jnp.asarray(prompt, jnp.int32),
                             max_new=14, logit_bias=jnp.asarray(bias))
    got = greedy_decode(tparams, cfg, torch.from_numpy(enc),
                        torch.from_numpy(prompt), max_new=14,
                        logit_bias=torch.from_numpy(bias))
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(),
                                  np.asarray(want.lengths))
    np.testing.assert_allclose(got.sum_logprobs.numpy(),
                               np.asarray(want.sum_logprobs), atol=1e-4,
                               rtol=1e-5)
    np.testing.assert_allclose(got.no_speech_prob.numpy(),
                               np.asarray(want.no_speech_prob), atol=1e-6)


def test_early_exit_polling_matches_stepwise(nano, monkeypatch):
    """Polling for early exit every N steps gives the step-wise loop's
    results: finished rows re-emit EOT and their logprob sum freezes."""
    cfg, _, tparams, enc, prompt = nano
    runs = []
    for b in (1e9, 0.0):
        for n in (1, 4):
            monkeypatch.setattr(decode, "POLL_EVERY", n)
            runs.append(greedy_decode(
                tparams, cfg, torch.from_numpy(enc), torch.from_numpy(prompt),
                max_new=11, logit_bias=torch.from_numpy(_eot_bias(cfg, b))))
    for a, b in (runs[:2], runs[2:]):
        assert torch.equal(a.tokens, b.tokens)
        assert torch.equal(a.sum_logprobs, b.sum_logprobs)
    forced = runs[0]                      # every row ends at the first pick
    P = prompt.shape[1]
    assert (forced.lengths == P + 1).all()
    assert (forced.tokens[:, P:] == cfg.eot_token).all()


def test_lengths_counts_through_first_eot():
    toks = torch.tensor([[1, 2, 9, 5, 9], [1, 2, 3, 4, 5]])
    assert _lengths(toks, 2, eot=9).tolist() == [3, 5]


def test_seeded_golden_tokens_through_port():
    """The JAX package's seed-7 tiny weights, converted, reproduce
    GOLDEN_TOKENS through the port on the CPU (fp32)."""
    cfg = get_config("tiny")
    params = to_device(from_jax_params(jax.tree.map(
        np.asarray, jax_init_params(cfg, jax.random.PRNGKey(GOLDEN_SEED)))),
        "cpu")
    t = np.arange(cfg.n_samples) / cfg.sample_rate
    audio = (0.4 * np.sin(2 * np.pi * GOLDEN_HZ * t)).astype(np.float32)
    mel = log_mel_spectrogram(torch.from_numpy(audio)[None], cfg)
    res = transcribe_tokens(params, cfg, mel,
                            torch.tensor([build_prompt(cfg)]), max_new=12)
    assert res.tokens[0, :int(res.lengths[0])].tolist() == GOLDEN_TOKENS
    assert 0.0 <= float(res.no_speech_prob[0]) <= 1.0
    assert np.isfinite(float(res.sum_logprobs[0]))


def test_pipeline_batch_and_window_agree(nano):
    cfg, np_tree, _, _, _ = nano
    pipe = WhisperPipeline.from_params(from_jax_params(np_tree), cfg,
                                       device="cpu")
    rng = np.random.RandomState(5)
    audio = (0.1 * rng.randn(2, cfg.n_samples)).astype(np.float32)
    batch = pipe.transcribe_batch(audio, max_new=6)
    assert batch.tokens.shape == (2, 4 + 1 + 6)
    for b in range(2):
        one = pipe.transcribe_window(audio[b], max_new=6)
        assert one.tokens == batch.tokens[b, :int(batch.lengths[b])].tolist()
        assert isinstance(one.text, str) and one.timings["total_s"] > 0
    with pytest.raises(ValueError, match="transcribe_batch takes"):
        pipe.transcribe_batch(audio[:, :100])


def test_pipeline_bf16_runs_on_cpu(nano):
    cfg, np_tree, _, _, _ = nano
    pipe = WhisperPipeline.from_params(from_jax_params(np_tree), cfg,
                                       dtype="bfloat16", device="cpu")
    assert pipe.params["decoder"]["tok_emb"].dtype == torch.bfloat16
    res = pipe.transcribe_batch(np.zeros((1, cfg.n_samples), np.float32),
                                max_new=3)
    assert res.tokens.shape == (1, 8)
    assert torch.isfinite(res.sum_logprobs).all()


def test_pipeline_refuses_cuda_when_absent(nano):
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the refusal path does not apply")
    cfg, np_tree, _, _, _ = nano
    with pytest.raises(RuntimeError, match="not available"):
        WhisperPipeline.from_params(from_jax_params(np_tree), cfg)


def _write_wav(path, seconds=2.0, rate=16000):
    t = np.arange(int(seconds * rate)) / rate
    x = (0.3 * np.sin(2 * np.pi * 330 * t) * 32000).astype(np.int16)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(x.tobytes())


def test_cli_runs_on_cpu(tmp_path, capsys):
    wav = tmp_path / "clip.wav"
    _write_wav(wav)
    assert cli.main(["--random-weights", "--audio", str(wav), "--max-new",
                     "3", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "tokens: [50258, 50259, 50359, 50363," in out


def test_cli_rejects_flags_outside_the_slice_and_absent_cuda(tmp_path):
    wav = tmp_path / "clip.wav"
    _write_wav(wav, seconds=0.5)
    with pytest.raises(SystemExit) as e:
        cli.main(["--random-weights", "--audio", str(wav),
                  "--word-timestamps"])
    assert e.value.code != 0
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit) as e:
            cli.main(["--random-weights", "--audio", str(wav)])
        assert e.value.code != 0


# ---------------------------------------------------------------------------
# large-v3 / turbo structure: 128 mel bins, the 51,866-token vocabulary, the
# +1-shifted task tokens, asymmetric depth
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def v3_nano():
    cfg = get_config("large-v3-turbo").replace(
        name="v3-nano", d_model=128, n_heads=2, n_audio_layers=3,
        n_text_layers=1)
    assert cfg.n_mels == 128 and cfg.vocab_size == 51_866
    assert cfg.transcribe_token == 50_360
    np_tree = jax.tree.map(np.asarray,
                           jax_init_params(cfg, jax.random.PRNGKey(3)))
    return cfg, np_tree


@pytest.fixture(scope="module")
def v3_vocab(tmp_path_factory):
    """A 51,866-entry table: the bundled one with <|yue|>, the 100th
    language, at id 50358 (config.py:118, :150-180)."""
    from whisper_tpu.tokenizer import _ASSET_VOCAB
    with open(_ASSET_VOCAB, encoding="utf-8") as f:
        tokens = f.read().split("\n")
    if tokens[-1] == "":
        tokens.pop()
    tokens.insert(50_358, "<|yue|>")
    path = tmp_path_factory.mktemp("vocab") / "vocab_v3.txt"
    path.write_text("\n".join(tokens) + "\n", encoding="utf-8")
    return str(path)


@pytest.mark.parametrize("tail", ["tail", "off"])
def test_v3_nano_greedy_matches_jax(v3_nano, v3_vocab, tail, monkeypatch):
    """v3-nano greedy tokens through the port's pipeline on the CPU, with
    the tail kernel's plain twin and with the tail-off branch, against JAX
    greedy_decode on the same weights (max_new=9: a cap no other test
    decodes with)."""
    from whisper_tpu.audio import log_mel_spectrogram as jax_log_mel
    from whisper_tpu.models.whisper import encoder_forward as jax_encoder
    cfg, np_tree = v3_nano
    if tail == "off":
        monkeypatch.setenv("WHISPER_TPU_FUSED_ENCODER", "0")
    rng = np.random.RandomState(6)
    t = np.arange(cfg.n_samples) / cfg.sample_rate
    audio = np.stack([0.3 * np.sin(2 * np.pi * 300 * t),
                      0.1 * rng.randn(cfg.n_samples)]).astype(np.float32)
    jparams = jax.tree.map(jnp.asarray, np_tree)
    enc = jax_encoder(jparams, cfg, jax_log_mel(jnp.asarray(audio), cfg))
    prompt = np.tile(build_prompt(cfg), (2, 1))
    want = jax_greedy_decode(jparams, cfg, enc,
                             jnp.asarray(prompt, jnp.int32), max_new=9)
    pipe = WhisperPipeline.from_params(from_jax_params(np_tree), cfg,
                                       device="cpu", vocab_path=v3_vocab)
    got = pipe.transcribe_batch(audio, max_new=9)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(),
                                  np.asarray(want.lengths))


def test_pipeline_takes_vocab_path_as_jax_does(v3_nano, v3_vocab, tmp_path):
    """Every constructor takes vocab_path; without it the bundled
    51,865-entry table is too short for a v3 model and the constructor
    raises, as the JAX pipeline does (whisper_tpu/tokenizer.py:80-86)."""
    from whisper_tpu.weights import to_flat_bin
    cfg, np_tree = v3_nano
    blob = tmp_path / "w.bin"
    blob.write_bytes(to_flat_bin(np_tree, cfg))
    makers = {
        "from_params": lambda **kw: WhisperPipeline.from_params(
            from_jax_params(np_tree), cfg, device="cpu", **kw),
        "from_random": lambda **kw: WhisperPipeline.from_random(
            cfg, device="cpu", **kw),
        "from_flat_bin": lambda **kw: WhisperPipeline.from_flat_bin(
            str(blob), cfg, device="cpu", **kw),
    }
    for name, make in makers.items():
        with pytest.raises(ValueError, match="vocab_path"):
            make()
        pipe = make(vocab_path=v3_vocab)
        assert pipe.tokenizer.vocab_size == cfg.vocab_size, name
        assert pipe.tokenizer.decode([50_358]) == "", name     # <|yue|>


def test_cli_vocab_flag(v3_nano, v3_vocab, tmp_path, capsys, monkeypatch):
    """--vocab reaches the tokenizer; a v3 model without it fails as the
    JAX CLI does. The model is registered under a test name in the port's
    own table, which the port's CLI reads."""
    from whisper_tpu_torch.config import CONFIGS
    cfg, _ = v3_nano
    monkeypatch.setitem(CONFIGS, "v3-nano", cfg)
    wav = tmp_path / "clip.wav"
    _write_wav(wav)
    args = ["--model", "v3-nano", "--random-weights", "--audio", str(wav),
            "--max-new", "3", "--device", "cpu"]
    with pytest.raises(ValueError, match="vocab_path"):
        cli.main(args)
    assert cli.main(args + ["--vocab", v3_vocab]) == 0
    assert "tokens: [50258, 50259, 50360, 50364," in capsys.readouterr().out
