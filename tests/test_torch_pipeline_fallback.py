"""The port's pipeline layer (whisper_tpu_torch/pipeline.py:
transcribe_window's temperature fallback, the silence gate, strip_prev,
language="auto", make_options, compression_ratio) and the CLI's decode
flags, against the JAX pipeline on the CPU.

The fallback tests replace decode_from_encoder in both pipelines with the
same scripted results and compare what each pipeline asked for
(temperature, beam size, seed, prompt) and what it returned."""

import ast

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_tpu import pipeline as jax_pipeline
from whisper_tpu.decode import DecodeResult as JaxResult
from whisper_tpu.models.whisper import init_params
from whisper_tpu_torch import cli
from whisper_tpu_torch import config as tconfig
from whisper_tpu_torch import pipeline
from whisper_tpu_torch.decode import DecodeResult
from whisper_tpu_torch.weights import from_jax_params, save_npz

torch.set_num_threads(2)

REPEAT = [7588] * 40                      # " the" forty times: ratio > 2.4
PLAIN = list(range(1000, 1024))           # 24 distinct tokens: ratio < 2.4


@pytest.fixture(scope="module")
def pipes(small_cfg):
    """The JAX and the port pipeline on the same nano weights (quant off,
    fp32)."""
    cfg = small_cfg.replace(name="torch-fallback-nano")
    rng = np.random.RandomState(3)
    tree = jax.tree.map(
        lambda x: (np.asarray(x) + 0.02 * rng.randn(*np.shape(x))
                   ).astype(np.float32),
        init_params(cfg, jax.random.PRNGKey(0)))
    jpipe = jax_pipeline.WhisperPipeline(
        cfg, jax.tree.map(jnp.asarray, tree), quant="off")
    tpipe = pipeline.WhisperPipeline(cfg, from_jax_params(tree),
                                     device="cpu")
    return cfg, tree, jpipe, tpipe


def _script(monkeypatch, outcomes, cfg):
    """Replace both pipelines' decode_from_encoder with a recorder that
    returns outcomes[i] = (generated ids, mean logprob, P(no speech)) at
    its i-th call. Returns the two call logs: (temperature, beam size,
    seed or None, prompt) per call."""
    logs = {"jax": [], "port": []}

    def result(prompt, i):
        gen, mean_lp, nsp = outcomes[min(i, len(outcomes) - 1)]
        ids = list(prompt) + gen + [cfg.eot_token]
        return ids, float(mean_lp * (len(gen) + 1)), float(nsp)

    def jax_fake(params, cfg_, enc, prompt, max_new=None, opts=None,
                 beam_size=1, rng=None):
        p = np.asarray(prompt)[0].tolist()
        seed = None if rng is None else int(np.asarray(rng)[-1])
        logs["jax"].append((opts.temperature, beam_size, seed, p))
        ids, lp, nsp = result(p, len(logs["jax"]) - 1)
        return JaxResult(tokens=jnp.asarray([ids], jnp.int32),
                         lengths=jnp.asarray([len(ids)], jnp.int32),
                         sum_logprobs=jnp.asarray([lp], jnp.float32),
                         no_speech_prob=jnp.asarray([nsp], jnp.float32))

    def port_fake(params, cfg_, enc, prompt, max_new=None, opts=None,
                  beam_size=1, generator=None, logit_bias=None):
        p = prompt[0].tolist()
        seed = None if generator is None else generator.initial_seed()
        logs["port"].append((opts.temperature, beam_size, seed, p))
        ids, lp, nsp = result(p, len(logs["port"]) - 1)
        return DecodeResult(tokens=torch.tensor([ids]),
                            lengths=torch.tensor([len(ids)]),
                            sum_logprobs=torch.tensor([lp]),
                            no_speech_prob=torch.tensor([nsp]))

    monkeypatch.setattr(jax_pipeline, "decode_from_encoder", jax_fake)
    monkeypatch.setattr(pipeline, "decode_from_encoder", port_fake)
    return logs


CASES = {
    # repetitive, then unconfident, then accepted at the third temperature
    "accept_third": dict(outcomes=[(REPEAT, -0.2, 0.1), (PLAIN, -1.5, 0.1),
                                   (PLAIN, -0.3, 0.1)],
                         fallback=pipeline.FALLBACK_TEMPERATURES, beam=5),
    # nothing passes: every temperature is tried, the last result stands
    "all_fail": dict(outcomes=[(REPEAT, -0.2, 0.1)],
                     fallback=pipeline.FALLBACK_TEMPERATURES, beam=5),
    # the first decode passes: no fallback
    "accept_first": dict(outcomes=[(PLAIN, -0.1, 0.1)],
                         fallback=(0.0, 0.5), beam=3),
    # one temperature, no list: one decode, never gated
    "single_sampled": dict(outcomes=[(REPEAT, -3.0, 0.1)], fallback=(),
                           beam=1, temperature=0.6),
    # silence gate: P(no speech) > 0.6 and avg logprob < -1 drop the text
    "silence_dropped": dict(outcomes=[(PLAIN, -1.5, 0.9)], fallback=(),
                            beam=1, nsp=0.6),
    "silence_kept": dict(outcomes=[(PLAIN, -0.5, 0.9)], fallback=(), beam=1,
                         nsp=0.6),
    # conditioning prefix stripped before the gates and from the output
    "strip_prev": dict(outcomes=[(REPEAT, -0.2, 0.1), (PLAIN, -0.2, 0.1)],
                       fallback=(0.0, 0.4), beam=2, prev=(300, 301, 302)),
}


@pytest.mark.parametrize("name", list(CASES))
def test_fallback_asks_what_jax_asks(pipes, monkeypatch, name):
    cfg, _, jpipe, tpipe = pipes
    case = CASES[name]
    logs = _script(monkeypatch, case["outcomes"], cfg)
    audio = np.random.RandomState(0).randn(16_000).astype(np.float32) * 0.1
    kw = dict(fallback_temperatures=case["fallback"], seed=40,
              prev_tokens=case.get("prev", ()),
              no_speech_threshold=case.get("nsp"), max_new=45)
    want = jpipe.transcribe_window(audio, opts=jpipe.make_options(
        beam_size=case["beam"], temperature=case.get("temperature", 0.0)),
        **kw)
    got = tpipe.transcribe_window(audio, opts=tpipe.make_options(
        beam_size=case["beam"], temperature=case.get("temperature", 0.0)),
        **kw)
    assert logs["port"] == logs["jax"]
    assert got.tokens == want.tokens
    assert got.text == want.text
    if name == "accept_third":
        assert [c[:3] for c in logs["port"]] == [(0.0, 5, None), (0.2, 1, 41),
                                                 (0.4, 1, 42)]
    if name == "all_fail":
        assert len(logs["port"]) == len(pipeline.FALLBACK_TEMPERATURES)
    if name == "silence_dropped":
        assert got.tokens == [] and got.text == ""
    if name == "strip_prev":
        assert got.tokens[0] == cfg.sot_token
        assert logs["port"][0][3][0] == cfg.sot_prev_token


@pytest.mark.parametrize("text", ["", "hello world", "ab" * 200,
                                  "the " * 50, "ünïcødé ✓ " * 7])
def test_compression_ratio_equals_jax(text):
    assert pipeline.compression_ratio(text) == \
        jax_pipeline.compression_ratio(text)


def test_thresholds_equal_jax():
    for name in ("COMPRESSION_RATIO_THRESHOLD", "LOGPROB_THRESHOLD",
                 "NO_SPEECH_THRESHOLD", "FALLBACK_TEMPERATURES"):
        assert getattr(pipeline, name) == getattr(jax_pipeline, name)


@pytest.mark.parametrize("kw", [
    {}, dict(timestamps=True), dict(suppress_nonspeech=True),
    dict(temperature=0.4, beam_size=1),
    dict(beam_size=5, length_penalty=1.0, timestamps=True,
         suppress_nonspeech=True)])
def test_make_options_equals_jax(pipes, kw):
    _, _, jpipe, tpipe = pipes
    assert tpipe.make_options(**kw)._asdict() == \
        jpipe.make_options(**kw)._asdict()


def test_auto_language_asks_for_jax_prompt(pipes, monkeypatch):
    """language="auto" detects on the window's encoder output and decodes
    with the detected language's prompt, as JAX does."""
    cfg, _, jpipe, tpipe = pipes
    logs = _script(monkeypatch, [(PLAIN, -0.1, 0.1)], cfg)
    audio = np.random.RandomState(1).randn(24_000).astype(np.float32) * 0.1
    jpipe.transcribe_window(audio, language="auto", task="translate")
    tpipe.transcribe_window(audio, language="auto", task="translate")
    assert logs["port"][0][3] == logs["jax"][0][3]
    assert logs["port"][0][3][2] == cfg.translate_token
    enc = tpipe._encode_audio(np.zeros((1, cfg.n_samples), np.float32))
    lang = tpipe.detect_language(enc)
    assert lang == jpipe.detect_language(jnp.asarray(enc.numpy()))


def test_window_segments_and_word_timestamps(pipes, monkeypatch):
    cfg, _, jpipe, tpipe = pipes
    ts0 = cfg.timestamp_begin
    logs = _script(monkeypatch, [([ts0 + 5] + PLAIN[:5] + [ts0 + 60],
                                  -0.2, 0.1)], cfg)
    audio = np.zeros(16_000, np.float32)
    want = jpipe.transcribe_window(audio, opts=jpipe.make_options(
        timestamps=True), window_offset_s=30.0)
    got = tpipe.transcribe_window(audio, opts=tpipe.make_options(
        timestamps=True), window_offset_s=30.0)
    assert logs["port"] == logs["jax"]
    assert got.segments == want.segments and got.segments[0]["start"] == 30.1
    # word timestamps on the scripted text, with and without a
    # <|startofprev|> prompt (whose text the alignment must skip): the
    # words and their times equal JAX's, shifted by the window offset
    loud = np.random.RandomState(4).randn(40_000).astype(np.float32) * 0.1
    for prev in ((), tuple(PLAIN[10:16])):
        kw = dict(opts=None, prev_tokens=prev, word_timestamps=True,
                  window_offset_s=12.5)
        want = jpipe.transcribe_window(loud, **kw)
        got = tpipe.transcribe_window(loud, **kw)
        assert got.words and [(w.word, w.start, w.end, w.tokens)
                              for w in got.words] == \
            [(w.word, w.start, w.end, w.tokens) for w in want.words]
        assert got.tokens == want.tokens and got.tokens[0] == cfg.sot_token
        assert all(12.5 <= w.start <= w.end <= 12.5 + 2.55
                   for w in got.words)


@pytest.fixture
def nano_cli(pipes, monkeypatch, tmp_path):
    """The nano weights as an npz under a test name in the port's table,
    and a 1 s clip."""
    from test_torch_decode import _write_wav
    cfg, tree, _, _ = pipes
    monkeypatch.setitem(tconfig.CONFIGS, cfg.name, cfg)
    save_npz(str(tmp_path / "w.npz"), from_jax_params(tree))
    _write_wav(tmp_path / "clip.wav", seconds=1.0)
    return ["--model", cfg.name, "--weights", str(tmp_path / "w.npz"),
            "--audio", str(tmp_path / "clip.wav"), "--max-new", "5",
            "--device", "cpu"]


def _tokens(out: str) -> list:
    line = next(ln for ln in out.splitlines() if ln.startswith("tokens:"))
    return ast.literal_eval(line.split(":", 1)[1].strip())


@pytest.mark.parametrize("flags", [
    ["--beam", "3", "--timestamps", "--suppress-nonspeech"],
    ["--temperature", "0.7", "--seed", "3"],
    ["--task", "translate", "--language", "auto", "--no-speech-threshold",
     "0.6"],
    ["--dtype", "bfloat16", "--no-quant", "--beam", "2"],
])
def test_cli_decode_flags(pipes, nano_cli, flags, capsys):
    cfg = pipes[0]
    assert cli.main(nano_cli + flags) == 0
    first = _tokens(capsys.readouterr().out)
    assert first[0] == cfg.sot_token
    assert cli.main(nano_cli + flags) == 0      # deterministic, seed included
    assert _tokens(capsys.readouterr().out) == first


def test_cli_beam_and_seed_change_the_decode(pipes, nano_cli, capsys):
    """--beam reaches beam search (the pipeline's beam tokens) and --seed
    the sampling stream."""
    cfg, tree, _, _ = pipes
    assert cli.main(nano_cli + ["--beam", "3"]) == 0
    beam = _tokens(capsys.readouterr().out)
    pipe = pipeline.WhisperPipeline(cfg, from_jax_params(tree), device="cpu")
    from whisper_tpu_torch.pipeline import load_wav
    wav = load_wav(nano_cli[nano_cli.index("--audio") + 1])
    want = pipe.transcribe_window(wav, max_new=5,
                                  opts=pipe.make_options(beam_size=3))
    assert beam == want.tokens
    runs = []
    for seed in ("1", "2"):
        assert cli.main(nano_cli + ["--temperature", "1.0", "--seed",
                                    seed]) == 0
        runs.append(_tokens(capsys.readouterr().out))
    assert runs[0] != runs[1]
