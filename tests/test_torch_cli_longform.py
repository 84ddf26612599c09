"""The port's CLI against the JAX CLI on the same nano npz, on the CPU:
a 45 s 22.05 kHz WAV transcribed long-form (tokens and the rendered SRT
or VTT byte-equal), the output formats and --output, --mel with
--reference-detok, the speculative flags (--draft-model with its
weights: the target's greedy tokens, JAX's errors and its self_kv_quant
warning), and every flag of the JAX CLI present in the port's."""

import ast
import os
import wave

import jax
import numpy as np
import pytest
import torch

from whisper_tpu import cli as jax_cli
from whisper_tpu import config as jconfig
from whisper_tpu import native as jax_native
from whisper_tpu.models.whisper import init_params
from whisper_tpu_torch import cli
from whisper_tpu_torch import config as tconfig
from whisper_tpu_torch.weights import from_jax_params, save_npz

torch.set_num_threads(2)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _jax_native_loaded():
    """whisper_tpu.native builds its library in place on first use, and
    test workers that collect at once may build it together; a worker that
    loaded it mid-write keeps it unavailable for good. Load it once more
    now that every build has finished."""
    if not jax_native.available():
        jax_native._tried = False
        jax_native.available()


def _write_wav(path, seconds: float, rate: int, seed: int = 0) -> None:
    """Tones that change every 6 s plus noise, 16-bit mono."""
    rng = np.random.RandomState(seed)
    t = np.arange(int(seconds * rate)) / rate
    x = (0.3 * np.sin(2 * np.pi * (200 + 50 * np.floor(t / 6)) * t)
         + 0.05 * rng.randn(t.size))
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes((x * 32767).astype("<i2").tobytes())


def _nano(small_cfg, name, seed, **kw):
    """A JAX config under `name` with `kw`, the port's twin, and the npz of
    seeded weights (biases and LayerNorms perturbed)."""
    jcfg = small_cfg.replace(name=name, **kw)
    tcfg = tconfig.get_config("tiny").replace(
        name=name, d_model=jcfg.d_model, n_heads=jcfg.n_heads,
        n_audio_layers=jcfg.n_audio_layers,
        n_text_layers=jcfg.n_text_layers, n_audio_ctx=jcfg.n_audio_ctx,
        n_text_ctx=jcfg.n_text_ctx)
    rng = np.random.RandomState(seed)
    tree = jax.tree.map(
        lambda x: (np.asarray(x) + 0.02 * rng.randn(*np.shape(x))
                   ).astype(np.float32),
        init_params(jcfg, jax.random.PRNGKey(seed)))
    return jcfg, tcfg, tree


@pytest.fixture(scope="module")
def files(small_cfg, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli")
    target = _nano(small_cfg, "torch-cli-nano", 0)
    draft = _nano(small_cfg, "torch-cli-draft-nano", 3, d_model=48,
                  n_audio_layers=1, n_text_layers=1)
    for (_, _, tree), name in ((target, "w.npz"), (draft, "d.npz")):
        save_npz(str(tmp / name), from_jax_params(tree))
    _write_wav(tmp / "long.wav", 45.0, 22_050)
    _write_wav(tmp / "short.wav", 1.5, 22_050, seed=1)
    return tmp, target, draft


@pytest.fixture
def run(files, monkeypatch, capsys):
    """run(package, flags) -> (rc, stdout, stderr) of that package's CLI on
    the nano npz, both configs registered in both packages' tables."""
    tmp, target, draft = files
    for jcfg, tcfg, _ in (target, draft):
        monkeypatch.setitem(jconfig.CONFIGS, jcfg.name, jcfg)
        monkeypatch.setitem(tconfig.CONFIGS, tcfg.name, tcfg)

    def go(package, flags, audio="long.wav"):
        argv = ["--model", target[0].name, "--weights", str(tmp / "w.npz")]
        if audio:
            argv += ["--audio", str(tmp / audio)]
        if package == "port":
            rc = cli.main(argv + flags + ["--device", "cpu"])
        else:
            rc = jax_cli.main(argv + flags)
        out = capsys.readouterr()
        return rc, out.out, out.err
    return go


def _line(out: str, key: str):
    line = next(ln for ln in out.splitlines() if ln.startswith(key + ":"))
    return line.split(":", 1)[1].strip()


@pytest.mark.parametrize("flags,fmt", [
    (["--word-timestamps", "--condition-on-previous", "--vad-db", "-40"],
     "srt"),
    (["--timestamps", "--word-timestamps"], "vtt"),
    (["--timestamps", "--suppress-nonspeech"], "tsv"),
    (["--word-timestamps"], "json"),
])
def test_long_wav_equals_jax_cli(files, run, flags, fmt):
    """45 s at 22.05 kHz: two or more windows, read by each package's
    native loader; the tokens, the printed segments and words, and the
    rendered file equal the JAX CLI's."""
    tmp = files[0]
    outs = {}
    for package in ("jax", "port"):
        path = tmp / f"{package}.{fmt}"
        rc, out, _ = run(package, flags + ["--max-new", "6",
                                           "--output-format", fmt,
                                           "--output", str(path)])
        assert rc == 0
        outs[package] = (ast.literal_eval(_line(out, "tokens")),
                         [ln for ln in out.splitlines()
                          if ln.startswith(("[", "words:", "text:"))],
                         path.read_bytes())
    assert outs["port"] == outs["jax"]
    tokens = outs["port"][0]
    assert tokens.count(50258) >= 2           # long-form: two windows
    if fmt == "srt":
        assert outs["port"][2].startswith(b"1\n00:00:")


@pytest.mark.parametrize("fmt", ["text", "srt", "vtt", "tsv", "json"])
def test_output_formats_to_stdout(run, fmt):
    rc, out, _ = run("port", ["--max-new", "4", "--output-format", fmt],
                     audio="short.wav")
    assert rc == 0
    rendered = out.split("text:", 1)[1].split("\n", 1)[1]
    want = {"srt": "1\n00:00:00,000 --> 00:00:01,500\n",
            "vtt": "WEBVTT\n", "tsv": "start\tend\ttext\n0\t1500\t",
            "json": '{\n  "text": ', "text": ""}[fmt]
    assert rendered.startswith(want)


def test_mel_and_reference_detok_equal_jax(files, run):
    from whisper_tpu_torch.audio import log_mel_spectrogram, pad_or_trim
    from whisper_tpu_torch.native import load_audio
    tmp, target, _ = files
    wav = pad_or_trim(load_audio(str(tmp / "short.wav")), 480_000)
    mel = log_mel_spectrogram(torch.from_numpy(wav)[None], target[1])[0]
    mel.numpy().astype("<f4").tofile(tmp / "mel.bin")
    got = {}
    for package in ("jax", "port"):
        for extra in ([], ["--reference-detok"]):
            rc, out, _ = run(package, ["--mel", str(tmp / "mel.bin"),
                                       "--max-new", "5", *extra], audio=None)
            assert rc == 0
            got[package, bool(extra)] = (_line(out, "tokens"),
                                         _line(out, "text"))
    for ref in (False, True):
        assert got["port", ref] == got["jax", ref]
    rc, out, _ = run("port", ["--max-new", "5", "--no-quant"],
                     audio="short.wav")
    assert _line(out, "tokens") == got["port", False][0]


def test_draft_model_gives_greedy_tokens(files, run):
    """--draft-model with --draft-weights: the target's greedy tokens (the
    port's plain run), equal to the JAX CLI's speculative run."""
    tmp, _, draft = files
    flags = ["--max-new", "7", "--draft-model", draft[0].name,
             "--draft-weights", str(tmp / "d.npz"), "--draft-k", "3"]
    rc, out, _ = run("port", flags, audio="short.wav")
    assert rc == 0
    spec = _line(out, "tokens")
    assert "'verify_rounds'" in _line(out, "timings")
    rc, out_j, _ = run("jax", flags, audio="short.wav")
    assert rc == 0 and _line(out_j, "tokens") == spec
    rc, out, _ = run("port", ["--max-new", "7"], audio="short.wav")
    assert _line(out, "tokens") == spec


@pytest.mark.parametrize("flags,audio,message", [
    (["--beam", "2"], "short.wav", "plain greedy only"),
    (["--timestamps"], "short.wav", "plain greedy only"),
    ([], "long.wav", "one <=30 s window"),
])
def test_draft_model_errors_as_jax(files, run, capsys, flags, audio,
                                   message):
    tmp, _, draft = files
    for package in ("jax", "port"):
        with pytest.raises(SystemExit) as e:
            run(package, flags + ["--draft-model", draft[0].name,
                                  "--draft-weights", str(tmp / "d.npz")],
                audio=audio)
        assert e.value.code == 2
        assert message in capsys.readouterr().err


def test_draft_model_needs_weights(files, run, capsys):
    _, _, draft = files
    with pytest.raises(SystemExit):
        run("port", ["--draft-model", draft[0].name], audio="short.wav")
    assert "--draft-weights" in capsys.readouterr().err


def test_draft_model_self_kv_quant_warning(files, run):
    tmp, _, draft = files
    rc, out, err = run("port", ["--max-new", "4", "--dtype", "bfloat16",
                                "--self-kv-quant", "--draft-model",
                                draft[0].name, "--draft-weights",
                                str(tmp / "d.npz")], audio="short.wav")
    assert rc == 0
    assert "self_kv_quant disabled" in err


def test_every_jax_flag_exists_in_the_port(capsys):
    """Every option of whisper_tpu/cli.py's parser is one of the port's."""
    tree = ast.parse(open(os.path.join(_REPO, "whisper_tpu", "cli.py")
                          ).read())
    jax_flags = {node.args[0].value for node in ast.walk(tree)
                 if isinstance(node, ast.Call)
                 and getattr(node.func, "attr", "") == "add_argument"}
    assert len(jax_flags) >= 30
    with pytest.raises(SystemExit):
        cli.main(["--help"])
    port_help = capsys.readouterr().out
    missing = [f for f in sorted(jax_flags) if f not in port_help]
    assert not missing, missing
    assert "--device" in port_help
