"""The port's audio input against the JAX package's: pipeline.load_wav
(scipy FFT resampling, exact), and the port's own ctypes binding of
native/whisper_native.cpp (decode_wav, resample, load_audio) bit for bit
against whisper_tpu.native, which compiles the same source with the same
flags. The port's library is built under whisper_tpu_torch/_build/."""

import shutil
import struct

import numpy as np
import pytest

from whisper_tpu import native as jax_native
from whisper_tpu import pipeline as jax_pipeline
from whisper_tpu_torch import native
from whisper_tpu_torch import pipeline

needs_gxx = pytest.mark.skipif(shutil.which("g++") is None,
                               reason="g++ is not installed")


@pytest.fixture(scope="module", autouse=True)
def _jax_native_loaded():
    """whisper_tpu.native builds its library in place on first use, and
    test workers that collect at once may build it together; a worker that
    loaded it mid-write keeps it unavailable for good. Load it once more
    now that every build has finished."""
    if not jax_native.available():
        jax_native._tried = False
        jax_native.available()


def _wav_bytes(x: np.ndarray, rate: int, fmt: str = "pcm16") -> bytes:
    """A RIFF/WAVE file of x ((n,) or (n, channels) in [-1, 1]) as 8-, 16-,
    24- or 32-bit PCM or 32-bit float."""
    x = np.asarray(x, np.float64)
    if x.ndim == 1:
        x = x[:, None]
    channels = x.shape[1]
    if fmt == "float32":
        tag, bits = 3, 32
        data = x.astype("<f4").tobytes()
    elif fmt == "pcm8":
        tag, bits = 1, 8
        data = np.clip(np.round(x * 127 + 128), 0, 255).astype(np.uint8
                                                                 ).tobytes()
    elif fmt == "pcm24":
        tag, bits = 1, 24
        v = np.clip(np.round(x * 8388607), -8388608, 8388607).astype("<i4")
        data = b"".join(int(s).to_bytes(3, "little", signed=True)
                        for s in v.reshape(-1))
    else:
        tag, bits = 1, int(fmt[3:])
        scale = {16: 32767, 32: 2147483647}[bits]
        data = np.round(x * scale).astype(f"<i{bits // 8}").tobytes()
    block = channels * bits // 8
    fmt_chunk = struct.pack("<HHIIHH", tag, channels, rate, rate * block,
                            block, bits)
    body = (b"WAVE" + b"fmt " + struct.pack("<I", len(fmt_chunk)) + fmt_chunk
            + b"data" + struct.pack("<I", len(data)) + data)
    return b"RIFF" + struct.pack("<I", len(body)) + body


def _signal(seconds: float, rate: int, channels: int = 1, seed: int = 0):
    """The 0.3-amplitude 440 Hz tone plus noise, per channel."""
    rng = np.random.RandomState(seed)
    t = np.arange(int(seconds * rate)) / rate
    x = np.stack([0.3 * np.sin(2 * np.pi * (440 + 110 * c) * t)
                  + 0.05 * rng.randn(t.size) for c in range(channels)], 1)
    return x if channels > 1 else x[:, 0]


@pytest.mark.parametrize("rate", [22_050, 44_100, 8_000, 16_000])
@pytest.mark.parametrize("channels,fmt", [(1, "pcm16"), (2, "pcm16"),
                                          (1, "pcm32"), (2, "pcm8")])
def test_load_wav_resamples_as_jax(tmp_path, rate, channels, fmt):
    """pipeline.load_wav equals JAX's exactly: the same scipy.signal.resample
    on the same float32 samples (the port once interpolated linearly, a
    max |diff| of 0.099 on a 22.05 kHz tone)."""
    path = tmp_path / "clip.wav"
    path.write_bytes(_wav_bytes(_signal(2.0, rate, channels), rate, fmt))
    got = pipeline.load_wav(str(path))
    want = jax_pipeline.load_wav(str(path))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert len(got) == int(len(_signal(2.0, rate, channels)) * 16_000 / rate)


@needs_gxx
def test_library_builds_beside_the_port():
    assert native.available()
    assert native.LIB.exists()
    assert native.LIB.parent.name == "_build"
    assert native.LIB.parent.parent.name == "whisper_tpu_torch"
    assert native.LIB.resolve() != __import__("pathlib").Path(
        jax_native._LIB).resolve()


@needs_gxx
@pytest.mark.parametrize("fmt", ["pcm8", "pcm16", "pcm24", "pcm32",
                                 "float32"])
@pytest.mark.parametrize("channels", [1, 2, 3])
def test_decode_wav_equals_jax(fmt, channels):
    data = _wav_bytes(_signal(0.3, 22_050, channels, seed=channels), 22_050,
                      fmt)
    got, rate = native.decode_wav(data)
    want, want_rate = jax_native.decode_wav(data)
    assert rate == want_rate == 22_050
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@needs_gxx
@pytest.mark.parametrize("in_rate,out_rate", [
    (22_050, 16_000), (44_100, 16_000), (48_000, 16_000), (8_000, 16_000),
    (16_000, 16_000), (11_025, 22_050), (16_000, 44_100)])
def test_resample_equals_jax(in_rate, out_rate):
    x = _signal(1.3, in_rate, seed=in_rate % 97).astype(np.float32)
    got = native.resample(x, in_rate, out_rate)
    np.testing.assert_array_equal(got,
                                  jax_native.resample(x, in_rate, out_rate))
    assert abs(len(got) - len(x) * out_rate / in_rate) <= 1


@needs_gxx
@pytest.mark.parametrize("rate,fmt,seconds", [
    (22_050, "pcm16", 45.0), (44_100, "float32", 3.0), (16_000, "pcm24",
                                                          2.0)])
def test_load_audio_equals_jax(tmp_path, rate, fmt, seconds):
    path = tmp_path / "clip.wav"
    path.write_bytes(_wav_bytes(_signal(seconds, rate, 2), rate, fmt))
    got = native.load_audio(str(path))
    np.testing.assert_array_equal(got, jax_native.load_audio(str(path)))
    assert abs(len(got) - seconds * 16_000) <= 1


@needs_gxx
def test_rejected_file_raises_as_jax(tmp_path):
    """A header the native decoder rejects raises ValueError; load_audio
    then hands the file to pipeline.load_wav, which raises what JAX's
    load_wav raises."""
    junk = b"RIFF\0\0\0\0WAVEjunk" + bytes(40)
    with pytest.raises(ValueError):
        native.decode_wav(junk)
    path = tmp_path / "junk.wav"
    path.write_bytes(junk)
    with pytest.raises(Exception) as want:
        jax_native.load_audio(str(path))
    with pytest.raises(want.type):
        native.load_audio(str(path))


def test_fallback_without_the_library(tmp_path, monkeypatch):
    path = tmp_path / "clip.wav"
    path.write_bytes(_wav_bytes(_signal(1.0, 22_050), 22_050))
    monkeypatch.setattr(native, "_load", lambda: None)
    assert not native.available()
    np.testing.assert_array_equal(native.load_audio(str(path)),
                                  pipeline.load_wav(str(path)))
    with pytest.raises(RuntimeError, match="unavailable"):
        native.resample(np.zeros(10, np.float32), 8_000, 16_000)
    with pytest.raises(RuntimeError, match="unavailable"):
        native.decode_wav(path.read_bytes())


# ---- MappedWeights and NativeDetokenizer (whisper_tpu/native.py:156-230)

@needs_gxx
def test_native_detokenizer_matches_jax_and_tokenizer():
    """tests/test_native.py:87's case against the JAX binding and the
    port's Tokenizer: byte-level and reference decoding of seeded ids,
    specials skipped and kept."""
    from whisper_tpu_torch.tokenizer import Tokenizer
    vocab = "whisper_tpu_torch/assets/vocab.txt"
    nd = native.NativeDetokenizer(vocab)
    jd = jax_native.NativeDetokenizer("whisper_tpu/assets/vocab.txt")
    tok = Tokenizer(vocab)
    assert nd.vocab_size == jd.vocab_size == tok.vocab_size
    rng = np.random.RandomState(3)
    for n in (0, 1, 30, 300):
        for _ in range(5):
            ids = rng.randint(0, tok.vocab_size, size=n).tolist()
            assert nd.decode(ids) == jd.decode(ids) == tok.decode(ids)
            assert (nd.decode(ids, reference_mode=True)
                    == jd.decode(ids, reference_mode=True)
                    == tok.decode_reference(ids))
            assert (nd.decode(ids, skip_special=False)
                    == jd.decode(ids, skip_special=False))
    nd.close()
    nd.close()                                  # a second close is a no-op


def test_native_detokenizer_needs_the_library(monkeypatch):
    monkeypatch.setattr(native, "_load", lambda: None)
    with pytest.raises(RuntimeError, match="unavailable"):
        native.NativeDetokenizer("whisper_tpu_torch/assets/vocab.txt")


@pytest.mark.parametrize("with_library", [True, False])
def test_mapped_weights_zero_copy_matches_read(tmp_path, monkeypatch,
                                               with_library):
    """tests/test_native.py:100's case, by the native map and by the
    np.memmap fallback, against the JAX binding's view."""
    if with_library and shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    if not with_library:
        monkeypatch.setattr(native, "_load", lambda: None)
    data = np.random.RandomState(4).randn(1000).astype("<f4")
    p = tmp_path / "w.bin"
    p.write_bytes(data.tobytes())
    with native.MappedWeights(str(p)) as m, \
            jax_native.MappedWeights(str(p)) as jm:
        assert (m._addr is not None) == with_library
        np.testing.assert_array_equal(np.asarray(m.floats), data)
        np.testing.assert_array_equal(np.asarray(m.floats),
                                      np.asarray(jm.floats))
    assert m.floats is None and m._addr is None


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("with_library", [True, False])
def test_flat_bin_path_loader_reads_through_the_map(tmp_path, monkeypatch,
                                                    with_library):
    """tests/test_native.py:109's case: to_flat_bin, then
    from_flat_bin_path through MappedWeights gives the same tree as JAX's
    loader on the same file, and every param is read after the map is
    closed (none aliases it)."""
    import jax

    from whisper_tpu.config import get_config
    from whisper_tpu.models.whisper import init_params
    from whisper_tpu.weights import from_flat_bin_path as jax_from_path
    from whisper_tpu.weights import to_flat_bin
    from whisper_tpu_torch import weights

    if with_library and shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    if not with_library:
        monkeypatch.setattr(native, "_load", lambda: None)
    cfg = get_config("tiny").replace(
        name="torch-native-nano", d_model=64, n_heads=2, n_audio_layers=1,
        n_text_layers=1, n_audio_ctx=8, n_text_ctx=8, vocab_size=256,
        n_mels=4, eot_token=250, n_languages=2)
    p = tmp_path / "w.bin"
    p.write_bytes(to_flat_bin(init_params(cfg, jax.random.PRNGKey(0)), cfg))
    maps = []
    real = native.MappedWeights

    class Recorded(real):
        def __init__(self, path):
            super().__init__(path)
            maps.append(self)

    monkeypatch.setattr(native, "MappedWeights", Recorded)
    got = weights.from_flat_bin_path(str(p), cfg)
    assert len(maps) == 1 and maps[0].floats is None     # closed on return
    assert (maps[0]._size > 0 if with_library else True)
    want = jax.tree_util.tree_map(np.asarray, jax_from_path(str(p), cfg))
    got_leaves, want_leaves = list(_leaves(got)), list(_leaves(want))
    assert [k for k, _ in got_leaves] == [k for k, _ in want_leaves]
    for (k, a), (_, b) in zip(got_leaves, want_leaves):
        np.testing.assert_array_equal(a.numpy(), b, err_msg=k)
    with pytest.raises(ValueError, match="does not match"):
        weights.from_flat_bin_path(str(p), cfg.replace(n_text_ctx=9))
