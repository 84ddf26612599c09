"""The port's long-form driver (whisper_tpu_torch/serving_longform.py) on
the CPU: against JAX's LongFormDriver over JAX's engine on the same
weights (text, tokens, segments and windows, with timestamps and seek,
conditioning and the VAD gate), against the port's own
pipeline.transcribe, and the port counterparts of
tests/test_longform.py's driver tests. fp32 at nano width: everything is
compared for equality."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_tpu.decode_rules import DecodeOptions as JaxOptions
from whisper_tpu.models.whisper import init_params
from whisper_tpu.serving_continuous import ContinuousBatcher as JaxBatcher
from whisper_tpu.serving_longform import LongFormDriver as JaxDriver
from whisper_tpu_torch.decode_rules import DecodeOptions
from whisper_tpu_torch.pipeline import WhisperPipeline
from whisper_tpu_torch.serving_continuous import ContinuousBatcher
from whisper_tpu_torch.serving_longform import LongFormDriver
from whisper_tpu_torch.weights import from_jax_params

torch.set_num_threads(2)

SR = 16_000
MAX_NEW = 8


@pytest.fixture(scope="module")
def nano(small_cfg):
    """The nano weights of tests/test_torch_longform.py's pipelines under
    a name of their own."""
    cfg = small_cfg.replace(name="torch-lf-driver-nano")
    rng = np.random.RandomState(5)
    tree = jax.tree.map(
        lambda x: (np.asarray(x) + 0.02 * rng.randn(*np.shape(x))
                   ).astype(np.float32),
        init_params(cfg, jax.random.PRNGKey(0)))
    return cfg, tree, from_jax_params(tree)


def _clip(seconds: float, seed: int, silent=()) -> np.ndarray:
    """Seeded tones plus noise; each (start_s, end_s) of `silent` zeroed."""
    rng = np.random.RandomState(seed)
    t = np.arange(int(seconds * SR)) / SR
    x = (0.3 * np.sin(2 * np.pi * (220 + 40 * np.floor(t / 7)) * t)
         + 0.05 * rng.randn(t.size)).astype(np.float32)
    for a, b in silent:
        x[int(a * SR):int(b * SR)] = 0.0
    return x


def _audio(seed, seconds):
    rng = np.random.RandomState(seed)
    return (rng.randn(int(seconds * SR)) * 0.1).astype(np.float32)


AUDIO_70 = _clip(70.0, 0, silent=[(30.0, 60.0)])

# driver kwargs, and whether the engine decodes timestamps
MODES = {
    "fixed": (dict(condition_on_previous=False), False),
    "timestamps_seek": (dict(condition_on_previous=True), True),
    "condition_on_previous": (dict(condition_on_previous=True), False),
    "vad_silent_middle": (dict(condition_on_previous=True,
                               vad_threshold_db=-40.0), False),
}


def _run(driver, files):
    fids = [driver.submit(a, **kw) for a, kw in files]
    out = driver.run()
    return [out[f] for f in fids]


@pytest.mark.parametrize("mode", list(MODES))
def test_driver_matches_jax(nano, mode):
    """Two files at once (the 70 s clip with its silent middle, and 45 s
    of noise in French) through JAX's driver and the port's, on two slots:
    equal text, tokens, segments and windows per file."""
    cfg, tree, params = nano
    kw, ts = MODES[mode]
    files = [(AUDIO_70, {}), (_audio(9, 45.0), {"language": "fr"})]
    jeng = JaxBatcher(jax.tree.map(jnp.asarray, tree), cfg, max_slots=2,
                      max_new=MAX_NEW,
                      opts=JaxOptions(timestamps=True) if ts else None)
    want = _run(JaxDriver(jeng, **kw), files)
    eng = ContinuousBatcher(params, cfg, max_slots=2, max_new=MAX_NEW,
                            opts=DecodeOptions(timestamps=True) if ts
                            else None, device="cpu")
    got = _run(LongFormDriver(eng, **kw), files)
    for g, w in zip(got, want):
        assert g.text == w.text
        assert g.tokens == w.tokens
        assert g.segments == w.segments
        assert g.windows == w.windows
    if mode == "vad_silent_middle":
        assert got[0].windows == 2              # the 30-60 s window skipped
    elif mode == "timestamps_seek":
        assert got[0].segments                  # seek read closed segments
    else:
        assert got[0].windows == 3 and got[1].windows == 2


@pytest.mark.parametrize("mode", ["condition_on_previous", "timestamps_seek",
                                  "vad_silent_middle"])
def test_driver_matches_pipeline_transcribe(nano, mode):
    """The driver chains windows with pipeline.transcribe's semantics:
    the same text, tokens and segments for the same audio."""
    cfg, _, params = nano
    kw, ts = MODES[mode]
    pipe = WhisperPipeline(cfg, params, device="cpu")
    opts = pipe.make_options(timestamps=True) if ts else None
    ref = pipe.transcribe(AUDIO_70, max_new=MAX_NEW, opts=opts, **kw)
    eng = ContinuousBatcher(params, cfg, max_slots=2, max_new=MAX_NEW,
                            opts=opts, device="cpu")
    out = _run(LongFormDriver(eng, **kw), [(AUDIO_70, {})])[0]
    assert out.text == ref.text
    assert out.tokens == ref.tokens
    assert out.segments == ref.segments
    assert out.windows == ref.tokens.count(cfg.sot_token)


def test_concurrent_files_are_isolated(nano):
    """Two long files interleaving in the slot batch each produce exactly
    the text they produce when run alone."""
    cfg, _, params = nano
    solos = []
    for seed in (11, 12):
        eng = ContinuousBatcher(params, cfg, max_slots=1, max_new=6,
                                device="cpu")
        drv = LongFormDriver(eng, condition_on_previous=True)
        fid = drv.submit(_audio(seed, 2 * cfg.chunk_length_s))
        solos.append(drv.run()[fid].text)

    eng = ContinuousBatcher(params, cfg, max_slots=2, max_new=6,
                            device="cpu")
    drv = LongFormDriver(eng, condition_on_previous=True)
    fids = [drv.submit(_audio(seed, 2 * cfg.chunk_length_s))
            for seed in (11, 12)]
    out = drv.run()
    assert [out[f].text for f in fids] == solos


def test_tokens_contract_and_cancel(nano):
    """Result tokens keep each window's SOT-onward region (tokens[0] ==
    SOT); cancel() stops the window chain and retain_results=False prunes
    the file's state."""
    cfg, _, params = nano
    eng = ContinuousBatcher(params, cfg, max_slots=1, max_new=6,
                            device="cpu")
    drv = LongFormDriver(eng, retain_results=True)
    fid = drv.submit(_audio(5, 2 * cfg.chunk_length_s))
    out = drv.run()[fid]
    assert out.tokens[0] == cfg.sot_token
    assert out.tokens.count(cfg.sot_token) == out.windows == 2

    eng2 = ContinuousBatcher(params, cfg, max_slots=1, max_new=6,
                             device="cpu")
    drv2 = LongFormDriver(eng2, retain_results=False)
    seen = []
    fid2 = drv2.submit(_audio(6, 2 * cfg.chunk_length_s),
                       on_token=lambda f, t: (seen.append(t),
                                              drv2.cancel(f)))
    eng2.run_until_idle()
    assert seen                           # the first window produced tokens
    assert fid2 not in drv2._files        # pruned after cancellation
    assert not eng2._queue                # no second window submitted


def test_later_windows_bypass_admission_and_callbacks_fire(nano):
    """Windows after a file's first are admitted past max_queue; the
    callback gets the whole result once, and on_token streams every
    window's generated tokens in order."""
    cfg, _, params = nano
    eng = ContinuousBatcher(params, cfg, max_slots=1, max_new=4,
                            max_queue=1, device="cpu")
    drv = LongFormDriver(eng, condition_on_previous=True,
                         retain_results=False)
    done, streamed = [], []
    fid = drv.submit(_audio(7, 65.0), callback=lambda f, r: done.append(
        (f, r)), on_token=lambda f, t: streamed.append(t))
    eng.run_until_idle()
    assert len(done) == 1 and done[0][0] == fid
    res = done[0][1]
    assert res.windows == 3 and not drv._files
    gen, i = [], 0
    while i < len(res.tokens):                # drop each window's prompt
        assert res.tokens[i:i + 4] == [50258, 50259, 50359, 50363]
        gen += res.tokens[i + 4:i + 4 + 4 + 1]
        i += 4 + 4 + 1
    assert streamed == gen
