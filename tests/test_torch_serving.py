"""The port's dynamic batcher (whisper_tpu_torch/serving.py) on the CPU:
against JAX's BatchedTranscriber on the same weights and requests, and the
port counterparts of tests/test_serving.py. The nano config has a name of
its own, so the JAX stages traced here are this file's alone."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_tpu.config import get_config
from whisper_tpu.models.whisper import init_params
from whisper_tpu.serving import BatchedTranscriber as JaxTranscriber
from whisper_tpu_torch import serving as serving_mod
from whisper_tpu_torch.serving import BatchedTranscriber
from whisper_tpu_torch.weights import from_jax_params

torch.set_num_threads(2)

MAX_NEW = 6


@pytest.fixture(scope="module")
def nano():
    """tests/test_serving.py's nano config under its own name, with the
    JAX init plus seeded noise (non-zero biases and LayerNorm parameters
    make the tokens depend on the audio)."""
    cfg = get_config("tiny").replace(
        name="torch-serve-nano", d_model=64, n_heads=2,
        n_audio_layers=2, n_text_layers=2,
        n_audio_ctx=1500, n_text_ctx=448)
    rng = np.random.RandomState(2)
    np_tree = jax.tree.map(
        lambda x: (np.asarray(x) + 0.05 * rng.randn(*np.shape(x))
                   ).astype(np.float32),
        init_params(cfg, jax.random.PRNGKey(0)))
    return cfg, np_tree, from_jax_params(np_tree)


@pytest.fixture(scope="module")
def server(nano, request):
    cfg, _, params = nano
    bt = BatchedTranscriber(params, cfg, max_batch=4, max_wait_ms=30,
                            max_new=MAX_NEW, device="cpu")
    request.addfinalizer(bt.close)
    return bt


def _audio(seed, seconds=2.0, rate=16_000):
    rng = np.random.RandomState(seed)
    return (rng.randn(int(seconds * rate)) * 0.1).astype(np.float32)


def test_matches_jax_batcher(nano, server):
    """The same requests through JAX's batcher and the port's, submitted
    together: equal tokens and text, per request; a 70 s request splits
    into three windows on both."""
    cfg, np_tree, _ = nano
    jbt = JaxTranscriber(jax.tree.map(jnp.asarray, np_tree), cfg,
                         max_batch=4, max_wait_ms=30, max_new=MAX_NEW)
    try:
        reqs = [(_audio(1), "en"), (_audio(2, 7.5), "en"),
                (_audio(3, 30.0), "fr"), (_audio(4, 70.0), "en"),
                (np.zeros(16_000, np.float32), "en")]
        want = [f.result(timeout=300) for f in
                [jbt.submit(a, language=lang) for a, lang in reqs]]
    finally:
        jbt.close()
    got = [f.result(timeout=300) for f in
           [server.submit(a, language=lang) for a, lang in reqs]]
    for g, w in zip(got, want):
        assert g.tokens == w.tokens
        assert g.text == w.text
    assert got[3].tokens.count(cfg.sot_token) == 3
    assert len({tuple(g.tokens) for g in got}) >= 3   # audio-dependent


def test_single_request(server):
    r = server.transcribe(_audio(0))
    assert isinstance(r.text, str)
    assert len(r.tokens) >= 4            # at least the prompt
    assert r.tokens[0] == server.cfg.sot_token
    assert r.batch_size == 1


def test_concurrent_requests_share_batches(server):
    futs = [server.submit(_audio(i)) for i in range(8)]
    results = [f.result(timeout=300) for f in futs]
    assert all(isinstance(r.text, str) for r in results)
    assert max(r.batch_size for r in results) >= 2


def test_batched_equals_individual(server):
    """A request's tokens do not depend on its batch neighbours."""
    a = _audio(42)
    solo = server.transcribe(a)
    futs = [server.submit(_audio(100 + i)) for i in range(3)]
    shared = server.submit(a)
    _ = [f.result(timeout=300) for f in futs]
    assert shared.result(timeout=300).tokens == solo.tokens


def test_error_propagates_not_hangs(server):
    r = server.transcribe(np.full(1000, np.nan, np.float32))
    assert isinstance(r.tokens, list)


def test_close_rejects_new_requests(nano):
    cfg, _, params = nano
    bt = BatchedTranscriber(params, cfg, max_batch=2, max_new=2,
                            device="cpu")
    bt.close()
    assert not bt._worker.is_alive()
    with pytest.raises(RuntimeError):
        bt.submit(_audio(0))


def test_mixed_prompt_lengths_fail_loudly(server, monkeypatch):
    """A request whose prompt length differs from the batch's errors; it
    never decodes under another request's prompt."""
    real = serving_mod.build_prompt

    def fake(cfg, language="en", task="transcribe", timestamps=False,
             prev_tokens=()):
        ids = real(cfg, language, task, timestamps, prev_tokens)
        if language == "fr":
            ids = ids + [ids[-1]]      # force a longer prompt
        return ids

    monkeypatch.setattr(serving_mod, "build_prompt", fake)
    ok = server.submit(_audio(7), language="en")
    odd = server.submit(_audio(8), language="fr")
    assert isinstance(ok.result(timeout=300).tokens, list)
    with pytest.raises(ValueError, match="prompt length"):
        odd.result(timeout=300)


def test_long_audio_splits_into_windows(server):
    """Audio past 30 s is split into windows and joined in order, not
    truncated."""
    cfg = server.cfg
    rng = np.random.RandomState(3)
    audio = (rng.randn(int(2.2 * cfg.n_samples)) * 0.1).astype(np.float32)
    short = server.transcribe(audio[:cfg.n_samples])
    full = server.transcribe(audio)
    assert full.tokens[:len(short.tokens)] == short.tokens
    assert full.tokens.count(cfg.sot_token) == 3     # 3 windows
    assert full.text.startswith(short.text)


def test_fixed_batch_shape_padded_with_silence(nano, monkeypatch):
    """Every batch runs at max_batch rows: the real requests first, then
    silence rows under the first request's prompt; batch_size counts the
    real rows."""
    cfg, _, params = nano
    bt = BatchedTranscriber(params, cfg, max_batch=3, max_wait_ms=200,
                            max_new=2, device="cpu")
    seen = []
    real = bt._transcribe_batch

    def recorded(audio, prompts):
        seen.append((audio.clone(), prompts.clone()))
        return real(audio, prompts)

    bt._transcribe_batch = recorded
    try:
        futs = [bt.submit(_audio(s, 1.0), language=lang)
                for s, lang in ((5, "de"), (6, "de"))]
        res = [f.result(timeout=300) for f in futs]
    finally:
        bt.close()
    assert len(seen) == 1
    audio, prompts = seen[0]
    assert audio.shape == (3, cfg.n_samples) and prompts.shape[0] == 3
    assert torch.equal(audio[2], torch.zeros(cfg.n_samples))
    assert torch.equal(prompts[2], prompts[0])
    assert torch.equal(audio[0, :16_000], torch.from_numpy(_audio(5, 1.0)))
    assert [r.batch_size for r in res] == [2, 2]


def test_batch_failure_fails_its_requests_and_serving_goes_on(nano):
    """A failure inside a batch (a kernel's refusal, say) fails every
    request of that batch; the worker serves the next one."""
    cfg, _, params = nano
    bt = BatchedTranscriber(params, cfg, max_batch=2, max_new=2,
                            device="cpu")
    real = bt._transcribe_batch
    fail = {"on": True}

    def flaky(audio, prompts):
        if fail["on"]:
            raise RuntimeError("kernel refused")
        return real(audio, prompts)

    bt._transcribe_batch = flaky
    try:
        with pytest.raises(RuntimeError, match="kernel refused"):
            bt.transcribe(_audio(0))
        fail["on"] = False
        assert bt.transcribe(_audio(0)).tokens[0] == cfg.sot_token
    finally:
        bt.close()


def test_bad_language_fails_on_the_callers_thread(server):
    with pytest.raises(ValueError, match="unknown language"):
        server.submit(_audio(0), language="zz")
    with pytest.raises(ValueError, match="unknown task"):
        server.submit(_audio(0), task="summarize")
    assert server.transcribe(_audio(0)).tokens[0] == server.cfg.sot_token


def test_cuda_is_the_default_device(nano):
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device exists")
    cfg, _, params = nano
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BatchedTranscriber(params, cfg, max_batch=2)
