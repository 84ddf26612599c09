"""Temperature sampling in the port: the pick's draw (decode.sample_gumbel
from a torch.Generator) and the engine's counter-based draw
(serving_continuous.hashed_gumbel) against softmax(logits / T), masked
tokens, determinism per seed, and the engine's per-request streams, on
the CPU. No generator of the port reproduces jax.random: the tests hold
the distribution and the determinism, not JAX's draws."""

import jax
import numpy as np
import pytest
import torch
from scipy.stats import chisquare

from whisper_tpu.models.whisper import init_params
from whisper_tpu_torch.decode import (
    _pick,
    gumbel_noise,
    greedy_decode,
    sample_gumbel,
)
from whisper_tpu_torch.decode_rules import (
    NEG,
    DecodeOptions,
    apply_rules,
    non_speech_tokens,
)
from whisper_tpu_torch.serving_continuous import (
    _MASK32,
    ContinuousBatcher,
    _mix32,
    hashed_gumbel,
)
from whisper_tpu_torch.tokenizer import Tokenizer, build_prompt
from whisper_tpu_torch.weights import from_jax_params, to_device

torch.set_num_threads(2)
DRAWS = 20_000


def _row(seed=0, V=12):
    """A fixed logits row with two masked tokens."""
    row = torch.from_numpy(np.random.RandomState(seed).randn(V) * 2.0
                           ).float()
    row[[3, 8]] = NEG
    return row


def _chi2_pvalue(tokens: torch.Tensor, logits: torch.Tensor, T: float):
    """Chi-square p-value of the drawn tokens against softmax(logits / T),
    bins with an expected count under 5 merged; masked tokens must not be
    drawn at all."""
    V = logits.shape[-1]
    probs = torch.softmax(logits.double() / T, dim=-1).numpy()
    counts = np.bincount(tokens.numpy(), minlength=V)
    assert counts[probs == 0].sum() == 0, "a masked token was drawn"
    expected = probs * counts.sum()
    big = expected >= 5
    obs = np.append(counts[big], counts[~big].sum())
    exp = np.append(expected[big], expected[~big].sum())
    if exp[-1] == 0:
        obs, exp = obs[:-1], exp[:-1]
    return chisquare(obs, exp).pvalue


@pytest.mark.parametrize("T", [0.5, 1.0, 1.7])
def test_pick_draws_follow_softmax(T):
    row = _row()
    g = torch.Generator().manual_seed(11)
    tokens = sample_gumbel(row.expand(DRAWS, -1), T, g)
    assert _chi2_pvalue(tokens, row, T) > 1e-3


@pytest.mark.parametrize("axis", ["seed", "pos"])
@pytest.mark.parametrize("T", [0.5, 1.0])
def test_engine_draws_follow_softmax(axis, T):
    """The engine's hashed noise, over 20,000 seeds at one position or
    20,000 positions of one seed."""
    row = _row(seed=3)
    n = torch.arange(DRAWS)
    seed, pos = (n, torch.full_like(n, 7)) if axis == "seed" else \
        (torch.full_like(n, 5), n)
    g = hashed_gumbel(seed, pos, row.shape[-1])
    tokens = (row / T + g).argmax(dim=-1)
    assert _chi2_pvalue(tokens, row, T) > 1e-3


def test_engine_noise_is_a_function_of_seed_pos_token():
    seed = torch.tensor([1, 1, 2, 1])
    pos = torch.tensor([4, 4, 4, 5])
    g = hashed_gumbel(seed, pos, 50)
    assert torch.equal(g[0], g[1])
    assert not torch.equal(g[0], g[2]) and not torch.equal(g[0], g[3])
    assert torch.isfinite(g).all()
    # seeds are taken modulo 2**32, as the engine stores them
    assert torch.equal(hashed_gumbel(torch.tensor([2**32 + 1]),
                                     torch.tensor([4]), 50)[0], g[0])


def test_gumbel_noise_is_finite_at_every_24_bit_uniform():
    """Every U the samplers make (torch.rand's and the hash's: k * 2**-24,
    k < 2**24) gives finite noise, the top one included."""
    u = torch.arange(1 << 24, dtype=torch.int32).float() * (1.0 / (1 << 24))
    g = gumbel_noise(u)
    assert torch.isfinite(g).all()
    assert -4.5 < float(g.min()) and float(g.max()) < 16.7
    assert float(g[-1]) == float(g.max())


def _unmix32(y: int) -> int:
    """The inverse of serving_continuous._mix32 on one 32-bit value."""
    inv = pow(0x45D9F3B, -1, 1 << 32)
    for _ in range(2):
        y = ((y ^ (y >> 16)) * inv) & _MASK32
    return y ^ (y >> 16)


def _seed_with_top_hash(pos: int, token: int) -> int:
    """The seed whose hash at (pos, token) is 2**32 - 1: the largest U."""
    tok = int(_mix32(torch.tensor(token)))
    row = _unmix32(_MASK32) ^ tok
    return _unmix32(_unmix32(row) ^ pos)


def test_top_hash_never_draws_a_masked_token(small_cfg):
    """At the full vocabulary, a seed that gives EOT the largest hash at a
    position: EOT's noise is the largest finite value, and with EOT masked
    it is not drawn."""
    cfg = small_cfg
    seed = _seed_with_top_hash(4, cfg.eot_token)
    g = hashed_gumbel(torch.tensor([seed]), torch.tensor([4]), cfg.vocab_size)
    assert torch.isfinite(g).all()
    assert int(g[0].argmax()) == cfg.eot_token
    row = torch.zeros(1, cfg.vocab_size)
    row[0, cfg.eot_token] = NEG
    assert int((row + g).argmax()) != cfg.eot_token


@pytest.fixture(scope="module")
def nano(small_cfg):
    cfg = small_cfg
    rng = np.random.RandomState(2)
    tree = jax.tree.map(
        lambda x: (np.asarray(x) + 0.02 * rng.randn(*np.shape(x))
                   ).astype(np.float32),
        init_params(cfg, jax.random.PRNGKey(0)))
    params = from_jax_params(tree)
    enc = torch.from_numpy(rng.randn(2, cfg.n_audio_ctx, cfg.d_model
                                     ).astype(np.float32))
    prompt = torch.tensor([build_prompt(cfg)] * 2)
    return cfg, params, enc, prompt


def test_pick_masks_rules_and_scores_unscaled(nano):
    """The rules' masked tokens are never drawn; the draw is
    sample_gumbel's on the ruled logits; the logprob is the unscaled
    log-softmax at the drawn token."""
    cfg = nano[0]
    B, T = 64, 1.3
    opts = DecodeOptions(temperature=T, suppress_tokens=tuple(range(0, 500)))
    logits = torch.from_numpy(np.random.RandomState(5).randn(
        B, 1, cfg.vocab_size).astype(np.float32) * 3.0)
    tokens = torch.full((B, 10), cfg.eot_token)
    tokens[:, :4] = torch.tensor(build_prompt(cfg))
    nxt, lp = _pick(logits, None, opts, cfg, tokens, 4, 4,
                    torch.Generator().manual_seed(1))
    assert ((nxt >= 500) & (nxt < cfg.timestamp_begin)).all()
    assert (nxt != cfg.eot_token).all() and (nxt != 220).all()
    ruled = apply_rules(logits[:, -1], tokens, 4, 4, cfg, opts)
    want = sample_gumbel(ruled, T, torch.Generator().manual_seed(1))
    assert torch.equal(nxt, want)
    torch.testing.assert_close(
        lp, torch.log_softmax(ruled, -1).gather(-1, nxt[:, None])[:, 0])


def test_temperature_zero_is_greedy(nano):
    cfg, params, enc, prompt = nano
    params = to_device(params, "cpu")
    base = greedy_decode(params, cfg, enc, prompt, max_new=8)
    zero = greedy_decode(params, cfg, enc, prompt, max_new=8,
                         opts=DecodeOptions(suppress_blank=False),
                         generator=torch.Generator().manual_seed(3))
    assert torch.equal(base.tokens, zero.tokens)


def test_sampling_is_seeded_and_varies(nano):
    cfg, params, enc, prompt = nano
    params = to_device(params, "cpu")
    opts = DecodeOptions(temperature=1.0, suppress_blank=False,
                         suppress_tokens=(cfg.eot_token,))

    def run(seed):
        return greedy_decode(params, cfg, enc, prompt, max_new=8, opts=opts,
                             generator=torch.Generator().manual_seed(seed))
    a, b, c = run(0), run(0), run(1)
    assert torch.equal(a.tokens, b.tokens)
    assert torch.equal(a.sum_logprobs, b.sum_logprobs)
    assert not torch.equal(a.tokens, c.tokens)
    gen = a.tokens[:, 4:]
    assert ((gen < cfg.timestamp_begin) & (gen != cfg.eot_token)).all()
    with pytest.raises(ValueError, match="Generator"):
        greedy_decode(params, cfg, enc, prompt, max_new=2, opts=opts)


def _audio(seed, seconds=1.5):
    rng = np.random.RandomState(seed)
    return (rng.randn(int(seconds * 16_000)) * 0.1).astype(np.float32)


def test_engine_streams_are_per_request(nano):
    """A request's samples depend only on its own seed and position: the
    same in a one-slot engine and in a crowded one, whatever its slot;
    another seed gives another stream (tests/test_continuous.py:139)."""
    cfg, params, _, _ = nano
    opts = DecodeOptions(temperature=1.0, suppress_blank=False)

    solo = ContinuousBatcher(params, cfg, max_slots=1, max_new=6, opts=opts,
                             device="cpu")
    r = solo.submit(_audio(9), seed=123)
    ref = solo.run_until_idle()[r]

    crowd = ContinuousBatcher(params, cfg, max_slots=3, max_new=6, opts=opts,
                              device="cpu")
    crowd.submit(_audio(1), seed=7)
    crowd.submit(_audio(2))                      # seed = its request id
    mine = crowd.submit(_audio(9), seed=123)
    other = crowd.submit(_audio(9), seed=999)   # waits for a free slot
    out = crowd.run_until_idle()
    assert out[mine] == ref
    assert out[other] != ref
    assert len(ref) == 4 + 1 + 6 or ref[-1] == cfg.eot_token


def test_engine_never_draws_a_masked_token(nano):
    """The engine at the full vocabulary with EOT and the non-speech set
    suppressed: no generated token is masked, for seeds that include one
    giving EOT the largest hash at the first generated position."""
    cfg, params, _, _ = nano
    banned = set(non_speech_tokens(cfg, Tokenizer())) | {cfg.eot_token}
    opts = DecodeOptions(temperature=1.0, suppress_blank=False,
                         suppress_tokens=tuple(sorted(banned)))
    P = len(build_prompt(cfg))
    eng = ContinuousBatcher(params, cfg, max_slots=3, max_new=5, opts=opts,
                            device="cpu")
    rids = [eng.submit(_audio(i), seed=s) for i, s in enumerate(
        (_seed_with_top_hash(P, cfg.eot_token), 0, 1, 2))]
    out = eng.run_until_idle()
    for r in rids:
        gen = out[r][P:]
        assert len(gen) == 6
        assert not banned & set(gen) and max(gen) < cfg.eot_token
