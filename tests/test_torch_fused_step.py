"""The port's fused decoder step (whisper_tpu_torch/ops/decoder_step.py and
its gate in decode.py) against the JAX package's, on the CPU at the nano
width (d=64, 2 heads of 32, 2 + 2 layers): the plain version against
JAX's Pallas kernel in interpret mode (as tests/test_fused_step.py runs
it), chained steps, greedy tokens, the gate (JAX's answer on the CPU, the
auto policy on a CUDA device) and the packing; and a deeper nano decoder
(6 layers of head_dim 64) teacher-forced through the fused step's plain
version against the unfused step."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_tpu import decode as jax_decode
from whisper_tpu.models.whisper import decoder_forward as jax_decoder_forward
from whisper_tpu.models.whisper import init_kv_cache as jax_init_kv_cache
from whisper_tpu.models.whisper import init_params as jax_init_params
from whisper_tpu.models.whisper import (
    precompute_cross_kv as jax_precompute_cross_kv,
)
from whisper_tpu.ops.decoder_step import fused_decoder_step as jax_fused_step
from whisper_tpu.ops.decoder_step import pack_misc, split_weights
from whisper_tpu.tokenizer import build_prompt
from whisper_tpu.weights import to_device as jax_to_device
from whisper_tpu_torch import decode, get_config
from whisper_tpu_torch.decode import greedy_decode
from whisper_tpu_torch.ops.decoder_step import (
    PHASES,
    fused_decoder_step,
    fused_decoder_step_plain,
    pack_decoder_weights,
    stamp_pairs,
    vec_offsets,
)
from whisper_tpu_torch.weights import from_jax_params, to_device

torch.set_num_threads(2)

# fp32: JAX's own bound for the fused step against the XLA path
# (tests/test_fused_step.py:52-59); bf16: its bf16 bound (:98-100), about
# one bf16 ulp of O(1) values where the two sum in other orders
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _perturbed_tree(cfg, key: int, seed: int) -> dict:
    """JAX-initialised params as a numpy tree, with non-trivial decoder
    biases and LayerNorm parameters (a random init's are zeros and
    ones)."""
    tree = jax.tree.map(np.asarray,
                        jax_init_params(cfg, jax.random.PRNGKey(key)))
    rng = np.random.RandomState(seed)

    def perturb(sub):
        for name, leaf in sub.items():
            if isinstance(leaf, dict):
                perturb(leaf)
            elif name == "b":
                sub[name] = (0.1 * rng.randn(*leaf.shape)).astype(np.float32)
            elif name == "g":
                sub[name] = (1 + 0.2 * rng.randn(*leaf.shape)
                             ).astype(np.float32)
    perturb(tree["decoder"]["layers"])
    return tree


@pytest.fixture(scope="module")
def nano(small_cfg):
    """Nano params with non-trivial biases and LayerNorm parameters, as a
    numpy tree."""
    return small_cfg, _perturbed_tree(small_cfg, 11, 12)


def _jax_tree(tree, dtype: str):
    jt = jax.tree.map(jnp.asarray, tree)
    return jt if dtype == "float32" else jax_to_device(jt, jnp.bfloat16)


def _port_tree(tree, dtype: str):
    return to_device(from_jax_params(tree), "cpu",
                     None if dtype == "float32" else torch.bfloat16)


def _head_outer(x: np.ndarray) -> np.ndarray:
    """(L, B, H, S, D) -> JAX's kernel layout (L, H*B, S, D)."""
    L, B, H, S, D = x.shape
    return x.transpose(0, 2, 1, 3, 4).reshape(L, H * B, S, D)


def _from_head_outer_rows(x: np.ndarray, B: int) -> np.ndarray:
    """JAX's (L, H*B, D) rows -> the port's (L, B, H, D)."""
    L, HB, D = x.shape
    return x.reshape(L, HB // B, B, D).transpose(0, 2, 1, 3)


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B", [2, 3])
@pytest.mark.parametrize("pos", [0, 5, 447])
def test_plain_step_matches_jax_interpret(nano, dtype, B, pos):
    """h_out, k_new and v_new of one step over random caches: the port's
    fused_decoder_step (its plain version on the CPU) against JAX's kernel
    in interpret mode on the same operands, at pos 0 (no cache row read),
    5 and 447 (the last slot of the 448-slot cache)."""
    cfg, tree = nano
    tdt, jdt = DTYPES[dtype]
    L, H, D, d = cfg.n_text_layers, cfg.n_heads, cfg.head_dim, cfg.d_model
    rng = np.random.RandomState(100 * B + pos)
    h0 = rng.randn(B, d).astype(np.float32)
    sk, sv = (rng.randn(L, B, H, cfg.n_text_ctx, D).astype(np.float32)
              for _ in range(2))
    ck, cv = (rng.randn(L, B, H, cfg.n_audio_ctx, D).astype(np.float32)
              for _ in range(2))

    layers = _jax_tree(tree, dtype)["decoder"]["layers"]
    wqkv, wcq, wo, wco = split_weights(layers, H, jdt)
    want = jax_fused_step(
        jnp.asarray(h0, jdt), wqkv, wcq, wo, wco,
        layers["fc1"]["w"].astype(jdt), layers["fc2"]["w"].astype(jdt),
        *pack_misc(layers, H),
        *(jnp.asarray(_head_outer(x), jdt) for x in (sk, sv, ck, cv)),
        pos + 1, n_layers=L, n_heads=H, eps=cfg.ln_eps, interpret=True)

    packed = pack_decoder_weights(
        _port_tree(tree, dtype)["decoder"]["layers"], tdt)
    launches = fused_decoder_step.launches
    got = fused_decoder_step(
        torch.from_numpy(h0).to(tdt), packed,
        *(torch.from_numpy(x).to(tdt) for x in (sk, sv, ck, cv)),
        pos + 1, n_heads=H, eps=cfg.ln_eps)
    assert fused_decoder_step.launches == launches   # the CPU runs no kernel
    tol = TOL[dtype]
    for name, g, w in (("h_out", got[0], _f32(want[0])),
                       ("k_new", got[1], _from_head_outer_rows(_f32(want[1]),
                                                               B)),
                       ("v_new", got[2], _from_head_outer_rows(_f32(want[2]),
                                                               B))):
        assert g.dtype == tdt, name
        np.testing.assert_allclose(_f32(g), w, rtol=tol, atol=tol,
                                   err_msg=name)


def _prefill(cfg, tree, B: int):
    """JAX prefill of the SOT prompt into a 448-slot cache (the fused
    gate's size) over a random encoder output: (jax params, jax cache,
    jax cross K/V, first tokens, the same cache and cross K/V in torch)."""
    jparams = jax.tree.map(jnp.asarray, tree)
    enc = jnp.asarray(np.random.RandomState(3).randn(
        B, cfg.n_audio_ctx, cfg.d_model).astype(np.float32))
    cross = jax_precompute_cross_kv(jparams, cfg, enc)
    prompt = jnp.asarray(np.tile(build_prompt(cfg), (B, 1)), jnp.int32)
    cache = jax_init_kv_cache(cfg, B)
    logits, cache = jax_decoder_forward(jparams, cfg, prompt, jnp.int32(0),
                                        cache, cross)
    first = jnp.argmax(logits[:, -1, :], axis=-1).astype(jnp.int32)

    def t(x):
        return torch.from_numpy(np.array(x))
    return (jparams, cache, cross, first, {n: t(cache[n]) for n in "kv"},
            {n: t(cross[n]) for n in "kv"}, prompt.shape[1])


def test_three_chained_steps_match_jax(nano):
    """Three fused steps through the port's _make_fused_step against JAX's
    (interpret mode), each fed JAX's argmax: logits within 1e-4 and the
    same argmax at every step; the port's appends land where JAX's
    dynamic_update_slice writes."""
    cfg, tree = nano
    cfg = cfg.replace(fused_step=True)
    B = 2
    jparams, jcache, jcross, first, cache, cross, P = _prefill(cfg, tree, B)
    jstep, jcache = jax_decode._make_fused_step(jparams, cfg, jcache, jcross)
    step = decode._make_fused_step(_port_tree(tree, "float32"), cfg, cross)
    last = first[:, None]
    for i in range(3):
        want, jcache = jstep(last, jnp.int32(P + i), jcache)
        got, cache = step(torch.from_numpy(np.array(last)).long(), P + i,
                          cache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-4)
        nxt = np.asarray(jnp.argmax(want[:, -1, :], axis=-1))
        np.testing.assert_array_equal(got[:, -1].argmax(-1).numpy(), nxt)
        last = jnp.asarray(nxt[:, None], jnp.int32)
    L, _, H, S, D = cache["k"].shape
    back = np.asarray(jcache["k"]).reshape(L, H, B, S, D).transpose(
        0, 2, 1, 3, 4)
    np.testing.assert_allclose(cache["k"][:, :, :, :P + 3].numpy(),
                               back[:, :, :, :P + 3], rtol=1e-4, atol=1e-5)


def test_fused_greedy_tokens_match_jax_and_unfused(nano):
    """Greedy fp32 with fused_step=True: tokens and lengths identical to
    JAX greedy_decode with the fused step and to the port's unfused path,
    sum_logprobs within 1e-4 (max_new=19: a cap no other test decodes the
    nano config with)."""
    cfg, tree = nano
    B = 2
    rng = np.random.RandomState(4)
    enc = rng.randn(B, cfg.n_audio_ctx, cfg.d_model).astype(np.float32)
    prompt = np.tile(build_prompt(cfg), (B, 1))
    fcfg = cfg.replace(fused_step=True)
    want = jax_decode.greedy_decode(jax.tree.map(jnp.asarray, tree), fcfg,
                                    jnp.asarray(enc),
                                    jnp.asarray(prompt, jnp.int32), max_new=19)
    params = _port_tree(tree, "float32")
    runs = {}
    for name, c in (("fused", fcfg), ("unfused", cfg)):
        runs[name] = greedy_decode(params, c, torch.from_numpy(enc),
                                   torch.from_numpy(prompt), max_new=19)
    for name, got in runs.items():
        np.testing.assert_array_equal(got.tokens.numpy(),
                                      np.asarray(want.tokens), err_msg=name)
        np.testing.assert_array_equal(got.lengths.numpy(),
                                      np.asarray(want.lengths), err_msg=name)
        np.testing.assert_allclose(got.sum_logprobs.numpy(),
                                   np.asarray(want.sum_logprobs), atol=1e-4,
                                   rtol=1e-5, err_msg=name)


def test_fused_path_runs_the_fused_step(nano, monkeypatch):
    """With the gate on, every loop step goes through fused_decoder_step
    once and the prefill allocates n_text_ctx slots; with it off, neither."""
    cfg, tree = nano
    monkeypatch.delenv("WHISPER_TPU_FUSED", raising=False)
    calls, slots = [], []
    real_step, real_cache = decode.fused_decoder_step, decode.init_kv_cache

    def counting_step(*a, **kw):
        calls.append(kw)
        return real_step(*a, **kw)

    def recording_cache(cfg, batch, dtype, s_max, device):
        slots.append(s_max)
        return real_cache(cfg, batch, dtype, s_max, device)
    monkeypatch.setattr(decode, "fused_decoder_step", counting_step)
    monkeypatch.setattr(decode, "init_kv_cache", recording_cache)
    params = _port_tree(tree, "float32")
    enc = torch.zeros(1, cfg.n_audio_ctx, cfg.d_model)
    prompt = torch.tensor([build_prompt(cfg)])
    bias = torch.zeros(cfg.vocab_size)
    bias[cfg.eot_token] = -1e9
    for fused, want_calls, want_slots in ((True, 6, 448), (False, 0, 64)):
        calls.clear()
        slots.clear()
        greedy_decode(params, cfg.replace(fused_step=fused), enc, prompt,
                      max_new=6, logit_bias=bias)
        assert len(calls) == want_calls and slots == [want_slots]


_FLAGS = [{}, {"kv_cache_quant": True}, {"cross_kv_quant": True},
          {"weight_quant": True}, {"self_kv_quant": True}]


def _set_env(monkeypatch, env) -> None:
    if env is None:
        monkeypatch.delenv("WHISPER_TPU_FUSED", raising=False)
    else:
        monkeypatch.setenv("WHISPER_TPU_FUSED", env)


@pytest.mark.parametrize("flags", _FLAGS, ids=lambda f: "+".join(f) or "none")
@pytest.mark.parametrize("fused", [None, True, False])
@pytest.mark.parametrize("env", [None, "0", "1"])
def test_gate_and_cache_slots_match_jax(small_cfg, monkeypatch, flags, fused,
                                        env):
    """The explicit setting (`_fused_setting`, None read as off), the gate
    on the CPU and _cache_slots answer as JAX's for every quant flag,
    cfg.fused_step and WHISPER_TPU_FUSED; the default is off there."""
    _set_env(monkeypatch, env)
    cfg = small_cfg.replace(fused_step=fused, **flags)
    on = decode._fused_step_enabled(cfg, torch.device("cpu"))
    assert on == jax_decode._fused_step_enabled(cfg)
    assert bool(decode._fused_setting(cfg)) == on
    if not flags and fused is None and env is None:
        assert on is False and decode._fused_setting(cfg) is None
    for total in (1, 23, 93, 200, 449):
        assert (decode._cache_slots(cfg, total)
                == jax_decode._cache_slots(cfg, total))


_CUDA = torch.device("cuda")     # a device object: no card is needed


@pytest.mark.parametrize("model", ["tiny", "base", "small", "medium",
                                   "large-v3", "large-v3-turbo"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_auto_policy_takes_the_fused_step_on_cuda(monkeypatch, model, dtype):
    """With neither cfg.fused_step nor WHISPER_TPU_FUSED set and no int8
    flag, a CUDA device takes the fused step at every Whisper width (head_dim
    64, d <= 1280) in both compute dtypes; the CPU keeps JAX's off. The auto
    path keeps the rounded self cache (the kernel reads only the rows below
    the current position)."""
    _set_env(monkeypatch, None)
    cfg = get_config(model).replace(compute_dtype=dtype)
    assert decode._fused_setting(cfg) is None
    assert decode._fused_step_enabled(cfg, _CUDA)
    assert decode._fused_step_enabled(cfg, "cuda:0")
    assert not decode._fused_step_enabled(cfg, torch.device("cpu"))
    assert decode._cache_slots(cfg, 101) == 128


def _case_id(case: dict) -> str:
    parts = [f"env{case['env']}"] if "env" in case else []
    parts += ["tp2"] if case.get("tp") else []
    return "+".join(parts + [f"{k}={v}" for k, v in
                             case.get("flags", {}).items()])


@pytest.mark.parametrize("case,want,slots", [
    ({"flags": {"kv_cache_quant": True}}, False, 128),
    ({"flags": {"cross_kv_quant": True}}, False, 128),
    ({"flags": {"weight_quant": True}}, False, 128),
    ({"flags": {"self_kv_quant": True}}, False, 128),
    ({"tp": True}, False, 128),
    ({"flags": {"n_heads": 12}}, False, 128),              # head_dim 32
    ({"flags": {"n_heads": 3}}, False, 128),               # head_dim 128
    ({"flags": {"d_model": 2560, "n_heads": 40}}, False, 128),  # d > 2048
    ({"env": "0"}, False, 128),
    ({"flags": {"fused_step": False}}, False, 128),
    ({"env": "0", "flags": {"fused_step": True}}, False, 128),
    ({"env": "1"}, True, 448),
    ({"flags": {"fused_step": True}}, True, 448),
    ({"env": "1", "flags": {"weight_quant": True}}, False, 128),
    ({"flags": {"fused_step": True, "cross_kv_quant": True}}, False, 128),
], ids=lambda c: _case_id(c) if isinstance(c, dict) else None)
def test_gate_on_a_cuda_device(monkeypatch, case, want, slots):
    """The gate on a CUDA device at tiny's widths: the auto policy turns
    off under each int8 flag, under tp > 1 and beyond the kernel's widths;
    WHISPER_TPU_FUSED and cfg.fused_step override it both ways, the env
    first; an int8 flag keeps it off whatever is set. An explicit on
    allocates JAX's n_text_ctx slots, everything else the rounded 128 of a
    101-position decode."""
    _set_env(monkeypatch, case.get("env"))
    if case.get("tp"):      # inside a models.whisper.sharded block, tp > 1
        monkeypatch.setattr(decode, "tp_group", lambda: object())
    cfg = get_config("tiny").replace(compute_dtype="bfloat16",
                                     **case.get("flags", {}))
    assert decode._fused_step_enabled(cfg, _CUDA) is want
    assert decode._cache_slots(cfg, 101) == slots


def _forcing_pick(real, record: list, forced=None):
    """A pick that records each pick's last-position logits (fp32) and
    calls `real` (decode._pick); given `forced` (B, total) tokens, it
    returns the token there in place of its own pick: a teacher-forced
    greedy loop."""
    def pick(logits, logit_bias, opts, cfg, tokens, pos, prompt_len,
             generator=None):
        record.append(logits[:, -1].float().clone())
        nxt, lp = real(logits, logit_bias, opts, cfg, tokens, pos,
                       prompt_len, generator)
        return (nxt if forced is None else forced[:, pos]), lp
    return pick


@pytest.mark.parametrize("route", ["fused_step", "auto"])
def test_deep_greedy_through_the_plain_twin_matches_unfused(monkeypatch,
                                                            route):
    """bf16 greedy_decode at a nano width the kernel takes (d=128, 2 heads
    of 64) with 6 decoder layers, more than tiny's 4, and B=5, not a
    multiple of 8: the unfused step's run picks the tokens; the fused
    step's run (its plain twin on the CPU), teacher-forced on them, gives
    logits within the fused tests' bf16 tolerance at every pick. "auto"
    reaches the fused step through the auto policy (decided on the cross
    cache's device, here stood in for by the CPU) with the rounded
    128-slot self cache; "fused_step" through cfg.fused_step with JAX's 448
    slots."""
    _set_env(monkeypatch, None)
    cfg = get_config("tiny").replace(name="test-nano-deep", d_model=128,
                                     n_heads=2, n_audio_layers=1,
                                     n_text_layers=6, compute_dtype="bfloat16")
    params = _port_tree(_perturbed_tree(cfg, 21, 22), "bfloat16")
    B, max_new = 5, 12
    rng = np.random.RandomState(23)
    enc = torch.from_numpy(rng.randn(B, cfg.n_audio_ctx, cfg.d_model).astype(
        np.float32)).to(torch.bfloat16)
    prompt = torch.tensor([build_prompt(cfg)] * B)
    bias = torch.zeros(cfg.vocab_size)
    bias[cfg.eot_token] = -1e9              # EOT banned: every step runs

    slots, fused_calls, asked = [], [], []
    real_cache, real_step = decode.init_kv_cache, decode.fused_decoder_step

    def recording_cache(cfg, batch, dtype, s_max, device):
        slots.append(s_max)
        return real_cache(cfg, batch, dtype, s_max, device)

    def counting_step(*a, **kw):
        fused_calls.append(a[0].shape)
        return real_step(*a, **kw)
    monkeypatch.setattr(decode, "init_kv_cache", recording_cache)
    monkeypatch.setattr(decode, "fused_decoder_step", counting_step)

    want_logits, real_pick = [], decode._pick
    monkeypatch.setattr(decode, "_pick", _forcing_pick(real_pick,
                                                       want_logits))
    ref = greedy_decode(params, cfg.replace(fused_step=False), enc, prompt,
                        max_new=max_new, logit_bias=bias)
    assert not fused_calls and slots == [64]

    if route == "auto":
        fcfg = cfg

        def auto(c, device):
            asked.append(device)
            return True
        monkeypatch.setattr(decode, "_fused_auto", auto)
    else:
        fcfg = cfg.replace(fused_step=True)
    got_logits = []
    monkeypatch.setattr(decode, "_pick", _forcing_pick(real_pick, got_logits,
                                                       ref.tokens))
    got = greedy_decode(params, fcfg, enc, prompt, max_new=max_new,
                        logit_bias=bias)
    assert len(fused_calls) == max_new
    assert slots[1:] == ([64] if route == "auto" else [448])
    if route == "auto":   # asked once, by the loop, on the cross cache's
        assert asked == [torch.device("cpu")]

    torch.testing.assert_close(got.tokens, ref.tokens, atol=0, rtol=0)
    assert len(got_logits) == len(want_logits) == max_new + 1
    atol = rtol = TOL["bfloat16"]
    for i, (g, w) in enumerate(zip(got_logits, want_logits)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=atol,
                                   rtol=rtol, err_msg=f"pick {i}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_packing_matches_jax_without_head_padding(nano, dtype):
    """pack_decoder_weights equals JAX's split_weights and pack_misc once
    the 128-lane head padding is stripped, and passes the params' matrices
    through without a copy."""
    cfg, tree = nano
    tdt, jdt = DTYPES[dtype]
    H, D, d = cfg.n_heads, cfg.head_dim, cfg.d_model
    L, ff = cfg.n_text_layers, cfg.d_ff
    layers = _jax_tree(tree, dtype)["decoder"]["layers"]
    wqkv, wcq, wo, wco = (np.asarray(jnp.asarray(x, jnp.float32))
                          for x in split_weights(layers, H, jdt))
    qkvb, fc1b, miscp, miscd = (np.asarray(x) for x in pack_misc(layers, H))
    Dhp = wcq.shape[-1] // H

    def cols(x, n):       # (..., n*H*Dhp) -> (..., n*H*D)
        return x.reshape(*x.shape[:-1], n * H, Dhp)[..., :D].reshape(
            *x.shape[:-1], n * H * D)

    def rows(x):          # (L, H*Dhp, d) -> (L, H*D, d)
        return x.reshape(L, H, Dhp, d)[:, :, :D].reshape(L, H * D, d)

    port_layers = _port_tree(tree, dtype)["decoder"]["layers"]
    got = pack_decoder_weights(port_layers, tdt)
    for name, want in (("wqkv", cols(wqkv, 3)), ("wcq", cols(wcq, 1)),
                       ("wo", rows(wo)), ("wco", rows(wco)),
                       ("fc1", np.asarray(layers["fc1"]["w"], np.float32)),
                       ("fc2", np.asarray(layers["fc2"]["w"], np.float32))):
        t = getattr(got, name)
        assert t.dtype == tdt, name
        np.testing.assert_array_equal(t.float().numpy(), want, err_msg=name)
    assert got.wqkv.data_ptr() == port_layers["attn"]["qkv"]["w"].data_ptr()
    assert got.fc2.data_ptr() == port_layers["fc2"]["w"].data_ptr()
    off = vec_offsets(d, ff)
    vec = got.vec.numpy()
    assert got.vec.dtype == torch.float32 and vec.shape == (L, off["end"])
    np.testing.assert_array_equal(vec[:, :3 * d], cols(qkvb[:, 0], 3))
    np.testing.assert_array_equal(vec[:, off["fc1_b"]:off["fc1_b"] + ff],
                                  fc1b[:, 0])
    np.testing.assert_array_equal(vec[:, off["cq_b"]:off["cq_b"] + d],
                                  cols(miscp[:, 0], 1))
    np.testing.assert_array_equal(vec[:, off["o_b"]:], miscd[:, 0])


def test_wrapper_refuses_bad_operands(nano):
    """pos outside the cache raises on the CPU too; int8 trees are refused
    by the packing (the gate keeps them off the fused step)."""
    cfg, tree = nano
    L, H, D, d = cfg.n_text_layers, cfg.n_heads, cfg.head_dim, cfg.d_model
    packed = pack_decoder_weights(_port_tree(tree, "float32")[
        "decoder"]["layers"], torch.float32)
    sk = torch.zeros(L, 1, H, 8, D)
    ck = torch.zeros(L, 1, H, 16, D)
    h0 = torch.zeros(1, d)
    for kv_len in (0, 9):
        with pytest.raises(IndexError, match="outside"):
            fused_decoder_step(h0, packed, sk, sk, ck, ck, kv_len, n_heads=H)
    with pytest.raises(ValueError, match="shape"):
        fused_decoder_step(h0, packed, sk[:, :, :1], sk, ck, ck, 3, n_heads=H)
    layers = dict(_port_tree(tree, "float32")["decoder"]["layers"])
    layers["fc1"] = {**layers["fc1"], "w_s": torch.ones(L, cfg.d_ff)}
    with pytest.raises(ValueError, match="int8"):
        pack_decoder_weights(layers, torch.float32)


@pytest.mark.parametrize("bad,exc,match", [
    ("dtype", TypeError, "torch.int64"),
    ("size", ValueError, "contiguous int64 elements"),
    ("strided", ValueError, "contiguous int64 elements"),
    ("cpu", ValueError, "time the CUDA kernel"),
])
def test_wrapper_checks_the_stamp_buffer(nano, bad, exc, match):
    """The timeline keyword is for the CUDA kernel only: a buffer of the
    wrong dtype or size is refused, and so is any buffer on a call whose
    tensors lie on the CPU (the plain version has no timeline). Without
    the keyword the CPU call runs the plain version as before."""
    cfg, tree = nano
    L, H, D, d = cfg.n_text_layers, cfg.n_heads, cfg.head_dim, cfg.d_model
    packed = pack_decoder_weights(_port_tree(tree, "float32")[
        "decoder"]["layers"], torch.float32)
    sk = torch.zeros(L, 1, H, 8, D)
    ck = torch.zeros(L, 1, H, 16, D)
    h0 = torch.zeros(1, d)
    n = 2 * stamp_pairs(L)
    stamps = {"dtype": torch.zeros(n, dtype=torch.int32),
              "size": torch.zeros(n - 2, dtype=torch.int64),
              "strided": torch.zeros(2 * n, dtype=torch.int64)[::2],
              "cpu": torch.zeros(n, dtype=torch.int64)}[bad]
    with pytest.raises(exc, match=match):
        fused_decoder_step(h0, packed, sk, sk, ck, ck, 3, n_heads=H,
                           stamps=stamps)
    out = fused_decoder_step(h0, packed, sk, sk, ck, ck, 3, n_heads=H)
    assert out[0].shape == (1, d)


def test_stamp_buffer_holds_the_phase_kinds():
    """The timeline's kinds: the phases of a layer, the final rows and
    the barrier probes, named in the kernel's order; room for 16 barriers
    a layer."""
    assert PHASES[0] == "start" and PHASES[-1] == "sync"
    assert len(set(PHASES)) == len(PHASES) == 12
    assert stamp_pairs(4) == 80 and stamp_pairs(1) == 32


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-4), ("bfloat16", 0.06)])
def test_plain_step_fp64_sums_keep_the_rounding_points(nano, dtype, atol):
    """acc_dtype=float64 keeps the compute dtype's rounding points and sums
    in fp64 between them: the reference the card tests adjudicate bf16
    near-ties with. At nano width it stays within the fused tolerance of
    the fp32 arithmetic (fp32 1e-4; bf16 one ulp of O(4) values, rtol
    2e-2), and its outputs are in the compute dtype."""
    cfg, tree = nano
    L, H, D, d = cfg.n_text_layers, cfg.n_heads, cfg.head_dim, cfg.d_model
    tdt = getattr(torch, dtype)
    packed = pack_decoder_weights(_port_tree(tree, dtype)["decoder"]["layers"],
                                  tdt)
    rng = np.random.RandomState(3)
    h0 = torch.from_numpy(rng.randn(2, d).astype(np.float32)).to(tdt)
    sk = torch.from_numpy(rng.randn(L, 2, H, 8, D).astype(np.float32)).to(tdt)
    ck = torch.from_numpy(rng.randn(L, 2, H, 16, D).astype(np.float32)).to(tdt)
    sv, cv = sk.flip(3), ck.flip(3)
    want = fused_decoder_step_plain(h0, packed, sk, sv, ck, cv, 6, n_heads=H)
    exact = fused_decoder_step_plain(h0, packed, sk, sv, ck, cv, 6, n_heads=H,
                                     acc_dtype=torch.float64)
    for w, e in zip(want, exact):
        assert e.dtype == tdt and e.shape == w.shape
        np.testing.assert_allclose(e.float().numpy(), w.float().numpy(),
                                   atol=atol, rtol=2e-2 if dtype == "bfloat16"
                                   else 1e-4)
