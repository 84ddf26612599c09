"""Port flash attention (whisper_tpu_torch/ops/flash_attention.py) and the
size dispatch (ops/attention.py multi_head_attention) against the JAX
package: the Pallas kernel in interpret mode, mha_reference and the JAX
auto policy, on the CPU."""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_tpu.ops.attention import _auto_backend
from whisper_tpu.ops.attention import mha_reference as jax_mha
from whisper_tpu.ops.attention import multi_head_attention as jax_mha_dispatch
from whisper_tpu.ops.flash_attention import flash_attention as jax_flash
from whisper_tpu_torch.ops import attention
from whisper_tpu_torch.ops.attention import _route, multi_head_attention
from whisper_tpu_torch.ops.flash_attention import (
    _check,
    flash_attention,
    flash_attention_plain,
)

torch.set_num_threads(2)

_JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}

# (B, T, S, H, kv_len, q_offset, causal)
_CASES = {
    "encoder": (2, 37, 200, 3, None, 0, False),
    "kv_len_below_S": (2, 33, 200, 2, 77, 0, False),
    "prefill_q0": (2, 4, 128, 2, 4, 0, True),
    "causal_offset": (1, 40, 256, 2, 140, 100, True),
    "T_not_tile_multiple": (2, 70, 200, 2, 150, 20, True),
    "kv_len_0": (1, 5, 64, 2, 0, 0, False),
    # one past two 64-row blocks and four 64-key tiles of the bf16 kernel
    "tile_straddle": (1, 129, 257, 2, None, 0, False),
    "tile_straddle_causal": (1, 129, 257, 2, 250, 100, True),
}


def _inputs(B, T, S, H, dtype, D=64, seed=0):
    """q, k, v in `dtype` on both sides, from one numpy draw (the torch
    copies hold the JAX values exactly)."""
    rng = np.random.RandomState(seed)
    jx = [jnp.asarray(rng.randn(*s), _JNP[dtype])
          for s in ((B, T, H, D), (B, H, S, D), (B, H, S, D))]
    tx = [torch.from_numpy(np.array(x.astype(jnp.float32))).to(dtype)
          for x in jx]
    return jx, tx


# fp32 1e-6: the same fp32 products and exponentials, summed in another
# order. bf16 rtol 2**-7: one bf16 ulp of the output, where a last-bit
# difference of the fp32 value rounds the other way.
_TOL = {torch.float32: dict(atol=1e-6, rtol=1e-5),
        torch.bfloat16: dict(atol=1e-6, rtol=2 ** -7)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(_CASES))
def test_flash_plain_matches_jax_interpret(case, dtype):
    B, T, S, H, kv_len, q_offset, causal = _CASES[case]
    (jq, jk, jv), (q, k, v) = _inputs(B, T, S, H, dtype)
    want = np.asarray(jax_flash(jq, jk, jv, kv_len, q_offset, causal=causal,
                                interpret=True).astype(jnp.float32))
    got = flash_attention(q, k, v, kv_len, q_offset, causal=causal)
    assert got.dtype == dtype and got.shape == (B, T, H, 64)
    np.testing.assert_allclose(got.float().numpy(), want, **_TOL[dtype])
    if kv_len == 0:
        assert not got.any()


# fp32 2e-6 / 1e-5: mha_reference's one-pass softmax against the plain
# version's, in fp32 (test_torch_attention.py's bound).
@pytest.mark.parametrize("case", sorted(set(_CASES) - {"kv_len_0"}))
def test_flash_plain_matches_jax_mha_reference(case):
    B, T, S, H, kv_len, q_offset, causal = _CASES[case]
    (jq, jk, jv), (q, k, v) = _inputs(B, T, S, H, torch.float32, seed=1)
    want = np.asarray(jax_mha(jq, jk, jv, kv_len, causal=causal,
                              q_offset=q_offset))
    got = flash_attention_plain(q, k, v, kv_len, q_offset, causal=causal)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-6, rtol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kv_len,q_offset,causal,poison_from", [
    (100, 0, False, 100),     # past kv_len
    (140, 100, True, 140),    # past kv_len, causal
    (256, 100, True, 140),    # past the last query's diagonal (T = 40)
])
def test_flash_never_reads_poisoned_keys(dtype, kv_len, q_offset, causal,
                                         poison_from):
    """NaN in K/V rows no query may see does not reach the output: the
    result equals the unpoisoned one bit for bit."""
    _, (q, k, v) = _inputs(1, 40, 256, 2, dtype, seed=2)
    clean = flash_attention(q, k, v, kv_len, q_offset, causal=causal)
    k[:, :, poison_from:] = float("nan")
    v[:, :, poison_from:] = float("nan")
    got = flash_attention(q, k, v, kv_len, q_offset, causal=causal)
    assert torch.isfinite(got.float()).all()
    assert torch.equal(got, clean)


def test_flash_casts_kv_to_q_dtype():
    """k and v take q's dtype (:153-154): bf16 q over fp32 K/V equals bf16
    q over K/V rounded to bf16."""
    _, (q, k, v) = _inputs(1, 9, 64, 2, torch.float32, seed=3)
    got = flash_attention(q.bfloat16(), k, v)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, flash_attention(q.bfloat16(), k.bfloat16(),
                                            v.bfloat16()))


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("q,k,kv_len,q_offset,err,match", [
    (_meta(1, 4, 2, 32), _meta(1, 2, 8, 32), 8, 0, ValueError, "head_dim"),
    (_meta(1, 4, 2, 64), _meta(1, 2, 8, 64, dtype=torch.bfloat16), 8, 0,
     TypeError, "k is torch.bfloat16"),
    (_meta(1, 4, 2, 64, dtype=torch.float16), _meta(1, 2, 8, 64,
                                                    dtype=torch.float16),
     8, 0, TypeError, "no kernel"),
    (_meta(1, 4, 2, 64), _meta(1, 3, 8, 64), 8, 0, ValueError, "shape"),
    (_meta(1, 4, 2, 64), _meta(1, 2, 8, 64), 9, 0, ValueError, "kv_len"),
    (_meta(1, 4, 2, 64), _meta(1, 2, 8, 64), 8, -1, ValueError, "q_offset"),
    (_meta(1, 4, 2, 64), _meta(1, 2, 8, 64), 8, 0, ValueError, "CUDA"),
    (torch.zeros(1, 4, 2, 64), torch.zeros(1, 2, 8, 64), 8, 0, ValueError,
     "CUDA"),
])
def test_check_refuses_what_the_kernel_does_not_take(q, k, kv_len, q_offset,
                                                    err, match):
    with pytest.raises(err, match=match):
        _check(q, k, k, kv_len, q_offset)


def _strided(shape, strides, dtype=torch.bfloat16):
    return torch.empty(0, dtype=dtype, device="meta").as_strided(shape,
                                                                  strides)


_STRIDED_BASE = {"q": ((2, 4, 3, 64), [832, 200, 64, 1]),
                 "k": ((2, 3, 8, 64), [1600, 520, 64, 1]),
                 "v": ((2, 3, 8, 64), [1600, 520, 64, 1])}


def _strided_args(which, dim, step, dtype):
    """q, k, v meta views with `which`'s stride `dim` moved by `step`."""
    args = {}
    for name, (shape, strides) in _STRIDED_BASE.items():
        if name == which:
            strides = list(strides)
            strides[dim] += step
        args[name] = _strided(shape, strides, dtype)
    return args


@pytest.mark.parametrize("which", ["q", "k", "v"])
@pytest.mark.parametrize("dim", [0, 1, 2])
def test_check_refuses_bf16_strides_off_8(which, dim):
    """The bf16 kernel copies 16 bytes at a time: a stride that is not a
    whole number of 8 elements is refused, in q, k or v and in any of the
    three outer dims; fp32, whose 16 bytes are 4 elements, takes a stride
    off 8 by 4."""
    args = _strided_args(which, dim, 1, torch.bfloat16)
    with pytest.raises(ValueError, match=f"{which}'s strides .* 8 elements"):
        _check(args["q"], args["k"], args["v"], 8, 0)
    args = _strided_args(which, dim, 4, torch.bfloat16)
    with pytest.raises(ValueError, match=f"{which}'s strides .* 8 elements"):
        _check(args["q"], args["k"], args["v"], 8, 0)
    fp32 = _strided_args(which, dim, 4, torch.float32)
    with pytest.raises(ValueError, match="q is on meta"):
        _check(fp32["q"], fp32["k"], fp32["v"], 8, 0)


@pytest.mark.parametrize("which", ["q", "k", "v"])
@pytest.mark.parametrize("dim", [0, 1, 2])
@pytest.mark.parametrize("step", [1, 2, 3])
def test_check_refuses_fp32_strides_off_4(which, dim, step):
    """The fp32 kernel copies 16 bytes (4 elements) at a time: a stride
    that is not a whole number of 4 elements is refused, in q, k or v and
    in any of the three outer dims."""
    args = _strided_args(which, dim, step, torch.float32)
    with pytest.raises(ValueError, match=f"{which}'s strides .* 4 elements"):
        _check(args["q"], args["k"], args["v"], 8, 0)


@pytest.mark.parametrize("model", ["tiny", "base", "small", "medium",
                                   "large-v3-turbo"])
def test_check_takes_the_encoders_bf16_views(model):
    """q, k and v as the encoder hands them over at each width: head
    views of one fused (B, T, 3d) QKV projection. They pass every check
    of the bf16 kernel but the device (meta here)."""
    from whisper_tpu_torch.config import get_config
    from whisper_tpu_torch.models.whisper import split_heads, split_heads_hm
    cfg = get_config(model)
    H, d, T = cfg.n_heads, cfg.d_model, cfg.n_audio_ctx
    qkv = torch.empty((2, T, 3 * d), dtype=torch.bfloat16, device="meta")
    q, k, v = qkv.chunk(3, dim=-1)
    q, k, v = split_heads(q, H), split_heads_hm(k, H), split_heads_hm(v, H)
    assert q.shape == (2, T, H, 64) and k.shape == (2, H, T, 64)
    assert all(t.storage_offset() % 8 == 0 for t in (q, k, v))
    with pytest.raises(ValueError, match="q is on meta"):
        _check(q, k, v, T, 0)


@pytest.mark.parametrize("model", ["tiny", "base", "small", "medium",
                                   "large-v3-turbo"])
def test_check_takes_the_encoders_fp32_views(model):
    """The fp32 analogue: the head views of one fused (B, T, 3d) fp32 QKV
    projection start 16-byte aligned (d * 4 bytes apart) with strides of
    whole 4 elements, and pass every check of the fp32 kernel but the
    device (meta here)."""
    from whisper_tpu_torch.config import get_config
    from whisper_tpu_torch.models.whisper import split_heads, split_heads_hm
    cfg = get_config(model)
    H, d, T = cfg.n_heads, cfg.d_model, cfg.n_audio_ctx
    qkv = torch.empty((2, T, 3 * d), dtype=torch.float32, device="meta")
    q, k, v = qkv.chunk(3, dim=-1)
    q, k, v = split_heads(q, H), split_heads_hm(k, H), split_heads_hm(v, H)
    assert q.shape == (2, T, H, 64) and k.shape == (2, H, T, 64)
    assert all(t.storage_offset() % 4 == 0 for t in (q, k, v))
    assert all(s % 4 == 0 for t in (q, k, v) for s in t.stride()[:3])
    with pytest.raises(ValueError, match="q is on meta"):
        _check(q, k, v, T, 0)


def test_flash_refuses_non_cuda_devices():
    """Off the CPU, a device without the kernel raises: no plain
    fallback."""
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(_meta(1, 4, 2, 64), _meta(1, 2, 8, 64),
                        _meta(1, 2, 8, 64))


def _shape(*s):
    return types.SimpleNamespace(shape=s)


# (B, T, H, S): q (B, T, H, D), k (B, H, S, D)
@pytest.mark.parametrize("B,T,H,S", [
    (1, 1500, 2, 1500),      # one nano clip, 2 heads: 18 MB of scores
    (32, 1500, 20, 1500),    # turbo encoder, b32
    (32, 4, 20, 1500),       # turbo cross prefill b32: 15.36 MB
    (32, 4, 20, 128),        # self prefill over 128 slots: 1.3 MB
    (1, 2048, 1, 2048),      # exactly 16 MiB
    (1, 2048, 1, 2047),      # one key under
    (8, 1, 20, 448),         # a T==1 read of a 448-slot cache
    (1, 1, 20, 4096),        # a T==1 read of a 4096-slot cache
])
def test_route_matches_jax_auto_backend(B, T, H, S):
    want = _auto_backend(_shape(B, T, H, 64), _shape(B, H, S, 64))
    got = _route(_meta(B, T, H, 64), _meta(B, H, S, 64))
    expect = {"reference": "reference",
              "pallas": "decode" if T == 1 else "flash"}[want]
    assert got == expect


def test_dispatch_above_the_gate_is_jax_flash(monkeypatch):
    """With the gate at 0 every T > 1 call takes the flash route: the
    result is the JAX dispatch's pallas route (interpret mode)."""
    monkeypatch.setattr(attention, "_FLASH_MIN_SCORE_BYTES", 0)
    (jq, jk, jv), (q, k, v) = _inputs(1, 16, 64, 2, torch.float32, seed=4)
    want = np.asarray(jax_mha_dispatch(jq, jk, jv, 40, causal=True,
                                       q_offset=24,
                                       backend="pallas_interpret"))
    got = multi_head_attention(q, k, v, 40, causal=True, q_offset=24)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-5)


def test_dispatch_long_cache_decode_raises_off_cpu(monkeypatch):
    """A T==1 read of a >= 4096-slot cache goes to decode_attention_bh by
    the auto gate: on a device without the kernel the wrapper raises, with
    no plain fallback; on the CPU it is the kernel's plain version, equal
    to the JAX dispatch's result."""
    calls = []
    real = attention.decode_attention_bh

    def counting(*args):
        calls.append(args[1].shape[2])
        return real(*args)

    monkeypatch.setattr(attention, "decode_attention_bh", counting)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        multi_head_attention(_meta(1, 1, 2, 64), _meta(1, 2, 4096, 64),
                             _meta(1, 2, 4096, 64), 100)
    (jq, jk, jv), (q, k, v) = _inputs(1, 1, 4096, 1, torch.float32, D=8,
                                      seed=5)
    want = np.asarray(jax_mha(jq, jk, jv, 100))
    got = multi_head_attention(q, k, v, 100)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-6, rtol=1e-5)
    assert calls == [4096, 4096]
