"""Port plain attention (whisper_tpu_torch/ops/attention.py) against the
JAX mha_reference, with every masking form the port uses."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_tpu.ops.attention import mha_reference as jax_mha
from whisper_tpu_torch.ops.attention import mha_reference

torch.set_num_threads(2)


# fp32 2e-6: the same fp32 einsums and softmax, summed in another order.
@pytest.mark.parametrize("kv_len,causal,q_offset", [
    (None, False, 0),       # cross-attention
    (4, True, 0),           # the 4-token prompt prefill
    (9, True, 5),           # a prefill continuing at position 5
])
def test_mha_matches_jax(kv_len, causal, q_offset):
    rng = np.random.RandomState(0)
    B, T, H, S, D = 2, 4, 3, 16, 32
    q = rng.randn(B, T, H, D).astype(np.float32)
    k = rng.randn(B, H, S, D).astype(np.float32)
    v = rng.randn(B, H, S, D).astype(np.float32)
    want = np.asarray(jax_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              kv_len, causal=causal, q_offset=q_offset))
    got = mha_reference(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(v), kv_len, causal=causal,
                        q_offset=q_offset)
    assert got.shape == (B, T, H, D)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-6, rtol=1e-5)


def test_mha_keeps_bf16_dtype():
    q = torch.randn(1, 2, 2, 8, generator=torch.Generator().manual_seed(0))
    out = mha_reference(q.bfloat16(), q.transpose(1, 2).bfloat16(),
                        q.transpose(1, 2).bfloat16())
    assert out.dtype == torch.bfloat16


def _ragged_case(B, S, T, form, seed=0):
    """Numpy inputs and per-row lengths: `kv_len` gives each row its own
    kv_len in [0, S] (0 and S included); `q_offset` gives each row its own
    causal offset in [0, S - T] over all S keys."""
    rng = np.random.RandomState(seed)
    H, D = 2, 64
    q = rng.randn(B, T, H, D).astype(np.float32)
    k = rng.randn(B, H, S, D).astype(np.float32)
    v = rng.randn(B, H, S, D).astype(np.float32)
    if form == "kv_len":
        lens = rng.randint(0, S + 1, size=B)
        lens[:2] = 0, S
        return q, k, v, dict(kv_len=lens.astype(np.int32), causal=False,
                             q_offset=0)
    offs = rng.randint(0, S - T + 1, size=B)
    offs[0] = 0
    return q, k, v, dict(kv_len=None, causal=True,
                         q_offset=offs.astype(np.int32))


def _lengths(kw, as_array):
    """kw with its per-row lengths as the given framework's arrays."""
    return {n: as_array(x) if isinstance(x, np.ndarray) else x
            for n, x in kw.items()}


# fp32 2e-6: the same fp32 einsums and softmax, summed in another order.
@pytest.mark.parametrize("backend", [None, "pallas"])
@pytest.mark.parametrize("B,S", [(3, 16), (16, 16)])
@pytest.mark.parametrize("form", ["kv_len", "q_offset"])
@pytest.mark.parametrize("T", [1, 4])
@pytest.mark.parametrize("fn", ["multi_head_attention",
                                "multi_head_attention_quant"])
def test_ragged_lengths_match_jax(fn, T, form, B, S, backend):
    """Per-row (B,) kv_len, or per-row q_offset with causal=True, through
    both functions: the port equals JAX's multi_head_attention /
    multi_head_attention_quant (each sends a ragged call to its
    mha_reference, whatever the backend; JAX's "pallas_interpret" stands
    for the port's "pallas"). The int8 function reads K/V quantized by
    JAX's quantize_kv, dequantized on both sides."""
    from whisper_tpu.models.whisper import quantize_kv
    from whisper_tpu.ops import attention as jax_attention
    from whisper_tpu_torch.ops import attention

    q, k, v, kw = _ragged_case(B, S, T, form)
    jkw = _lengths(kw, jnp.asarray)
    tkw = _lengths(kw, lambda a: torch.from_numpy(a.astype(np.int64)))
    jax_backend = backend and "pallas_interpret"
    if fn == "multi_head_attention":
        want = jax_attention.multi_head_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **jkw,
            backend=jax_backend)
        got = attention.multi_head_attention(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            **tkw, backend=backend)
    else:
        (k8, ks), (v8, vs) = quantize_kv(jnp.asarray(k)), \
            quantize_kv(jnp.asarray(v))
        want = jax_attention.multi_head_attention_quant(
            jnp.asarray(q), k8, ks, v8, vs, **jkw, backend=jax_backend)
        got = attention.multi_head_attention_quant(
            torch.from_numpy(q), *(torch.from_numpy(np.array(a))
                                   for a in (k8, ks, v8, vs)),
            **tkw, backend=backend)
    assert got.shape == (B, T, 2, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6,
                               rtol=1e-5)
