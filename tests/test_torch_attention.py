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
