"""Port encoder-block tail (whisper_tpu_torch/ops/encoder_layer.py): its
plain version against the JAX Pallas kernel in interpret mode, at
tests/test_encoder_layer.py's sizes and tolerances, and the wrapper's
dispatch and argument checks. The CUDA kernel itself is tested on the card
(tests/test_torch_kernels_cuda.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_tpu.ops.encoder_layer import encoder_block_tail as jax_tail
from whisper_tpu.ops.encoder_layer import pack_tail_misc, pad_tail_weights
from whisper_tpu_torch.ops import encoder_layer
from whisper_tpu_torch.ops.encoder_layer import (
    encoder_block_tail,
    encoder_block_tail_plain,
)

torch.set_num_threads(2)


def _mk(seed, B, T, H, D, ff):
    """fp32 numpy inputs with non-zero biases and LN parameters."""
    rng = np.random.RandomState(seed)
    d = H * D
    f = lambda *s, scale=1.0, shift=0.0: (  # noqa: E731
        rng.randn(*s) * scale + shift).astype(np.float32)
    return {"q": f(B, T, H, D), "k": f(B, H, T, D), "v": f(B, H, T, D),
            "h": f(B, T, d), "wo": f(d, d, scale=0.1), "o_b": f(d, scale=0.1),
            "fc1_w": f(d, ff, scale=0.1), "fc1_b": f(ff, scale=0.1),
            "fc2_w": f(ff, d, scale=0.1), "fc2_b": f(d, scale=0.1),
            "ln_g": f(d, scale=0.2, shift=1.0), "ln_b": f(d, scale=0.1)}


def _jax(x, dtype, H, **kw):
    j = {k: jnp.asarray(v, dtype) for k, v in x.items()}
    lp = {"attn": {"o": {"w": j["wo"], "b": j["o_b"]}},
          "fc1": {"w": j["fc1_w"], "b": j["fc1_b"]},
          "fc2": {"w": j["fc2_w"], "b": j["fc2_b"]},
          "mlp_ln": {"g": j["ln_g"], "b": j["ln_b"]}}
    out = jax_tail(j["q"], j["k"], j["v"], j["h"],
                   pad_tail_weights(j["wo"], H, dtype), j["fc1_w"],
                   j["fc2_w"], pack_tail_misc(lp), interpret=True, **kw)
    return np.asarray(out.astype(jnp.float32))


def _torch_args(x, dtype):
    t = {k: torch.from_numpy(v).to(dtype) for k, v in x.items()}
    return (t["q"], t["k"], t["v"], t["h"], t["wo"], t["fc1_w"], t["fc2_w"],
            t["o_b"], t["fc1_b"], t["fc2_b"], t["ln_g"], t["ln_b"])


# fp32 3e-5: the JAX test's bound for the same sums in another order;
# bf16 0.06 (rtol 2e-2): one bf16 ulp of the O(4) outputs, where the two
# sides round an fp32 sum taken in a different order.
@pytest.mark.parametrize("dtype,atol", [("float32", 3e-5),
                                        ("bfloat16", 0.06)])
def test_plain_tail_matches_jax_kernel(dtype, atol):
    B, T, H, D, ff = 2, 40, 2, 32, 256
    x = _mk(0, B, T, H, D, ff)
    want = _jax(x, jnp.dtype(dtype), H)
    tdt = getattr(torch, dtype)
    out = encoder_block_tail_plain(*_torch_args(x, tdt))
    assert out.dtype == tdt and out.shape == (B, T, H * D)
    np.testing.assert_allclose(out.float().numpy(), want, atol=atol,
                               rtol=2e-2)


def test_plain_tail_matches_jax_blocked_q():
    """T = 50 is no multiple of the JAX kernel's 16-row q-block: its pad
    rows must not leak, and the port (no q-blocks) must agree. fp32 1e-5,
    as tests/test_encoder_layer.py holds the blocked kernel to itself."""
    B, T, H, D, ff = 1, 50, 2, 32, 128
    x = _mk(1, B, T, H, D, ff)
    want = _jax(x, jnp.float32, H, block_q=16)
    out = encoder_block_tail_plain(*_torch_args(x, torch.float32))
    np.testing.assert_allclose(out.numpy(), want, atol=3e-5, rtol=1e-5)


def test_wrapper_runs_plain_on_cpu_and_counts_no_launch():
    x = _mk(2, 1, 20, 2, 32, 128)
    args = _torch_args(x, torch.float32)
    before = encoder_block_tail.launches
    out = encoder_block_tail(*args)
    assert torch.equal(out, encoder_block_tail_plain(*args))
    assert encoder_block_tail.launches == before


def test_wrapper_refuses_devices_without_a_kernel():
    args = [t.to("meta") for t in _torch_args(_mk(3, 1, 8, 2, 32, 64),
                                              torch.float32)]
    with pytest.raises(ValueError, match="no kernel for device"):
        encoder_block_tail(*args)


def _check_args(B=1, T=8, H=2, D=64, ff=64, dtype=torch.float32):
    x = _mk(4, B, T, H, D, ff)
    return list(_torch_args(x, dtype))


def test_kernel_checks_accept_supported_shapes():
    a = _check_args()
    encoder_layer._check(*a[:7], tuple(a[7:]))


@pytest.mark.parametrize("bad,match", [
    ("head_dim", "head_dim 64"),
    ("dtype", "is torch.bfloat16"),
    ("contiguity", "not contiguous"),
    ("shape", "expected"),
    ("float16", "no kernel for torch.float16"),
])
def test_kernel_checks_reject(bad, match):
    a = _check_args(D=32) if bad == "head_dim" else _check_args()
    if bad == "dtype":
        a[4] = a[4].to(torch.bfloat16)
    elif bad == "contiguity":
        a[0] = a[0].transpose(1, 2).contiguous().transpose(1, 2)
    elif bad == "shape":
        a[5] = a[5][:, :-4]
    elif bad == "float16":
        a = [t.half() for t in a]
    with pytest.raises((ValueError, TypeError), match=match):
        encoder_layer._check(*a[:7], tuple(a[7:]))
