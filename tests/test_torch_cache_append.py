"""Port in-place cache append (whisper_tpu_torch/ops/cache_append.py): the
plain version against the JAX Pallas kernel in interpret mode (exact),
in-place storage, and the wrapper's checks. The CUDA kernel itself is
tested on the card (tests/test_torch_kernels_cuda.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_tpu.ops.cache_append import cache_append_rows as jax_append
from whisper_tpu_torch.ops.cache_append import cache_append_rows

torch.set_num_threads(2)


def _mk(seed, L=3, B=2, H=4, S=32, D=64):
    rng = np.random.RandomState(seed)
    return (rng.randn(L, B, H, S, D).astype(np.float32),
            rng.randn(L, B, H, S, D).astype(np.float32),
            rng.randn(L, B, H, D).astype(np.float32),
            rng.randn(L, B, H, D).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pos", [0, 5, 8, 17, 31])
def test_append_matches_jax_kernel_in_place(pos, dtype):
    """A copy: exact equality in both dtypes."""
    ck, cv, kn, vn = _mk(pos)
    jdt = jnp.dtype(dtype)
    jk, jv = jax_append(*(jnp.asarray(a, jdt) for a in (ck, cv, kn, vn)),
                        pos, interpret=True)
    tdt = getattr(torch, dtype)
    tk, tv, tkn, tvn = (torch.from_numpy(a).to(tdt) for a in (ck, cv, kn, vn))
    ptr_k, ptr_v = tk.data_ptr(), tv.data_ptr()
    ok, ov = cache_append_rows(tk, tv, tkn, tvn, pos)
    assert ok is tk and ov is tv
    assert ok.data_ptr() == ptr_k and ov.data_ptr() == ptr_v
    np.testing.assert_array_equal(ok.float().numpy(),
                                  np.asarray(jk.astype(jnp.float32)))
    np.testing.assert_array_equal(ov.float().numpy(),
                                  np.asarray(jv.astype(jnp.float32)))


def test_append_touches_only_row_pos():
    ck, cv, kn, vn = (torch.from_numpy(a) for a in _mk(9))
    k0, v0 = ck.clone(), cv.clone()
    cache_append_rows(ck, cv, kn, vn, 7)
    keep = torch.ones(ck.shape[3], dtype=torch.bool)
    keep[7] = False
    assert torch.equal(ck[:, :, :, keep], k0[:, :, :, keep])
    assert torch.equal(cv[:, :, :, keep], v0[:, :, :, keep])
    assert torch.equal(ck[:, :, :, 7], kn) and torch.equal(cv[:, :, :, 7], vn)


def test_append_counts_no_launch_on_cpu():
    ck, cv, kn, vn = (torch.from_numpy(a) for a in _mk(1))
    before = cache_append_rows.launches
    cache_append_rows(ck, cv, kn, vn, 3)
    assert cache_append_rows.launches == before


@pytest.mark.parametrize("pos", [-1, 32])
def test_append_rejects_pos_outside_cache(pos):
    ck, cv, kn, vn = (torch.from_numpy(a) for a in _mk(2))
    with pytest.raises(IndexError):
        cache_append_rows(ck, cv, kn, vn, pos)


def test_append_rejects_mismatched_rows():
    ck, cv, kn, vn = (torch.from_numpy(a) for a in _mk(3))
    with pytest.raises(ValueError, match="expected"):
        cache_append_rows(ck, cv, kn[:, :1], vn, 0)
    with pytest.raises(TypeError, match="bfloat16"):
        cache_append_rows(ck, cv, kn.to(torch.bfloat16), vn, 0)
    with pytest.raises(ValueError, match="no kernel for device"):
        cache_append_rows(*(t.to("meta") for t in (ck, cv, kn, vn)), 0)
