"""Port in-place cache appends (whisper_tpu_torch/ops/cache_append.py), the
scalar and the ragged form: the plain versions against the JAX Pallas
kernels in interpret mode (exact), in-place storage, and the wrappers'
checks. The CUDA kernels themselves are tested on the card
(tests/test_torch_kernels_cuda.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_tpu.ops.cache_append import cache_append_rows as jax_append
from whisper_tpu.ops.cache_append import (
    cache_append_rows_ragged as jax_append_ragged,
)
from whisper_tpu_torch.ops.cache_append import (
    cache_append_rows,
    cache_append_rows_ragged,
    cache_append_rows_ragged_plain,
)

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


@pytest.mark.parametrize("pos", [0, 7, 31])
def test_append_int8_matches_jax_kernel_in_place(pos):
    """int8 caches (the self_kv_quant step's quantized rows): exact against
    the JAX kernel in interpret mode, in place."""
    rng = np.random.RandomState(pos)
    L, B, H, S, D = 2, 2, 3, 32, 64
    arrs = [rng.randint(-127, 128, shape).astype(np.int8)
            for shape in ((L, B, H, S, D), (L, B, H, S, D), (L, B, H, D),
                          (L, B, H, D))]
    jk, jv = jax_append(*(jnp.asarray(a) for a in arrs), pos, interpret=True)
    tk, tv, tkn, tvn = (torch.from_numpy(a) for a in arrs)
    ptr_k, ptr_v = tk.data_ptr(), tv.data_ptr()
    before = cache_append_rows.launches
    ok, ov = cache_append_rows(tk, tv, tkn, tvn, pos)
    assert cache_append_rows.launches == before
    assert ok.dtype == torch.int8
    assert ok.data_ptr() == ptr_k and ov.data_ptr() == ptr_v
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(ov.numpy(), np.asarray(jv))


def test_append_refuses_mixed_int8_rows():
    """int8 caches take int8 rows only: the step quantizes them first."""
    ck, cv, kn, vn = (torch.from_numpy(a) for a in _mk(8))
    with pytest.raises(TypeError, match="int8"):
        cache_append_rows(ck.to(torch.int8), cv.to(torch.int8), kn, vn, 0)


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


# ---------------------------------------------------------------------------
# cache_append_rows_ragged: row b lands at its own position pos[b]
# ---------------------------------------------------------------------------

def _mk_ragged(seed, L=3, B=6, H=4, S=32, D=64):
    return _mk(seed, L=L, B=B, H=H, S=S, D=D)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pos", [
    (0, 31, 5, 5, 17, 0),        # edges and repeated positions
    (3, 3, 3, 3, 3, 3),          # every row at one position
    (31, 30, 1, 0, 8, 16),
])
def test_ragged_plain_matches_jax_kernel(pos, dtype):
    """The plain version against the JAX Pallas kernel in interpret mode:
    exact in both dtypes, in place."""
    ck, cv, kn, vn = _mk_ragged(sum(pos))
    jdt = jnp.dtype(dtype)
    jk, jv = jax_append_ragged(
        *(jnp.asarray(a, jdt) for a in (ck, cv, kn, vn)),
        jnp.asarray(pos, jnp.int32), interpret=True)
    tdt = getattr(torch, dtype)
    tk, tv, tkn, tvn = (torch.from_numpy(a).to(tdt) for a in (ck, cv, kn, vn))
    ptr_k, ptr_v = tk.data_ptr(), tv.data_ptr()
    ok, ov = cache_append_rows_ragged_plain(tk, tv, tkn, tvn,
                                            torch.tensor(pos))
    assert ok.data_ptr() == ptr_k and ov.data_ptr() == ptr_v
    np.testing.assert_array_equal(ok.float().numpy(),
                                  np.asarray(jk.astype(jnp.float32)))
    np.testing.assert_array_equal(ov.float().numpy(),
                                  np.asarray(jv.astype(jnp.float32)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bad", [-1, 32, 1000])
def test_ragged_leaves_rows_outside_the_cache_untouched(dtype, bad):
    """A row whose pos[b] lies outside [0, S) keeps its cache exactly; the
    other rows land at their positions (the CUDA kernel skips such rows
    the same way)."""
    ck, cv, kn, vn = (torch.from_numpy(a).to(dtype) for a in _mk_ragged(4))
    pos = torch.tensor([2, bad, 31, 0, 7, 7])
    k0, v0 = ck.clone(), cv.clone()
    cache_append_rows_ragged(ck, cv, kn, vn, pos)
    assert torch.equal(ck[:, 1], k0[:, 1]) and torch.equal(cv[:, 1], v0[:, 1])
    for b in (0, 2, 3, 4, 5):
        p = int(pos[b])
        assert torch.equal(ck[:, b, :, p], kn[:, b])
        assert torch.equal(cv[:, b, :, p], vn[:, b])
        keep = torch.arange(ck.shape[3]) != p
        assert torch.equal(ck[:, b][:, :, keep], k0[:, b][:, :, keep])


def test_ragged_counts_no_launch_on_cpu_and_refuses_int32_pos():
    """The CPU call takes the plain version and counts no launch; positions
    are int64 only (the engine's dtype), so an int32 vector raises."""
    ck, cv, kn, vn = (torch.from_numpy(a) for a in _mk_ragged(5))
    before = cache_append_rows_ragged.launches
    want_k, want_v = cache_append_rows_ragged_plain(
        ck.clone(), cv.clone(), kn, vn, torch.arange(6))
    got_k, got_v = cache_append_rows_ragged(ck, cv, kn, vn, torch.arange(6))
    assert cache_append_rows_ragged.launches == before
    assert torch.equal(got_k, want_k) and torch.equal(got_v, want_v)
    with pytest.raises(ValueError, match="int64"):
        cache_append_rows_ragged(ck, cv, kn, vn,
                                 torch.arange(6, dtype=torch.int32))


def test_ragged_rejects_bad_arguments():
    ck, cv, kn, vn = (torch.from_numpy(a) for a in _mk_ragged(6))
    pos = torch.zeros(6, dtype=torch.long)
    with pytest.raises(ValueError, match="expected"):
        cache_append_rows_ragged(ck, cv, kn[:, :1], vn, pos)
    with pytest.raises(TypeError, match="bfloat16"):
        cache_append_rows_ragged(ck, cv, kn.to(torch.bfloat16), vn, pos)
    with pytest.raises(ValueError, match="pos must be"):
        cache_append_rows_ragged(ck, cv, kn, vn, pos[:5])
    with pytest.raises(ValueError, match="pos must be"):
        cache_append_rows_ragged(ck, cv, kn, vn, pos.float())
    with pytest.raises(ValueError, match="pos must be"):
        cache_append_rows_ragged(ck, cv, kn, vn, [0] * 6)
    with pytest.raises(ValueError, match="no kernel for device"):
        cache_append_rows_ragged(*(t.to("meta") for t in (ck, cv, kn, vn)),
                                 pos.to("meta"))
