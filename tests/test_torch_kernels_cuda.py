"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs an NVIDIA GPU and nvcc: they carry the `cuda`
marker and skip when CUDA is absent. Run them on a GPU machine with

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda -q
"""

import pytest
import torch

from whisper_tpu_torch.ops.cache_append import (
    cache_append_rows,
    cache_append_rows_plain,
)
from whisper_tpu_torch.ops.encoder_layer import (
    encoder_block_tail,
    encoder_block_tail_plain,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda is not available)")
    torch.backends.cuda.matmul.allow_tf32 = False   # the plain oracle in fp32
    return torch.device("cuda")


def _tail_args(B, T, H, ff, dtype, dev, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    D, d = 64, H * 64

    def r(*s, scale=1.0, shift=0.0):
        return (torch.randn(*s, generator=g) * scale + shift).to(dev)

    mats = [r(B, T, H, D), r(B, H, T, D), r(B, H, T, D), r(B, T, d),
            r(d, d, scale=0.05), r(d, ff, scale=0.05), r(ff, d, scale=0.05)]
    vecs = [r(d, scale=0.1), r(ff, scale=0.1), r(d, scale=0.1),
            r(d, scale=0.2, shift=1.0), r(d, scale=0.1)]
    return [m.to(dtype) for m in mats] + vecs


# fp32 1e-4: fp32 FMAs against cuBLAS fp32 over K <= 1536 and S <= 1500;
# bf16 atol 0.06 / rtol 2e-2: one bf16 ulp of the O(4) outputs, where the
# kernel's online softmax rounds p at another running max than the
# two-pass plain version.
@pytest.mark.parametrize("dtype,atol,rtol", [
    (torch.float32, 1e-4, 0.0), (torch.bfloat16, 0.06, 2e-2)])
@pytest.mark.parametrize("B,T,H,ff", [
    (2, 50, 2, 512),        # T not a multiple of the 64-row q tile
    (1, 1500, 6, 1536),     # Whisper-tiny's encoder block
    (3, 130, 4, 1024),      # a ragged last key tile and row tile
])
def test_encoder_tail_kernel_matches_plain(dev, dtype, atol, rtol, B, T, H,
                                           ff):
    args = _tail_args(B, T, H, ff, dtype, dev)
    before = encoder_block_tail.launches
    got = encoder_block_tail(*args)
    torch.cuda.synchronize()
    assert encoder_block_tail.launches == before + 1
    want = encoder_block_tail_plain(*args)
    assert got.dtype == dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


def test_encoder_tail_kernel_refuses_noncontiguous(dev):
    args = _tail_args(1, 64, 2, 256, torch.float32, dev)
    args[0] = args[0].transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="not contiguous"):
        encoder_block_tail(*args)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,pos", [
    ((4, 32, 6, 128, 64), 0), ((4, 32, 6, 128, 64), 1),
    ((4, 32, 6, 128, 64), 63), ((4, 32, 6, 128, 64), 127),
    ((2, 3, 5, 16, 64), 15),   # L*B*H = 30: a ragged last block of rows
])
def test_cache_append_kernel_matches_plain(dev, dtype, shape, pos):
    g = torch.Generator(device="cpu").manual_seed(pos)
    L, B, H, S, D = shape
    ck = torch.randn(shape, generator=g).to(dev, dtype)
    cv = torch.randn(shape, generator=g).to(dev, dtype)
    kn = torch.randn((L, B, H, D), generator=g).to(dev, dtype)
    vn = torch.randn((L, B, H, D), generator=g).to(dev, dtype)
    want_k, want_v = cache_append_rows_plain(ck.clone(), cv.clone(), kn, vn,
                                             pos)
    ptr_k, ptr_v = ck.data_ptr(), cv.data_ptr()
    before = cache_append_rows.launches
    ok, ov = cache_append_rows(ck, cv, kn, vn, pos)
    torch.cuda.synchronize()
    assert cache_append_rows.launches == before + 1
    assert ok.data_ptr() == ptr_k and ov.data_ptr() == ptr_v
    assert torch.equal(ok, want_k) and torch.equal(ov, want_v)


def test_cache_append_kernel_refuses_pos_past_end(dev):
    ck = torch.zeros((1, 1, 1, 8, 64), device=dev)
    kn = torch.zeros((1, 1, 1, 64), device=dev)
    with pytest.raises(IndexError):
        cache_append_rows(ck, ck.clone(), kn, kn, 8)
