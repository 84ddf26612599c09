"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs an NVIDIA GPU and nvcc: they carry the `cuda`
marker and skip when CUDA is absent. Run them on a GPU machine with

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda -q
"""

import pytest
import torch

from whisper_tpu_torch.config import CONFIGS
from whisper_tpu_torch.ops.attention import multi_head_attention
from whisper_tpu_torch.ops.cache_append import (
    cache_append_rows,
    cache_append_rows_plain,
    cache_append_rows_ragged,
    cache_append_rows_ragged_plain,
)
from whisper_tpu_torch.ops.decode_attention import (
    decode_attention,
    decode_attention_bg,
    decode_attention_bg_plain,
    decode_attention_bh,
    decode_attention_bh_plain,
    decode_attention_plain,
    decode_attention_q8,
    decode_attention_q8_bh,
    decode_attention_q8_plain,
)
from whisper_tpu_torch.ops.decoder_step import (
    PackedDecoder,
    fused_decoder_step,
    fused_decoder_step_plain,
    vec_offsets,
)
from whisper_tpu_torch.ops import _build
from whisper_tpu_torch.ops import encoder_layer as tail_mod
from whisper_tpu_torch.ops import flash_attention as flash_mod
from whisper_tpu_torch.ops.encoder_layer import (
    encoder_block_tail,
    encoder_block_tail_backward,
    encoder_block_tail_backward_plain,
    encoder_block_tail_plain,
    encoder_block_tail_q8,
    encoder_block_tail_q8_plain,
    tail_fits_smem,
    tail_q8_mlp,
)
from whisper_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_backward,
    flash_attention_backward_plain,
    flash_attention_plain,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda is not available)")
    torch.backends.cuda.matmul.allow_tf32 = False   # the plain oracle in fp32
    return torch.device("cuda")


def _tail_args(B, T, H, ff, dtype, dev, seed=0, fan_in=False):
    """The tail's operands; the matrices at 0.05, or with `fan_in` at
    1/sqrt(fan-in) (0.05 at tiny's d = 384), which keeps the activations
    of the wide layers at tiny's scale."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    D, d = 64, H * 64

    def r(*s, scale=1.0, shift=0.0):
        return (torch.randn(*s, generator=g) * scale + shift).to(dev)

    sd, sf = (d ** -0.5, ff ** -0.5) if fan_in else (0.05, 0.05)
    mats = [r(B, T, H, D), r(B, H, T, D), r(B, H, T, D), r(B, T, d),
            r(d, d, scale=sd), r(d, ff, scale=sd), r(ff, d, scale=sf)]
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
    (1, 300, 12, 3072),     # small's width
    (1, 200, 16, 4096),     # medium's
    (1, 150, 20, 5120),     # large's and turbo's
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


# The MLP tiles' edges: base width, row counts B*T that are no multiple
# of the 128-row tile, d and ff multiples of 64 but not of the 128 columns
# of a tile (a tile with 64 dead columns), and the narrowest widths.
@pytest.mark.parametrize("dtype,atol,rtol", [
    (torch.float32, 1e-4, 0.0), (torch.bfloat16, 0.06, 2e-2)])
@pytest.mark.parametrize("B,T,H,ff", [
    (2, 1500, 8, 2048),     # Whisper-base's encoder block
    (1, 1501, 8, 2048),     # base, 1501 rows: a 93-row last tile
    (3, 37, 6, 1536),       # 111 rows: one ragged row tile
    (2, 64, 1, 128),        # d = 64: half a column tile, one k stage
    (1, 100, 3, 320),       # d = 192, ff = 320: partial last column tiles
    (2, 64, 2, 256),        # the nano widths
    (1, 70, 13, 832),       # d and ff no multiple of the 128 columns of
                            # a tile, 70 rows of a 128-row tile
    (3, 100, 9, 2304),      # d = 576
])
def test_encoder_tail_kernel_mlp_edges_match_plain(dev, dtype, atol, rtol,
                                                   B, T, H, ff):
    args = _tail_args(B, T, H, ff, dtype, dev, seed=T)
    got = encoder_block_tail(*args)
    torch.cuda.synchronize()
    want = encoder_block_tail_plain(*args)
    assert got.dtype == dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,ff", [(6, 1536), (20, 5120)])
def test_encoder_tail_kernel_is_deterministic(dev, dtype, H, ff):
    """Fixed summation orders: two calls on the same inputs are bitwise
    equal (tiny and turbo widths, a ragged last tile)."""
    args = _tail_args(1, 1500, H, ff, dtype, dev, seed=9)
    assert torch.equal(encoder_block_tail(*args), encoder_block_tail(*args))


def _tail_q8_args(B, T, H, ff, dev, o_q, seed=0):
    """The int8 form's operands: _tail_args in bf16 with fc1, fc2 (and wo
    under o_q) quantized per output column, K-major. Past d = 512 the
    matrices are drawn at 1/sqrt(fan-in): at 0.05 the turbo-width
    activations grow 3.6-fold and the one-step quantization differences
    that the attention's rounding causes with them (0.32 at 4 of 192,000
    outputs against the whole plain version, beyond its 0.25)."""
    from whisper_tpu_torch.models.whisper import _quant_cols
    q, k, v, h, wo, fc1, fc2, *vecs = _tail_args(B, T, H, ff, torch.bfloat16,
                                                 dev, seed,
                                                 fan_in=H * 64 > 512)
    (f1q, f1s), (f2q, f2s) = _quant_cols(fc1), _quant_cols(fc2)
    wo_s = None
    if o_q:
        wo, wo_s = _quant_cols(wo)
    return [q, k, v, h, wo.t().contiguous(), f1q.t().contiguous(),
            f2q.t().contiguous(), *vecs, f1s, f2s, wo_s]


# Against the plain MLP fed the kernel's own attention rows: the int32
# sums are exact, so only LN2's sums in another order can move a value
# across a bf16 rounding point, and in such a row h2 by one bf16 ulp and
# y's and t1's quantization by one int8 step each (0.15, rtol 2e-2; at
# most 15% of the rows differ at all). Against the whole plain version,
# whose attention sums in another order and reaches the quantization of
# nearly every row: 0.25, rtol 2e-2 (chip_smoke.py TAIL_Q8_TOL).
@pytest.mark.parametrize("o_q", [True, False])
@pytest.mark.parametrize("B,T,H,ff", [
    (2, 50, 2, 512),        # T not a multiple of the 32-row block
    (1, 1500, 6, 1536),     # Whisper-tiny's encoder block
    (1, 1500, 8, 2048),     # base's
    (1, 300, 12, 3072),     # small's
    (1, 200, 16, 4096),     # medium's
    (1, 150, 20, 5120),     # large's and turbo's
    (1, 70, 13, 832),       # d and ff no multiple of 128 (a partial k
                            # stage of int8), 70 rows of a 128-row tile
])
def test_encoder_tail_q8_kernel_matches_plain(dev, o_q, B, T, H, ff):
    args = _tail_q8_args(B, T, H, ff, dev, o_q, seed=T)
    before = encoder_block_tail_q8.launches
    got = encoder_block_tail_q8(*args).float()
    torch.cuda.synchronize()
    assert encoder_block_tail_q8.launches == before + 1
    att = flash_attention(args[0], args[1], args[2]).reshape(args[3].shape)
    same = tail_q8_mlp(att, *args[3:]).float()
    torch.testing.assert_close(got, same, atol=0.15, rtol=2e-2)
    rows = (got != same).reshape(-1, got.shape[-1]).any(-1)
    assert rows.float().mean() <= 0.15
    full = encoder_block_tail_q8_plain(*args).float()
    torch.testing.assert_close(got, full, atol=0.25, rtol=2e-2)


@pytest.mark.parametrize("H,ff", [(6, 1536), (20, 5120)])
def test_encoder_tail_q8_kernel_is_deterministic(dev, H, ff):
    args = _tail_q8_args(1, 1500, H, ff, dev, True, seed=9)
    assert torch.equal(encoder_block_tail_q8(*args),
                       encoder_block_tail_q8(*args))


def test_encoder_tail_q8_refuses_what_the_kernel_does_not_take(dev):
    """No fallback: a width past the kernel's (d = 1,344), fp32, or a
    non-contiguous operand raises on a CUDA tensor."""
    with pytest.raises(ValueError, match="up to 1280"):
        encoder_block_tail_q8(*_tail_q8_args(1, 64, 21, 5376, dev, True))
    args = _tail_q8_args(1, 64, 2, 256, dev, True)
    with pytest.raises(TypeError, match="bf16 only"):
        encoder_block_tail_q8(*[a.float() for a in args[:4]], *args[4:])
    args[0] = args[0].transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="not contiguous"):
        encoder_block_tail_q8(*args)


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


def _ragged_args(shape, dtype, dev, pos, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    L, B, H, S, D = shape

    def draw(s):
        if dtype == torch.int8:
            return torch.randint(-127, 128, s, generator=g,
                                 dtype=torch.int8).to(dev)
        return torch.randn(s, generator=g).to(dev, dtype)

    ck, cv = draw(shape), draw(shape)
    kn, vn = draw((L, B, H, D)), draw((L, B, H, D))
    return ck, cv, kn, vn, pos.to(dev)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int8])
@pytest.mark.parametrize("shape,pos", [
    # tiny's engine: 0, S-1, a repeated value, one row past the end
    ((4, 32, 6, 448, 64), [0, 447] + [5, 5, 5] + list(range(100, 126))
     + [448]),
    ((4, 8, 20, 448, 64), [0, 447, 9, 9, 300, 17, 2, -1]),   # turbo's
    ((2, 3, 5, 16, 64), [15, -7, 3]),   # L*B*H = 30: a ragged last block
])
def test_cache_append_ragged_kernel_matches_plain(dev, dtype, shape, pos):
    """Exact and in place; a row whose position lies outside [0, S) keeps
    its cache."""
    ck, cv, kn, vn, pos = _ragged_args(shape, dtype, dev, torch.tensor(pos))
    want_k, want_v = cache_append_rows_ragged_plain(ck.clone(), cv.clone(),
                                                    kn, vn, pos)
    outside = (pos < 0) | (pos >= shape[3])
    before = ck[:, outside].clone()
    ptr_k, ptr_v = ck.data_ptr(), cv.data_ptr()
    before_n = cache_append_rows_ragged.launches
    ok, ov = cache_append_rows_ragged(ck, cv, kn, vn, pos)
    torch.cuda.synchronize()
    assert cache_append_rows_ragged.launches == before_n + 1
    assert ok.data_ptr() == ptr_k and ov.data_ptr() == ptr_v
    assert torch.equal(ok, want_k) and torch.equal(ov, want_v)
    assert outside.any() and torch.equal(ok[:, outside], before)


def test_cache_append_ragged_reads_no_position_on_the_host(dev):
    """The wrapper captures into a CUDA graph, where a host read of `pos`
    would raise; replays with new positions write the new rows."""
    shape = (2, 4, 3, 32, 64)
    pos = torch.tensor([0, 5, 5, 31])
    ck, cv, kn, vn, pos = _ragged_args(shape, torch.bfloat16, dev, pos)
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        cache_append_rows_ragged(ck, cv, kn, vn, pos)       # warm-up
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph):
        cache_append_rows_ragged(ck, cv, kn, vn, pos)
    pos.copy_(torch.tensor([7, 8, 9, 10]))
    want_k, want_v = cache_append_rows_ragged_plain(ck.clone(), cv.clone(),
                                                    kn, vn, pos)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(ck, want_k) and torch.equal(cv, want_v)


def test_cache_append_ragged_refuses_what_the_kernel_does_not_take(dev):
    ck, cv, kn, vn, pos = _ragged_args((1, 2, 1, 8, 64), torch.float32, dev,
                                       torch.tensor([0, 1]))
    with pytest.raises(ValueError, match="pos"):
        cache_append_rows_ragged(ck, cv, kn, vn, pos.cpu())
    with pytest.raises(ValueError, match="pos"):
        cache_append_rows_ragged(ck, cv, kn, vn, pos.float())
    with pytest.raises(ValueError, match="int64"):
        cache_append_rows_ragged(ck, cv, kn, vn, pos.int())
    with pytest.raises(TypeError):
        cache_append_rows_ragged(ck.half(), cv.half(), kn.half(), vn.half(),
                                 pos)
    with pytest.raises(ValueError, match="not contiguous"):
        cache_append_rows_ragged(ck, cv, kn, vn,
                                 torch.arange(4, device=dev)[::2])


def test_continuous_engine_on_the_card_matches_the_cpu(dev):
    """The engine at nano width in fp32: the card's tokens (ragged kernel,
    cuBLAS with TF32 off) equal the CPU's plain path for a schedule with
    more requests than slots and a <|startofprev|> prompt."""
    import numpy as np

    from whisper_tpu_torch import get_config, weights
    from whisper_tpu_torch.serving_continuous import ContinuousBatcher
    cfg = get_config("tiny").replace(name="cuda-cont-nano", d_model=64,
                                     n_heads=1, n_audio_layers=2,
                                     n_text_layers=2)
    params = weights.init_params(cfg, seed=3)
    rng = np.random.RandomState(0)
    clips = [(rng.randn(16_000 * s) * 0.1).astype(np.float32)
             for s in (2, 3, 4, 5)]
    outs = {}
    for device in ("cpu", "cuda"):
        eng = ContinuousBatcher(params, cfg, max_slots=3, max_new=6,
                                device=device)
        rids = [eng.submit(c) for c in clips[:3]]
        rids.append(eng.submit(clips[3], prev_tokens=list(range(700, 730))))
        before = cache_append_rows_ragged.launches
        out = eng.run_until_idle()
        outs[device] = [out[r] for r in rids]
        if device == "cuda":
            assert cache_append_rows_ragged.launches > before
    assert outs["cuda"] == outs["cpu"]


def test_tail_gate_is_the_kernels_answer(dev):
    """For every width of the family, tail_fits_smem answers as the kernel
    does: every Whisper width fits and runs, in both element types; a
    width past the kernel's (d = 1,344) is refused."""
    for d in sorted({c.d_model for c in CONFIGS.values()}):
        assert tail_fits_smem(d, 4 * d, dev)
        for dtype in (torch.float32, torch.bfloat16):
            encoder_block_tail(*_tail_args(1, 64, d // 64, 4 * d, dtype,
                                           dev))
            torch.cuda.synchronize()
    assert not tail_fits_smem(1344, 4 * 1344, dev)
    with pytest.raises(ValueError, match="up to 1280"):
        encoder_block_tail(*_tail_args(1, 64, 21, 4 * 1344, torch.bfloat16,
                                       dev))


def _flash_args(B, T, S, H, dtype, dev, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    return [torch.randn(s, generator=g).to(dev, dtype)
            for s in ((B, T, H, 64), (B, H, S, 64), (B, H, S, 64))]


# fp32 2e-5 / 1e-5: the kernel's online softmax and fp32 FMAs against the
# plain two-pass softmax and cuBLAS fp32, summed in other orders. bf16
# atol 2e-3 / rtol 1e-2: about one bf16 ulp of the output, where the kernel
# rounds p at a running max and the plain version at the final one.
_FLASH_TOL = {torch.float32: (2e-5, 1e-5), torch.bfloat16: (2e-3, 1e-2)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,S,H,kv_len,q_offset,causal", [
    (2, 300, 300, 3, None, 0, False),   # encoder-like, ragged tiles
    (1, 1500, 1500, 20, None, 0, False),  # one turbo encoder clip
    (4, 4, 1500, 20, None, 0, False),   # cross prefill
    (3, 4, 128, 2, 4, 0, True),         # prefill from position 0
    (2, 40, 448, 2, 140, 100, True),    # causal, q_offset 100
    (1, 130, 200, 2, 150, 20, True),    # several q tiles under causal
    (2, 5, 64, 2, 0, 0, False),         # kv_len 0: zeros
])
def test_flash_kernel_matches_plain(dev, dtype, B, T, S, H, kv_len,
                                    q_offset, causal):
    q, k, v = _flash_args(B, T, S, H, dtype, dev)
    before = flash_attention.launches
    got = flash_attention(q, k, v, kv_len, q_offset, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    want = flash_attention_plain(q, k, v, kv_len, q_offset, causal=causal)
    assert got.dtype == dtype and got.shape == want.shape
    atol, rtol = _FLASH_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)
    if kv_len == 0:
        assert not got.any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kv_len,q_offset,causal,poison_from", [
    (100, 0, False, 100), (140, 100, True, 140), (448, 100, True, 140)])
def test_flash_kernel_never_reads_poisoned_keys(dev, dtype, kv_len, q_offset,
                                                causal, poison_from):
    q, k, v = _flash_args(2, 40, 448, 2, dtype, dev, seed=1)
    clean = flash_attention(q, k, v, kv_len, q_offset, causal=causal)
    k[:, :, poison_from:] = float("nan")
    v[:, :, poison_from:] = float("nan")
    got = flash_attention(q, k, v, kv_len, q_offset, causal=causal)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    assert torch.equal(got, clean)


def test_flash_kernel_reads_strided_views(dev):
    """q, k, v as the encoder hands them over: views of one fused QKV
    projection, read in place."""
    B, T, H = 2, 100, 4
    d = 64 * H
    g = torch.Generator(device="cpu").manual_seed(2)
    qkv = torch.randn(B, T, 3 * d, generator=g).to(dev)
    q, k, v = qkv.chunk(3, dim=-1)
    q = q.reshape(B, T, H, 64)
    k = k.reshape(B, T, H, 64).permute(0, 2, 1, 3)
    v = v.reshape(B, T, H, 64).permute(0, 2, 1, 3)
    assert not (q.is_contiguous() or k.is_contiguous())
    got = flash_attention(q, k, v)
    want = flash_attention(q.contiguous(), k.contiguous(), v.contiguous())
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T", [127, 128, 129])
@pytest.mark.parametrize("S", [127, 128, 129])
def test_flash_kernel_tile_edges_match_plain(dev, dtype, T, S):
    """q and key counts one under, at and one over two of the bf16
    kernel's 64-row blocks and 64-key tiles."""
    q, k, v = _flash_args(2, T, S, 3, dtype, dev, seed=T + S)
    got = flash_attention(q, k, v)
    torch.cuda.synchronize()
    atol, rtol = _FLASH_TOL[dtype]
    torch.testing.assert_close(got.float(), flash_attention_plain(
        q, k, v).float(), atol=atol, rtol=rtol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,S,H,kv_len,q_offset,causal", [
    (2, 1500, 1500, 6, None, 0, False),   # one tiny encoder layer, b2
    (2, 129, 300, 2, 200, 70, True),      # kv_len and diagonal inside tiles
    (1, 257, 448, 2, 331, 74, True),      # three q blocks, q_offset 74
])
def test_flash_kernel_long_and_causal_match_plain(dev, dtype, B, T, S, H,
                                                  kv_len, q_offset, causal):
    q, k, v = _flash_args(B, T, S, H, dtype, dev, seed=7)
    got = flash_attention(q, k, v, kv_len, q_offset, causal=causal)
    torch.cuda.synchronize()
    want = flash_attention_plain(q, k, v, kv_len, q_offset, causal=causal)
    atol, rtol = _FLASH_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize("S", [64, 1500])
def test_flash_kernel_one_hot_rows_are_v_rows(dev, S):
    """Each query is a large multiple of one key, the keys orthonormal (S =
    64) or random unit vectors (S = 1500): p is one-hot to far below a bf16
    ulp, so every output row is exactly one V row. A layout or swizzle
    error in either product shows as a permuted row, not a small error."""
    B, T, H = 2, 300, 3
    g = torch.Generator(device="cpu").manual_seed(S)
    keys = torch.randn((B, H, S, 64), generator=g, dtype=torch.float64)
    if S == 64:
        keys = torch.linalg.qr(keys)[0].transpose(-1, -2)   # orthonormal rows
    keys = keys / keys.norm(dim=-1, keepdim=True)
    pick = torch.randint(0, S, (B, H, T), generator=g)
    q = 1000 * torch.gather(keys, 2, pick[..., None].expand(B, H, T, 64))
    v = torch.randn((B, H, S, 64), generator=g)
    q, k, v = (x.to(dev, torch.bfloat16) for x in (q.transpose(1, 2), keys, v))
    got = flash_attention(q, k, v)
    torch.cuda.synchronize()
    want = torch.gather(v, 2, pick.to(dev)[..., None].expand(B, H, T, 64))
    assert torch.equal(got, want.transpose(1, 2))


def test_flash_kernel_refuses_misaligned_bf16_views(dev):
    """The bf16 kernel copies 16 bytes at a time: a view one element past
    a 16-byte boundary raises before any launch."""
    n = 2 * 8 * 2 * 64
    buf = torch.zeros(n + 8, dtype=torch.bfloat16, device=dev)
    q = buf[1:n + 1].view(2, 8, 2, 64)
    k = torch.zeros((2, 2, 8, 64), dtype=torch.bfloat16, device=dev)
    before = flash_attention.launches
    with pytest.raises(ValueError, match="q does not start on a 16-byte"):
        flash_attention(q, k, k)
    with pytest.raises(ValueError, match="k does not start on a 16-byte"):
        flash_attention(k.transpose(1, 2), q.transpose(1, 2), k)
    assert flash_attention.launches == before


@pytest.mark.parametrize("T", [1, 4, 15, 16, 17, 63, 64, 65])
@pytest.mark.parametrize("S", [1, 7, 31, 32, 33, 63, 64, 65, 191])
def test_flash_fp32_kernel_micro_tile_edges_match_plain(dev, T, S):
    """fp32: query counts around a warp's 16 rows and the block's 64, key
    counts around the 8-key lane stride and one and two 32-key tiles."""
    q, k, v = _flash_args(3, T, S, 2, torch.float32, dev, seed=T * 7 + S)
    got = flash_attention(q, k, v)
    torch.cuda.synchronize()
    atol, rtol = _FLASH_TOL[torch.float32]
    torch.testing.assert_close(got, flash_attention_plain(q, k, v),
                               atol=atol, rtol=rtol)


@pytest.mark.parametrize("T,S,kv_len,q_offset", [
    (100, 300, 250, 150),     # the diagonal crosses four 32-key tiles
    (64, 64, 64, 0),          # the diagonal of one whole 64-row block
    (65, 200, 130, 0),        # a second q block of one row, kv_len inside
    (1, 448, 93, 92),         # one query at the last visible key
    (130, 448, 448, 318),     # the last 130 of 448 positions
])
def test_flash_fp32_kernel_causal_diagonal_matches_plain(dev, T, S, kv_len,
                                                         q_offset):
    q, k, v = _flash_args(2, T, S, 3, torch.float32, dev, seed=T + S)
    k[:, :, kv_len:] = float("nan")        # never read
    v[:, :, kv_len:] = float("nan")
    got = flash_attention(q, k, v, kv_len, q_offset, causal=True)
    torch.cuda.synchronize()
    want = flash_attention_plain(q, k, v, kv_len, q_offset, causal=True)
    atol, rtol = _FLASH_TOL[torch.float32]
    torch.testing.assert_close(got, want, atol=atol, rtol=rtol)


def test_flash_fp32_kernel_kv_len_0_gives_zeros(dev):
    q, k, v = _flash_args(2, 70, 130, 2, torch.float32, dev, seed=3)
    k.fill_(float("nan"))
    v.fill_(float("nan"))
    got = flash_attention(q, k, v, 0)
    torch.cuda.synchronize()
    assert not got.any()


@pytest.mark.parametrize("B,T,H", [(2, 1500, 6), (2, 100, 20)])
def test_flash_fp32_kernel_reads_fused_qkv_views(dev, B, T, H):
    """fp32 q, k, v as the encoder hands them over (head views of one
    fused QKV projection, read in place) against the plain version."""
    from whisper_tpu_torch.models.whisper import split_heads, split_heads_hm
    g = torch.Generator(device="cpu").manual_seed(B * T + H)
    qkv = torch.randn(B, T, 3 * 64 * H, generator=g).to(dev)
    q, k, v = qkv.chunk(3, dim=-1)
    q, k, v = split_heads(q, H), split_heads_hm(k, H), split_heads_hm(v, H)
    assert not (q.is_contiguous() or k.is_contiguous())
    got = flash_attention(q, k, v)
    torch.cuda.synchronize()
    atol, rtol = _FLASH_TOL[torch.float32]
    torch.testing.assert_close(got, flash_attention_plain(q, k, v),
                               atol=atol, rtol=rtol)


def test_flash_kernel_refuses_misaligned_fp32_views(dev):
    """The fp32 kernel copies 16 bytes at a time too: a view one element
    past a 16-byte boundary, or with a stride off 4 elements, raises
    before any launch, and the C entry refuses a misaligned pointer by
    itself."""
    from whisper_tpu_torch.ops import _build
    n = 2 * 8 * 2 * 64
    buf = torch.zeros(n + 4, device=dev)
    q = buf[1:n + 1].view(2, 8, 2, 64)
    k = torch.zeros((2, 2, 8, 64), device=dev)
    before = flash_attention.launches
    with pytest.raises(ValueError, match="q does not start on a 16-byte"):
        flash_attention(q, k, k)
    with pytest.raises(ValueError, match="v does not start on a 16-byte"):
        flash_attention(k.transpose(1, 2), k, q.transpose(1, 2))
    wide = torch.zeros((2, 2, 8, 66), device=dev)[..., :64]
    with pytest.raises(ValueError, match="k's strides .* 4 elements"):
        flash_attention(k.transpose(1, 2), wide, k)
    assert flash_attention.launches == before
    lib = _build.load_library()
    out = torch.empty((2, 8, 2, 64), device=dev)
    err = lib.wt_flash_attention(
        q.data_ptr(), k.data_ptr(), k.data_ptr(), out.data_ptr(), None, 2, 8,
        8, 2, 64, 8, 0, 0, *q.stride()[:3], *k.stride()[:3],
        *k.stride()[:3], 0, torch.cuda.current_stream(dev).cuda_stream)
    assert err != 0


def test_flash_kernel_refuses_head_dim_32(dev):
    q = torch.zeros((1, 4, 2, 32), device=dev)
    k = torch.zeros((1, 2, 8, 32), device=dev)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(q, k, k)


def test_long_cache_decode_raises_on_cuda(dev):
    """A T==1 read of a >= 4096-slot cache, which raised before
    decode_attention_bh was ported, launches that kernel by the auto gate
    and matches its plain version."""
    g = torch.Generator(device="cpu").manual_seed(3)
    q = torch.randn((2, 1, 2, 64), generator=g).to(dev)
    k, v = (torch.randn((2, 2, 4096, 64), generator=g).to(dev)
            for _ in range(2))
    before = decode_attention_bh.launches
    got = multi_head_attention(q, k, v, 3000)
    torch.cuda.synchronize()
    assert decode_attention_bh.launches == before + 1
    torch.testing.assert_close(got, decode_attention_bh_plain(q, k, v, 3000),
                               atol=2e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# decode_attention_bh, decode_attention_bg, decode_attention: fp32/bf16 K/V
# ---------------------------------------------------------------------------

_DECODE = {"bh": (decode_attention_bh, decode_attention_bh_plain, {}),
           "bg": (decode_attention_bg, decode_attention_bg_plain,
                  {"block_b": 1}),
           "per_head": (decode_attention, decode_attention_plain, {})}


def _decode_args(B, H, S, q_dtype, kv_dtype, dev, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    q = torch.randn((B, 1, H, 64), generator=g).to(dev, q_dtype)
    k, v = (torch.randn((B, H, S, 64), generator=g).to(dev, kv_dtype)
            for _ in range(2))
    return q, k, v


# fp32 2e-5 / 1e-5: online against two-pass softmax, fp32 sums in other
# orders; bf16 2e-3 / 1e-2: about one bf16 ulp of the output (and of p,
# where decode_attention rounds it to bf16 V at another running max).
_DECODE_TOL = {torch.float32: (2e-5, 1e-5), torch.bfloat16: (2e-3, 1e-2)}


@pytest.mark.parametrize("which", sorted(_DECODE))
@pytest.mark.parametrize("q_dtype,kv_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16)])
@pytest.mark.parametrize("B,H,S,kv_len", [
    (32, 6, 1500, None),        # tiny b32's cross read
    (32, 20, 1500, None),       # turbo b32's
    (32, 6, 448, 93),           # tiny's self cache, mid-decode
    (2, 3, 200, 0), (2, 3, 200, 1), (2, 3, 200, 77), (2, 3, 200, 199),
    (1, 2, 4096, 3000),         # the >= 4096-slot gate's read
])
def test_decode_kernel_matches_plain(dev, which, q_dtype, kv_dtype, B, H, S,
                                     kv_len):
    fn, plain, kw = _DECODE[which]
    args = _decode_args(B, H, S, q_dtype, kv_dtype, dev)
    before = fn.launches
    got = fn(*args, kv_len, **kw)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    want = plain(*args, kv_len, **kw)
    assert got.dtype == q_dtype and got.shape == want.shape
    bf16 = torch.bfloat16 in (q_dtype, kv_dtype) and (
        q_dtype == torch.bfloat16 or which == "per_head")
    atol, rtol = _DECODE_TOL[torch.bfloat16 if bf16 else torch.float32]
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)
    if kv_len == 0:
        assert not got.any()


@pytest.mark.parametrize("which", sorted(_DECODE))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_never_reads_past_kv_len(dev, which, dtype):
    fn, _, kw = _DECODE[which]
    q, k, v = _decode_args(2, 3, 300, dtype, dtype, dev, seed=1)
    clean = fn(q, k, v, 130, **kw)
    k[:, :, 130:] = float("nan")
    v[:, :, 130:] = float("nan")
    got = fn(q, k, v, 130, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, clean)


def test_decode_bg_takes_block_b_as_jax_does(dev):
    """block_b is a check, not a launch shape: bg at block_b 8 equals bh;
    a block_b that does not divide the batch raises."""
    q, k, v = _decode_args(32, 6, 1500, torch.bfloat16, torch.bfloat16, dev)
    assert torch.equal(decode_attention_bg(q, k, v, 500, block_b=8),
                       decode_attention_bh(q, k, v, 500))
    with pytest.raises(ValueError, match="does not divide"):
        decode_attention_bg(q[:6], k[:6], v[:6], block_b=4)


@pytest.mark.parametrize("which", sorted(_DECODE))
def test_decode_kernel_refuses_what_it_does_not_take(dev, which):
    fn, _, kw = _DECODE[which]
    q, k, v = _decode_args(1, 2, 16, torch.float32, torch.float32, dev)
    with pytest.raises(ValueError, match="head_dim"):
        fn(q[..., :32].contiguous(), k[..., :32].contiguous(),
           v[..., :32].contiguous(), **kw)
    with pytest.raises(ValueError, match="not contiguous"):
        fn(q, k.transpose(1, 2).contiguous().transpose(1, 2), v, **kw)
    with pytest.raises(TypeError, match="query"):
        fn(q.half(), k, v, **kw)
    with pytest.raises(TypeError, match="one dtype"):
        fn(q, k, v.bfloat16(), **kw)
    with pytest.raises(ValueError, match="is on"):
        fn(q, k.cpu(), v, **kw)


@pytest.mark.parametrize("which", sorted(_DECODE))
@pytest.mark.parametrize("kv_len", [511, 512, 513, 767, 768, 769, 1199,
                                    1200, 1201, 1499, 1500])
def test_decode_kernel_at_split_boundaries_matches_plain(dev, which, kv_len):
    """A bf16 read of 2 x 3 rows, which the plan splits, with kv_len where
    it changes its split count (512: two splits of 256) and one key either
    side of split boundaries (3 x 256, 4 x 300); NaN past kv_len."""
    from whisper_tpu_torch.ops.decode_attention import _split_plan
    fn, plain, kw = _DECODE[which]
    q, k, v = _decode_args(2, 3, 1500, torch.bfloat16, torch.bfloat16, dev,
                           seed=kv_len)
    k[:, :, kv_len:] = float("nan")
    v[:, :, kv_len:] = float("nan")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert _split_plan(2 * 3, kv_len, sms)[0] == max(1, kv_len // 256)
    got = fn(q, k, v, kv_len, **kw)
    torch.cuda.synchronize()
    atol, rtol = _DECODE_TOL[torch.bfloat16]
    torch.testing.assert_close(got.float(), plain(q, k, v, kv_len, **kw)
                               .float(), atol=atol, rtol=rtol)


@pytest.mark.parametrize("which", sorted(_DECODE))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,S,kv_len", [
    (4, 6, 8192, 8000),          # the long cache: many splits
    (32, 6, 448, 93),            # one split: the block writes out itself
    (2, 1, 1500, 1500),          # two rows: as many splits as the plan allows
])
def test_decode_kernel_split_reads_never_read_past_kv_len(dev, which, dtype,
                                                          B, H, S, kv_len):
    fn, plain, kw = _DECODE[which]
    q, k, v = _decode_args(B, H, S, dtype, dtype, dev, seed=B + S)
    k[:, :, kv_len:] = float("nan")
    v[:, :, kv_len:] = float("nan")
    got = fn(q, k, v, kv_len, **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    atol, rtol = _DECODE_TOL[dtype]
    torch.testing.assert_close(got.float(), plain(q, k, v, kv_len, **kw)
                               .float(), atol=atol, rtol=rtol)


def _graph_of(fn):
    """fn() captured once in a CUDA graph, after a warm-up on a side
    stream; returns (graph, the output tensor of the captured call)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    return graph, out


@pytest.mark.parametrize("which", sorted(_DECODE) + ["q8_bh", "q8"])
@pytest.mark.parametrize("B,H,S,kv_len", [(2, 3, 1500, 1500),
                                          (4, 6, 8192, 8000),
                                          (32, 6, 1500, 1500),
                                          (32, 6, 448, 93)])
def test_decode_kernel_is_deterministic_across_calls_and_replay(
        dev, which, B, H, S, kv_len):
    """The split partials are merged in index order whichever block comes
    last: two calls and a CUDA-graph replay are bitwise equal."""
    if which.startswith("q8"):
        fn = decode_attention_q8_bh if which == "q8_bh" else \
            decode_attention_q8
        args, kw = _q8_args(B, H, S, torch.bfloat16, dev, seed=4), {}
    else:
        fn, _, kw = _DECODE[which]
        args = _decode_args(B, H, S, torch.bfloat16, torch.bfloat16, dev,
                            seed=4)
    first = fn(*args, kv_len, **kw)
    second = fn(*args, kv_len, **kw)
    graph, captured = _graph_of(lambda: fn(*args, kv_len, **kw))
    graph.replay()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    assert torch.equal(captured, first)


@pytest.mark.parametrize("which", sorted(_DECODE))
def test_decode_split_reads_on_two_streams_at_once_agree(dev, which):
    """Split reads share no state: two reads of the same shape over other
    data, launched over and over on two streams at once, each give their
    one-stream answer."""
    fn, _, kw = _DECODE[which]
    a = _decode_args(4, 6, 1500, torch.bfloat16, torch.bfloat16, dev, seed=1)
    b = _decode_args(4, 6, 1500, torch.bfloat16, torch.bfloat16, dev, seed=2)
    want_a, want_b = fn(*a, **kw), fn(*b, **kw)
    streams = (torch.cuda.Stream(), torch.cuda.Stream())
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    outs = []
    for _ in range(50):
        for s, args in zip(streams, (a, b)):
            with torch.cuda.stream(s):
                outs.append(fn(*args, **kw))
    torch.cuda.synchronize()
    for i, got in enumerate(outs):
        assert torch.equal(got, (want_a, want_b)[i % 2])


@pytest.mark.parametrize("which", sorted(_DECODE) + ["q8_bh"])
def test_decode_split_read_first_run_inside_a_graph_capture(dev, which):
    """A split read of a size never read before may first run inside a
    CUDA-graph capture: it allocates nothing but its output."""
    if which == "q8_bh":
        fn, kw = decode_attention_q8_bh, {}
        args = _q8_args(3, 1, 1536, torch.bfloat16, dev, seed=6)
        want = decode_attention_q8_plain(*args)
        atol, rtol = _Q8_TOL[torch.bfloat16]
    else:
        fn, plain, kw = _DECODE[which]
        args = _decode_args(3, 1, 1536, torch.bfloat16, torch.bfloat16, dev,
                            seed=6)
        want = plain(*args, **kw)
        atol, rtol = _DECODE_TOL[torch.bfloat16]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn(*args, **kw)
    graph.replay()
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), want.float(), atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize("which", ["bh", "per_head"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kv_len", [512, 751, 1500])
def test_decode_q8_kernel_split_reads_match_plain(dev, which, dtype, kv_len):
    """The q8 pair takes the same split read with its scales: 2 x 3 rows
    at split counts 2 to 5, NaN scales past kv_len."""
    fn = decode_attention_q8_bh if which == "bh" else decode_attention_q8
    args = _q8_args(2, 3, 1500, dtype, dev, seed=kv_len)
    want = decode_attention_q8_plain(*args, kv_len)
    for t in (args[2], args[4]):
        t[:, :, kv_len:] = float("nan")
    got = fn(*args, kv_len)
    torch.cuda.synchronize()
    atol, rtol = _Q8_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


# ---------------------------------------------------------------------------
# decode_attention_q8(_bh): int8 K/V with per-vector scales, and the int8
# scalar append
# ---------------------------------------------------------------------------

def _q8_args(B, H, S, dtype, dev, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)

    def quant(x):
        s = (x.abs().amax(-1, keepdim=True) / 127.0).clamp_min(1e-10)
        return torch.round(x / s).clamp(-127, 127).to(torch.int8), s

    q = torch.randn((B, 1, H, 64), generator=g).to(dev, dtype)
    k8, ks = quant(torch.randn((B, H, S, 64), generator=g) * 2)
    v8, vs = quant(torch.randn((B, H, S, 64), generator=g))
    return [q] + [t.to(dev) for t in (k8, ks, v8, vs)]


# fp32 2e-5 / 1e-5: online against two-pass softmax, fp32 sums in other
# orders; bf16 2e-3 / 1e-2: about one bf16 ulp of the output.
_Q8_TOL = {torch.float32: (2e-5, 1e-5), torch.bfloat16: (2e-3, 1e-2)}


@pytest.mark.parametrize("which", ["bh", "per_head"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,S,kv_len", [
    (32, 6, 1500, None),        # tiny b32's cross read
    (32, 20, 1500, None),       # turbo b32's
    (2, 3, 200, 0), (2, 3, 200, 1), (2, 3, 200, 77), (2, 3, 200, 199),
    (1, 2, 4096, 3000),         # the >= 4096-slot gate's read
])
def test_decode_q8_kernel_matches_plain(dev, which, dtype, B, H, S, kv_len):
    fn = decode_attention_q8_bh if which == "bh" else decode_attention_q8
    args = _q8_args(B, H, S, dtype, dev)
    before = fn.launches
    got = fn(*args, kv_len)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    want = decode_attention_q8_plain(*args, kv_len)
    assert got.dtype == dtype and got.shape == want.shape
    atol, rtol = _Q8_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)
    if kv_len == 0:
        assert not got.any()


def test_decode_q8_kernel_never_reads_past_kv_len(dev):
    args = _q8_args(2, 3, 300, torch.float32, dev, seed=1)
    clean = decode_attention_q8_bh(*args, 130)
    for t in (args[2], args[4]):               # the scales past kv_len
        t[:, :, 130:] = float("nan")
    got = decode_attention_q8_bh(*args, 130)
    torch.cuda.synchronize()
    assert torch.equal(got, clean)


def test_decode_q8_kernel_refuses_what_it_does_not_take(dev):
    q, k8, ks, v8, vs = _q8_args(1, 2, 16, torch.float32, dev)
    with pytest.raises(TypeError, match="int8"):
        decode_attention_q8_bh(q, k8.float(), ks, v8, vs)
    with pytest.raises(TypeError, match="query"):
        decode_attention_q8_bh(q.half(), k8, ks, v8, vs)
    with pytest.raises(ValueError, match="head_dim"):
        decode_attention_q8_bh(q[..., :32], k8[..., :32].contiguous(), ks,
                               v8[..., :32].contiguous(), vs)
    with pytest.raises(ValueError, match="not contiguous"):
        decode_attention_q8(q, k8.transpose(1, 2).contiguous().transpose(1, 2),
                            ks, v8, vs)


@pytest.mark.parametrize("heads", [6, 20])     # tiny, turbo at b32
@pytest.mark.parametrize("pos", [0, 1, 63, 127])
def test_cache_append_int8_kernel_matches_plain(dev, pos, heads):
    g = torch.Generator(device="cpu").manual_seed(pos)
    shape = (4, 32, heads, 128, 64)
    ck, cv = (torch.randint(-127, 128, shape, generator=g, dtype=torch.int8
                            ).to(dev) for _ in range(2))
    kn, vn = (torch.randint(-127, 128, shape[:3] + (64,), generator=g,
                            dtype=torch.int8).to(dev) for _ in range(2))
    want_k, want_v = cache_append_rows_plain(ck.clone(), cv.clone(), kn, vn,
                                             pos)
    ptr_k = ck.data_ptr()
    before = cache_append_rows.launches
    ok, ov = cache_append_rows(ck, cv, kn, vn, pos)
    torch.cuda.synchronize()
    assert cache_append_rows.launches == before + 1
    assert ok.data_ptr() == ptr_k
    assert torch.equal(ok, want_k) and torch.equal(ov, want_v)


@pytest.mark.parametrize("flags", [{"cross_kv_quant": True},
                                   {"kv_cache_quant": True}])
def test_int8_greedy_on_the_card_matches_the_cpu(dev, flags):
    """Greedy fp32 at a head_dim-64 nano width with int8 caches: the
    card's tokens equal the CPU's plain path. With an int8 cross cache
    every layer's cross read at every step is one decode_attention_q8_bh
    launch; under kv_cache_quant the reads dequantize (1500 < 4096)."""
    import numpy as np

    from whisper_tpu_torch import get_config, weights
    from whisper_tpu_torch.decode import greedy_decode
    from whisper_tpu_torch.tokenizer import build_prompt
    cfg = get_config("tiny").replace(name="cuda-q8-nano", d_model=128,
                                     n_heads=2, n_audio_layers=2,
                                     n_text_layers=2, **flags)
    params = weights.init_params(cfg, seed=4)
    enc = torch.from_numpy(np.random.RandomState(0).randn(
        2, cfg.n_audio_ctx, cfg.d_model).astype(np.float32))
    prompt = torch.tensor([build_prompt(cfg)] * 2)
    bias = torch.zeros(cfg.vocab_size)
    bias[cfg.eot_token] = -1e9              # EOT banned: all 10 steps run
    toks = {}
    for device in ("cpu", "cuda"):
        p = weights.to_device(params, device)
        before = decode_attention_q8_bh.launches
        res = greedy_decode(p, cfg, enc.to(device), prompt.to(device),
                            max_new=10, logit_bias=bias.to(device))
        toks[device] = res.tokens.cpu()
        if device == "cuda":
            want = (cfg.n_text_layers * 10 if cfg.cross_kv_quant else 0)
            assert decode_attention_q8_bh.launches - before == want
    assert torch.equal(toks["cuda"], toks["cpu"])


def _pallas_nano(**flags):
    from whisper_tpu_torch import get_config
    return get_config("tiny").replace(name="cuda-pallas-nano", d_model=128,
                                      n_heads=2, n_audio_layers=2,
                                      n_text_layers=2, attn_backend="pallas",
                                      **flags)


def test_pallas_greedy_on_the_card_matches_the_cpu(dev):
    """fp32 kv_cache_quant greedy decoding and detect_language under
    attn_backend "pallas" at a head_dim-64 nano width: every T==1 read
    (self and cross per layer, each step and the detection pass) is one
    decode_attention_bh launch, its q a strided view of the fused QKV made
    contiguous by the route; tokens equal the CPU's, the language
    probabilities agree to 1e-5."""
    import numpy as np

    from whisper_tpu_torch import weights
    from whisper_tpu_torch.decode import detect_language, greedy_decode
    from whisper_tpu_torch.tokenizer import build_prompt
    cfg = _pallas_nano(kv_cache_quant=True)
    params = weights.init_params(cfg, seed=5)
    enc = torch.from_numpy(np.random.RandomState(1).randn(
        2, cfg.n_audio_ctx, cfg.d_model).astype(np.float32))
    prompt = torch.tensor([build_prompt(cfg)] * 2)
    bias = torch.zeros(cfg.vocab_size)
    bias[cfg.eot_token] = -1e9              # EOT banned: all 10 steps run
    toks, probs = {}, {}
    for device in ("cpu", "cuda"):
        p = weights.to_device(params, device)
        before = decode_attention_bh.launches
        toks[device] = greedy_decode(p, cfg, enc.to(device),
                                     prompt.to(device), max_new=10,
                                     logit_bias=bias.to(device)).tokens.cpu()
        probs[device] = detect_language(p, cfg, enc.to(device)).cpu()
        if device == "cuda":
            want = 2 * cfg.n_text_layers * (10 + 1)
            assert decode_attention_bh.launches - before == want
    assert torch.equal(toks["cuda"], toks["cpu"])
    torch.testing.assert_close(probs["cuda"], probs["cpu"], atol=1e-5,
                               rtol=0)


def test_bg_cross_step_on_the_card_matches_the_cpu(dev, monkeypatch):
    """decoder_step_ip in bf16 under WHISPER_TPU_IP_CROSS=bg8 at B=8: one
    decode_attention_bg launch per layer; logits within a few bf16 ulps of
    the O(1) values of the CPU step (the plain version) and the same
    argmax."""
    import numpy as np

    from whisper_tpu_torch import weights
    from whisper_tpu_torch.models import whisper as tm
    from whisper_tpu_torch.tokenizer import build_prompt
    monkeypatch.setenv("WHISPER_TPU_IP_CROSS", "bg8")
    cfg = _pallas_nano(compute_dtype="bfloat16")
    params = weights.init_params(cfg, seed=6)
    enc = torch.from_numpy(np.random.RandomState(2).randn(
        8, cfg.n_audio_ctx, cfg.d_model).astype(np.float32))
    prompt = torch.tensor([build_prompt(cfg)] * 8)
    P = prompt.shape[1]
    logits = {}
    for device in ("cpu", "cuda"):
        p = weights.to_device(params, device, torch.bfloat16)
        with torch.inference_mode():
            cross = tm.precompute_cross_kv(p, cfg, enc.to(device,
                                                          torch.bfloat16))
            cache = tm.init_kv_cache(cfg, 8, torch.bfloat16, 64, device)
            pre, cache = tm.decoder_forward(p, cfg, prompt.to(device), 0,
                                            cache, cross)
            before = decode_attention_bg.launches
            lg, _ = tm.decoder_step_ip(p, cfg, pre[:, -1:].argmax(-1), P,
                                       cache, cross)
        if device == "cuda":
            assert decode_attention_bg.launches - before == cfg.n_text_layers
        logits[device] = lg.float().cpu()
    torch.testing.assert_close(logits["cuda"], logits["cpu"], atol=0.05,
                               rtol=0)
    assert torch.equal(logits["cuda"].argmax(-1), logits["cpu"].argmax(-1))


# ---------------------------------------------------------------------------
# fused_decoder_step: the whole T==1 decoder step in one cooperative launch
# ---------------------------------------------------------------------------

def _fused_args(B, L, H, ff, S, Sc, dtype, dev, seed=0):
    """h0, packed operands with non-trivial biases and LayerNorm vectors,
    and random self and cross caches (L, B, H, S, 64)."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    d = 64 * H

    def r(*s, scale=1.0):
        return (torch.randn(*s, generator=g) * scale).to(dev, dtype)

    off = vec_offsets(d, ff)
    vec = torch.randn(L, off["end"], generator=g) * 0.1
    for name in ("ln1_g", "ln2_g", "ln3_g"):
        vec[:, off[name]:off[name] + d] += 1.0
    if dtype == torch.bfloat16:     # the live params' values are bf16
        vec = vec.bfloat16().float()
    packed = PackedDecoder(
        wqkv=r(L, d, 3 * d, scale=0.05), wcq=r(L, d, d, scale=0.05),
        wo=r(L, d, d, scale=0.05), wco=r(L, d, d, scale=0.05),
        fc1=r(L, d, ff, scale=0.05), fc2=r(L, ff, d, scale=0.05),
        vec=vec.to(dev))
    return (r(B, d), packed, r(L, B, H, S, 64), r(L, B, H, S, 64),
            r(L, B, H, Sc, 64), r(L, B, H, Sc, 64))


# fp32 1e-4: fp32 FMAs against cuBLAS fp32 through 4 layers, summed in
# other orders; bf16 atol 0.06 / rtol 2e-2: one bf16 ulp of O(4) values,
# where a sum in another order lands on the other side of a rounding point
_FUSED_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (0.06, 2e-2)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B", [1, 3, 32])
@pytest.mark.parametrize("pos", [0, 5, 447])
def test_fused_step_kernel_matches_plain(dev, dtype, B, pos):
    """Whisper-tiny's decoder (d=384, 6 heads, ff=1536, 4 layers), a
    448-slot self cache and 1500 cross positions."""
    args = _fused_args(B, 4, 6, 1536, 448, 1500, dtype, dev, seed=pos)
    before = fused_decoder_step.launches
    got = fused_decoder_step(*args, pos + 1, n_heads=6)
    torch.cuda.synchronize()
    assert fused_decoder_step.launches == before + 1
    want = fused_decoder_step_plain(*args, pos + 1, n_heads=6)
    atol, rtol = _FUSED_TOL[dtype]
    for name, a, b in zip(("h_out", "k_new", "v_new"), got, want):
        assert a.dtype == dtype and a.shape == b.shape, name
        torch.testing.assert_close(a.float(), b.float(), atol=atol,
                                   rtol=rtol, msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B", [1, 5, 33])
def test_fused_step_kernel_batches_match_plain_and_repeat(dev, dtype, B):
    """Batches that fill no tile evenly, at tiny width, pos 48: the plain
    version's values, and a second call bitwise equal to the first (every
    sum in a fixed order). The plain version's own fp32 sums can round a
    bf16 near-tie the other way and carry it through the layers (B=33 here:
    0.078 from its fp64-summed form at one element, where the kernel sits
    on that form), so where the plain version is outside the tolerance of
    its fp64-summed form, the kernel is held to that form instead, at the
    same tolerance."""
    args = _fused_args(B, 4, 6, 1536, 448, 1500, dtype, dev, seed=B)
    got = fused_decoder_step(*args, 49, n_heads=6)
    again = fused_decoder_step(*args, 49, n_heads=6)
    torch.cuda.synchronize()
    want = fused_decoder_step_plain(*args, 49, n_heads=6)
    exact = fused_decoder_step_plain(*args, 49, n_heads=6,
                                     acc_dtype=torch.float64)
    atol, rtol = _FUSED_TOL[dtype]

    def within(x, ref):
        return (x.float() - ref.float()).abs() <= atol + rtol * ref.float().abs()

    for name, a, a2, b, e in zip(("h_out", "k_new", "v_new"), got, again,
                                 want, exact):
        assert torch.equal(a, a2), name
        ok = within(a, b) | (~within(b, e) & within(a, e))
        assert bool(ok.all()), (name, float((a.float() - b.float()).abs().max()))


def test_fused_step_kernel_timeline(dev):
    """The stamp buffer: a timeline of known phase kinds with increasing
    times, ended by -1; the step's outputs bitwise those of a call
    without it."""
    from whisper_tpu_torch.ops.decoder_step import PHASES, stamp_pairs
    args = _fused_args(4, 2, 6, 1536, 448, 1500, torch.bfloat16, dev, seed=3)
    stamps = torch.full((2 * stamp_pairs(2),), -7, dtype=torch.int64,
                        device=dev)
    got = fused_decoder_step(*args, 10, n_heads=6, stamps=stamps)
    want = fused_decoder_step(*args, 10, n_heads=6)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    pairs = stamps.view(-1, 2).cpu()
    end = int((pairs[:, 0] < 0).nonzero()[0])
    kinds = [PHASES[int(k)] for k in pairs[:end, 0]]
    assert kinds[0] == "start" and kinds[-1] == "sync" and "final" in kinds
    assert bool((pairs[1:end, 1] >= pairs[:end - 1, 1]).all())
    with pytest.raises(ValueError, match="stamps are on"):
        fused_decoder_step(*args, 10, n_heads=6, stamps=stamps.cpu())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pos", [0, 5, 200])
def test_fused_step_kernel_never_reads_rows_at_or_past_pos(dev, dtype, pos):
    args = _fused_args(3, 2, 6, 1536, 448, 1500, dtype, dev, seed=7)
    clean = fused_decoder_step(*args, pos + 1, n_heads=6)
    for cache in args[2:4]:
        cache[:, :, :, pos:] = float("nan")
    got = fused_decoder_step(*args, pos + 1, n_heads=6)
    torch.cuda.synchronize()
    for a, b in zip(got, clean):
        assert torch.isfinite(a.float()).all()
        assert torch.equal(a, b)


def test_fused_step_kernel_refuses_what_it_does_not_take(dev):
    h0, packed, sk, sv, ck, cv = _fused_args(2, 1, 2, 512, 16, 32,
                                             torch.float32, dev)
    with pytest.raises(IndexError, match="outside"):
        fused_decoder_step(h0, packed, sk, sv, ck, cv, 17, n_heads=2)
    with pytest.raises(ValueError, match="head_dim"):      # 4 heads of 32
        fused_decoder_step(h0, packed, sk.reshape(1, 2, 4, 16, 32),
                           sv.reshape(1, 2, 4, 16, 32),
                           ck.reshape(1, 2, 4, 32, 32),
                           cv.reshape(1, 2, 4, 32, 32), 3, n_heads=4)
    with pytest.raises(TypeError, match="int8"):
        fused_decoder_step(h0, packed, sk.to(torch.int8), sv.to(torch.int8),
                           ck, cv, 3, n_heads=2)
    with pytest.raises(ValueError, match="not contiguous"):
        fused_decoder_step(h0, packed, sk,
                           sv.transpose(3, 4).contiguous().transpose(3, 4),
                           ck, cv, 3, n_heads=2)


@pytest.mark.parametrize("fused", [True, None], ids=["forced", "auto"])
def test_fused_greedy_on_the_card_matches_the_cpu(dev, monkeypatch, fused):
    """Greedy fp32 at a head_dim-64 nano width with the fused step, set on
    ("forced") or by the auto policy on the card ("auto": the CPU keeps the
    unfused step): one fused_decoder_step and one append launch per loop
    step, and the card's tokens equal the CPU's plain path."""
    import numpy as np

    from whisper_tpu_torch import get_config, weights
    from whisper_tpu_torch.decode import greedy_decode
    from whisper_tpu_torch.tokenizer import build_prompt
    monkeypatch.delenv("WHISPER_TPU_FUSED", raising=False)
    cfg = get_config("tiny").replace(name="cuda-fused-nano", d_model=128,
                                     n_heads=2, n_audio_layers=2,
                                     n_text_layers=2, fused_step=fused)
    params = weights.init_params(cfg, seed=5)
    enc = torch.from_numpy(np.random.RandomState(1).randn(
        2, cfg.n_audio_ctx, cfg.d_model).astype(np.float32))
    prompt = torch.tensor([build_prompt(cfg)] * 2)
    bias = torch.zeros(cfg.vocab_size)
    bias[cfg.eot_token] = -1e9              # EOT banned: all 10 steps run
    toks = {}
    for device in ("cpu", "cuda"):
        p = weights.to_device(params, device)
        fused, append = fused_decoder_step.launches, cache_append_rows.launches
        res = greedy_decode(p, cfg, enc.to(device), prompt.to(device),
                            max_new=10, logit_bias=bias.to(device))
        toks[device] = res.tokens.cpu()
        if device == "cuda":
            assert fused_decoder_step.launches - fused == 10
            assert cache_append_rows.launches - append == 10
    assert torch.equal(toks["cuda"], toks["cpu"])


# ---------------------------------------------------------------------------
# under autograd (the train step): the tail and flash carry their backward
# kernels' gradients; every other wrapper raises
# ---------------------------------------------------------------------------

def _grads_of(fn, args, w):
    return torch.autograd.grad((fn(*args) * w).sum(), args)


def _close_grad(got, want, what=""):
    """The backward kernels' tolerance against their plain twins (and the
    plain forward's autograd): max |got - want| <= 1e-5 * max |want| +
    1e-6. fp32 FMAs, ex2.approx and the forward's log-sum-exp against
    cuBLAS fp32 and exp, summed in other orders over up to 1,500 keys and
    24,000 rows."""
    assert got.shape == want.shape and got.dtype == want.dtype, what
    err = float((got.double() - want.double()).abs().max())
    bound = 1e-5 * float(want.double().abs().max()) + 1e-6
    assert err <= bound, (what, err, bound)


@pytest.mark.parametrize("B,T,S,H,kv_len,q_offset,causal", [
    (2, 224, 448, 6, 224, 0, True),     # tiny's training self read
    (2, 224, 1500, 6, None, 0, False),  # tiny's training cross read
    (2, 40, 448, 2, 140, 100, True),    # causal, q_offset 100
    (1, 130, 200, 2, 150, 20, True),    # several q tiles under causal
])
def test_flash_gradient_is_the_plain_gradient(dev, B, T, S, H, kv_len,
                                              q_offset, causal):
    """The flash wrapper under autograd: the value is the kernel's (one
    launch), the backward one launch of flash_attention_backward, each
    input's gradient the plain version's autograd gradient at the same
    inputs within `_close_grad`."""
    args = [a.requires_grad_() for a in
            _flash_args(B, T, S, H, torch.float32, dev, seed=3)]
    kw = dict(kv_len=kv_len, q_offset=q_offset, causal=causal)
    w = torch.randn(B, T, H, 64, generator=torch.Generator().manual_seed(4)
                    ).to(dev)
    n, nb = flash_attention.launches, flash_attention_backward.launches
    out = flash_attention(*args, **kw)
    assert out.requires_grad and flash_attention.launches == n + 1
    with torch.no_grad():
        assert torch.equal(out, flash_attention(*args, **kw))
    got = torch.autograd.grad((out * w).sum(), args)
    assert flash_attention.launches == n + 2
    assert flash_attention_backward.launches == nb + 1
    want = _grads_of(lambda *a: flash_attention_plain(*a, **kw), args, w)
    for name, g, x in zip("qkv", got, want):
        _close_grad(g, x, name)


def test_flash_gradient_through_fused_qkv_views(dev):
    """q a strided view of one fused projection, as the decoder gives it:
    the gradient reaches the projection."""
    g = torch.Generator().manual_seed(6)
    qkv = torch.randn(2, 100, 3 * 128, generator=g).to(dev).requires_grad_()
    q = qkv[..., :128].reshape(2, 100, 2, 64)
    k = qkv[..., 128:256].reshape(2, 100, 2, 64).permute(0, 2, 1, 3)
    v = qkv[..., 256:].reshape(2, 100, 2, 64).permute(0, 2, 1, 3)
    got = torch.autograd.grad(flash_attention(q, k, v, causal=True).sum(),
                              qkv)[0]
    want = torch.autograd.grad(
        flash_attention_plain(q, k, v, causal=True).sum(), qkv)[0]
    _close_grad(got, want)


@pytest.mark.parametrize("B,T,H,ff", [(2, 100, 6, 1536), (1, 1500, 6, 1536),
                                      (1, 64, 20, 5120)])
def test_tail_gradient_is_the_plain_gradient(dev, B, T, H, ff):
    """encoder_block_tail under autograd: the kernel's value (one launch),
    the backward one launch of encoder_block_tail_backward (its attention
    counted there, not on flash_attention_backward), every one of the
    twelve inputs' gradients the plain version's within `_close_grad`."""
    args = [a.requires_grad_() for a in
            _tail_args(B, T, H, ff, torch.float32, dev, seed=7,
                       fan_in=H > 8)]
    w = torch.randn(B, T, H * 64, generator=torch.Generator().manual_seed(8)
                    ).to(dev)
    n, nb = encoder_block_tail.launches, encoder_block_tail_backward.launches
    nf = flash_attention_backward.launches
    out = encoder_block_tail(*args)
    assert out.requires_grad and encoder_block_tail.launches == n + 1
    got = torch.autograd.grad((out * w).sum(), args)
    assert encoder_block_tail.launches == n + 1
    assert encoder_block_tail_backward.launches == nb + 1
    assert flash_attention_backward.launches == nf
    want = _grads_of(encoder_block_tail_plain, args, w)
    for i, (g, x) in enumerate(zip(got, want)):
        _close_grad(g, x, i)


# (B, T, S, H, kv_len, q_offset, causal): the training reads, then the
# tile edges (T and S off the 32- and 64-row tiles, the causal diagonal
# inside a tile, a q_offset), kv_len 0, and the encoder tail's attention
# (tiny B=16, turbo B=4)
_FLASH_BWD_CASES = [
    (16, 224, 448, 6, 224, 0, True),    # tiny B=16's training self read
    (16, 224, 1500, 6, None, 0, False),  # tiny B=16's training cross read
    (4, 224, 1500, 20, None, 0, False),  # turbo B=4's cross read
    (2, 127, 129, 3, None, 0, False),
    (2, 129, 127, 3, None, 0, False),
    (1, 100, 300, 2, 250, 37, True),
    (2, 65, 200, 2, 97, 0, True),
    (1, 130, 200, 2, 150, 20, True),
    (2, 5, 64, 2, 0, 0, False),
    (16, 1500, 1500, 6, None, 0, False),  # tiny B=16's encoder layer
    (4, 1500, 1500, 20, None, 0, False),  # turbo B=4's encoder layer
]


def _flash_bwd_inputs(B, T, S, H, kv_len, q_offset, causal, dev, seed,
                      q_scale=1.0):
    """q (times q_scale), k, v, the plain forward's out and lse, and
    d_out."""
    q, k, v = _flash_args(B, T, S, H, torch.float32, dev, seed=seed)
    q = q * q_scale
    out, lse = flash_attention_plain(q, k, v, kv_len, q_offset,
                                     causal=causal, return_lse=True)
    g = torch.randn(B, T, H, 64,
                    generator=torch.Generator().manual_seed(seed + 1)).to(dev)
    return q, k, v, out.contiguous(), lse, g


@pytest.mark.parametrize("B,T,S,H,kv_len,q_offset,causal", _FLASH_BWD_CASES)
def test_flash_backward_kernel_matches_its_twin(dev, B, T, S, H, kv_len,
                                                q_offset, causal):
    """The backward kernel against flash_attention_backward_plain on the
    same out and lse: one launch, `_close_grad`, zero rows past the last
    visible key, and nothing allocated on the way but the three gradients
    and delta (B, H, T) (1 MiB of the allocator's rounding allowed): no
    (B, H, T, S) tensor."""
    args = _flash_bwd_inputs(B, T, S, H, kv_len, q_offset, causal, dev, 40)
    kw = dict(kv_len=kv_len, q_offset=q_offset, causal=causal)
    n = flash_attention_backward.launches
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    got = flash_attention_backward(*args, **kw)
    torch.cuda.synchronize()
    grads_bytes = sum(4 * a.numel() for a in got)
    assert (torch.cuda.max_memory_allocated() - base
            <= grads_bytes + 4 * B * H * T + (1 << 20))
    assert flash_attention_backward.launches == n + 1
    want = flash_attention_backward_plain(*args, **kw)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        _close_grad(a, b, name)
    end = min(S if kv_len is None else kv_len,
              q_offset + T if causal else S)
    for a in got[1:]:
        assert not a[:, :, end:].any()


def test_flash_backward_kernel_holds_sharp_scores(dev):
    """Scores scaled x8 (q x 8: rows whose p is near one-hot), where a
    TF32 rounding of s would show in p: the split-TF32 products stay
    within `_close_grad` of the twin (tiny's training self read)."""
    B, T, S, H, kv_len, q_offset, causal = _FLASH_BWD_CASES[0]
    args = _flash_bwd_inputs(B, T, S, H, kv_len, q_offset, causal, dev, 44,
                             q_scale=8.0)
    kw = dict(kv_len=kv_len, q_offset=q_offset, causal=causal)
    got = flash_attention_backward(*args, **kw)
    want = flash_attention_backward_plain(*args, **kw)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        _close_grad(a, b, name)


def test_flash_backward_reads_fused_qkv_views(dev):
    """q, k and v strided views of one fused projection, as the decoder
    hands them over."""
    g = torch.Generator().manual_seed(41)
    qkv = torch.randn(2, 100, 3 * 128, generator=g).to(dev)
    q = qkv[..., :128].reshape(2, 100, 2, 64)
    k = qkv[..., 128:256].reshape(2, 100, 2, 64).permute(0, 2, 1, 3)
    v = qkv[..., 256:].reshape(2, 100, 2, 64).permute(0, 2, 1, 3)
    out, lse = flash_attention_plain(q, k, v, causal=True, return_lse=True)
    d_out = torch.randn(2, 100, 2, 64, generator=g).to(dev)
    got = flash_attention_backward(q, k, v, out, lse, d_out, causal=True)
    want = flash_attention_backward_plain(q, k, v, out, lse, d_out,
                                          causal=True)
    for a, b in zip(got, want):
        _close_grad(a, b)


@pytest.mark.parametrize("case", [0, 1, 5, 9])
def test_flash_backward_kernel_is_deterministic(dev, case):
    args = _flash_bwd_inputs(*_FLASH_BWD_CASES[case], dev, 42)
    B, T, S, H, kv_len, q_offset, causal = _FLASH_BWD_CASES[case]
    kw = dict(kv_len=kv_len, q_offset=q_offset, causal=causal)
    first = flash_attention_backward(*args, **kw)
    for a, b in zip(first, flash_attention_backward(*args, **kw)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("B,T,S,H,kv_len,q_offset,causal",
                         _FLASH_BWD_CASES[:2] + _FLASH_BWD_CASES[5:6])
def test_flash_forward_kernel_writes_the_lse(dev, B, T, S, H, kv_len,
                                             q_offset, causal):
    """Under autograd the fp32 forward kernel also writes each row's
    log-sum-exp: against the plain version's, and the output unchanged."""
    q, k, v = _flash_args(B, T, S, H, torch.float32, dev, seed=43)
    kw = dict(kv_len=S if kv_len is None else kv_len, q_offset=q_offset,
              causal=causal)
    out, (_, lse) = flash_mod._forward_for_grad(q, k, v, **kw)
    with torch.no_grad():
        assert torch.equal(out, flash_attention(q, k, v, **kw))
    _, want = flash_attention_plain(q, k, v, **kw, return_lse=True)
    torch.testing.assert_close(lse, want, atol=2e-5, rtol=1e-5)


# (B, T, H, ff): tiny's width at its training length and a ragged T, and
# turbo's (d 1280, ff 5120); then the train step's layers, tiny B=16 and
# turbo B=4
_TAIL_BWD_CASES = [(2, 1500, 6, 1536), (3, 100, 6, 1536),
                   (1, 1500, 20, 5120), (2, 130, 20, 5120),
                   (16, 1500, 6, 1536), (4, 1500, 20, 5120)]


def _tail_bwd_inputs(B, T, H, ff, dev, seed):
    """The tail's operands, the plain forward's attention rows and lse,
    and d_out."""
    args = _tail_args(B, T, H, ff, torch.float32, dev, seed=seed,
                      fan_in=H > 8)
    attn, lse = flash_attention_plain(*args[:3], return_lse=True)
    g = torch.randn(B, T, H * 64,
                    generator=torch.Generator().manual_seed(seed + 1)).to(dev)
    return (*args, attn.reshape(B, T, H * 64).contiguous(), lse, g)


@pytest.mark.parametrize("B,T,H,ff", _TAIL_BWD_CASES)
def test_tail_backward_kernel_matches_its_twin(dev, B, T, H, ff):
    """The tail's backward against encoder_block_tail_backward_plain on
    the same attention rows and lse: one launch, all twelve gradients
    within `_close_grad`, and at T = 1500 (where one (B, H, T, T) fp32
    tensor outweighs the backward's row buffers) less allocated on the
    way than one such tensor."""
    args = _tail_bwd_inputs(B, T, H, ff, dev, 44)
    n = encoder_block_tail_backward.launches
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    got = encoder_block_tail_backward(*args)
    torch.cuda.synchronize()
    if T == 1500:
        assert torch.cuda.max_memory_allocated() - base < 4 * B * H * T * T
    assert encoder_block_tail_backward.launches == n + 1
    want = encoder_block_tail_backward_plain(*args)
    assert len(got) == len(want) == 12
    for i, (a, b) in enumerate(zip(got, want)):
        _close_grad(a, b, i)


@pytest.mark.parametrize("H,ff", [(6, 1536), (20, 5120)])
def test_tail_backward_kernel_is_deterministic(dev, H, ff):
    args = _tail_bwd_inputs(1, 1500, H, ff, dev, 45)
    first = encoder_block_tail_backward(*args)
    for a, b in zip(first, encoder_block_tail_backward(*args)):
        assert torch.equal(a, b)


# the tail backward's eight products, one stage of csrc/encoder_tail_bwd.cu
# at a time, at tiny's width (d 384, ff 1536) and turbo's (1280, 5120),
# over a number of rows that is no multiple of the 128-row tile nor of the
# 32-deep k tile (the weight gradients' K)
_PRODUCT_SHAPES = [(384, 1536, 3001), (1280, 5120, 1537)]
_PRODUCTS = ("z", "u", "dt1", "dw2", "dw1", "dy", "dwo", "da")


def _close_fp64(got, want, what=""):
    """1e-5 of max |want| + 1e-6 against the product in fp64."""
    err = float((got.double() - want).abs().max())
    bound = 1e-5 * float(want.abs().max()) + 1e-6
    assert err <= bound, (what, err, bound)


@pytest.mark.parametrize("d,ff,rows", _PRODUCT_SHAPES)
@pytest.mark.parametrize("stage", _PRODUCTS)
def test_tail_backward_product_matches_fp64(dev, stage, d, ff, rows):
    """Each product stage (split-TF32 wgmma tiles) against the same
    product in fp64 on the same fp32 inputs: z = a Wo, u = y W1 (the
    weights transposed, as the wrapper hands them over), dt1 = G W2^T with
    its GELU epilogue (t1 over u, du), the weight gradients with their bias
    sums, dy = du W1^T, da = dh2 Wo^T."""
    g = torch.Generator().manual_seed(60)

    def r(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(dev)

    lib = _build.load_library()
    x_d, x_ff = r(rows, d), r(rows, ff)          # rows of width d and ff
    wo, w1, w2 = r(d, d, scale=d ** -0.5), r(d, ff, scale=d ** -0.5), \
        r(ff, d, scale=ff ** -0.5)
    misc = r(4 * d + ff, scale=0.1)
    b1 = misc[d:d + ff]
    work = torch.empty(lib.wt_encoder_tail_bwd_workspace(rows, d, ff),
                       device=dev)
    vecs = torch.full((4 * d + ff,), float("nan"), device=dev)

    def run(*bufs):
        tail_mod._stage(lib, stage, bufs, rows, d, ff, 1e-5, torch.device(dev))
        torch.cuda.synchronize()

    f64 = [t.double() for t in (x_d, x_ff, wo, w1, w2)]
    if stage in ("z", "u", "dy", "da"):
        a, b, n = {"z": (x_d, wo.t().contiguous(), d),
                   "u": (x_d, w1.t().contiguous(), ff),
                   "dy": (x_ff, w1, d), "da": (x_d, wo, d)}[stage]
        want = {"z": f64[0] @ f64[2], "u": f64[0] @ f64[3],
                "dy": f64[1] @ f64[3].t(), "da": f64[0] @ f64[2].t()}[stage]
        out = torch.empty(rows, n, device=dev)
        run(a, b, out)
        _close_fp64(out, want, stage)
    elif stage == "dt1":
        u = r(rows, ff)
        du = torch.empty(rows, ff, device=dev)
        x = u.double() + b1.double()
        dt1 = f64[0] @ f64[4].t()
        run(x_d, w2, u, misc, du)
        _close_fp64(u, torch.nn.functional.gelu(x), "t1")
        _close_fp64(du, dt1 * tail_mod.gelu_grad(x), "du")
    else:
        a, b, m, n, at = {"dw2": (x_ff, x_d, ff, d, d + ff),
                          "dw1": (x_d, x_ff, d, ff, d),
                          "dwo": (x_d, r(rows, d), d, d, 0)}[stage]
        out = torch.empty(m, n, device=dev)
        run(a, b, work, out, vecs)
        _close_fp64(out, a.double().t() @ b.double(), stage)
        _close_fp64(vecs[at:at + n], b.double().sum(0), stage + " bias")


def test_bf16_gradient_through_the_two_wrappers_raises(dev):
    """The backward kernels are fp32 only: under autograd a bf16 call to
    either wrapper raises, naming it, before it launches."""
    bf = torch.bfloat16
    q, k, v = (a.requires_grad_() for a in
               _flash_args(1, 8, 8, 2, bf, dev, seed=46))
    n = flash_attention.launches
    with pytest.raises(RuntimeError, match="flash_attention: no backward"):
        flash_attention(q, k, v)
    assert flash_attention.launches == n
    args = _tail_args(1, 64, 2, 256, bf, dev, seed=47)
    args[3].requires_grad_()
    n = encoder_block_tail.launches
    with pytest.raises(RuntimeError,
                       match="encoder_block_tail: no backward"):
        encoder_block_tail(*args)
    assert encoder_block_tail.launches == n
    with torch.no_grad():
        flash_attention(q, k, v)
        encoder_block_tail(*args)
    torch.cuda.synchronize()


def _no_backward_calls(dev):
    """Every wrapper without a backward, with CUDA inputs of which one
    requires grad."""
    g = torch.Generator().manual_seed(9)

    def r(*s, dtype=torch.float32):
        return torch.randn(*s, generator=g).to(dev, dtype)

    q = r(2, 1, 2, 64).requires_grad_()
    k, v = r(2, 2, 8, 64), r(2, 2, 8, 64)
    k8 = torch.ones(2, 2, 8, 64, dtype=torch.int8, device=dev)
    ks = r(2, 2, 8, 1).abs()
    ck, cv = r(2, 2, 2, 8, 64), r(2, 2, 2, 8, 64)
    kn, vn = r(2, 2, 2, 64).requires_grad_(), r(2, 2, 2, 64)
    L, B, H, d = 2, 2, 2, 128
    packed = PackedDecoder(
        r(L, d, 3 * d), r(L, d, d), r(L, d, d), r(L, d, d), r(L, d, d),
        r(L, d, d), r(L, vec_offsets(d, d)["end"]))
    h8 = r(1, 4, 2, 64, dtype=torch.bfloat16)
    i8 = torch.ones(d, d, dtype=torch.int8, device=dev)
    return {
        "decode_attention_bh": lambda: decode_attention_bh(q, k, v, 5),
        "decode_attention_bg": lambda: decode_attention_bg(q, k, v, 5,
                                                           block_b=2),
        "decode_attention": lambda: decode_attention(q, k, v, 5),
        "decode_attention_q8_bh": lambda: decode_attention_q8_bh(
            q, k8, ks, k8, ks, 5),
        "decode_attention_q8": lambda: decode_attention_q8(q, k8, ks, k8, ks,
                                                           5),
        "cache_append_rows": lambda: cache_append_rows(ck, cv, kn, vn, 3),
        "cache_append_rows_ragged": lambda: cache_append_rows_ragged(
            ck, cv, kn, vn, torch.tensor([1, 4], device=dev)),
        "fused_decoder_step": lambda: fused_decoder_step(
            r(B, d).requires_grad_(), packed, r(L, B, H, 8, 64),
            r(L, B, H, 8, 64), r(L, B, H, 10, 64), r(L, B, H, 10, 64), 4,
            n_heads=H),
        "encoder_block_tail_q8": lambda: encoder_block_tail_q8(
            h8.requires_grad_(), r(1, 2, 4, 64, dtype=torch.bfloat16),
            r(1, 2, 4, 64, dtype=torch.bfloat16),
            r(1, 4, d, dtype=torch.bfloat16), i8, i8, i8, r(d), r(d), r(d),
            r(d), r(d), r(d).abs(), r(d).abs(), r(d).abs()),
    }


@pytest.mark.parametrize("name", [
    "decode_attention_bh", "decode_attention_bg", "decode_attention",
    "decode_attention_q8_bh", "decode_attention_q8", "cache_append_rows",
    "cache_append_rows_ragged", "fused_decoder_step",
    "encoder_block_tail_q8"])
def test_wrappers_without_backward_raise_under_grad_on_the_card(dev, name):
    """No kernel output without a graph reaches a loss: under autograd the
    wrapper raises before it launches; under no_grad the same call
    launches."""
    call = _no_backward_calls(dev)[name]
    fn = globals()[name]
    n = fn.launches
    with pytest.raises(RuntimeError, match=name + ": no backward"):
        call()
    assert fn.launches == n
    with torch.no_grad():
        call()
    torch.cuda.synchronize()
    assert fn.launches == n + 1
