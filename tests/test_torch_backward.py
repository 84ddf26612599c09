"""The backward kernels' plain twins (whisper_tpu_torch/ops:
`flash_attention_backward_plain`, `encoder_block_tail_backward_plain`)
against the JAX package on the CPU, fp32: each held to `jax.vjp` of the
JAX function (flash against whisper_tpu/ops/attention.py mha_reference at
Precision.HIGHEST; the tail against the JAX encoder's tail-off block,
whisper_tpu/models/whisper.py:572-578: mha_reference, linear, layer_norm,
gelu) and to `torch.autograd.grad` of the port's forward plain version,
on inputs made from a seed with numpy. Also the wrappers' CPU route and
`kernel_with_backward` with the twins as the backward.

Tolerance, every gradient: max |got - want| <= 1e-5 * max |want| + 1e-6
(fp32 sums over up to 1,500 keys and 256 MLP columns in another order;
the twins write the gradient out in closed form, JAX and autograd chain
the ops)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_tpu.models import whisper as jm
from whisper_tpu.ops.attention import mha_reference as jax_mha
from whisper_tpu_torch.ops import encoder_layer as el
from whisper_tpu_torch.ops import grad
from whisper_tpu_torch.ops.encoder_layer import (
    encoder_block_tail_backward,
    encoder_block_tail_backward_plain,
    encoder_block_tail_plain,
    gelu_grad,
)
from whisper_tpu_torch.ops.flash_attention import (
    flash_attention_backward,
    flash_attention_backward_plain,
    flash_attention_plain,
)

torch.set_num_threads(2)

REL, ABS = 1e-5, 1e-6


def _close(got, want, what):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    bound = REL * float(np.abs(want).max()) + ABS
    assert err <= bound, (what, err, bound)


# (B, T, S, H, kv_len, q_offset, causal)
FLASH_CASES = {
    # tiny's training self read: 224 tokens over JAX's 448 cache slots
    "self_train": (2, 224, 448, 3, 224, 0, True),
    # the training cross read over the 1,500 encoder positions
    "cross": (1, 224, 1500, 2, None, 0, False),
    # kv_len < S, not causal
    "kv_len": (2, 40, 300, 3, 170, 0, False),
    # q_offset > 0 over several 64-query tiles, kv_len inside the diagonal
    "q_offset": (2, 150, 400, 2, 300, 100, True),
}


def _flash_numpy(B, T, S, H, seed, D=64):
    rng = np.random.RandomState(seed)
    return [rng.randn(*s).astype(np.float32) for s in
            ((B, T, H, D), (B, H, S, D), (B, H, S, D), (B, T, H, D))]


def _flash_twin(q, k, v, g, kw):
    """The twin on the port's own forward (out and lse from the plain
    version)."""
    t = [torch.from_numpy(x) for x in (q, k, v, g)]
    out, lse = flash_attention_plain(*t[:3], **kw, return_lse=True)
    return flash_attention_backward_plain(*t[:3], out, lse, t[3], **kw)


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_backward_plain_matches_jax_vjp(case):
    B, T, S, H, kv_len, q_offset, causal = FLASH_CASES[case]
    q, k, v, g = _flash_numpy(B, T, S, H, seed=11)
    kw = dict(kv_len=kv_len, q_offset=q_offset, causal=causal)
    got = _flash_twin(q, k, v, g, kw)
    f = functools.partial(jax_mha, kv_len=kv_len, causal=causal,
                          q_offset=q_offset,
                          precision=jax.lax.Precision.HIGHEST)
    _, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(g))
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        _close(a.numpy(), np.asarray(b), f"{case} {name}")


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_backward_plain_matches_autograd(case):
    B, T, S, H, kv_len, q_offset, causal = FLASH_CASES[case]
    q, k, v, g = _flash_numpy(B, T, S, H, seed=12)
    kw = dict(kv_len=kv_len, q_offset=q_offset, causal=causal)
    got = _flash_twin(q, k, v, g, kw)
    t = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    want = torch.autograd.grad(flash_attention_plain(*t, **kw), t,
                               torch.from_numpy(g))
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        _close(a.numpy(), b.numpy(), f"{case} {name}")


def test_flash_backward_plain_lse_matches_jax():
    """The forward's log-sum-exp, which the backward reads, against
    JAX's logsumexp of the masked scores."""
    B, T, S, H, kv_len, q_offset, causal = FLASH_CASES["q_offset"]
    q, k, _, _ = _flash_numpy(B, T, S, H, seed=13)
    t = [torch.from_numpy(x) for x in (q, k, k)]
    _, lse = flash_attention_plain(*t, kv_len, q_offset, causal=causal,
                                   return_lse=True)
    s = jnp.einsum("bthd,bhsd->bhts", jnp.asarray(q) * 0.125, jnp.asarray(k),
                   precision=jax.lax.Precision.HIGHEST)
    key = jnp.arange(S)
    mask = (key[None, :] < kv_len) & (key[None, :]
                                      <= q_offset + jnp.arange(T)[:, None])
    want = jax.nn.logsumexp(jnp.where(mask, s, -jnp.inf), axis=-1)
    _close(lse.numpy(), np.asarray(want), "lse")


@pytest.mark.parametrize("causal", [False, True])
def test_flash_backward_plain_kv_len_0_is_zero(causal):
    """No visible key: every gradient 0, as the port's forward returns
    zeros there (JAX's mha_reference averages every key instead, its mask
    being a finite minimum, so it is no reference here)."""
    q, k, v, g = _flash_numpy(2, 5, 16, 2, seed=14)
    kw = dict(kv_len=0, q_offset=3, causal=causal)
    got = _flash_twin(q, k, v, g, kw)
    for a, x in zip(got, (q, k, v)):
        assert a.shape == x.shape and float(a.abs().max()) == 0.0
    # the forward is the constant 0 there: autograd records no dependence
    t = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    assert not flash_attention_plain(*t, **kw).requires_grad


def test_flash_backward_zeroes_keys_past_the_last_visible():
    B, T, S, H, kv_len, q_offset, causal = FLASH_CASES["q_offset"]
    q, k, v, g = _flash_numpy(B, T, S, H, seed=15)
    _, dk, dv = _flash_twin(q, k, v, g, dict(kv_len=kv_len,
                                             q_offset=q_offset,
                                             causal=causal))
    end = min(kv_len, q_offset + T)
    assert float(dk[:, :, end:].abs().max()) == 0.0
    assert float(dv[:, :, end:].abs().max()) == 0.0
    assert float(dk[:, :, :end].abs().max()) > 0.0


def test_flash_backward_wrapper_on_cpu_is_the_twin():
    """CPU tensors take the plain twin; no launch is counted."""
    q, k, v, g = _flash_numpy(2, 30, 50, 2, seed=16)
    t = [torch.from_numpy(x) for x in (q, k, v, g)]
    out, lse = flash_attention_plain(*t[:3], 40, 5, causal=True,
                                     return_lse=True)
    n = flash_attention_backward.launches
    got = flash_attention_backward(*t[:3], out, lse, t[3], 40, 5,
                                   causal=True)
    want = flash_attention_backward_plain(*t[:3], out, lse, t[3], 40, 5,
                                          causal=True)
    assert flash_attention_backward.launches == n
    for a, b in zip(got, want):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the backward kernel's arithmetic (csrc/flash_attention_bwd.cu), modelled
# on the CPU: every product as split TF32 on the tensor cores
# ---------------------------------------------------------------------------

def _tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: fp32 to 10 stored mantissa bits, to nearest with
    ties away from zero, by integer rounding of the fp32 bits (the sign is
    apart, so adding half of the 13 dropped bits rounds the magnitude)."""
    bits = x.float().contiguous().view(torch.int32).long() & 0xFFFFFFFF
    bits = ((bits + 0x1000) & 0xFFFFE000).to(torch.int64)
    return torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits).to(
        torch.int32).view(torch.float32)


def _tf32_trunc(x: torch.Tensor) -> torch.Tensor:
    """An fp32 operand as the tensor cores read it in TF32: its low 13
    bits dropped (rounded toward zero)."""
    bits = x.float().contiguous().view(torch.int32)
    return (bits & -0x2000).view(torch.float32)


def _split_tf32(x: torch.Tensor) -> tuple:
    """The kernel's split: big = x rounded to TF32, small = x - big (exact
    in fp32) as the MMA reads it."""
    big = _tf32_rna(x)
    return big, _tf32_trunc(x.float() - big)


def _round_to_zero(x: torch.Tensor) -> torch.Tensor:
    """fp64 to fp32 toward zero: the model of the tensor cores' fp32 sums
    (no round-to-nearest is assumed of them)."""
    f = x.float()
    over = f.double().abs() > x.abs()
    return torch.where(over, torch.nextafter(f, torch.zeros_like(f)), f)


def _kernel_einsum(single: bool):
    """torch.einsum as the kernel forms the twin's five products (two
    operands, one contracted index): k-steps of 8 along the contracted
    index, each an m16n8k8 MMA (exact TF32 products, the sum rounded
    toward zero to fp32). Split (`_split_tf32`): small.big, big.small,
    then big.big into one accumulator; single: big.big alone. The accumulator starts from
    zero every k-step over the head dim (the scores) and every 4 k-steps,
    a 32-row tile, over keys or queries (dv, dk, dq), and is added to the
    product's fp32 sum, rounded to nearest."""
    einsum = torch.einsum

    def product(eq, a, b):
        ins, out = eq.split("->")
        ia, ib = ins.split(",")
        (c,) = set(ia) & set(ib) - set(out)
        a_hi, a_lo = _split_tf32(a)
        b_hi, b_lo = _split_tf32(b)
        n = a.shape[ia.index(c)]
        fold = 1 if c == "d" else 4           # the head dim, or a tile
        terms = [(a_hi, b_hi)] if single else [
            (a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi)]
        total = part = None
        for step, k0 in enumerate(range(0, n, 8)):
            for x, y in terms:
                z = einsum(eq, x.narrow(ia.index(c), k0, min(8, n - k0))
                           .double(),
                           y.narrow(ib.index(c), k0, min(8, n - k0))
                           .double())
                part = _round_to_zero(z if part is None
                                      else part.double() + z)
            if (step + 1) % fold == 0 or k0 + 8 >= n:
                total = part if total is None else total + part
                part = None
        return total

    return product


def _backward_fp64(q, k, v, out, lse, d_out, kv_len, q_offset, causal):
    """The twin's math in fp64 on fp64 copies of the same inputs."""
    T, S = q.shape[1], k.shape[2]
    scale = q.shape[-1] ** -0.5
    end = S if kv_len is None else kv_len
    end = min(end, q_offset + T) if causal else end
    q, k, v, out, lse, g = (x.double() for x in (q, k, v, out, lse, d_out))
    kf, vf = k[:, :, :end], v[:, :, :end]
    s = torch.einsum("bthd,bhsd->bhts", q * scale, kf)
    if causal:
        s = s.masked_fill(torch.arange(end)[None, :]
                          > q_offset + torch.arange(T)[:, None], -torch.inf)
    p = torch.exp(s - lse[..., None])
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    dv[:, :, :end] = torch.einsum("bhts,bthd->bhsd", p, g)
    dp = torch.einsum("bthd,bhsd->bhts", g, vf)
    delta = (g * out).sum(-1).permute(0, 2, 1)
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhts,bhsd->bthd", ds, kf) * scale
    dk[:, :, :end] = torch.einsum("bhts,bthd->bhsd", ds, q) * scale
    return dq, dk, dv


# (B, T, S, H, kv_len, q_offset, causal, q scale): a cross read, a causal
# self read, a ragged kv_len, a q_offset, and scores scaled x8 (sharp
# rows, where a TF32 rounding of s shows in p)
SPLIT_CASES = {
    "cross": (1, 224, 400, 2, None, 0, False, 1.0),
    "causal": (1, 256, 256, 2, None, 0, True, 1.0),
    "kv_len": (2, 150, 400, 2, 333, 0, False, 1.0),
    "q_offset": (1, 150, 400, 2, 300, 100, True, 1.0),
    "sharp": (1, 300, 400, 2, None, 0, True, 8.0),
}


@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_split_tf32_backward_holds_the_card_tolerance(case, monkeypatch):
    """flash_attention_backward_plain's math with each product as the
    kernel's split TF32 MMAs: dq, dk and dv within the card tests' 1e-5 of
    max |g| + 1e-6 of the same math in fp64; with a single TF32 pass every
    gradient misses it."""
    B, T, S, H, kv_len, q_offset, causal, scale = SPLIT_CASES[case]
    q, k, v, g = _flash_numpy(B, T, S, H, seed=17)
    t = [torch.from_numpy(x) for x in (q * np.float32(scale), k, v, g)]
    kw = dict(kv_len=kv_len, q_offset=q_offset, causal=causal)
    out, lse = flash_attention_plain(*t[:3], **kw, return_lse=True)
    want = _backward_fp64(*t[:3], out, lse, t[3], **kw)
    shares = {}
    for single in (False, True):
        with monkeypatch.context() as m:
            m.setattr(torch, "einsum", _kernel_einsum(single))
            got = flash_attention_backward_plain(*t[:3], out, lse, t[3],
                                                 **kw)
        shares[single] = [
            float((a.double() - b).abs().max())
            / (REL * float(b.abs().max()) + ABS) for a, b in zip(got, want)]
    assert max(shares[False]) <= 1.0, (case, shares)
    assert min(shares[True]) > 1.0, (case, shares)


def test_tf32_rna_rounds_to_nearest_ties_away():
    """The model's cvt.rna: 10 stored bits, ties away from zero, both
    signs; the split's parts are TF32 values that sum back to x within
    2^-21 of it (big to nearest, small toward zero)."""
    one = 1.0
    ulp = 2.0 ** -10
    x = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 4,
                      one + 3 * ulp / 4, 3.0], dtype=torch.float32)
    want = torch.tensor([one + ulp, -(one + ulp), one, one + ulp, 3.0])
    assert torch.equal(_tf32_rna(x), want)
    r = torch.from_numpy(np.random.RandomState(18).randn(4096)
                         .astype(np.float32))
    big, small = _split_tf32(r)
    assert torch.equal(_tf32_rna(big), big)
    assert torch.equal(_tf32_rna(small), small)
    err = (big.double() + small.double() - r.double()).abs()
    assert bool((err <= 2.0 ** -21 * r.double().abs()).all())
    assert torch.equal(_tf32_trunc(-x), -_tf32_trunc(x))


# ---------------------------------------------------------------------------
# the tail
# ---------------------------------------------------------------------------

# nano width: d 64 = 2 heads of 32, ff 256; T = S = 30 positions
TAIL_SHAPE = dict(B=2, T=30, H=2, D=32, ff=256)
TAIL_NAMES = ("q", "k", "v", "h_in", "wo", "fc1_w", "fc2_w", "o_b", "fc1_b",
              "fc2_b", "ln2_g", "ln2_b")


def _tail_numpy(seed, shape=TAIL_SHAPE):
    rng = np.random.RandomState(seed)
    B, T, H, D, ff = (shape[n] for n in ("B", "T", "H", "D", "ff"))
    d = H * D
    shapes = ((B, T, H, D), (B, H, T, D), (B, H, T, D), (B, T, d), (d, d),
              (d, ff), (ff, d), (d,), (ff,), (d,), (d,), (d,))
    scales = (1, 1, 1, 1, d ** -0.5, d ** -0.5, ff ** -0.5, 0.1, 0.1, 0.1,
              0.2, 0.1)
    xs = [(rng.randn(*s) * c).astype(np.float32)
          for s, c in zip(shapes, scales)]
    xs[10] += 1.0                                   # ln2_g around 1
    return xs, (rng.randn(B, T, d)).astype(np.float32)


def _jax_tail(q, k, v, h_in, wo, fc1_w, fc2_w, o_b, fc1_b, fc2_b, g, b):
    """The JAX encoder's tail-off block after the QKV projection
    (whisper_tpu/models/whisper.py:572-578)."""
    B, T, H, D = q.shape
    a = jax_mha(q, k, v).reshape(B, T, H * D)
    h = h_in + jm.linear(a, {"w": wo, "b": o_b})
    y = jm.layer_norm(h, g, b, 1e-5)
    y = jm.linear(jm.gelu(jm.linear(y, {"w": fc1_w, "b": fc1_b})),
                  {"w": fc2_w, "b": fc2_b})
    return h + y


def _tail_twin(xs, g):
    t = [torch.from_numpy(x) for x in xs]
    B, T, H, D = t[0].shape
    attn, lse = flash_attention_plain(*t[:3], return_lse=True)
    return encoder_block_tail_backward_plain(
        *t, attn.reshape(B, T, H * D), lse, torch.from_numpy(g))


# ---------------------------------------------------------------------------
# the tail backward kernel's products (csrc/encoder_tail_bwd.cu), modelled
# on the CPU through the twin's one product function
# ---------------------------------------------------------------------------

# d 64, ff 256 and 3,000 rows: the weight gradients sum over 3,000 rows,
# no multiple of a 32-row tile
TAIL_MODEL_SHAPE = dict(B=20, T=150, H=2, D=32, ff=256)


def _kernel_product(single: bool = False, fold: bool = True,
                    chunk: int | None = None):
    """`backward_product` (x @ w, x (M, K), w (K, N)) as the kernel forms
    it: k-steps of 8, each an MMA whose exact sum (of TF32 products, fp64
    here) is rounded toward zero into its fp32 accumulator; split
    (`_split_tf32`): small.big, big.small, then big.big; single: big.big
    alone. With `fold` the accumulator starts from zero every 4 k-steps (a
    32-deep tile) and is added to the fp32 total rounded to nearest;
    without it one accumulator takes the whole range. K is cut into
    ranges of `chunk` (the weight gradients' split-K), each summed apart,
    and the partials are added in index order."""
    def product(x, w):
        K = x.shape[1]
        x_hi, x_lo = _split_tf32(x)
        w_hi, w_lo = _split_tf32(w)
        terms = [(x_hi, w_hi)] if single else [
            (x_lo, w_hi), (x_hi, w_lo), (x_hi, w_hi)]
        step_k = K if chunk is None else chunk
        out = None
        for c0 in range(0, K, step_k):
            c1 = min(K, c0 + step_k)
            total = part = None
            for step, k0 in enumerate(range(c0, c1, 8)):
                k1 = min(c1, k0 + 8)
                for a, b in terms:
                    z = a[:, k0:k1].double() @ b[k0:k1].double()
                    part = _round_to_zero(z if part is None
                                          else part.double() + z)
                if fold and ((step + 1) % 4 == 0 or k1 == c1):
                    total = part if total is None else total + part
                    part = None
            total = part if total is None else total
            out = total if out is None else out + total
        return out

    return product


def _tail_backward_fp64(q, k, v, h_in, wo, fc1_w, fc2_w, o_b, fc1_b, fc2_b,
                        g, b, attn, lse, d_out, eps=1e-5):
    """encoder_block_tail_backward_plain's math in fp64 on fp64 copies of
    the same inputs (the attention's through `_backward_fp64`)."""
    B, T, H, D = q.shape
    d = h_in.shape[-1]
    wo, w1, w2, bo, b1, b2, g, b = (x.double() for x in (
        wo, fc1_w, fc2_w, o_b, fc1_b, fc2_b, g, b))
    a = attn.double().reshape(-1, d)
    G = d_out.double().reshape(-1, d)
    h2 = h_in.double().reshape(-1, d) + a @ wo + bo
    mean = h2.mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt((h2 - mean).square().mean(dim=-1, keepdim=True) + eps)
    xhat = (h2 - mean) * rstd
    y = xhat * g + b
    u = y @ w1 + b1
    t1 = torch.nn.functional.gelu(u)
    du = (G @ w2.t()) * gelu_grad(u)
    dy = du @ w1.t()
    dx = dy * g
    dh2 = G + rstd * (dx - dx.mean(dim=-1, keepdim=True)
                      - xhat * (dx * xhat).mean(dim=-1, keepdim=True))
    da = (dh2 @ wo.t()).reshape(B, T, H, D)
    dq, dk, dv = _backward_fp64(q, k, v, attn.reshape(B, T, H, D), lse, da,
                                None, 0, False)
    return (dq, dk, dv, dh2.reshape(B, T, d), a.t() @ dh2, y.t() @ du,
            t1.t() @ G, dh2.sum(0), du.sum(0), G.sum(0), (dy * xhat).sum(0),
            dy.sum(0))


def _tail_model_shares(args, want, monkeypatch, **model) -> list:
    """Each gradient's error under the product model, as a share of the
    card tolerance (REL max |want| + ABS)."""
    with monkeypatch.context() as m:
        m.setattr(el, "backward_product", _kernel_product(**model))
        got = encoder_block_tail_backward_plain(*args)
    return [float((a.double() - b).abs().max())
            / (REL * float(b.abs().max()) + ABS) for a, b in zip(got, want)]


@pytest.mark.parametrize("chunk", [None, 800])
def test_tail_products_split_tf32_hold_the_card_tolerance(chunk,
                                                           monkeypatch):
    """The twin with its eight products as the kernel's split-TF32 wgmma
    tiles, folded every 32-deep tile (over 3,000 rows whole, or in split-K
    ranges of 800 summed in order): all twelve gradients within 1e-5 of
    max |g| + 1e-6 of the same math in fp64. A single TF32 pass misses it
    at every gradient that a product reaches (all but db2 = sum G). Not
    folded, one accumulator over the whole 3,000 rows misses it at the
    weight gradients (over 800-row ranges it does not, at this size)."""
    xs, g = _tail_numpy(seed=24, shape=TAIL_MODEL_SHAPE)
    t = [torch.from_numpy(x) for x in xs]
    B, T, H, D = t[0].shape
    attn, lse = flash_attention_plain(*t[:3], return_lse=True)
    args = (*t, attn.reshape(B, T, H * D), lse, torch.from_numpy(g))
    want = _tail_backward_fp64(*args)
    split = _tail_model_shares(args, want, monkeypatch, chunk=chunk)
    single = _tail_model_shares(args, want, monkeypatch, single=True,
                                chunk=chunk)
    assert max(split) <= 1.0, dict(zip(TAIL_NAMES, split))
    missed = [n for n, s in zip(TAIL_NAMES, single) if s > 1.0]
    assert missed == [n for n in TAIL_NAMES if n != "fc2_b"], \
        dict(zip(TAIL_NAMES, single))
    if chunk is None:
        whole = dict(zip(TAIL_NAMES, _tail_model_shares(
            args, want, monkeypatch, fold=False)))
        assert min(whole[n] for n in ("wo", "fc1_w", "fc2_w")) > 1.0, whole


def test_tail_backward_plain_matches_jax_vjp():
    xs, g = _tail_numpy(seed=21)
    got = _tail_twin(xs, g)
    _, vjp = jax.vjp(_jax_tail, *[jnp.asarray(x) for x in xs])
    want = vjp(jnp.asarray(g))
    assert len(got) == len(want) == 12
    for name, a, b in zip(TAIL_NAMES, got, want):
        _close(a.numpy(), np.asarray(b), name)


def test_tail_backward_plain_matches_autograd():
    xs, g = _tail_numpy(seed=22)
    got = _tail_twin(xs, g)
    t = [torch.from_numpy(x).requires_grad_() for x in xs]
    want = torch.autograd.grad(encoder_block_tail_plain(*t), t,
                               torch.from_numpy(g))
    for name, a, b in zip(TAIL_NAMES, got, want):
        _close(a.numpy(), b.numpy(), name)


def test_tail_backward_wrapper_on_cpu_is_the_twin():
    xs, g = _tail_numpy(seed=23)
    t = [torch.from_numpy(x) for x in xs]
    B, T, H, D = t[0].shape
    attn, lse = flash_attention_plain(*t[:3], return_lse=True)
    args = (*t, attn.reshape(B, T, H * D), lse, torch.from_numpy(g))
    n = encoder_block_tail_backward.launches
    got = encoder_block_tail_backward(*args)
    assert encoder_block_tail_backward.launches == n
    for a, b in zip(got, encoder_block_tail_backward_plain(*args)):
        assert torch.equal(a, b)


def test_gelu_grad_is_the_gelu_derivative():
    x = torch.linspace(-8, 8, 2001, dtype=torch.float64).requires_grad_()
    want, = torch.autograd.grad(torch.nn.functional.gelu(x).sum(), x)
    torch.testing.assert_close(gelu_grad(x.detach()), want, atol=1e-12,
                               rtol=1e-12)


# ---------------------------------------------------------------------------
# kernel_with_backward with the twins
# ---------------------------------------------------------------------------

def test_kernel_with_backward_carries_the_flash_twin():
    """The route the card takes, with the twins in the kernels' places:
    the value is the forward's, each gradient the backward twin's, within
    the tolerance of autograd's."""
    B, T, S, H, kv_len, q_offset, causal = FLASH_CASES["q_offset"]
    q, k, v, g = _flash_numpy(B, T, S, H, seed=31)
    kw = dict(kv_len=kv_len, q_offset=q_offset, causal=causal)
    t = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]

    def forward(*x):
        out, lse = flash_attention_plain(*x, **kw, return_lse=True)
        return out, (out, lse)

    def backward(grad_out, tensors, residuals):
        return flash_attention_backward_plain(*tensors, *residuals, grad_out,
                                              **kw)

    out = grad.kernel_with_backward(forward, backward, *t)
    want_out = flash_attention_plain(*t, **kw)
    assert torch.equal(out.detach(), want_out.detach())
    got = torch.autograd.grad(out, t, torch.from_numpy(g))
    want = torch.autograd.grad(want_out, t, torch.from_numpy(g))
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        _close(a.numpy(), b.numpy(), name)


def test_kernel_with_backward_carries_the_tail_twin():
    xs, g = _tail_numpy(seed=32)
    t = [torch.from_numpy(x).requires_grad_() for x in xs]
    B, T, H, D = t[0].shape

    def forward(*x):
        attn, lse = flash_attention_plain(*x[:3], return_lse=True)
        return encoder_block_tail_plain(*x), (attn.reshape(B, T, H * D),
                                              lse)

    def backward(grad_out, tensors, residuals):
        return encoder_block_tail_backward_plain(*tensors, *residuals,
                                                 grad_out)

    out = grad.kernel_with_backward(forward, backward, *t)
    got = torch.autograd.grad(out, t, torch.from_numpy(g))
    want = torch.autograd.grad(encoder_block_tail_plain(*t), t,
                               torch.from_numpy(g))
    for name, a, b in zip(TAIL_NAMES, got, want):
        _close(a.numpy(), b.numpy(), name)


def test_kernel_with_backward_drops_gradients_not_needed():
    """Inputs that do not require grad get none, whatever the backward
    returns for them; the backward runs once."""
    q, k, v, g = _flash_numpy(1, 6, 9, 2, seed=33)
    q, v = (torch.from_numpy(x).requires_grad_() for x in (q, v))
    k = torch.from_numpy(k)
    calls = []

    def forward(*x):
        out, lse = flash_attention_plain(*x, return_lse=True)
        return out, (out, lse)

    def backward(grad_out, tensors, residuals):
        calls.append(len(tensors))
        return flash_attention_backward_plain(*tensors, *residuals, grad_out)

    out = grad.kernel_with_backward(forward, backward, q, k, v)
    out.backward(torch.from_numpy(g))
    assert calls == [3]
    assert k.grad is None and q.grad is not None and v.grad is not None


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_refuse_bf16_grad_names_the_wrapper(dtype):
    with pytest.raises(RuntimeError, match="flash_attention: no backward"):
        grad.refuse_bf16_grad("flash_attention", dtype)
    grad.refuse_bf16_grad("flash_attention", torch.float32)
