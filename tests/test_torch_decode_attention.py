"""The port's fp32/bf16 decode attention (whisper_tpu_torch/ops/
decode_attention.py: decode_attention_bh, decode_attention_bg,
decode_attention) and the attention backend switch that reaches it
(ops/attention.py, models/whisper.py) against the JAX package on the CPU:
each plain version against its Pallas kernel in interpret mode, the
routes of every backend, the encoder gate under "reference",
decoder_step_ip's WHISPER_TPU_IP_CROSS=bg[N] cross read, and greedy
kv_cache_quant tokens under "pallas".

Kernel inputs: D=64, up to B=8, H=3, over S=200 cache slots (not a
multiple of the JAX kernels' 128-key tile). Decoder tests run at d_model
128 with 2 heads (head_dim 64, the kernel's)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_tpu.config import CONFIGS
from whisper_tpu.decode import greedy_decode as jax_greedy_decode
from whisper_tpu.models import whisper as jm
from whisper_tpu.ops import attention as jax_attention
from whisper_tpu.ops import decode_attention as jax_da
from whisper_tpu.tokenizer import build_prompt
from whisper_tpu.weights import to_device as jax_to_device
from whisper_tpu_torch.decode import greedy_decode
from whisper_tpu_torch.models import whisper as tm
from whisper_tpu_torch.ops import attention, decode_attention
from whisper_tpu_torch.weights import from_jax_params, to_device

torch.set_num_threads(2)

_DT = {"float32": (torch.float32, jnp.float32),
       "bfloat16": (torch.bfloat16, jnp.bfloat16)}
# fp32: online against two-pass softmax, fp32 sums in other orders. bf16
# output: about one bf16 ulp of O(1) values, where two fp32 results that
# differ in their last bits round to neighbouring bf16 values.
_TOL = {torch.float32: dict(atol=2e-5, rtol=1e-5),
        torch.bfloat16: dict(atol=8e-3, rtol=1e-2)}
S = 200


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.array(jnp.asarray(x).astype(jnp.float32))


def _inputs(q_dtype, kv_dtype, B=8, H=3, S=S, seed=0):
    """q (B, 1, H, 64) and k, v (B, H, S, 64) in the given dtypes on both
    sides (the torch copies hold the JAX values exactly)."""
    rng = np.random.RandomState(seed)
    jq = jnp.asarray(rng.randn(B, 1, H, 64), _DT[q_dtype][1])
    jk, jv = (jnp.asarray(rng.randn(B, H, S, 64), _DT[kv_dtype][1])
              for _ in range(2))
    return (jq, jk, jv), tuple(torch.from_numpy(_f32(a)).to(_DT[d][0])
                               for a, d in ((jq, q_dtype), (jk, kv_dtype),
                                            (jv, kv_dtype)))


# port wrapper, its plain version, the JAX function, block_b
_FNS = {
    "bh": (decode_attention.decode_attention_bh,
           decode_attention.decode_attention_bh_plain,
           jax_da.decode_attention_bh, None),
    "bg2": (decode_attention.decode_attention_bg,
            decode_attention.decode_attention_bg_plain,
            jax_da.decode_attention_bg, 2),
    "bg8": (decode_attention.decode_attention_bg,
            decode_attention.decode_attention_bg_plain,
            jax_da.decode_attention_bg, 8),
    "per_head": (decode_attention.decode_attention,
                 decode_attention.decode_attention_plain,
                 jax_da.decode_attention, None),
}


@pytest.mark.parametrize("kv_len", [0, 1, 60, S])
@pytest.mark.parametrize("q_dtype,kv_dtype", [
    ("float32", "float32"), ("bfloat16", "bfloat16"),
    ("bfloat16", "float32"),    # bh/bg round K/V to the query's bf16
    ("float32", "bfloat16"),    # decode_attention rounds p to V's bf16
])
@pytest.mark.parametrize("which", sorted(_FNS))
def test_plain_matches_jax_interpret(which, q_dtype, kv_dtype, kv_len):
    """Each wrapper's CPU route (its plain version) against its Pallas
    kernel in interpret mode, with the kernel's rounding points: in q's
    dtype, to the tolerance of that dtype; kv_len 0 gives zeros; the CPU
    counts no launch."""
    fn, plain, jfn, block_b = _FNS[which]
    (jq, jk, jv), (q, k, v) = _inputs(q_dtype, kv_dtype)
    kw = {} if block_b is None else {"block_b": block_b}
    want = jfn(jq, jk, jv, kv_len, interpret=True, **kw)
    before = fn.launches
    got = fn(q, k, v, kv_len, **kw)
    assert fn.launches == before
    assert got.dtype == q.dtype and tuple(got.shape) == want.shape
    # decode_attention rounds p to bf16 V at the running max of JAX's
    # 128-key tiles and at the final max here: one bf16 ulp of p, so the
    # bf16 tolerance, also under an fp32 query
    p_bf16 = which == "per_head" and v.dtype == torch.bfloat16
    tol = _TOL[torch.bfloat16 if p_bf16 else q.dtype]
    np.testing.assert_allclose(_f32(got), _f32(want), **tol)
    assert torch.equal(got, plain(q, k, v, kv_len, **kw))
    if kv_len == 0:
        assert not got.any()


@pytest.mark.parametrize("which", sorted(_FNS))
def test_plain_never_reads_past_kv_len(which):
    """NaN in the rows at and past kv_len does not reach the result: it
    equals the clean one bit for bit."""
    fn, _, _, block_b = _FNS[which]
    kw = {} if block_b is None else {"block_b": block_b}
    _, (q, k, v) = _inputs("bfloat16", "bfloat16", seed=1)
    clean = fn(q, k, v, 130, **kw)
    k[:, :, 130:] = float("nan")
    v[:, :, 130:] = float("nan")
    assert torch.equal(fn(q, k, v, 130, **kw), clean)


# (B*H, kv_len, SMs): the main paths' b32 reads on 132 SMs (tiny's and
# turbo's cross reads, tiny's 93-of-448 self read), the long cache, edges
# of the split threshold, and other cards and batches
_PLAN_GRID = [(bh, kv_len, sms)
              for bh in (1, 6, 24, 192, 640)
              for kv_len in (0, 1, 93, 255, 511, 512, 1500, 8000)
              for sms in (1, 132)]


@pytest.mark.parametrize("bh,kv_len,sms", _PLAN_GRID)
def test_split_plan_covers_the_keys(bh, kv_len, sms):
    """The splits the kernel reads, [s*chunk, min((s+1)*chunk, kv_len)),
    cover [0, kv_len) exactly, none is empty, all but the last hold chunk
    >= SPLIT_MIN_KEYS keys when there is more than one, there is one below
    2*SPLIT_MIN_KEYS keys, and the plan is a function of its inputs."""
    n, chunk, warps = decode_attention._split_plan(bh, kv_len, sms)
    assert (n, chunk, warps) == decode_attention._split_plan(bh, kv_len, sms)
    assert 1 <= n <= decode_attention.SPLIT_MAX
    assert warps in (8, decode_attention.WIDE_WARPS)
    bounds = [(s * chunk, min((s + 1) * chunk, kv_len)) for s in range(n)]
    keys = [j for a, b in bounds for j in range(a, b)]
    assert keys == list(range(kv_len))
    if kv_len:
        assert all(b > a for a, b in bounds)
    if n > 1:
        assert chunk >= decode_attention.SPLIT_MIN_KEYS
        assert all(b - a == chunk for a, b in bounds[:-1])
    if kv_len < 2 * decode_attention.SPLIT_MIN_KEYS:
        assert (n, chunk, warps) == (1, kv_len, 8)
    if bh >= sms:
        assert n == 1


@pytest.mark.parametrize("bh,kv_len,kv_bytes,want", [
    (192, 1500, 2, (1, 1500, 12)),  # tiny b32's bf16 cross read: one wave
    (192, 1500, 1, (1, 1500, 12)),  # its int8 (q8) read
    (192, 1500, 4, (1, 1500, 8)),   # fp32 K/V: 12 warps would not fit two
    (640, 1500, 2, (1, 1500, 8)),   # turbo b32's: 640 blocks
    (192, 93, 2, (1, 93, 8)),       # tiny b32's self read mid-bench
    (80, 1500, 2, (1, 1500, 12)),   # turbo B=4: 80 rows, not split
    (24, 8000, 2, (5, 1600, 12)),   # the long cache, B=4, H=6: 120 blocks
    (6, 1500, 2, (5, 300, 8)),      # tiny B=1's cross read: capped by keys
    (1, 8000, 2, (8, 1000, 12)),    # one row: capped by the cluster's 8
])
def test_split_plan_at_the_main_paths_reads(bh, kv_len, kv_bytes, want):
    """On 132 SMs: rows that leave fewer than half the SMs idle are not
    split, fewer rows are split into at most one block an SM; long reads
    whose grid fits two blocks an SM take 12 warps a block."""
    assert decode_attention._split_plan(bh, kv_len, 132, kv_bytes) == want


def _split_partials(q, k, v, kv_len, chunk, *, cast_kv, p_round):
    """Each split's partial softmax as the kernel's blocks write it, in
    torch ops: for split s over keys [s*chunk, min((s+1)*chunk, kv_len)),
    m_s = max s_j, l_s = sum_j exp(s_j - m_s) and acc_s = sum_j p_j v_j
    with p_j = exp(s_j - m_s) (rounded to V's dtype under p_round, l
    unrounded), all fp32. Returns m, l (B, H, n_split) and acc (B, H,
    n_split, D), n_split = ceil(kv_len / chunk). kv_len > 0."""
    D = q.shape[-1]
    if cast_kv:
        k, v = k.to(q.dtype), v.to(q.dtype)
    qs = q[:, 0].float() * (D ** -0.5)                      # (B, H, D)
    ms, ls, accs = [], [], []
    for start in range(0, kv_len, chunk):
        end = min(start + chunk, kv_len)
        s = torch.einsum("bhd,bhsd->bhs", qs, k[:, :, start:end].float())
        m = s.amax(dim=-1)
        p = torch.exp(s - m[..., None])
        ls.append(p.sum(dim=-1))
        if p_round:
            p = p.to(v.dtype)
        accs.append(torch.einsum("bhs,bhsd->bhd", p.float(),
                                 v[:, :, start:end].float()))
        ms.append(m)
    return torch.stack(ms, -1), torch.stack(ls, -1), torch.stack(accs, -2)


def _merge_splits(m, l, acc, dtype):
    """The merge the cluster's first block runs, in index order:
    M = max_s m_s, out = sum_s acc_s e^(m_s - M) /
    max(sum_s l_s e^(m_s - M), 1e-30), cast to `dtype`. Shapes as
    `_split_partials` returns them; the result is (B, 1, H, D)."""
    big = m.amax(dim=-1, keepdim=True)
    a = torch.exp(m - big)                                  # (B, H, n)
    lt = torch.zeros_like(big[..., 0])
    ot = torch.zeros_like(acc[:, :, 0])
    for s in range(m.shape[-1]):
        lt = lt + l[..., s] * a[..., s]
        ot = ot + acc[:, :, s] * a[..., s, None]
    return (ot / lt.clamp_min(1e-30)[..., None])[:, None].to(dtype)


# JAX function, cast_kv, p_round of each kernel form
_SPLIT_FNS = {"bh": (jax_da.decode_attention_bh, True, False),
              "per_head": (jax_da.decode_attention, False, True)}


@pytest.mark.parametrize("n_split,kv_len", [(1, 200), (2, 200), (3, 200),
                                            (4, 131)])
@pytest.mark.parametrize("q_dtype,kv_dtype", [
    ("float32", "float32"), ("bfloat16", "bfloat16"),
    ("bfloat16", "float32"),    # bh rounds K/V to the query's bf16
    ("float32", "bfloat16"),    # decode_attention rounds p to V's bf16
])
@pytest.mark.parametrize("which", sorted(_SPLIT_FNS))
def test_split_merge_matches_jax_interpret(which, q_dtype, kv_dtype,
                                           n_split, kv_len):
    """The split read's math in torch ops (each split's partial (m, l,
    acc), then the cluster's merge in index order) against the Pallas
    kernel in interpret mode, at the tolerances of
    test_plain_matches_jax_interpret: under p_round, p is rounded at each
    split's max."""
    jfn, cast_kv, p_round = _SPLIT_FNS[which]
    (jq, jk, jv), (q, k, v) = _inputs(q_dtype, kv_dtype, seed=5)
    want = jfn(jq, jk, jv, kv_len, interpret=True)
    chunk = -(-kv_len // n_split)
    m, l, acc = _split_partials(
        q, k, v, kv_len, chunk, cast_kv=cast_kv, p_round=p_round)
    assert m.shape == l.shape == (8, 3, n_split)
    assert acc.shape == (8, 3, n_split, 64)
    got = _merge_splits(m, l, acc, q.dtype)
    assert got.dtype == q.dtype and tuple(got.shape) == want.shape
    p_bf16 = p_round and v.dtype == torch.bfloat16
    tol = _TOL[torch.bfloat16 if p_bf16 else q.dtype]
    np.testing.assert_allclose(_f32(got), _f32(want), **tol)


def test_rounding_points_differ_where_jax_does():
    """decode_attention rounds p to bf16 V where decode_attention_bh does
    not, and bh rounds fp32 K/V to a bf16 query where decode_attention
    does not: the plain versions differ there, as the JAX kernels do."""
    _, (q, k, v) = _inputs("float32", "bfloat16", seed=2)
    a = decode_attention.decode_attention_plain(q, k, v)
    b = decode_attention.decode_attention_bh_plain(q, k, v)
    assert not torch.equal(a, b)
    _, (q, k, v) = _inputs("bfloat16", "float32", seed=3)
    a = decode_attention.decode_attention_plain(q, k, v)
    b = decode_attention.decode_attention_bh_plain(q, k, v)
    assert torch.equal(b, decode_attention.decode_attention_bh_plain(
        q, k.bfloat16(), v.bfloat16()))
    assert not torch.equal(a, b)


def test_wrappers_refuse_bad_arguments():
    _, (q, k, v) = _inputs("float32", "float32", B=6, S=16)
    with pytest.raises(ValueError, match="block_b 4 does not divide"):
        decode_attention.decode_attention_bg(q, k, v, block_b=4)
    with pytest.raises(ValueError, match="block_b 4 does not divide"):
        decode_attention.decode_attention_bg_plain(q, k, v, block_b=4)
    with pytest.raises(ValueError, match="one query token"):
        decode_attention.decode_attention_bh(q.expand(6, 2, 3, 64), k, v)
    with pytest.raises(ValueError, match="kv_len"):
        decode_attention.decode_attention(q, k, v, 17)
    with pytest.raises(ValueError, match="expected"):
        decode_attention.decode_attention_bh(q, k[:, :2], v)
    with pytest.raises(ValueError, match="no kernel for device"):
        decode_attention.decode_attention(*(t.to("meta") for t in (q, k, v)))


# ---------------------------------------------------------------------------
# the backend switch
# ---------------------------------------------------------------------------

@pytest.fixture
def routes(monkeypatch):
    """Each route the switch can take, counted by name."""
    seen = []
    for name in ("flash_attention", "decode_attention_bh", "mha_reference",
                 "decode_attention_q8_bh"):
        real = getattr(attention, name)

        def counting(*args, _real=real, _name=name, **kw):
            seen.append(_name)
            return _real(*args, **kw)

        monkeypatch.setattr(attention, name, counting)
    return seen


# the port's backend, JAX's for the same routes on the CPU
_JAX_BACKEND = {"reference": "reference", "pallas": "pallas_interpret",
                "pallas_interpret": "pallas_interpret", "auto": "auto"}
# (backend, T) -> the routes multi_head_attention takes, at sizes below
# the auto gates
_MHA_ROUTES = {
    ("reference", 1): ["mha_reference"], ("reference", 4): ["mha_reference"],
    ("pallas", 1): ["decode_attention_bh"], ("pallas", 4): ["flash_attention"],
    ("pallas_interpret", 1): ["decode_attention_bh"],
    ("pallas_interpret", 4): ["flash_attention"],
    ("auto", 1): ["mha_reference"], ("auto", 4): ["mha_reference"],
}


def _attention_inputs(T, seed=4):
    rng = np.random.RandomState(seed)
    q = rng.randn(2, T, 3, 64).astype(np.float32)
    k = rng.randn(2, 3, S, 64).astype(np.float32)
    v = rng.randn(2, 3, S, 64).astype(np.float32)
    return q, k, v


# fp32 2e-5 / 1e-5: the kernels' plain versions against JAX's kernels or
# reference, online against two-pass softmax, summed in other orders.
@pytest.mark.parametrize("T", [1, 4])
@pytest.mark.parametrize("backend", sorted(_JAX_BACKEND))
def test_switch_routes_and_matches_jax(backend, T, routes):
    """multi_head_attention under each backend takes JAX's route and
    equals JAX's result under the matching backend (the port's "pallas"
    against JAX's "pallas_interpret"): a self read (kv_len = q_offset + T,
    causal)."""
    q, k, v = _attention_inputs(T)
    kw = dict(causal=True, q_offset=77 - T)
    want = jax_attention.multi_head_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 77, **kw,
        backend=_JAX_BACKEND[backend])
    got = attention.multi_head_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), 77,
        **kw, backend=backend)
    assert routes == _MHA_ROUTES[backend, T]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=1e-5)


# (backend, T) -> the routes multi_head_attention_quant takes below 4096
# slots: the q8 kernel at every size only under "pallas_interpret"
_QUANT_ROUTES = {
    ("reference", 1): ["mha_reference"], ("reference", 4): ["mha_reference"],
    ("pallas", 1): ["decode_attention_bh"], ("pallas", 4): ["flash_attention"],
    ("pallas_interpret", 1): ["decode_attention_q8_bh"],
    ("pallas_interpret", 4): ["flash_attention"],
    ("auto", 1): ["mha_reference"], ("auto", 4): ["mha_reference"],
}


@pytest.mark.parametrize("T", [1, 4])
@pytest.mark.parametrize("backend", sorted(_JAX_BACKEND))
def test_quant_switch_routes_and_matches_jax(backend, T, routes):
    """multi_head_attention_quant under each backend: the q8 kernel for a
    T==1 read under "pallas_interpret" (at every size), never under
    "reference"; otherwise the dequantized read passed on with the same
    backend. Equal to JAX's under the matching backend."""
    q, k, v = _attention_inputs(T, seed=5)
    (k8, ks), (v8, vs) = jm.quantize_kv(jnp.asarray(k)), \
        jm.quantize_kv(jnp.asarray(v))
    want = jax_attention.multi_head_attention_quant(
        jnp.asarray(q), k8, ks, v8, vs, 90, causal=True, q_offset=90 - T,
        backend=_JAX_BACKEND[backend])
    got = attention.multi_head_attention_quant(
        torch.from_numpy(q), *(torch.from_numpy(np.array(a))
                               for a in (k8, ks, v8, vs)), 90,
        causal=True, q_offset=90 - T, backend=backend)
    assert routes == _QUANT_ROUTES[backend, T]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("quant", [False, True])
def test_kernel_routes_hand_over_a_contiguous_query(quant, monkeypatch):
    """A self-attention q is a strided view of the fused QKV projection;
    the decode kernels take a contiguous q, so the T==1 kernel routes hand
    them one (the card's wrappers raise on a strided q)."""
    seen = []
    for name in ("decode_attention_bh", "decode_attention_q8_bh"):
        real = getattr(attention, name)

        def checking(q, *args, _real=real):
            seen.append(q.is_contiguous())
            return _real(q, *args)

        monkeypatch.setattr(attention, name, checking)
    rng = np.random.RandomState(8)
    qkv = torch.from_numpy(rng.randn(3, 1, 3 * 128).astype(np.float32))
    q = tm.split_heads(qkv.chunk(3, dim=-1)[0], 2)
    assert not q.is_contiguous()
    k, v = (torch.from_numpy(rng.randn(3, 2, 40, 64).astype(np.float32))
            for _ in range(2))
    if quant:
        (k8, ks), (v8, vs) = tm.quantize_kv(k), tm.quantize_kv(v)
        got = attention.multi_head_attention_quant(
            q, k8, ks, v8, vs, 30, backend="pallas_interpret")
        want = attention.mha_reference(q, k8 * ks, v8 * vs, 30)
    else:
        got = attention.multi_head_attention(q, k, v, 30, backend="pallas")
        want = attention.mha_reference(q, k, v, 30)
    assert seen == [True]
    torch.testing.assert_close(got, want, atol=2e-6, rtol=1e-5)


@pytest.mark.parametrize("env,backend,want", [
    ("pallas", None, ["decode_attention_bh"]),        # the env var alone
    ("reference", None, ["mha_reference"]),
    ("reference", "pallas", ["decode_attention_bh"]),  # explicit first
    ("pallas", "reference", ["mha_reference"]),
    ("", None, ["mha_reference"]),                    # unset: auto
])
def test_env_var_and_precedence(env, backend, want, routes, monkeypatch):
    """WHISPER_TPU_ATTN picks the backend of a call without one; an
    explicit backend= wins over it; unset (or empty) is "auto", as JAX's
    default_backend reads it."""
    monkeypatch.setenv("WHISPER_TPU_ATTN", env)
    assert attention.default_backend() == (env or "auto")
    if env:
        assert jax_attention.default_backend() == env
    q, k, v = (torch.from_numpy(a) for a in _attention_inputs(1))
    attention.multi_head_attention(q, k, v, 50, backend=backend)
    assert routes == want


def test_cfg_backend_wins_over_env_var(routes, monkeypatch):
    """cfg.attn_backend reaches the cache reads and wins over
    WHISPER_TPU_ATTN; with None the env var decides."""
    monkeypatch.setenv("WHISPER_TPU_ATTN", "pallas")
    q, k, v = (torch.from_numpy(a) for a in _attention_inputs(1))
    cfg = CONFIGS["tiny"]
    for backend, want in (("reference", "mha_reference"),
                          (None, "decode_attention_bh")):
        routes.clear()
        tm._cache_attention(q, {"k": k, "v": v}, 50, causal=True,
                            q_offset=49, cfg=cfg.replace(attn_backend=backend),
                            dtype=torch.float32)
        assert routes == [want]


@pytest.mark.parametrize("quant", [False, True])
def test_unknown_backend_raises(quant, monkeypatch):
    q, k, v = (torch.from_numpy(a) for a in _attention_inputs(1))
    if quant:
        k8, ks = tm.quantize_kv(k)

        def call(backend):
            return attention.multi_head_attention_quant(q, k8, ks, k8, ks,
                                                        backend=backend)
    else:
        def call(backend):
            return attention.multi_head_attention(q, k, v, backend=backend)
    with pytest.raises(ValueError, match="unknown attention backend 'flash'"):
        call("flash")
    with pytest.raises(ValueError):      # JAX raises on it too
        jax_attention.multi_head_attention(
            jnp.zeros((1, 1, 1, 64)), jnp.zeros((1, 1, 8, 64)),
            jnp.zeros((1, 1, 8, 64)), backend="flash")
    monkeypatch.setenv("WHISPER_TPU_ATTN", "xla")
    with pytest.raises(ValueError, match="unknown attention backend 'xla'"):
        call(None)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_encoder_tail_mode_under_reference(name, monkeypatch):
    """"reference" turns the tail off at every width, from the config or
    from WHISPER_TPU_ATTN, as the JAX gate does; "pallas" takes the tail
    at every width, as the JAX gate does (the port's rule takes every
    Whisper width)."""
    cfg = CONFIGS[name]
    dev = torch.device("cpu")
    ref = cfg.replace(attn_backend="reference")
    assert jm._encoder_tail_mode(ref, 1, cfg.n_audio_ctx) == "off"
    assert tm._encoder_tail_mode(ref, dev) == "off"
    pallas = cfg.replace(attn_backend="pallas")
    assert jm._encoder_tail_mode(pallas, 1, cfg.n_audio_ctx) == "pallas"
    assert tm._encoder_tail_mode(pallas, dev) == "tail"
    monkeypatch.setenv("WHISPER_TPU_ATTN", "reference")
    assert tm._encoder_tail_mode(cfg, dev) == "off"


# ---------------------------------------------------------------------------
# the model: decoder_step_ip's bg cross read, kv_cache_quant greedy tokens
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dcfg(small_cfg):
    return small_cfg.replace(name="bg-nano", d_model=128, n_heads=2,
                             n_audio_ctx=200, n_text_ctx=64)


@pytest.fixture(scope="module")
def dtree(dcfg):
    rng = np.random.RandomState(1)
    return jax.tree.map(
        lambda x: (np.asarray(x) + 0.02 * rng.randn(*np.shape(x))
                   ).astype(np.float32),
        jm.init_params(dcfg, jax.random.PRNGKey(3)))


def _both(np_tree, cfg):
    jp = jax.tree.map(jnp.asarray, np_tree)
    bf16 = cfg.compute_dtype == "bfloat16"
    tp = to_device(from_jax_params(np_tree), "cpu",
                   torch.bfloat16 if bf16 else None)
    return (jax_to_device(jp, jnp.bfloat16) if bf16 else jp), tp


@pytest.mark.parametrize("dtype,B,mode,takes_bg", [
    ("bfloat16", 4, "bg2", True),   # every layer's cross read: block_b 2
    ("bfloat16", 4, "bg", False),   # block_b 8 does not divide 4: einsum
    ("float32", 4, "bg2", False),   # fp32 mode never takes bg
])
def test_step_ip_bg_cross_matches_jax(dcfg, dtree, dtype, B, mode, takes_bg,
                                      monkeypatch):
    """decoder_step_ip under WHISPER_TPU_IP_CROSS against JAX's step with
    the same knob and "pallas_interpret" (its interpret-mode
    decode_attention_bg): logits to a few bf16 ulps of the O(1) values in
    bf16 (1e-4 in fp32), the same argmax, and decode_attention_bg taken
    for every layer exactly where JAX takes it."""
    monkeypatch.setenv("WHISPER_TPU_IP_CROSS", mode)
    cfg = dcfg.replace(compute_dtype=dtype)
    tdt, jdt = _DT[dtype]
    jp, tp = _both(dtree, cfg)
    rng = np.random.RandomState(6)
    enc = rng.randn(B, cfg.n_audio_ctx, cfg.d_model).astype(np.float32)
    prompt = np.tile(build_prompt(cfg), (B, 1))
    P = prompt.shape[1]
    jcross = jm.precompute_cross_kv(jp, cfg, jnp.asarray(enc, jdt))
    jl0, jcache = jm.decoder_forward(jp, cfg, jnp.asarray(prompt, jnp.int32),
                                     jnp.int32(0),
                                     jm.init_kv_cache(cfg, B, jdt, 64), jcross)
    last = np.argmax(_f32(jl0)[:, -1:], axis=-1)
    jcfg = cfg.replace(attn_backend="pallas_interpret")
    jl, _ = jm.decoder_step_ip(jp, jcfg, jnp.asarray(last, jnp.int32),
                               jnp.int32(P), jcache, jcross, mxu_t=0)
    tcross = {n: torch.from_numpy(_f32(a)).to(tdt) for n, a in jcross.items()}
    tcache = {n: torch.from_numpy(_f32(a)).to(tdt) for n, a in jcache.items()}
    calls = []
    real = tm.decode_attention_bg
    monkeypatch.setattr(tm, "decode_attention_bg",
                        lambda *a, **kw: calls.append(kw) or real(*a, **kw))
    tl, _ = tm.decoder_step_ip(tp, cfg, torch.from_numpy(last), P, tcache,
                               tcross)
    assert len(calls) == (cfg.n_text_layers if takes_bg else 0)
    assert all(kw == {"block_b": 2} for kw in calls)
    np.testing.assert_allclose(tl.numpy(), _f32(jl),
                               atol=0.05 if dtype == "bfloat16" else 1e-4)
    assert (tl[:, -1].argmax(-1).numpy() == _f32(jl)[:, -1].argmax(-1)).all()


def test_kv_cache_quant_greedy_under_pallas_matches_jax(dcfg, dtree,
                                                        monkeypatch):
    """fp32 kv_cache_quant greedy decoding under "pallas" (every T==1 step
    read through decode_attention_bh, the prefill's through flash) gives
    JAX's tokens under "pallas_interpret" (its interpret-mode q8 kernel
    for the step reads). max_new=17: a decode cap no other test uses with
    this config (the JAX stages are jitted on (cfg, total, max_new))."""
    cfg = dcfg.replace(kv_cache_quant=True)
    jp, tp = _both(dtree, cfg)
    enc = np.random.RandomState(7).randn(2, cfg.n_audio_ctx, cfg.d_model
                                         ).astype(np.float32)
    prompt = np.tile(build_prompt(cfg), (2, 1))
    bias = np.zeros(cfg.vocab_size, np.float32)
    bias[cfg.eot_token] = -1e9             # EOT banned: all 17 steps run
    want = jax_greedy_decode(jp, cfg.replace(attn_backend="pallas_interpret"),
                             jnp.asarray(enc), jnp.asarray(prompt, jnp.int32),
                             max_new=17, logit_bias=jnp.asarray(bias))
    calls = []
    real = attention.decode_attention_bh
    monkeypatch.setattr(attention, "decode_attention_bh",
                        lambda *a: calls.append(1) or real(*a))
    got = greedy_decode(tp, cfg.replace(attn_backend="pallas"),
                        torch.from_numpy(enc), torch.from_numpy(prompt),
                        max_new=17, logit_bias=torch.from_numpy(bias))
    np.testing.assert_array_equal(got.tokens.numpy(), np.array(want.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(),
                                  np.asarray(want.lengths))
    assert len(calls) == 2 * cfg.n_text_layers * 17   # self, cross: each step
