"""The port's train step (whisper_tpu_torch/train.py) against the JAX
package's (whisper_tpu/train.py) at nano width, fp32, on the CPU: the
loss, every gradient leaf on each attention route, eight optimizer steps,
the schedule and the clip against optax, JAX's own train tests on the
port, the decoder's cache under autograd, a checkpoint round trip into
JAX, and the kernel wrappers' contract under autograd."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from whisper_tpu import train as jt
from whisper_tpu.config import get_config
from whisper_tpu.models import whisper as jm
from whisper_tpu.weights import load_npz as jax_load_npz
from whisper_tpu_torch import train as tt
from whisper_tpu_torch.models import whisper as tm
from whisper_tpu_torch.ops import cache_append, decode_attention, grad
from whisper_tpu_torch.ops.decoder_step import (
    fused_decoder_step,
    pack_decoder_weights,
)
from whisper_tpu_torch.ops.encoder_layer import (
    encoder_block_tail_plain,
    encoder_block_tail_q8,
)
from whisper_tpu_torch.ops import flash_attention as flash_mod
from whisper_tpu_torch.weights import (
    _keystr_leaves,
    from_device,
    from_jax_params,
    save_npz,
    trainable,
)

torch.set_num_threads(2)

# the three key biases: a key bias adds one constant to every score of a
# query, which the softmax cancels, so their true gradient is 0 and both
# packages give rounding noise there (|g| ~ 1e-10): held by absolute error
KEY_BIASES = ("['encoder']['layers']['attn']['k']['b']",
              "['decoder']['layers']['attn']['k']['b']",
              "['decoder']['layers']['cross_attn']['k']['b']")
GRAD_RTOL = 1e-4      # of the leaf's max |g|: fp32 sums in another order
GRAD_ATOL = 1e-7
KEY_BIAS_ATOL = 1e-7
# every parameter after eight train steps: ~2.6 times JAX's own spread
# between its jitted and eager steps (test_eight_steps_match_jax_train_step)
STEPS_ATOL = 5e-5
T_TOKENS = 12         # of n_text_ctx 16 slots: attention reads kv_len 12


def _cfg(layers: int = 2, name: str = "train-nano-2"):
    return get_config("tiny").replace(
        name=name, d_model=64, n_heads=2, n_audio_layers=layers,
        n_text_layers=layers, n_audio_ctx=32, n_text_ctx=16, vocab_size=512,
        eot_token=500, n_languages=4)


def _np_tree(cfg, seed: int):
    """JAX init params plus seeded noise (non-zero biases and LayerNorm
    parameters, so their gradients are exercised)."""
    rng = np.random.RandomState(seed + 100)
    return jax.tree.map(
        lambda x: (np.asarray(x) + 0.02 * rng.randn(*np.shape(x))
                   ).astype(np.float32),
        jm.init_params(cfg, jax.random.PRNGKey(seed)))


def _batch(cfg, B: int, T: int, seed: int, half: bool = False):
    rng = np.random.RandomState(seed)
    mel = (rng.randn(B, cfg.n_mels, 2 * cfg.n_audio_ctx) * 0.5
           ).astype(np.float32)
    tokens = rng.randint(0, 400, (B, T)).astype(np.int32)
    mask = np.ones((B, T), np.float32)
    if half:
        mask[:, T // 2:] = 0.0
    return mel, tokens, mask


def _jax_batch(b):
    return jt.TrainBatch(jnp.asarray(b[0]), jnp.asarray(b[1]),
                         jnp.asarray(b[2]))


def _port_batch(b):
    return tt.TrainBatch(*(torch.from_numpy(x) for x in b))


def _grads(tparams):
    """The gradient tree of a trainable tree, in JAX's layout, by JAX
    keystr."""
    def walk(t):
        return ({k: walk(v) for k, v in t.items()} if isinstance(t, dict)
                else t.grad)
    return dict(_keystr_leaves(from_device(walk(tparams))))


def _jax_by_key(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(kp): np.asarray(v) for kp, v in flat}


@pytest.fixture(scope="module")
def setup():
    """Weights, a batch (T = 12 of 16 slots), and JAX's loss and
    gradients on them."""
    cfg = _cfg()
    tree = _np_tree(cfg, 0)
    batch = _batch(cfg, 2, T_TOKENS, seed=1)
    jparams = jax.tree.map(jnp.asarray, tree)
    loss, jgrads = jax.jit(lambda p, b: jax.value_and_grad(jt.loss_fn)(
        p, cfg, b))(jparams, _jax_batch(batch))
    return dict(cfg=cfg, tree=tree, batch=batch, jparams=jparams,
                loss=float(loss), jgrads=_jax_by_key(jgrads))


@pytest.mark.parametrize("half", [False, True])
def test_loss_matches_jax(setup, half):
    cfg = setup["cfg"]
    batch = _batch(cfg, 2, T_TOKENS, seed=1, half=half)
    want = float(jax.jit(lambda p, b: jt.loss_fn(p, cfg, b))(
        setup["jparams"], _jax_batch(batch)))
    tparams = trainable(from_jax_params(setup["tree"]), "cpu")
    got = tt.loss_fn(tparams, cfg, _port_batch(batch)).item()
    assert abs(got - want) <= 1e-5, (got, want)


@pytest.mark.parametrize("route,env,backend,flash_calls", [
    ("default", {}, None, 0),
    ("tail_off", {"WHISPER_TPU_FUSED_ENCODER": "0"}, None, 0),
    # "pallas" sends the decoder's T > 1 reads (self and cross per layer)
    # through flash_attention, on the CPU its plain version, under grad
    ("pallas", {}, "pallas", 4),
    ("pallas_tail_off", {"WHISPER_TPU_FUSED_ENCODER": "0"}, "pallas", 6),
])
def test_gradients_match_jax(setup, monkeypatch, route, env, backend,
                             flash_calls):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    calls = []
    plain = flash_mod.flash_attention_plain

    def counted(*a, **kw):
        calls.append(torch.is_grad_enabled())
        return plain(*a, **kw)
    monkeypatch.setattr(flash_mod, "flash_attention_plain", counted)
    cfg = setup["cfg"].replace(attn_backend=backend)
    tparams = trainable(from_jax_params(setup["tree"]), "cpu")
    loss = tt.loss_fn(tparams, cfg, _port_batch(setup["batch"]))
    loss.backward()
    assert calls == [True] * flash_calls, route
    assert abs(loss.item() - setup["loss"]) <= 1e-5
    got = _grads(tparams)
    want = setup["jgrads"]
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        g = got[key].numpy()
        assert g.shape == w.shape, key
        err = float(np.abs(g - w).max())
        if key in KEY_BIASES:
            assert err <= KEY_BIAS_ATOL, (route, key, err)
        else:
            bound = GRAD_RTOL * float(np.abs(w).max()) + GRAD_ATOL
            assert float(np.abs(w).max()) > 0, key
            assert err <= bound, (route, key, err, bound)


def _key_bias_grads(tparams, d: int) -> float:
    """The largest |g| of the three key biases (after train_step's clip)."""
    layers = (tparams["encoder"]["layers"], tparams["decoder"]["layers"])
    return max([float(ly["attn"]["qkv"]["b"].grad[:, d:2 * d].abs().max())
                for ly in layers]
               + [float(layers[1]["cross_attn"]["k"]["b"].grad.abs().max())])


def test_eight_steps_match_jax_train_step(setup):
    """Eight updates at lr 1e-3 (warmup 1, total 50): the port's
    train_step against JAX's jitted train_step from the same weights on a
    fixed batch: the loss and the pre-clip norm of every step (rtol 1e-5),
    and every parameter afterwards within STEPS_ATOL.

    STEPS_ATOL: Adam scales each value's step by its own gradient's size,
    so a value whose gradient is small against its leaf's rounding
    difference (up to 1e-4 of the leaf's largest |g|, held in
    test_gradients_match_jax) can take another step. JAX's own train
    steps part that way when only the summation order changes: run jitted
    and run eagerly from these weights, after these eight steps they
    differ by up to 1.9e-5 (decoder fc2, where the largest moves are
    7e-3), and the port differs from the jitted by up to 1.6e-5 (CPU,
    fp32). The eager run takes ~50 s, so it is not repeated here.
    `test_optimizer_step_matches_optax` holds the update itself to 1e-6.

    The key biases: their gradient is rounding noise in both packages
    (KEY_BIASES), and Adam moves a leaf whose gradients stay below G by at
    most lr * G / eps a step (|m_hat| <= G, sqrt(v_hat) >= 0), in a
    direction the noise picks. Each package's key biases are so moved by
    up to sum(lr) * G / eps, so they are held to twice that, G the largest
    key-bias |g| of the port's steps and of JAX's first."""
    cfg, batch = setup["cfg"], setup["batch"]
    optimizer = jt.make_optimizer(lr=1e-3, warmup_steps=1, total_steps=50)
    jb = _jax_batch(batch)

    @jax.jit
    def step(params, opt_state):
        return jt.train_step(params, opt_state, cfg, jb, optimizer)

    jparams = setup["jparams"]
    opt_state = optimizer.init(jparams)
    tparams = trainable(from_jax_params(setup["tree"]), "cpu")
    opt = tt.make_optimizer(tparams, lr=1e-3, warmup_steps=1, total_steps=50)
    pb = _port_batch(batch)
    noise = max(float(np.abs(setup["jgrads"][k]).max()) for k in KEY_BIASES)
    lr_sum = 0.0
    for i in range(8):
        jparams, opt_state, jm_ = step(jparams, opt_state)
        lr_sum += opt.schedule(opt.count)
        tm_ = tt.train_step(tparams, opt, cfg, pb)
        noise = max(noise, _key_bias_grads(tparams, cfg.d_model))
        for name in ("loss", "grad_norm"):
            got, want = float(tm_[name]), float(jm_[name])
            assert abs(got - want) <= 1e-5 * abs(want), (i, name, got, want)
    assert opt.count == 8
    assert noise <= KEY_BIAS_ATOL
    got = dict(_keystr_leaves(from_device(tparams)))
    start = _jax_by_key(setup["jparams"])
    for key, w in _jax_by_key(jparams).items():
        err = float(np.abs(got[key].numpy() - w).max())
        if key in KEY_BIASES:
            bound = 2 * lr_sum * noise / 1e-8
        else:
            bound = STEPS_ATOL
        assert err <= bound, (key, err, bound, np.abs(w - start[key]).max())


@pytest.mark.parametrize("scale", [0.1, 30.0])
def test_optimizer_step_matches_optax(scale):
    """optimizer_step against JAX's make_optimizer chain on the same
    gradients, five updates (lr 1e-2, warmup 2, total 10, decay 0.1):
    below the clip (scale 0.1) and above it (30), gradients of order one
    against Adam's eps. Every parameter after every update to 1e-6."""
    rng = np.random.RandomState(7)
    # keys in sorted order: jax.tree.map's dicts and these walk alike
    shapes = {"b": (5,), "ln": {"b": (4,), "g": (4,)}, "w": (6, 5)}

    def draw(tree, s=1.0):
        return ({k: draw(v, s) for k, v in tree.items()}
                if isinstance(tree, dict)
                else (rng.randn(*tree) * s).astype(np.float32))
    params = draw(shapes)
    optimizer = jt.make_optimizer(lr=1e-2, weight_decay=0.1,
                                  warmup_steps=2, total_steps=10)
    jparams = jax.tree.map(jnp.asarray, params)
    state = optimizer.init(jparams)
    tparams = jax.tree.map(lambda x: torch.tensor(x, requires_grad=True),
                           params)
    opt = tt.make_optimizer(tparams, lr=1e-2, weight_decay=0.1,
                            warmup_steps=2, total_steps=10)
    for i in range(5):
        grads = draw(shapes, scale / 3)
        updates, state = optimizer.update(
            jax.tree.map(jnp.asarray, grads), state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for p, g in zip(tm.tree_leaves(tparams), tm.tree_leaves(grads)):
            p.grad = torch.from_numpy(g.copy())
        norm = tt.optimizer_step(tparams, opt)
        assert abs(float(norm) - float(optax.global_norm(grads))) \
            <= 1e-6 * float(norm)
        for p, w in zip(tm.tree_leaves(tparams), tm.tree_leaves(jparams)):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(w),
                                       rtol=0, atol=1e-6, err_msg=str(i))
    assert opt.count == 5


@pytest.mark.parametrize("lr,warmup,total", [
    (1e-3, 1, 50), (1e-5, 50, 1000), (2e-4, 10, 5), (3e-4, 0, 40)])
def test_schedule_matches_optax(lr, warmup, total):
    opt = tt.make_optimizer({"w": torch.zeros(2, requires_grad=True)},
                            lr=lr, warmup_steps=warmup, total_steps=total)
    want = optax.warmup_cosine_decay_schedule(0.0, lr, warmup,
                                              max(total, warmup + 1))
    for count in range(61):
        assert abs(opt.schedule(count) - float(want(count))) <= 1e-7, count
    assert opt.schedule(0) == (0.0 if warmup else lr)


@pytest.mark.parametrize("scale", [0.05, 7.0])
def test_clip_matches_optax(scale):
    """Below the bound (|g| < 1) the gradients stay as they are; above it
    optax's (g / |g|) * 1.0, not torch's clip_grad_norm_."""
    rng = np.random.RandomState(3)
    leaves = [rng.randn(*s).astype(np.float32) * scale
              for s in ((4, 5), (7,), (3, 2, 2))]
    got = [torch.from_numpy(x.copy()) for x in leaves]
    norm = tt.clip_by_global_norm(got, 1.0)
    want, _ = optax.clip_by_global_norm(1.0).update(
        [jnp.asarray(x) for x in leaves], optax.EmptyState())
    assert abs(float(norm) - float(optax.global_norm(leaves))) <= 1e-6
    assert (float(norm) < 1.0) == (scale < 1.0)
    for g, w, x in zip(got, want, leaves):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=0)
        if scale < 1.0:
            assert np.array_equal(g.numpy(), x)


def test_loss_decreases_on_fixed_batch():
    """tests/test_train.py's test, on the port: JAX's weights (PRNGKey 0,
    one layer each side), 8 steps at lr 1e-3 on a fixed batch of 4."""
    cfg = _cfg(1, "train-nano")
    params = jm.init_params(cfg, jax.random.PRNGKey(0))
    rng = np.random.RandomState(0)
    B = 4
    batch = (rng.randn(B, cfg.n_mels, 2 * cfg.n_audio_ctx)
             .astype(np.float32) * 0.5,
             rng.randint(0, 400, (B, cfg.n_text_ctx)).astype(np.int32),
             np.ones((B, cfg.n_text_ctx), np.float32))
    tparams = trainable(from_jax_params(jax.tree.map(np.asarray, params)),
                        "cpu")
    opt = tt.make_optimizer(tparams, lr=1e-3, warmup_steps=1, total_steps=50)
    pb = _port_batch(batch)
    l0 = tt.loss_fn(tparams, cfg, pb).item()
    assert abs(l0 - float(jt.loss_fn(params, cfg, _jax_batch(batch)))) <= 1e-5
    for _ in range(8):
        metrics = tt.train_step(tparams, opt, cfg, pb)
    l1 = tt.loss_fn(tparams, cfg, pb).item()
    assert np.isfinite(l0) and np.isfinite(l1)
    assert l1 < l0 * 0.95, (l0, l1)       # memorizing a fixed batch
    assert float(metrics["grad_norm"]) > 0


def test_loss_mask_zeroes_positions():
    """tests/test_train.py's test, on the port: masking out the second
    half changes the loss, as it changes JAX's."""
    cfg = _cfg(1, "train-nano")
    params = jm.init_params(cfg, jax.random.PRNGKey(1))
    full = _batch(cfg, 2, cfg.n_text_ctx, seed=1)
    half = _batch(cfg, 2, cfg.n_text_ctx, seed=1, half=True)
    tparams = trainable(from_jax_params(jax.tree.map(np.asarray, params)),
                        "cpu")
    lf = tt.loss_fn(tparams, cfg, _port_batch(full)).item()
    lh = tt.loss_fn(tparams, cfg, _port_batch(half)).item()
    assert abs(lf - lh) > 1e-6
    for b, got in ((full, lf), (half, lh)):
        assert abs(got - float(jt.loss_fn(params, cfg, _jax_batch(b)))) \
            <= 1e-5


def test_decoder_cache_under_grad_equals_no_grad(setup):
    """decoder_forward under autograd writes nothing in place and returns
    a new cache; its logits and cache equal the in-place no-grad call's,
    for a prompt and for tokens after it (pos_offset > 0)."""
    cfg = setup["cfg"]
    tparams = trainable(from_jax_params(setup["tree"]), "cpu")
    rng = np.random.RandomState(5)
    enc = torch.from_numpy(rng.randn(2, cfg.n_audio_ctx, cfg.d_model)
                           .astype(np.float32))
    toks = torch.from_numpy(rng.randint(0, 400, (2, 9)))
    cache_g = tm.init_kv_cache(cfg, 2, torch.float32, cfg.n_text_ctx, "cpu")
    cache_n = tm.init_kv_cache(cfg, 2, torch.float32, cfg.n_text_ctx, "cpu")
    cross = tm.precompute_cross_kv(tparams, cfg, enc)
    for lo, hi in ((0, 5), (5, 9)):
        given = {k: v.clone() for k, v in cache_g.items()}
        lg, cache_g = tm.decoder_forward(tparams, cfg, toks[:, lo:hi], lo,
                                         cache_g, cross)
        assert lg.requires_grad and cache_g["k"].requires_grad
        for k in given:                   # the given cache is untouched
            assert torch.equal(given[k], cache_g[k]) is (lo == hi)
        with torch.no_grad():
            ln, cache_n = tm.decoder_forward(
                tparams, cfg, toks[:, lo:hi], lo, cache_n,
                {k: v.detach() for k, v in cross.items()})
        assert torch.equal(lg.detach(), ln)
        for k in ("k", "v"):
            assert torch.equal(cache_g[k].detach(), cache_n[k])
    lg.sum().backward()
    assert tparams["decoder"]["layers"]["attn"]["qkv"]["w"].grad is not None


def test_trained_checkpoint_loads_into_jax(setup, tmp_path):
    """Port-trained params -> from_device -> save_npz -> JAX's load_npz:
    JAX's loss on them equals the port's."""
    cfg, batch = setup["cfg"], setup["batch"]
    tparams = trainable(from_jax_params(setup["tree"]), "cpu")
    opt = tt.make_optimizer(tparams, lr=1e-3, warmup_steps=1, total_steps=50)
    for _ in range(3):
        tt.train_step(tparams, opt, cfg, _port_batch(batch))
    path = str(tmp_path / "trained.npz")
    save_npz(path, from_device(tparams))
    jparams = jax_load_npz(path, cfg)
    want = float(jt.loss_fn(jparams, cfg, _jax_batch(batch)))
    got = tt.loss_fn(tparams, cfg, _port_batch(batch)).item()
    assert abs(got - want) <= 1e-5, (got, want)
    assert want != setup["loss"]          # the steps moved the weights


def test_trainable_owns_its_leaves_and_from_device_inverts_it(setup):
    params = from_jax_params(setup["tree"])
    tparams = trainable(params, "cpu")
    qkv = tparams["encoder"]["layers"]["attn"]["qkv"]
    assert qkv["w"].shape[-1] == 3 * setup["cfg"].d_model
    leaves = list(tm.tree_leaves(tparams))
    assert all(t.requires_grad and t.dtype == torch.float32 for t in leaves)
    ptrs = {t.data_ptr() for t in tm.tree_leaves(params)}
    assert not ptrs & {t.data_ptr() for t in leaves}
    back = dict(_keystr_leaves(from_device(tparams)))
    for key, want in _keystr_leaves(params):
        assert torch.equal(back[key], want), key


def test_bf16_training_raises(setup):
    cfg = setup["cfg"].replace(compute_dtype="bfloat16")
    tparams = trainable(from_jax_params(setup["tree"]), "cpu")
    with pytest.raises(ValueError, match="float32"):
        tt.loss_fn(tparams, cfg, _port_batch(setup["batch"]))


def _flash_inputs(T, S, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(*s, generator=g, dtype=torch.float64).float()
            .requires_grad_() for s in ((2, T, 3, 8), (2, 3, S, 8),
                                        (2, 3, S, 8))]


def _tail_inputs(seed=0):
    g = torch.Generator().manual_seed(seed)
    B, T, H, D, ff = 2, 5, 2, 8, 32
    d = H * D
    shapes = ((B, T, H, D), (B, H, T, D), (B, H, T, D), (B, T, d), (d, d),
              (d, ff), (ff, d), (d,), (ff,), (d,), (d,), (d,))
    return [(torch.randn(*s, generator=g) * 0.3).requires_grad_()
            for s in shapes]


def _autograd_backward(plain):
    """A backward for kernel_with_backward: `plain`'s autograd gradient at
    the saved inputs (every input, needed or not)."""
    def backward(grad_out, tensors, residuals):
        assert residuals == ()
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_() for t in tensors]
            return torch.autograd.grad(plain(*inputs), inputs, grad_out,
                                       allow_unused=True,
                                       materialize_grads=True)
    return backward


@pytest.mark.parametrize("case", [
    "flash", "flash_causal", "flash_kv_len", "flash_offset", "tail"])
def test_plain_backward_is_the_plain_gradient(case):
    """kernel_with_backward: the value is the forward's (here the plain
    version plus a constant, to tell them apart), the gradient of every
    input is the backward's (here the plain version's autograd
    gradient)."""
    if case == "tail":
        inputs = _tail_inputs()
        plain = functools.partial(encoder_block_tail_plain, eps=1e-5)
    else:
        kw = {"flash": {}, "flash_causal": {"causal": True, "kv_len": 7},
              "flash_kv_len": {"kv_len": 4},
              "flash_offset": {"causal": True, "q_offset": 2, "kv_len": 7}
              }[case]
        inputs = _flash_inputs(5, 7)
        plain = functools.partial(flash_mod.flash_attention_plain, **kw)
    w = torch.randn(plain(*inputs).shape, generator=torch.Generator()
                    .manual_seed(9))
    got = grad.kernel_with_backward(
        lambda *t: (plain(*t) + 0.5, ()), _autograd_backward(plain), *inputs)
    want = plain(*inputs)
    assert torch.equal(got.detach(), want.detach() + 0.5)
    g_got = torch.autograd.grad((got * w).sum(), inputs, allow_unused=True)
    g_want = torch.autograd.grad((want * w).sum(), inputs,
                                 allow_unused=True, materialize_grads=True)
    for a, b in zip(g_got, g_want):
        assert torch.equal(a, b)


def test_plain_backward_skips_inputs_without_grad():
    q, k, v = _flash_inputs(4, 6)
    k = k.detach()
    plain = flash_mod.flash_attention_plain
    out = grad.kernel_with_backward(lambda *t: (plain(*t), ()),
                                    _autograd_backward(plain), q, k, v)
    gq, gv = torch.autograd.grad(out.sum(), (q, v))
    wq, wv = torch.autograd.grad(
        flash_mod.flash_attention_plain(q, k, v).sum(), (q, v))
    assert torch.equal(gq, wq) and torch.equal(gv, wv)


def test_flash_plain_runs_without_inplace_ops():
    """flash_attention_plain under autograd: causal rows, a kv_len and a
    query past every key (zeros) all differentiate."""
    q, k, v = _flash_inputs(6, 9)
    out = flash_mod.flash_attention_plain(q, k, v, 5, 1, causal=True)
    out.square().sum().backward()
    assert all(torch.isfinite(t.grad).all() for t in (q, k, v))
    assert float(k.grad[:, :, 5:].abs().max()) == 0.0


def _grad_wrappers():
    """Every kernel wrapper without a backward, with CPU inputs of which
    one requires grad."""
    g = torch.Generator().manual_seed(4)

    def r(*s, dtype=torch.float32):
        return torch.randn(*s, generator=g).to(dtype)

    q = r(2, 1, 2, 64).requires_grad_()
    k, v = r(2, 2, 8, 64), r(2, 2, 8, 64)
    k8, v8 = (torch.randint(-127, 128, (2, 2, 8, 64), dtype=torch.int8)
              for _ in range(2))
    ks, vs = r(2, 2, 8, 1).abs(), r(2, 2, 8, 1).abs()
    cache = r(2, 2, 2, 8, 64), r(2, 2, 2, 8, 64)
    rows = r(2, 2, 2, 64).requires_grad_(), r(2, 2, 2, 64)
    d, ff, H = 128, 128, 2
    bf = torch.bfloat16
    i8 = torch.int8
    layers = {"attn": {"qkv": {"w": r(2, d, 3 * d), "b": r(2, 3 * d)},
                       "o": {"w": r(2, d, d), "b": r(2, d)}},
              "cross_attn": {n: {"w": r(2, d, d), "b": r(2, d)}
                             for n in "qkvo"},
              "fc1": {"w": r(2, d, ff), "b": r(2, ff)},
              "fc2": {"w": r(2, ff, d), "b": r(2, d)},
              **{ln: {"g": r(2, d), "b": r(2, d)}
                 for ln in ("attn_ln", "cross_ln", "mlp_ln")}}
    packed = pack_decoder_weights(layers, torch.float32)
    return {
        "decode_attention_bh": lambda: decode_attention.decode_attention_bh(
            q, k, v, 5),
        "decode_attention_bg": lambda: decode_attention.decode_attention_bg(
            q, k, v, 5, block_b=2),
        "decode_attention": lambda: decode_attention.decode_attention(
            q, k, v, 5),
        "decode_attention_q8_bh":
            lambda: decode_attention.decode_attention_q8_bh(q, k8, ks, v8,
                                                            vs, 5),
        "decode_attention_q8": lambda: decode_attention.decode_attention_q8(
            q, k8, ks, v8, vs, 5),
        "cache_append_rows": lambda: cache_append.cache_append_rows(
            *cache, *rows, 3),
        "cache_append_rows_ragged":
            lambda: cache_append.cache_append_rows_ragged(
                *cache, *rows, torch.tensor([1, 4])),
        "fused_decoder_step": lambda: fused_decoder_step(
            r(2, d).requires_grad_(), packed, *(r(2, 2, H, 8, 64)
                                                for _ in range(2)),
            *(r(2, 2, H, 10, 64) for _ in range(2)), 4, n_heads=H),
        "encoder_block_tail_q8": lambda: encoder_block_tail_q8(
            r(1, 4, H, 64, dtype=bf).requires_grad_(),
            r(1, H, 4, 64, dtype=bf), r(1, H, 4, 64, dtype=bf),
            r(1, 4, d, dtype=bf), torch.ones(d, d, dtype=i8),
            torch.ones(ff, d, dtype=i8), torch.ones(d, ff, dtype=i8),
            r(d), r(ff), r(d), r(d), r(d), r(ff).abs(), r(d).abs(),
            r(d).abs()),
    }


@pytest.mark.parametrize("name", sorted(_grad_wrappers()))
def test_wrappers_without_backward_raise_under_grad(name):
    """Under autograd a wrapper with no backward raises, naming itself,
    instead of returning an output with no graph; under no_grad the same
    call runs."""
    call = _grad_wrappers()[name]
    with pytest.raises(RuntimeError, match=name + ": no backward"):
        call()
    with torch.no_grad():
        call()
