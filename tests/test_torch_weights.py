"""Port weights (whisper_tpu_torch/weights.py) against the JAX package's
trees: conversion, the flat-bin reader, seeded init shapes, placement."""

import jax
import numpy as np
import pytest
import torch

from whisper_tpu.models.whisper import init_params as jax_init_params
from whisper_tpu.weights import from_flat_bin as jax_from_flat_bin
from whisper_tpu.weights import to_flat_bin
from whisper_tpu_torch import weights

torch.set_num_threads(2)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


@pytest.fixture(scope="module")
def jax_tree(small_cfg):
    return jax.tree.map(np.asarray,
                        jax_init_params(small_cfg, jax.random.PRNGKey(0)))


def test_from_jax_params_copies_every_leaf(jax_tree):
    got = _leaves(weights.from_jax_params(jax_tree))
    want = _leaves(jax_tree)
    assert got.keys() == want.keys()
    for name, w in want.items():
        assert got[name].dtype == torch.float32, name
        np.testing.assert_array_equal(got[name].numpy(), w, err_msg=name)


def test_flat_bin_reader_matches_jax(small_cfg, jax_tree, tmp_path):
    blob = to_flat_bin(jax_tree, small_cfg)
    want = _leaves(jax_from_flat_bin(blob, small_cfg))
    path = tmp_path / "w.bin"
    path.write_bytes(blob)
    for got_tree in (weights.from_flat_bin(blob, small_cfg),
                     weights.from_flat_bin_path(str(path), small_cfg)):
        got = _leaves(got_tree)
        assert got.keys() == want.keys()
        for name, w in want.items():
            np.testing.assert_array_equal(got[name].numpy(), np.asarray(w),
                                          err_msg=name)


def test_flat_bin_reader_rejects_wrong_size(small_cfg, jax_tree):
    blob = to_flat_bin(jax_tree, small_cfg)
    with pytest.raises(ValueError, match="exhausted"):
        weights.from_flat_bin(blob[:-4], small_cfg)
    with pytest.raises(ValueError, match="unread"):
        weights.from_flat_bin(blob + b"\0\0\0\0", small_cfg)


def test_init_params_shapes_and_scales(small_cfg, jax_tree):
    got = _leaves(weights.init_params(small_cfg, seed=3))
    want = _leaves(jax_tree)
    assert got.keys() == want.keys()
    for name, w in want.items():
        assert tuple(got[name].shape) == w.shape, name
        if name.endswith("/g"):
            assert torch.all(got[name] == 1.0), name
        elif name.endswith("/b"):
            assert torch.all(got[name] == 0.0), name
    w = got["/decoder/tok_emb"]
    assert abs(float(w.std()) - 0.02) < 1e-3
    # the fixed sinusoid is the JAX one exactly
    np.testing.assert_allclose(got["/encoder/pos_emb"].numpy(),
                               want["/encoder/pos_emb"], atol=1e-6)


def test_init_params_is_seeded(small_cfg):
    a = weights.init_params(small_cfg, seed=1)["decoder"]["tok_emb"]
    b = weights.init_params(small_cfg, seed=1)["decoder"]["tok_emb"]
    c = weights.init_params(small_cfg, seed=2)["decoder"]["tok_emb"]
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_to_device_casts_rank2_leaves_only(small_cfg, jax_tree):
    """The JAX rule (weights.py:337): fp32 leaves of rank >= 2 take the
    compute dtype, 1-D leaves stay fp32."""
    out = _leaves(weights.to_device(weights.from_jax_params(jax_tree), "cpu",
                                    torch.bfloat16))
    for name, t in out.items():
        want = torch.bfloat16 if t.ndim >= 2 else torch.float32
        assert t.dtype == want, name
