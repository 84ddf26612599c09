"""The port's expert parallelism (whisper_tpu_torch/parallel/expert.py)
against the JAX package's (whisper_tpu/parallel/expert.py): moe_mlp on
JAX's weights, dense equivalence with tied experts, routing, and
moe_mlp_sharded at (dp, ep) = (1, 4) and (2, 2) in a gloo world of 4 CPU
processes, equal to the unsharded layer."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_ranks as ranks
from whisper_tpu.parallel import expert as jexpert
from whisper_tpu_torch.parallel import expert, launch

D, FF, E = 16, 32, 4
WORLD_TIMEOUT_S = 180


def _torch(tree):
    return {k: (_torch(v) if isinstance(v, dict) else
                torch.from_numpy(np.array(v))) for k, v in tree.items()}


@pytest.fixture(scope="module")
def setup():
    params = jexpert.init_moe_params(jax.random.PRNGKey(0), D, FF, E)
    x = jax.random.normal(jax.random.PRNGKey(1), (2, 6, D), jnp.float32)
    return params, np.array(x)


def test_moe_mlp_matches_jax(setup):
    params, x = setup
    want = np.asarray(jexpert.moe_mlp(jnp.asarray(x), params))
    got = expert.moe_mlp(torch.from_numpy(x), _torch(params)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_dense_equivalence(setup):
    """With identical expert weights the switch layer equals the plain MLP
    times the top-1 gate, for any routing."""
    params, x = setup
    p = _torch(params)
    tied = dict(p, w1=p["w1"][:1].expand_as(p["w1"]),
                b1=torch.zeros_like(p["b1"]),
                w2=p["w2"][:1].expand_as(p["w2"]),
                b2=torch.zeros_like(p["b2"]))
    xt = torch.from_numpy(x)
    y = expert.moe_mlp(xt, tied)
    gv = torch.softmax(xt @ tied["router"]["w"], dim=-1).amax(-1,
                                                              keepdim=True)
    dense = torch.nn.functional.gelu(xt @ tied["w1"][0]) @ tied["w2"][0]
    np.testing.assert_allclose(y.numpy(), (dense * gv).numpy(), rtol=1e-5,
                               atol=1e-5)


def test_routing_selects_distinct_experts(setup):
    params, x = setup
    gates = torch.softmax(torch.from_numpy(x) @ _torch(params)["router"]["w"],
                          dim=-1)
    assert len(np.unique(gates.argmax(-1).numpy())) > 1


def test_init_moe_params_shapes_and_scale():
    p = expert.init_moe_params(torch.Generator().manual_seed(0), D, FF, E)
    j = jexpert.init_moe_params(jax.random.PRNGKey(0), D, FF, E)
    for k in ("w1", "b1", "w2", "b2"):
        assert tuple(p[k].shape) == j[k].shape
    assert tuple(p["router"]["w"].shape) == j["router"]["w"].shape
    assert abs(p["w1"].std().item() / (2.0 / D) ** 0.5 - 1) < 0.1
    assert not p["b1"].any() and not p["b2"].any()


def test_moe_specs_match_jax():
    got = expert.moe_specs()
    want = jexpert.moe_specs()
    assert got["router"]["w"] == tuple(want["router"]["w"])
    for k in ("w1", "b1", "w2", "b2"):
        assert got[k] == tuple(want[k])


@pytest.fixture(scope="module")
def world(setup):
    params, x = setup
    return launch.run("torch_mesh_ranks:expert_rank", ranks.WORLD,
                      (jax.tree.map(np.asarray, params), x),
                      timeout=WORLD_TIMEOUT_S)


@pytest.mark.parametrize("dp,ep", [(1, 4), (2, 2)])
def test_ep_sharded_matches_unsharded(setup, world, dp, ep):
    params, x = setup
    ref = np.asarray(jexpert.moe_mlp(jnp.asarray(x), params))
    plain = expert.moe_mlp(torch.from_numpy(x), _torch(params)).numpy()
    for r in world:
        got, n_local = r[dp, ep]
        assert n_local == E // ep
        np.testing.assert_array_equal(got, plain)
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
