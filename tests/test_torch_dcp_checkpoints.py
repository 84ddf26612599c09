"""The port's sharded checkpoints (weights.save_dcp / load_dcp on
torch.distributed.checkpoint, the counterparts of the JAX package's
save_orbax / load_orbax): a checkpoint saved at tp = 4 and one saved at
(tp, pp) = (2, 2) restore bit-exact at (dp, tp) = (2, 2), at (tp, pp) =
(2, 2) and unsharded (equal to the JAX params they came from); a whole-tree
round trip without a mesh; and the reason for DTensors: a plain-tensor
save of four shards of one (4, 2) tensor keeps one shard's shape. One
gloo world of 4 CPU processes saves and restores
(tests/torch_mesh_ranks.py)."""

import jax
import numpy as np
import pytest
import torch

import torch_mesh_ranks as ranks
from whisper_tpu.config import get_config
from whisper_tpu.models.whisper import init_params
from whisper_tpu_torch import weights
from whisper_tpu_torch.parallel import launch

WORLD_TIMEOUT_S = 240


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    cfg = get_config("tiny").replace(
        name="shard-nano", d_model=64, n_heads=4, n_audio_layers=2,
        n_text_layers=2, n_audio_ctx=1500, n_text_ctx=448)
    params_np = jax.tree.map(np.asarray,
                             init_params(cfg, jax.random.PRNGKey(3)))
    directory = str(tmp_path_factory.mktemp("dcp"))
    out = launch.run("torch_mesh_ranks:dcp_rank", ranks.WORLD,
                     (params_np, directory), timeout=WORLD_TIMEOUT_S)
    return params_np, directory, out


@pytest.mark.parametrize("name", ["tp4", "tp2pp2", "tp4_to_tp2pp2"])
def test_sharded_restore_is_bit_exact(world, name):
    """Every rank's restored shard equals shard_params' at the new mesh."""
    *_, out = world
    for r in out:
        bad = [k for k, ok in r[name].items() if not ok]
        assert not bad, bad
        assert len(r[name]) == 53          # every leaf of the tree


@pytest.mark.parametrize("name", ["tp4", "tp2pp2"])
def test_unsharded_restore_equals_jax_params(world, name):
    params_np, directory, _ = world
    got = dict(weights._keystr_leaves(weights.load_dcp(
        f"{directory}/{name}", ranks.shard_nano())))
    want = {jax.tree_util.keystr(k): v for k, v in
            jax.tree_util.tree_flatten_with_path(params_np)[0]}
    assert got.keys() == want.keys()
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)


def test_whole_tree_round_trip(tmp_path):
    """No mesh: the tree is written and read in this process; a to_device
    tree (fused q/k/v) is written in the JAX layout."""
    cfg = ranks.shard_nano()
    params = weights.init_params(cfg, 5)
    weights.save_dcp(str(tmp_path / "c"), weights.to_device(params, "cpu"),
                     cfg)
    got = dict(weights._keystr_leaves(weights.load_dcp(str(tmp_path / "c"),
                                                       cfg)))
    for k, v in weights._keystr_leaves(params):
        assert torch.equal(got[k], v), k


def test_int8_tree_refused(tmp_path):
    cfg = ranks.shard_nano()
    params = weights.init_params(cfg, 5)
    params["decoder"]["tok_emb"] = params["decoder"]["tok_emb"].to(
        torch.int8)
    with pytest.raises(ValueError, match="int8"):
        weights.save_dcp(str(tmp_path / "c"), params, cfg)


def test_plain_tensor_save_loses_shards(world):
    """Why save_dcp wraps shards as DTensors: four ranks saving their
    (1, 2) shards of a (4, 2) tensor as plain tensors leave a (1, 2)
    checkpoint (DCP takes a plain tensor as replicated); the DTensor save
    keeps (4, 2)."""
    *_, out = world
    for r in out:
        assert r["sizes"] == {"plain": (1, 2), "dtensor": (4, 2)}
