"""The port's mesh and sharding rules (whisper_tpu_torch/parallel/mesh.py)
against the JAX package's (whisper_tpu/parallel/mesh.py): the mesh axes,
sanitize_pspec, param_pspecs, each rank's shards against the JAX
NamedSharding's shard on the matching virtual device, padded_vocab_rows,
and the tp = 4 prefill with the padded vocabulary against JAX's unsharded
logits. The ranks run in one gloo world of 4 CPU processes
(tests/torch_mesh_ranks.py), spawned once for the module."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import torch_mesh_ranks as ranks
from whisper_tpu.config import get_config
from whisper_tpu.models.whisper import (
    decoder_forward,
    encoder_forward,
    init_kv_cache,
    init_params,
    precompute_cross_kv,
)
from whisper_tpu.parallel import mesh as jmesh
from whisper_tpu.tokenizer import build_prompt
from whisper_tpu_torch import weights
from whisper_tpu_torch.parallel import launch
from whisper_tpu_torch.parallel import mesh as tmesh

WORLD_TIMEOUT_S = 240
LOGITS_ATOL, LOGITS_RTOL = 2e-4, 1e-5


def _jax_cfg():
    return get_config("tiny").replace(
        name="shard-nano", d_model=64, n_heads=4, n_audio_layers=2,
        n_text_layers=2, n_audio_ctx=1500, n_text_ctx=448)


@pytest.fixture(scope="module")
def world():
    cfg = _jax_cfg()
    params = init_params(cfg, jax.random.PRNGKey(0))
    params_np = jax.tree.map(np.asarray, params)
    rng = np.random.RandomState(7)
    mel = (rng.randn(4, cfg.n_mels, cfg.n_frames) * 0.5).astype(np.float32)
    prompt = np.tile(build_prompt(cfg), (4, 1)).astype(np.int64)
    out = launch.run("torch_mesh_ranks:mesh_rank", ranks.WORLD,
                     (params_np, mel, prompt), timeout=WORLD_TIMEOUT_S)
    return cfg, params, params_np, mel, prompt, out


def test_make_mesh_axes(world):
    *_, out = world
    for r in out:
        assert r["axes"] == (("dp", "sp", "tp"), (2, 1, 2))
        assert r["mismatch_raises"]        # 3 x 2 != 4 processes


def test_make_mesh_needs_processes():
    """Without a process group only the mesh of one opens its own
    world."""
    import torch.distributed as dist
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="needs 4 processes"):
        tmesh.make_mesh(dp=2, tp=2, device_type="cpu")


def test_sanitize_pspec_drops_indivisible_axes(world):
    *_, out = world
    mesh = jmesh.make_mesh(dp=2, tp=2, devices=jax.devices()[:4])
    want = [jmesh.sanitize_pspec(s, P(*spec), mesh) for s, spec in (
        ((51865, 64), ("tp", None)), ((128, 384), (None, "tp")),
        ((64, 3), (("dp", "tp"), None)), ((8, 8, 8), ("tp",)),
        ((9, 8, 8), ("tp",)))]
    for r in out:
        assert [P(*s) for s in r["sanitize"]] == want
    assert out[0]["sanitize"][0] == (None, None)
    assert out[0]["sanitize"][2] == (("dp", "tp"), None)


@pytest.mark.parametrize("pipeline", [False, True])
def test_param_pspecs_match_jax(world, pipeline):
    """The rule table, leaf for leaf, on the JAX tree's paths."""
    _, params, params_np, *_ = world
    want = dict((jax.tree_util.keystr(k), tuple(v)) for k, v in
                jax.tree_util.tree_flatten_with_path(
                    jmesh.param_pspecs(params, pipeline=pipeline),
                    is_leaf=lambda x: isinstance(x, P))[0])
    got = dict(weights._keystr_leaves(tmesh.param_pspecs(
        weights.from_jax_params(params_np), pipeline=pipeline)))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == want[k] + (None,) * (len(got[k]) - len(want[k])), k
    assert got["['decoder']['tok_emb']"] == ("tp", None)
    assert got["['encoder']['layers']['fc1']['w']"] == (
        "pp" if pipeline else None, None, "tp")
    assert got["['encoder']['layers']['fc2']['w']"] == (
        "pp" if pipeline else None, "tp", None)


def _jax_shards(params, mesh):
    """{keystr: {flat device index: shard data}} of JAX's placement."""
    index = {d: i for i, d in enumerate(mesh.devices.reshape(-1))}
    flat, _ = jax.tree_util.tree_flatten_with_path(
        jmesh.shard_params(params, mesh))
    return {jax.tree_util.keystr(k): {index[s.device]: np.asarray(s.data)
                                      for s in v.addressable_shards}
            for k, v in flat}


# a leaf of each rule: column, row, vocab, replicated, pp-stacked
LEAVES = ("['encoder']['layers']['fc1']['w']",       # column
          "['encoder']['layers']['fc1']['b']",       # column bias
          "['encoder']['layers']['fc2']['w']",       # row
          "['decoder']['layers']['attn']['o']['w']",  # row
          "['decoder']['layers']['fc2']['b']",       # row bias: replicated
          "['decoder']['layers']['cross_attn']['q']['w']",
          "['decoder']['tok_emb']",                  # vocab (padded)
          "['encoder']['conv1']['w']",               # replicated
          "['encoder']['pos_emb']",
          "['decoder']['ln']['g']",
          "['decoder']['layers']['mlp_ln']['g']")    # stacked LN


@pytest.mark.parametrize("axes", [{"dp": 2, "sp": 1, "tp": 2},
                                  {"dp": 1, "sp": 1, "tp": 2, "pp": 2}],
                         ids=["dp2_tp2", "tp2_pp2"])
@pytest.mark.parametrize("leaf", LEAVES)
def test_shards_match_jax_placement(world, axes, leaf):
    """Each rank's local shard equals the JAX NamedSharding's shard on the
    virtual device at the same mesh position."""
    _, params, *_, out = world
    mesh = jmesh.make_mesh(**axes, devices=jax.devices()[:4])
    want = _jax_shards(params, mesh)[leaf]
    key = "shards_tp_pp" if "pp" in axes else "shards_dp_tp"
    for r in range(ranks.WORLD):
        np.testing.assert_array_equal(out[r][key][leaf], want[r])


def test_pp_stacks_split_layers(world):
    *_, out = world
    spec = out[0]["pspecs_pp"]["['decoder']['layers']['attn']['q']['w']"]
    assert spec == ("pp", None, "tp")
    q = out[0]["shards_tp_pp"]["['decoder']['layers']['attn']['q']['w']"]
    assert q.shape == (1, 64, 32)          # 2 layers / pp 2, 64 / tp 2


def test_padded_vocab_rows():
    for tp in (2, 4, 8):
        for v in (51_865, 51_864, 51_866):
            rows = tmesh.padded_vocab_rows(v, tp)
            assert rows == jmesh.padded_vocab_rows(v, tp)
            assert rows >= v and rows % (tp * 128) == 0
    assert tmesh.padded_vocab_rows(51_865, 4) == 52_224


def test_pad_vocab_rule():
    x = torch.ones(10, 3)
    assert tmesh.pad_vocab(x, 2) is x                      # 10 % 2 == 0
    y = tmesh.pad_vocab(x, 4)
    assert y.shape == (512, 3) and not y[10:].any()


def test_vocab_padding_preserves_logits(world):
    """tp = 4 pads 51,865 rows to 52,224; the prefill logits keep the
    vocabulary's shape and JAX's unsharded values."""
    cfg, params, _, mel, prompt, out = world
    assert out[0]["vocab_rows"] == 52_224 // 4

    def fwd(p, m, pr):
        enc = encoder_forward(p, cfg, m)
        cross = precompute_cross_kv(p, cfg, enc)
        logits, _ = decoder_forward(p, cfg, pr, jnp.int32(0),
                                    init_kv_cache(cfg, m.shape[0]), cross)
        return logits
    want = np.asarray(jax.jit(fwd)(params, mel, prompt.astype(np.int32)))
    for r in out:
        assert r["logits_tp4"].shape == want.shape
        np.testing.assert_allclose(r["logits_tp4"], want, atol=LOGITS_ATOL,
                                   rtol=LOGITS_RTOL)


def test_activation_shardings():
    class Fake:
        mesh_dim_names = ("dp", "sp", "tp")
    got = tmesh.activation_shardings(Fake())
    assert got["mel"] == ("dp", None, "sp")
    assert got["enc_out"] == ("dp", "sp", None)
    assert got["tokens"] == ("dp", None)
    assert got["audio"] == ("dp", "sp")
    assert got["replicated"] == ()


def test_shard_params_refuses_fused_and_int8_trees(world):
    """A to_device tree (fused q/k/v) and a weight_quant tree raise under
    tp > 1, before any collective."""
    _, _, params_np, *_ = world

    class Mesh:
        mesh_dim_names = ("dp", "sp", "tp")

        def size(self, i):
            return (1, 1, 2)[i]

    fused = weights.to_device(weights.from_jax_params(params_np), "cpu")
    with pytest.raises(ValueError, match="fused"):
        tmesh.shard_params(fused, Mesh())
    q = weights.from_jax_params(params_np)
    q["decoder"]["tok_emb_s"] = torch.ones(q["decoder"]["tok_emb"].shape[0])
    with pytest.raises(NotImplementedError):
        tmesh.shard_params(q, Mesh())
