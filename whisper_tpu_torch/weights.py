"""Parameters for the port: conversion from the JAX params tree, the
checkpoint loaders (HF state_dict, safetensors, npz, the reference
flat-bin reader and writer), seeded random init, and device placement.

The params are the JAX package's nested dict, unchanged in structure and
layout, with torch tensors at the leaves (whisper_tpu/weights.py and
whisper_tpu/models/whisper.py:309 init_params):
  * transformer layers stacked on a leading L axis;
  * linear weights stored (in, out) so every projection is `x @ w`;
  * k_proj's bias slot present and zero (HF k_proj has no bias);
  * conv weights in torch's (out, in, k) layout.
`to_device` places a tree for the model and replaces each self-attention's
q/k/v linears with one fused (d, 3d) `qkv` linear; `trainable` makes such a
tree the train step's parameters, and `from_device` is the way back (q, k
and v split again, for `save_npz` and the JAX package).
"""

from __future__ import annotations

import io
from typing import Any, Callable, Mapping

import numpy as np
import torch

from whisper_tpu_torch.config import WhisperConfig

Params = Any    # nested dict of torch tensors


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def from_jax_params(tree) -> Params:
    """The JAX params tree (leaves as numpy arrays, e.g. after
    `jax.tree.map(np.asarray, params)`) -> the same tree of CPU tensors:
    int8 leaves (a tree after the JAX quantize_weights_wq) stay int8,
    every other leaf becomes fp32. Leaves are copied, so the result owns
    its memory."""
    def leaf(x):
        dt = np.int8 if np.asarray(x).dtype == np.int8 else np.float32
        return torch.from_numpy(np.array(x, dtype=dt))
    return _tree_map(leaf, tree)


def _np32(x) -> np.ndarray:
    """A torch tensor or an array-like as an fp32 numpy array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().float().numpy()
    return np.asarray(x, dtype=np.float32)


# ---------------------------------------------------------------------------
# HF state_dict and safetensors (whisper_tpu/weights.py:36-112, :261-273)
# ---------------------------------------------------------------------------

def _lin(get, prefix: str, has_bias: bool = True) -> dict:
    w = get(prefix + ".weight")          # (out, in)
    b = (get(prefix + ".bias") if has_bias
         else np.zeros((w.shape[0],), np.float32))
    return {"w": np.ascontiguousarray(w.T), "b": b}


def _ln(get, prefix: str) -> dict:
    return {"g": get(prefix + ".weight"), "b": get(prefix + ".bias")}


def _attn(get, prefix: str) -> dict:
    return {"q": _lin(get, prefix + ".q_proj"),
            "k": _lin(get, prefix + ".k_proj", has_bias=False),
            "v": _lin(get, prefix + ".v_proj"),
            "o": _lin(get, prefix + ".out_proj")}


def from_hf_state_dict(state: Mapping[str, Any], cfg: WhisperConfig
                       ) -> Params:
    """A HF WhisperForConditionalGeneration state_dict (torch tensors or
    numpy arrays, `model.`-prefixed keys) -> the port's params tree of
    fp32 CPU tensors, the tree from_jax_params gives for the JAX
    package's from_hf_state_dict (:61)."""
    def get(name: str) -> np.ndarray:
        return _np32(state[name])

    def enc_layer(i: int) -> dict:
        p = f"model.encoder.layers.{i}"
        return {"attn": _attn(get, p + ".self_attn"),
                "attn_ln": _ln(get, p + ".self_attn_layer_norm"),
                "fc1": _lin(get, p + ".fc1"), "fc2": _lin(get, p + ".fc2"),
                "mlp_ln": _ln(get, p + ".final_layer_norm")}

    def dec_layer(i: int) -> dict:
        p = f"model.decoder.layers.{i}"
        return {"attn": _attn(get, p + ".self_attn"),
                "attn_ln": _ln(get, p + ".self_attn_layer_norm"),
                "cross_attn": _attn(get, p + ".encoder_attn"),
                "cross_ln": _ln(get, p + ".encoder_attn_layer_norm"),
                "fc1": _lin(get, p + ".fc1"), "fc2": _lin(get, p + ".fc2"),
                "mlp_ln": _ln(get, p + ".final_layer_norm")}

    return from_jax_params({
        "encoder": {
            "conv1": {"w": get("model.encoder.conv1.weight"),
                      "b": get("model.encoder.conv1.bias")},
            "conv2": {"w": get("model.encoder.conv2.weight"),
                      "b": get("model.encoder.conv2.bias")},
            "pos_emb": get("model.encoder.embed_positions.weight"),
            "layers": _stack([enc_layer(i)
                              for i in range(cfg.n_audio_layers)]),
            "ln_post": _ln(get, "model.encoder.layer_norm"),
        },
        "decoder": {
            "tok_emb": get("model.decoder.embed_tokens.weight"),
            "pos_emb": get("model.decoder.embed_positions.weight"),
            "layers": _stack([dec_layer(i)
                              for i in range(cfg.n_text_layers)]),
            "ln": _ln(get, "model.decoder.layer_norm"),
        },
    })


def from_safetensors(path: str, cfg: WhisperConfig) -> Params:
    """An HF `model.safetensors` of WhisperForConditionalGeneration, with
    `model.`-prefixed or bare keys (:261), read through safetensors'
    numpy API."""
    try:
        from safetensors.numpy import load_file
    except ImportError:
        raise ImportError("from_safetensors needs the 'safetensors' "
                          "package, which is not installed") from None
    state = dict(load_file(path))
    if not any(k.startswith("model.") for k in state):
        state = {f"model.{k}": v for k, v in state.items()}
    return from_hf_state_dict(state, cfg)


# ---------------------------------------------------------------------------
# named storage: npz keyed by JAX keystr paths (:314-327)
# ---------------------------------------------------------------------------

def param_shapes(cfg: WhisperConfig) -> dict:
    """The params tree for cfg with each leaf's shape in place of the
    leaf: the tree of init_params and of every loader."""
    d, ff, La, Lt = cfg.d_model, cfg.d_ff, cfg.n_audio_layers, \
        cfg.n_text_layers

    def lin(L: int, d_in: int, d_out: int) -> dict:
        return {"w": (L, d_in, d_out), "b": (L, d_out)}

    def ln(*lead: int) -> dict:
        return {"g": (*lead, d), "b": (*lead, d)}

    def layer(L: int, cross: bool) -> dict:
        attn = {n: lin(L, d, d) for n in ("q", "k", "v", "o")}
        p = {"attn": attn, "attn_ln": ln(L), "fc1": lin(L, d, ff),
             "fc2": lin(L, ff, d), "mlp_ln": ln(L)}
        if cross:
            p["cross_attn"] = {n: lin(L, d, d) for n in ("q", "k", "v", "o")}
            p["cross_ln"] = ln(L)
        return p

    return {
        "encoder": {"conv1": {"w": (d, cfg.n_mels, 3), "b": (d,)},
                    "conv2": {"w": (d, d, 3), "b": (d,)},
                    "pos_emb": (cfg.n_audio_ctx, d),
                    "layers": layer(La, False), "ln_post": ln()},
        "decoder": {"tok_emb": (cfg.vocab_size, d),
                    "pos_emb": (cfg.n_text_ctx, d),
                    "layers": layer(Lt, True), "ln": ln()},
    }


def _keystr_leaves(tree, prefix: str = ""):
    """(path, leaf) pairs in jax.tree_util's order (dict keys sorted),
    each path spelled as jax.tree_util.keystr spells a dict path:
    "['decoder']['layers']['attn']['k']['w']"."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _keystr_leaves(tree[k], f"{prefix}[{k!r}]")
    else:
        yield prefix, tree


def save_npz(path: str, params: Params) -> None:
    """Write a params tree (before to_device: separate q/k/v linears) as
    an npz whose keys are the JAX package's (:314), so either package
    loads the other's file. int8 leaves stay int8, the rest fp32."""
    def arr(x):
        if isinstance(x, torch.Tensor):
            x = x.detach().cpu()
            return x.numpy() if x.dtype == torch.int8 else x.float().numpy()
        return np.asarray(x)
    np.savez(path, **{k: arr(v) for k, v in _keystr_leaves(params)})


def load_npz(path: str, cfg: WhisperConfig) -> Params:
    """Read an npz written by either package's save_npz (:318) into a
    params tree of CPU tensors, holding every array to cfg's shape."""
    with np.load(path) as data:
        def leaf(key, shape):
            if key not in data:
                raise ValueError(f"{path}: no array {key} for {cfg.name!r}")
            a = data[key]
            if a.shape != shape:
                raise ValueError(f"{path}: {key} has shape {a.shape}, "
                                 f"{cfg.name!r} needs {shape}")
            return a

        def walk(tree, prefix=""):
            if isinstance(tree, dict):
                return {k: walk(v, f"{prefix}[{k!r}]")
                        for k, v in tree.items()}
            return leaf(prefix, tree)

        return from_jax_params(walk(param_shapes(cfg)))


# ---------------------------------------------------------------------------
# reference flat-binary reader (whisper_tpu/weights.py:156, numpy only)
# ---------------------------------------------------------------------------

def _stack(trees: list) -> Any:
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees)


def _map_leaves(fn: Callable, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    return fn(tree)


def from_flat_bin(data, cfg: WhisperConfig) -> Params:
    """Parse the reference's headerless little-endian fp32 weight stream
    (the order IS the contract; whisper_tpu/weights.py:156 from_flat_bin)
    into a params tree of fp32 CPU tensors. `data`: bytes or an fp32
    ndarray (e.g. a memmap)."""
    buf = (np.frombuffer(data, dtype="<f4") if isinstance(data, bytes)
           else np.asarray(data).view("<f4").reshape(-1))
    pos = 0

    def take(*shape: int) -> np.ndarray:
        nonlocal pos
        n = int(np.prod(shape))
        if pos + n > buf.size:
            raise ValueError(f"flat bin exhausted: need {n} floats at offset "
                             f"{pos}, have {buf.size - pos}")
        out = np.array(buf[pos:pos + n]).reshape(shape)
        pos += n
        return out

    d, ff, nm = cfg.d_model, cfg.d_ff, cfg.n_mels

    def lin(rows: int, cols: int, bias: bool = True) -> dict:
        w = take(rows, cols)                 # (out, in)
        b = take(rows) if bias else np.zeros((rows,), np.float32)
        return {"w": np.ascontiguousarray(w.T), "b": b}

    def ln() -> dict:
        return {"g": take(d), "b": take(d)}

    def attn() -> dict:
        # write order q_w,q_b,k_w,v_w,v_b,out_w,out_b
        return {"q": lin(d, d), "k": lin(d, d, bias=False), "v": lin(d, d),
                "o": lin(d, d)}

    def enc_layer() -> dict:
        a, a_ln = attn(), ln()
        fc1, fc2 = lin(ff, d), lin(d, ff)
        return {"attn": a, "attn_ln": a_ln, "fc1": fc1, "fc2": fc2,
                "mlp_ln": ln()}

    def dec_layer() -> dict:
        a, a_ln = attn(), ln()
        x, x_ln = attn(), ln()
        fc1, fc2 = lin(ff, d), lin(d, ff)
        return {"attn": a, "attn_ln": a_ln, "cross_attn": x,
                "cross_ln": x_ln, "fc1": fc1, "fc2": fc2, "mlp_ln": ln()}

    conv1 = {"w": take(d, nm, 3), "b": take(d)}
    conv2 = {"w": take(d, d, 3), "b": take(d)}
    enc_pos = take(cfg.n_audio_ctx, d)
    enc_layers = _stack([enc_layer() for _ in range(cfg.n_audio_layers)])
    enc_ln = ln()
    tok_emb = take(cfg.vocab_size, d)
    dec_pos = take(cfg.n_text_ctx, d)
    dec_layers = _stack([dec_layer() for _ in range(cfg.n_text_layers)])
    dec_ln = ln()
    if pos != buf.size:
        raise ValueError(f"flat bin has {buf.size - pos} unread floats")
    return from_jax_params({
        "encoder": {"conv1": conv1, "conv2": conv2, "pos_emb": enc_pos,
                    "layers": enc_layers, "ln_post": enc_ln},
        "decoder": {"tok_emb": tok_emb, "pos_emb": dec_pos,
                    "layers": dec_layers, "ln": dec_ln},
    })


def to_flat_bin(params: Params, cfg: WhisperConfig) -> bytes:
    """Inverse of from_flat_bin (:218): the reference's byte stream, from
    a params tree before to_device (torch or numpy leaves)."""
    out = io.BytesIO()

    def w32(a):
        out.write(np.ascontiguousarray(_np32(a), dtype="<f4").tobytes())

    def lin(p: dict, bias: bool = True):
        w32(_np32(p["w"]).T)             # back to (out, in)
        if bias:
            w32(p["b"])

    def ln(p: dict):
        w32(p["g"])
        w32(p["b"])

    def attn(p: dict):
        lin(p["q"])
        lin(p["k"], bias=False)
        lin(p["v"])
        lin(p["o"])

    enc, dec = params["encoder"], params["decoder"]
    for name in ("conv1", "conv2"):
        w32(enc[name]["w"])
        w32(enc[name]["b"])
    w32(enc["pos_emb"])
    for i in range(cfg.n_audio_layers):
        lp = _tree_map(lambda x: x[i], enc["layers"])
        attn(lp["attn"]); ln(lp["attn_ln"])
        lin(lp["fc1"]); lin(lp["fc2"]); ln(lp["mlp_ln"])
    ln(enc["ln_post"])
    w32(dec["tok_emb"])
    w32(dec["pos_emb"])
    for i in range(cfg.n_text_layers):
        lp = _tree_map(lambda x: x[i], dec["layers"])
        attn(lp["attn"]); ln(lp["attn_ln"])
        attn(lp["cross_attn"]); ln(lp["cross_ln"])
        lin(lp["fc1"]); lin(lp["fc2"]); ln(lp["mlp_ln"])
    ln(dec["ln"])
    return out.getvalue()


def from_flat_bin_path(path: str, cfg: WhisperConfig) -> Params:
    """Read a flat-bin file through a read-only map of it
    (native.MappedWeights: wn_mmap_open, else np.memmap; :141). The params
    are copies: none aliases the map, which is closed on return."""
    from whisper_tpu_torch.native import MappedWeights
    with MappedWeights(path) as m:
        try:
            return from_flat_bin(m.floats, cfg)
        except ValueError as e:
            raise ValueError(
                f"{path} does not match the {cfg.name!r} layout ({e}). The "
                f"flat-bin format is positional — pass the model the file "
                f"was exported for.") from None


# ---------------------------------------------------------------------------
# seeded random init (shapes and scales of whisper_tpu init_params)
# ---------------------------------------------------------------------------

def init_params(cfg: WhisperConfig, seed: int) -> Params:
    """Random params with the exact shapes of a converted checkpoint and
    the JAX init's scales (normal * 0.02 weights, zero biases, LayerNorm
    ones/zeros, sinusoidal encoder positions), drawn from a numpy
    RandomState(seed). The draws differ from jax.random's: use
    from_jax_params to run the port on the JAX package's weights."""
    from whisper_tpu_torch.models.whisper import sinusoidal_positions

    rng = np.random.RandomState(seed)

    def draw(tree, key: str = ""):
        """Draw a shape tree's leaves in its key order, a stacked "layers"
        tree one layer at a time: "g" ones, "b" zeros, else normal * 0.02."""
        if key == "layers":
            one = _map_leaves(lambda s: s[1:], tree)
            n = next(_keystr_leaves(tree))[1][0]
            return _stack([draw(one) for _ in range(n)])
        if isinstance(tree, dict):
            return {k: draw(v, k) for k, v in tree.items()}
        if key in ("g", "b"):
            return np.full(tree, 1.0 if key == "g" else 0.0, np.float32)
        return (rng.standard_normal(tree) * 0.02).astype(np.float32)

    shapes = param_shapes(cfg)
    enc = shapes["encoder"]
    tree = {
        "encoder": {k: (sinusoidal_positions(*v).numpy() if k == "pos_emb"
                        else draw(v, k)) for k, v in enc.items()},
        "decoder": draw(shapes["decoder"]),
    }
    return from_jax_params(tree)


def to_device(params: Params, device, dtype: torch.dtype | None = None
              ) -> Params:
    """Move every leaf to `device`; with `dtype`, cast the fp32 leaves of
    rank >= 2 to it — the JAX package's rule (whisper_tpu/weights.py:337
    to_device), so the stacked per-layer biases and LayerNorm params take
    the compute dtype while the top-level 1-D ones stay fp32. The leaves
    of an int8 tree keep their types: int8 values, and the fp32 scales
    (`w_s`, `tok_emb_s`), which the JAX pipeline makes after its cast.

    Each self-attention's q, k and v linears become one `qkv` linear,
    weight (L, d, 3d) and bias (L, 3d) (and an int8 linear's scales
    (L, 3d)), fused once here: the JAX model concatenates them inside its
    jitted step (models/whisper.py:89 qkv_fused), the port's eager step
    would do it at every call. A tree placed before keeps its fused
    linear."""
    device = torch.device(device)

    def put(tree, name=""):
        if isinstance(tree, dict):
            return {k: put(v, k) for k, v in tree.items()}
        if (dtype is not None and tree.dtype == torch.float32
                and tree.ndim >= 2 and not name.endswith("_s")):
            tree = tree.to(dtype)
        return tree.to(device)

    def fuse(attn: dict) -> dict:
        if "qkv" in attn:
            return attn
        qkv = {n: torch.cat([attn[p][n] for p in "qkv"], dim=-1)
               for n in attn["q"]}
        return {"qkv": qkv, "o": attn["o"]}

    params = {part: dict(sub) for part, sub in params.items()}
    for part in ("encoder", "decoder"):
        layers = dict(params[part]["layers"])
        layers["attn"] = fuse(layers["attn"])
        params[part]["layers"] = layers
    return put(params)


def trainable(params: Params, device="cuda") -> Params:
    """The train step's parameters (whisper_tpu_torch/train.py): the
    `to_device` tree (the fused `qkv` linears) on `device` in fp32, every
    leaf a copy of its own that requires grad. Fusing q, k and v changes
    nothing in training: AdamW, the clip and the global norm act on each
    value or on sums over all of them. An int8 tree raises."""
    def leaf(t):
        if not t.is_floating_point():
            raise ValueError(f"trainable: an int8 tree has no gradient "
                             f"({t.dtype} leaf)")
        return t.detach().to(torch.float32, copy=True).requires_grad_()
    return _tree_map(leaf, to_device(params, device))


def from_device(params: Params) -> Params:
    """The way back from `to_device` and `trainable`: every leaf detached,
    on the CPU and in fp32 (int8 leaves stay int8), and each fused `qkv`
    linear split into JAX's q, k and v linears, so that `save_npz` writes
    the JAX package's keys."""
    def split(attn: dict) -> dict:
        if "qkv" not in attn:
            return attn
        parts = {n: t.chunk(3, dim=-1) for n, t in attn["qkv"].items()}
        return {**{p: {n: parts[n][j] for n in parts}
                   for j, p in enumerate("qkv")}, "o": attn["o"]}

    def leaf(t):
        t = t.detach().to("cpu", copy=True)
        return t.contiguous() if t.dtype == torch.int8 else \
            t.float().contiguous()

    params = {part: dict(sub) for part, sub in params.items()}
    for part in ("encoder", "decoder"):
        layers = dict(params[part]["layers"])
        layers["attn"] = split(layers["attn"])
        params[part]["layers"] = layers
    return _tree_map(leaf, params)


# ---------------------------------------------------------------------------
# sharded checkpoints (whisper_tpu/weights.py:276-311 save_orbax/load_orbax)
# on torch.distributed.checkpoint
# ---------------------------------------------------------------------------

def _cpu_mesh(mesh):
    """The mesh's axis groups as a CPU mesh: the checkpoint's DTensors
    hold host copies of the shards."""
    from torch.distributed.device_mesh import DeviceMesh
    names = mesh.mesh_dim_names
    return DeviceMesh.from_group([mesh.get_group(n) for n in names], "cpu",
                                 mesh=mesh.mesh, mesh_dim_names=names)


def _placements(spec: tuple, names: tuple) -> list:
    """A spec's DTensor placements over the mesh's axes."""
    from torch.distributed.tensor import Replicate, Shard
    return [next((Shard(d) for d, a in enumerate(spec) if a == n),
                 Replicate()) for n in names]


_VOCAB_KEY = "['decoder']['tok_emb']"


def _dcp_layout(cfg: WhisperConfig, mesh):
    """(global shape by key, spec by key, tp) of cfg's tree on `mesh`: the
    rules of parallel/mesh.py; the token embedding's spec is left out
    (save_dcp writes it whole)."""
    from whisper_tpu_torch.parallel.mesh import (
        axis_size,
        param_pspecs,
        sanitize_pspec,
    )
    names = mesh.mesh_dim_names
    pipeline = "pp" in names and axis_size(mesh, "pp") > 1
    shapes = dict(_keystr_leaves(param_shapes(cfg)))
    tmpl = _map_leaves(lambda s: torch.empty(s, device="meta"),
                       param_shapes(cfg))
    specs = dict(_keystr_leaves(param_pspecs(tmpl, pipeline=pipeline)))
    specs = {k: sanitize_pspec(shapes[k], specs[k], mesh) for k in shapes}
    specs[_VOCAB_KEY] = (None, None)
    return shapes, specs, axis_size(mesh, "tp") if "tp" in names else 1


def save_dcp(path: str, params: Params, cfg: WhisperConfig,
             mesh=None) -> None:
    """Checkpoint a params tree with torch.distributed.checkpoint, each
    rank writing its own shards (save_orbax, :276): the counterpart of
    orbax's per-shard save, which the port cannot use (orbax imports
    JAX). With a mesh, call it on every rank with the rank's local tree
    (mesh.shard_params', before or after to_device, the layers over pp
    when the mesh has pp > 1): every sharded leaf becomes a DTensor of its shard, so
    that each shard is written once (a plain tensor would count as
    replicated, and only rank 0's would be kept). The token embedding is
    gathered over tp and saved without its pad rows, so that the
    checkpoint restores at any tp and unsharded. Without a mesh, the whole
    tree is written from this process. Values are written in fp32 (int8
    trees are refused)."""
    import torch.distributed.checkpoint as dcp
    from torch.distributed.tensor import DTensor
    tree = from_device(params)
    local = dict(_keystr_leaves(tree))
    if any(t.dtype != torch.float32 for t in local.values()):
        raise ValueError("save_dcp: int8 trees are not checkpointed")
    if mesh is None:
        dcp.save(local, checkpoint_id=path, no_dist=True)
        return
    from whisper_tpu_torch.ops import collectives
    from whisper_tpu_torch.parallel.mesh import axis_group
    shapes, specs, _ = _dcp_layout(cfg, mesh)
    cpu_mesh, names = _cpu_mesh(mesh), mesh.mesh_dim_names
    state = {}
    for key, t in local.items():
        if key == _VOCAB_KEY:
            full = collectives.all_gather(t, axis_group(mesh, "tp"), 0)
            state[key] = full[:cfg.vocab_size].contiguous()
        else:
            state[key] = DTensor.from_local(
                t, cpu_mesh, _placements(specs[key], names))
    dcp.save(state, checkpoint_id=path)


def load_dcp(path: str, cfg: WhisperConfig, mesh=None) -> Params:
    """Restore a save_dcp checkpoint (load_orbax, :293), whatever mesh
    wrote it. Without a mesh: the whole tree, read in this process. With a
    mesh, on every rank: the rank's local tree as mesh.shard_params gives
    it (q, k and v apart, the vocab padded under tp), each shard read from
    the shards that hold its rows."""
    import torch.distributed.checkpoint as dcp
    from torch.distributed.tensor import DTensor
    if mesh is None:
        state = {k: torch.zeros(s) for k, s in
                 _keystr_leaves(param_shapes(cfg))}
        dcp.load(state, checkpoint_id=path, no_dist=True)
        return _unflatten(state)
    from whisper_tpu_torch.parallel.mesh import (
        axis_size,
        pad_vocab,
        shard_tensor,
    )
    shapes, specs, tp = _dcp_layout(cfg, mesh)
    cpu_mesh, names = _cpu_mesh(mesh), mesh.mesh_dim_names
    state = {}
    for key, shape in shapes.items():
        if key == _VOCAB_KEY:
            state[key] = torch.zeros(shape)
            continue
        local = list(shape)
        for d, a in enumerate(specs[key]):
            if a is not None:
                local[d] //= axis_size(mesh, a)
        state[key] = DTensor.from_local(
            torch.zeros(local), cpu_mesh, _placements(specs[key], names))
    dcp.load(state, checkpoint_id=path)
    out = {k: t.to_local().contiguous() for k, t in state.items()
           if k != _VOCAB_KEY}
    out[_VOCAB_KEY] = shard_tensor(pad_vocab(state[_VOCAB_KEY], tp),
                                   ("tp", None) if tp > 1 else (None, None),
                                   mesh)
    return _unflatten(out)


def _unflatten(flat: dict) -> Params:
    """A {keystr path: leaf} dict as the nested tree."""
    tree: dict = {}
    for key, leaf in flat.items():
        parts = key[2:-2].split("']['")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf
    return tree
