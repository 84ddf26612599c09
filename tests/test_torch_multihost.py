"""The port's multi-process glue (whisper_tpu_torch/parallel/multihost.py)
against the JAX package's single-process behaviour, a gloo world of 4 CPU
processes (global_batch from each rank's dp rows), the degenerate mesh of
one process with no launcher (ShardedPipeline in a fresh interpreter,
equal to WhisperPipeline), and the launcher's failure and timeout paths."""

import os
import subprocess
import sys

import numpy as np
import pytest

import torch_mesh_ranks as ranks
from whisper_tpu.parallel import multihost as jmh
from whisper_tpu_torch.ops import collectives
from whisper_tpu_torch.parallel import launch, multihost
from whisper_tpu_torch.parallel import mesh as tmesh

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_initialize_single_process_noop(monkeypatch):
    import torch.distributed as dist
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    multihost.initialize()                # must not raise or hang
    jmh.initialize()
    assert not dist.is_initialized()
    assert multihost.is_coordinator() == jmh.is_coordinator()


@pytest.mark.parametrize("local_rank, rank, cards, want", [
    ("3", 5, 4, 3),          # torchrun's LOCAL_RANK wins
    (None, 5, 4, 1),         # else the rank modulo the host's cards
    (None, 3, 1, 0),         # ranks sharing one card
])
def test_pin_device_maps_rank_to_card(monkeypatch, local_rank, rank, cards,
                                      want):
    import torch
    pinned = []
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(torch.cuda, "set_device", pinned.append)
    if local_rank is None:
        monkeypatch.delenv("LOCAL_RANK", raising=False)
    else:
        monkeypatch.setenv("LOCAL_RANK", local_rank)
    assert multihost.pin_device(rank) == want
    assert pinned == [want]


def test_initialize_pins_the_card_before_nccl(monkeypatch):
    """Under torchrun on a CUDA host, each process takes its LOCAL_RANK's
    card before the NCCL group opens, with the one collective timeout."""
    import torch
    import torch.distributed as dist
    events = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda i: events.append(("set_device", i)))
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: events.append(
                            ("init", backend, kw["timeout"])))
    monkeypatch.setenv("WORLD_SIZE", "16")
    monkeypatch.setenv("RANK", "10")
    monkeypatch.setenv("LOCAL_RANK", "2")
    multihost.initialize()
    assert events == [("set_device", 2),
                      ("init", "nccl", collectives.TIMEOUT)]


def test_make_mesh_pins_the_card_first(monkeypatch):
    """make_mesh on "cuda" pins the process before it opens or checks the
    world (here: no group and a mesh of two, which raises after)."""
    pinned = []
    monkeypatch.setattr(tmesh, "pin_device", pinned.append)
    with pytest.raises(ValueError, match="needs 2 processes"):
        tmesh.make_mesh(dp=2, device_type="cuda")
    assert pinned == [0]


def test_global_batch_single_process():
    rows = np.arange(2 * 5 * 3, dtype=np.float32).reshape(2, 5, 3)
    np.testing.assert_array_equal(multihost.global_batch(rows).numpy(), rows)
    assert multihost.global_batch_size(4) == jmh.global_batch_size(4) == 4


@pytest.fixture(scope="module")
def world():
    rows = np.arange(4 * 5 * 3, dtype=np.float32).reshape(4, 5, 3)
    return rows, launch.run("torch_mesh_ranks:multihost_rank", ranks.WORLD,
                            (rows,), timeout=180)


def test_global_batch_assembles_dp_shards(world):
    """Each rank passes its dp rows; every rank gets the global batch."""
    rows, out = world
    for r in out:
        np.testing.assert_array_equal(r["global"], rows)


def test_host_transport_takes_non_contiguous_tensors(world):
    """The host copies of send/recv, all_gather and all_reduce (how gloo
    carries a CUDA tensor where it takes none) are contiguous, whatever
    the input's strides; an in-place all_reduce sums into the input."""
    _, out = world
    x = [(np.arange(12.0).reshape(3, 4) + 100 * r).T for r in range(4)]
    for r, o in enumerate(out):
        h = o["host"]
        np.testing.assert_array_equal(h["recv"], x[0] if r == 1 else x[r])
        np.testing.assert_array_equal(h["gather"], np.concatenate(x))
        np.testing.assert_array_equal(h["reduce"], sum(x))
        np.testing.assert_array_equal(h["reduce_inplace"], sum(x))
        assert h["inplace_is_x"]


def test_global_batch_size_and_coordinator(world):
    _, out = world
    assert [r["coordinator"] for r in out] == [r["rank"] == 0 for r in out]
    assert {r["size"] for r in out} == {8}   # 2 rows x 4 processes


_DEGENERATE = r"""
import numpy as np, torch, torch.distributed as dist
from whisper_tpu_torch import get_config, weights
from whisper_tpu_torch.parallel.inference import ShardedPipeline
from whisper_tpu_torch.pipeline import WhisperPipeline
cfg = get_config("tiny").replace(name="shard-nano", d_model=64, n_heads=4,
                                 n_audio_layers=2, n_text_layers=2)
params = weights.init_params(cfg, 0)
audio = (np.random.RandomState(1).randn(2, 16000) * 0.1).astype(np.float32)
assert not dist.is_initialized()
got = ShardedPipeline(params, cfg, device="cpu").transcribe_batch(
    audio, max_new=6)
assert dist.is_initialized() and dist.get_world_size() == 1
pipe = WhisperPipeline(cfg, params, device="cpu")
pad = np.zeros((2, cfg.n_samples), np.float32); pad[:, :16000] = audio
res = pipe.transcribe_batch(pad, max_new=6)
want = [res.tokens[b, :res.lengths[b]].tolist() for b in range(2)]
assert [r["tokens"] for r in got] == want, (got, want)
print("OK")
"""


def test_degenerate_mesh_needs_no_launcher():
    """dp = tp = sp = 1 in a process with no group: make_mesh opens a
    world of one itself, and the tokens equal WhisperPipeline's."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "PYTHONSTARTUP")}
    r = subprocess.run([sys.executable, "-c", _DEGENERATE], cwd=_REPO,
                       env=env, capture_output=True, text=True, timeout=180)
    assert r.returncode == 0 and r.stdout.strip().endswith("OK"), \
        r.stderr[-3000:]


def test_launch_reports_a_failing_rank():
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        launch.run("torch_mesh_ranks:fail_on_rank_1", 2, timeout=120)


def test_launch_times_out_and_kills_every_rank():
    with pytest.raises(TimeoutError):
        launch.run("torch_mesh_ranks:hang", 2, timeout=6)


def test_resolve_rejects_a_bare_name():
    with pytest.raises(ValueError):
        launch.resolve("no_colon")
