"""Start a world of processes, one per mesh rank (no JAX counterpart: a
JAX program sees every device of its host in one process, and
multihost.initialize joins hosts; torch.distributed runs one process per
rank).

`run("package.module:function", world, args)` spawns `world` processes
(multiprocessing's spawn method: each starts from a fresh import, so the
function is named by its import path and its arguments are pickled). Each
joins the process group as rank r of `world` through `init_method`
(default: a `file://` rendezvous in a new temporary directory, so that
concurrent worlds on one host never share a port), calls
`function(*args)` and sends back what it returns. `run` returns the
results in rank order.

The world's backend is gloo: CPU tensors, and CUDA tensors through the
collective helpers (ops/collectives.py), also for several ranks sharing
one card, which NCCL refuses. Every collective of the world, and of the
axis groups make_mesh creates, raises after ops/collectives.TIMEOUT
instead of waiting forever. `run` itself waits at most `timeout` seconds
for the whole world; on a timeout, or as soon as any rank fails, it
kills every rank and raises.
"""

from __future__ import annotations

import importlib
import os
import queue as queue_lib
import shutil
import tempfile
import time
import traceback
from typing import Any, Optional, Sequence


def resolve(name: str):
    """The function of an importable "package.module:qualname" name."""
    module, _, qual = name.partition(":")
    if not qual:
        raise ValueError(f"launch: {name!r} is not 'module:function'")
    obj = importlib.import_module(module)
    for part in qual.split("."):
        obj = getattr(obj, part)
    return obj


def _rank_main(rank: int, world: int, fn_name: str, args: tuple,
               init_method: str, threads: Optional[int], results) -> None:
    """One rank: join the group, run the function, report, leave."""
    try:
        import torch
        import torch.distributed as dist

        from whisper_tpu_torch.ops import collectives
        if threads:
            torch.set_num_threads(threads)
        dist.init_process_group(
            "gloo", init_method=init_method, rank=rank, world_size=world,
            timeout=collectives.TIMEOUT)
        try:
            out = resolve(fn_name)(*args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:                   # reported, then the rank exits
        results.put((rank, False, traceback.format_exc()))
        raise


def _failures(fn_name: str, results, rank: int, trace: str) -> str:
    """The first failure's report, and those of ranks failing within the
    next second (a rank's peers often fail after it, on a closed
    connection, and may report first)."""
    lines = [f"launch: rank {rank} of {fn_name} failed:\n{trace}"]
    deadline = time.monotonic() + 1.0
    while time.monotonic() < deadline:
        try:
            r, ok, value = results.get(timeout=0.1)
        except queue_lib.Empty:
            continue
        if not ok:
            lines.append(f"launch: rank {r} of {fn_name} failed:\n{value}")
    return "\n".join(lines)


def run(fn_name: str, world: int, args: Sequence[Any] = (), *,
        timeout: float = 300.0, init_method: Optional[str] = None,
        threads: Optional[int] = 1) -> list:
    """Run `fn_name` (an importable "module:function") on `world` spawned
    ranks of one process group and return each rank's result, by rank.

    init_method: the rendezvous URL (default: a file in a new temporary
    directory, removed afterwards). threads: torch.set_num_threads in
    each rank (None leaves torch's default). Raises RuntimeError with the
    rank's traceback when a rank fails, TimeoutError when the world does
    not finish within `timeout` seconds; either way every rank is killed
    first."""
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    tmp = None
    if init_method is None:
        tmp = tempfile.mkdtemp(prefix="wt_launch_")
        init_method = "file://" + os.path.join(tmp, "rendezvous")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, world, fn_name, tuple(args),
                               init_method, threads, results))
             for r in range(world)]
    try:
        for p in procs:
            p.start()
        out: dict[int, Any] = {}
        deadline = time.monotonic() + timeout
        while len(out) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"launch: {fn_name} on {world} ranks did not finish in "
                    f"{timeout} s (ranks done: {sorted(out)})")
            try:
                rank, ok, value = results.get(timeout=min(left, 1.0))
            except queue_lib.Empty:
                dead = [r for r, p in enumerate(procs)
                        if not p.is_alive() and r not in out
                        and p.exitcode not in (0, None)]
                if dead:
                    # a rank that died without reporting (killed, crashed)
                    try:
                        rank, ok, value = results.get(timeout=1.0)
                    except queue_lib.Empty:
                        raise RuntimeError(
                            f"launch: rank {dead[0]} of {fn_name} exited "
                            f"with code {procs[dead[0]].exitcode}") from None
                else:
                    continue
            if not ok:
                raise RuntimeError(_failures(fn_name, results, rank, value))
            out[rank] = value
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 5.0))
        return [out[r] for r in range(world)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            if p.pid is not None:
                p.join(timeout=10)
        results.close()
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)
