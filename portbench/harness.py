"""The benchmark's driver, led by data: `BENCHMARK.json` names the cells,
configurations and metrics, and each has files of its own that this
module finds by name. It holds no table of them.

  portbench/cells/<workload>.json    the cell: configuration, traffic,
                                     entry settings, precision policy,
                                     sample size and correctness limits
  portbench/configs/<config>.json    the model's published sizes (the
                                     `file` of the configuration entry)
  portbench/models/<model_type>.py   a model type (the configuration
                                     file's "model_type"): make(cfg,
                                     seed, device, dtype) -> the seeded
                                     weights; served_logits(w, cfg,
                                     audio, prompts, served, policy,
                                     device) -> the reference's logits;
                                     preset_pairs(ctx) -> (key, file
                                     value, program value) for the
                                     discovery test
  portbench/traffic/<traffic>.json   the traffic mix: its `kind` and
                                     parameters
  portbench/kinds/<kind>.py          the generator and driver of a kind
                                     of traffic: setup(ctx), window(ctx,
                                     prog), sample(ctx, prog, obs),
                                     teardown(prog)
  portbench/metrics/<metric>.py      one metric's reader: read(obs) ->
                                     number, or None when it finds
                                     nothing to read

One run: the kind builds the program from the seed and warms up the
cell's shapes (set-up), measures `seconds` (traced by `torch.profiler`
when `trace`), frees the program after reading the memory peak, and the
reference (the model type's `served_logits`, computed in
`portbench/reference/`) judges a sample of what the timed path produced
on weights that the model type's `make` draws again.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from typing import Any, Optional

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "whisper_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """A module from a file whose name may hold dots (a metric's name)."""
    spec = importlib.util.spec_from_file_location(
        "portbench._loaded." + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Ctx:
    """What a kind's functions get: the cell's files and the run's
    arguments."""
    name: str
    workload: dict
    cell: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: str
    spec: dict
    root: Path = ROOT
    notes: list = dataclasses.field(default_factory=list)

    def note(self, text: str) -> None:
        """A line for standard error, printed before the checks."""
        self.notes.append(text)


def spec_of(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def context(workload: str, seed: int, seconds: float, trace: bool,
            device: str = "cuda", root: Path = ROOT,
            overrides: Optional[dict] = None) -> Ctx:
    """The cell's files, found by the workload's name. `overrides` (the
    tests, the control) maps "cell", "config" or "traffic" to keys that
    update that file's."""
    spec = spec_of(root)
    w = next((x for x in spec["workloads"] if x["name"] == workload), None)
    if w is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in spec["configs"] if c["name"] == w["config"])
    pb = root / "portbench"
    files = {"cell": pb / "cells" / f"{workload}.json",
             "config": root / conf["file"],
             "traffic": pb / "traffic" / f"{w['traffic']}.json"}
    got = {k: {**load_json(path), **(overrides or {}).get(k, {})}
           for k, path in files.items()}
    return Ctx(name=workload, workload=w, seed=int(seed),
               seconds=float(seconds), trace=bool(trace), device=device,
               spec=spec, root=root, **got)


def kind_of(ctx: Ctx):
    return load_module(ctx.root / "portbench" / "kinds"
                       / f"{ctx.traffic['kind']}.py")


def model_of(ctx: Ctx):
    """The module of the configuration's model type,
    `portbench/models/<model_type>.py`; an error that names what is
    missing where the configuration has no "model_type" or the type no
    file."""
    name = ctx.workload["config"]
    mtype = ctx.config.get("model_type")
    if mtype is None:
        raise KeyError(f"configuration {name!r} has no \"model_type\"")
    path = ctx.root / "portbench" / "models" / f"{mtype}.py"
    if not path.exists():
        raise FileNotFoundError(f"model_type {mtype!r} of configuration "
                                f"{name!r} has no file {path}")
    return load_module(path)


def metrics_for(ctx: Ctx) -> list[dict]:
    """The cell's metrics: end-to-end without trace, per-layer with it,
    each listing this cell (or no cells)."""
    group = ctx.spec["per_layer" if ctx.trace else "end_to_end"]
    return [m for m in group
            if ctx.name in m.get("workloads", [ctx.name])]


def read_metrics(ctx: Ctx, obs: dict) -> dict:
    out = {}
    for m in metrics_for(ctx):
        path = ctx.root / "portbench" / "metrics" / f"{m['name']}.py"
        value = load_module(path).read(obs)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def free_device() -> None:
    import torch
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def judge(ctx: Ctx, obs: dict, sample: dict) -> dict:
    """The numbers compared, each {value, limit}: those of the reference's
    numbers (check.served_numbers) that the cell's "limits" name, and the
    kind's own counts (obs["counts"], each held to 0)."""
    import torch

    from portbench.reference import check
    cfg = ctx.config
    model = model_of(ctx)
    dtype = getattr(torch, ctx.cell["dtype"])
    w = model.make(cfg, ctx.seed, ctx.device, dtype)
    refs = model.served_logits(w, cfg, sample["audio"], sample["prompts"],
                               sample["served"], ctx.cell.get("policy", {}),
                               ctx.device)
    ok = check.allowed_mask(cfg["vocab_size"], sample["banned_ids"],
                            sample["banned_from"], ctx.device)
    nums = check.served_numbers(refs, sample["served"], ok)
    ctx.note("reference: " + ", ".join(f"{k} {v!r}"
                                       for k, v in nums.items()))
    checks = {name: {"value": finite(nums[name]), "limit": limit}
              for name, limit in ctx.cell["limits"].items()}
    for name, value in obs.get("counts", {}).items():
        checks[name] = {"value": value, "limit": 0}
    obs["reference"] = nums
    del w, refs
    free_device()
    return checks


def run(ctx: Ctx, t_start: float) -> dict:
    """One run of the cell: the result line's dict (last key `checks`)."""
    import torch
    kind = kind_of(ctx)
    prog = kind.setup(ctx)
    if ctx.device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t_window = time.perf_counter()
    obs = kind.window(ctx, prog)
    obs["setup_s"] = t_window - t_start
    peak = (torch.cuda.max_memory_allocated() if ctx.device == "cuda"
            else 0)
    sample = kind.sample(ctx, prog, obs)
    kind.teardown(prog)
    del prog
    free_device()
    checks = judge(ctx, obs, sample)
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    device = {"platform": "gpu" if ctx.device == "cuda" else "cpu",
              "kind": (torch.cuda.get_device_name(0)
                       if ctx.device == "cuda" else "cpu"),
              "count": int(ctx.workload["chips"]),
              "memory_peak_bytes": int(peak)}
    tr = obs.get("trace")
    if ctx.trace and tr is not None:
        device["busy_s"] = tr["busy_s"]
        device["window_s"] = tr["window_s"]
    line: dict[str, Any] = {
        "correct": bool(correct), "attempted": int(obs["attempted"]),
        "failed": int(obs["failed"]), "metrics": read_metrics(ctx, obs),
        "device": device}
    if ctx.trace and tr is not None:
        line["breakdown"] = {"device_ops": tr["device_ops"],
                             "idle_gaps": tr["idle_gaps"]}
    line["checks"] = checks
    return line


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (`whisper_tpu_torch` is not `whisper_tpu`)."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def finite(x: float) -> float:
    """x, or 1e300 for what is not a finite number (a banned token served,
    nothing served): JSON has no infinity, and it fails every limit."""
    return float(x) if math.isfinite(x) else 1e300


def fmt(x: float) -> str:
    return repr(float(x)) if math.isfinite(x) else str(x)
