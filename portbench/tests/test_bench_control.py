"""Each cell's control at tiny's width on the CPU: the nearest precision
below the configuration's, in the program's place, comes out as not
correct against the cell's own limits, where the program does not. On
the chip the same readings come from `python3 -m portbench.control`
at the cells' own sizes (PERF.md gives them)."""

from __future__ import annotations

import pytest

from portbench import control, harness
from portbench.tests.conftest import tiny_overrides


@pytest.mark.parametrize("workload", ["turbo.engine32", "medium.batch64"])
def test_the_control_fails_the_cells_limits(workload, monkeypatch):
    orig = harness.context

    def tiny(name, seed, seconds, trace, device="cpu", root=harness.ROOT,
             overrides=None):
        ov = tiny_overrides(name)
        for k, v in (overrides or {}).items():
            ov[k] = {**ov.get(k, {}), **v}
        return orig(name, seed, seconds, trace, device="cpu", root=root,
                    overrides=ov)
    monkeypatch.setattr(harness, "context", tiny)
    got = control.readings(workload, 2 ** 31 + 3, 2.0 if "engine" in
                           workload else 0.1, "cpu")
    limits = harness.context(workload, 1, 1.0, False).cell["limits"]
    for name, limit in limits.items():
        assert got["program"][name] <= limit, got
    assert any(got["control"][name] > limit
               for name, limit in limits.items()), got


@pytest.mark.cuda
def test_on_the_card_a_cell_runs_at_tiny_width(cuda_device):
    """The harness end to end on the card at tiny's width (the kernels'
    build included): correct, every end-to-end metric read."""
    ctx = harness.context("medium.batch64", 2 ** 31 + 9, 0.1, False,
                          device=cuda_device,
                          overrides=tiny_overrides("medium.batch64"))
    line = harness.run(ctx, 0.0)
    assert line["correct"], line["checks"]
    assert set(line["metrics"]) == {"rtfx", "setup_s"}
