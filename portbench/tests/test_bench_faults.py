"""Each cell's run, at tiny's width on the CPU, with the timed path broken
underneath: `correct` comes out false for each fault the cell can have
(a step that returns its state unchanged, half of the batch left out, a
token altered where it is produced), and true unbroken. The harness's
look for a card is skipped: the run is `harness.run` itself."""

from __future__ import annotations

import pytest
import torch

from portbench import harness
from portbench.tests.conftest import tiny_overrides


def run_cell(workload: str, seconds: float, **cell) -> dict:
    ctx = harness.context(workload, 2 ** 31 + 77, seconds, False,
                          device="cpu",
                          overrides=tiny_overrides(workload, **cell))
    return harness.run(ctx, 0.0)


def altered_engine_step(monkeypatch):
    """Every token the engine writes is replaced as it is produced."""
    from whisper_tpu_torch import serving_continuous as sc
    orig = sc._engine_step_impl

    def step(params, cfg, state, opts=None):
        old = state["pos"].clone()
        state = orig(params, cfg, state, opts)
        rows = torch.nonzero(state["pos"] > old)[:, 0]
        at = old[rows]
        gen = at >= state["forced_len"][rows]
        rows, at = rows[gen], at[gen]
        state["tokens"][rows, at] = (state["tokens"][rows, at] + 7919) % 50000
        return state
    monkeypatch.setattr(sc, "_engine_step_impl", step)


def unchanged_engine_step(monkeypatch):
    from whisper_tpu_torch import serving_continuous as sc
    monkeypatch.setattr(sc, "_engine_step_impl",
                        lambda params, cfg, state, opts=None: state)


def altered_pick(monkeypatch):
    from whisper_tpu_torch import decode
    orig = decode._pick

    def pick(*a, **k):
        nxt, lp = orig(*a, **k)
        return (nxt + 7919) % 50000, lp
    monkeypatch.setattr(decode, "_pick", pick)


def unchanged_decode_step(monkeypatch):
    """The T==1 step returns the state it was given: the cache it got,
    and the logits of the first step, at every step."""
    from whisper_tpu_torch import decode
    orig, first = decode.decoder_step_ip, []

    def step(params, cfg, tokens1, pos, cache, cross):
        if not first:
            first.append(orig(params, cfg, tokens1, pos, cache, cross)[0])
        return first[0], cache
    monkeypatch.setattr(decode, "decoder_step_ip", step)


def half_the_batch(monkeypatch):
    """The encoder runs the first half of the rows; the rest get copies."""
    from whisper_tpu_torch import decode
    orig = decode.encoder_forward

    def enc(params, cfg, mel):
        half = orig(params, cfg, mel[:(mel.shape[0] + 1) // 2])
        return torch.cat([half, half])[:mel.shape[0]]
    monkeypatch.setattr(decode, "encoder_forward", enc)


ENGINE = {"altered": altered_engine_step, "unchanged": unchanged_engine_step}
BATCH = {"altered": altered_pick, "unchanged": unchanged_decode_step,
         "half": half_the_batch}


@pytest.mark.parametrize("fault", [None, *ENGINE])
def test_engine_cell_under_faults(fault, monkeypatch):
    if fault:
        ENGINE[fault](monkeypatch)
    line = run_cell("turbo.engine32", 3.0, drain_s=6 if fault else 20)
    assert line["correct"] is (fault is None), line["checks"]
    if fault == "unchanged":
        assert line["checks"]["unfinished"]["value"] > 0


@pytest.mark.parametrize("fault", [None, *BATCH])
def test_batch_cell_under_faults(fault, monkeypatch):
    if fault:
        BATCH[fault](monkeypatch)
    line = run_cell("medium.batch64", 0.1)
    assert line["correct"] is (fault is None), line["checks"]
