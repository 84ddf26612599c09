"""mfu.engine: the model FLOPs of the useful work in the window before
the traced stretch (the joining rows' encoder, cross K/V and prefill at
their real prompt lengths, and one decode step at its real kv length per
token received) over those seconds x 989 TFLOP/s."""

from portbench import stats


def read(obs: dict):
    if obs.get("kind") != "open_loop" or "trace" not in obs:
        return None
    return stats.mfu_pct(obs["useful_flops"], stats.untraced_s(obs))
