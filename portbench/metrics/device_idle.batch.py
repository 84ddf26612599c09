"""device_idle.batch: the share of a batch's wall in which no operation
runs on the device: the device-busy seconds of the traced batch over the
median wall of the window's untraced batches. The traced batch's own wall
is not used: tracing slows its host-paced launches by 15-30%, which would
read as idle time."""

from portbench import stats


def read(obs: dict):
    if obs.get("kind") != "closed_loop":
        return None
    walls = [b["end"] - b["start"] for b in obs["batches"]
             if b["trace"] is None]
    return stats.idle_pct(obs, "closed_loop", stats.median(walls))
