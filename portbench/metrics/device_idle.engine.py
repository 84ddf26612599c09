"""device_idle.engine: the share of the traced stretch in which no
operation ran on the device. Tracing slows the host-paced token steps, so
this reads somewhat above an untraced window's share."""

from portbench import stats


def read(obs: dict):
    return stats.idle_pct(obs, "open_loop")
