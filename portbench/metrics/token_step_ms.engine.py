"""token_step_ms.engine: the median host wall of the engine's untraced
step() calls that admitted nothing (one ragged decode step over every
slot, then the device read)."""

from portbench import stats


def read(obs: dict):
    if obs.get("kind") != "open_loop":
        return None
    walls = stats.step_walls(obs, fills=False)
    return 1e3 * stats.median(walls) if walls else None
