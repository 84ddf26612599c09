"""fill_ms.engine: the median host wall of the engine's untraced step()
calls that admitted requests (the fill's log-mel, encoder, cross K/V and
joined prefill, then one token step; step() ends in a device read)."""

from portbench import stats


def read(obs: dict):
    if obs.get("kind") != "open_loop":
        return None
    walls = stats.step_walls(obs, fills=True)
    return 1e3 * stats.median(walls) if walls else None
