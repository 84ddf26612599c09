"""queue_wait_p95_ms.engine: the 95th percentile over every request due
in the window before the traced stretch of the time from its due time to
the start of the step() whose fill admitted it; a request never admitted
counts with its time to the end of the drain."""

from portbench import stats


def read(obs: dict):
    if obs.get("kind") != "open_loop":
        return None
    waits = [(r["admit"] if r["admit"] is not None else obs["t_end"])
             - r["due_abs"] for r in obs["requests"]
             if stats.untraced(obs, r["due_abs"])]
    return 1e3 * stats.pct(waits, 95) if waits else None
