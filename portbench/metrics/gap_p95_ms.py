"""gap_p95_ms: the 95th percentile over every gap between consecutive
tokens of every request due in the window, as the host receives them."""

from portbench import stats


def read(obs: dict):
    if obs.get("kind") != "open_loop":
        return None
    g = stats.gaps(obs)
    return 1e3 * stats.pct(g, 95) if g else None
