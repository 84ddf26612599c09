"""ttft_p95_ms: the 95th percentile, over every request due in the window,
of the time from its due time to the host receiving its first token; a
failed request counts with its time to the end of the drain."""

from portbench import stats


def read(obs: dict):
    if obs.get("kind") != "open_loop":
        return None
    return 1e3 * stats.pct([r["ttft"] for r in obs["requests"]], 95)
