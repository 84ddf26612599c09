"""gap_p95_ms.engine: the 95th percentile over every gap between
consecutive tokens of a request, both received before the traced
stretch (all of the window in an untraced run), of every request due in
the window. Fills stall about 5% of the gaps at the cell's rate, so the
percentile reads a fill or the tail of the token steps by the order of
arrivals and the host's speed; it stands beside `token_step_ms.engine`
and `fill_ms.engine`, which read the two apart."""

from portbench import stats


def read(obs: dict):
    if obs.get("kind") != "open_loop":
        return None
    g = [b - a for r in obs["requests"]
         for a, b in zip(r["toks"], r["toks"][1:])
         if stats.untraced(obs, b)]
    return 1e3 * stats.pct(g, 95) if g else None
