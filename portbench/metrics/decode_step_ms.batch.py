"""decode_step_ms.batch: the median over the window's batches (but the
profiled one) of the span around decode.decode_from_encoder (cross K/V,
prefill, the T==1 steps, the tokens to the host), divided by the tokens
it generates a row."""

from portbench import stats


def read(obs: dict):
    if obs.get("kind") != "closed_loop":
        return None
    v = [b["decode_s"] / obs["generated"] for b in obs["batches"]
         if b["decode_s"] and b["trace"] is None]
    return 1e3 * stats.median(v) if v else None
