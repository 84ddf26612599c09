"""encoder_ms.batch: the median over the window's batches (but the
profiled one) of the synchronised span around the audio's copy, log-mel
and decode.encode."""

from portbench import stats


def read(obs: dict):
    if obs.get("kind") != "closed_loop":
        return None
    v = [b["encoder_s"] for b in obs["batches"]
         if b["encoder_s"] and b["trace"] is None]
    return 1e3 * stats.median(v) if v else None
