"""mfu.batch: the model FLOPs of a batch (encoder, cross K/V, prefill
with its logits, the decode steps) over the median wall of the window's
batches that ran outside the profiler x 989 TFLOP/s."""

from portbench import stats


def read(obs: dict):
    if obs.get("kind") != "closed_loop" or "trace" not in obs:
        return None
    walls = [b["end"] - b["start"] for b in obs["batches"]
             if b["trace"] is None]
    return stats.mfu_pct(obs["batch_flops"], stats.median(walls))
