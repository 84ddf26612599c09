"""tail_roofline.batch: the bf16 encoder tail's least time (its
operations at 989 TFLOP/s or its bytes at 3.35 TB/s, over the batch's
rows) over the device time of every kernel its calls launched (the flash
launch inside it included) in the traced batch."""

from portbench import stats


def read(obs: dict):
    return stats.tail_roofline_pct(obs, "closed_loop")
