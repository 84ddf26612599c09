"""tail_roofline.batch: the bf16 encoder tail's least time (its
operations at 989 TFLOP/s or its bytes at 3.35 TB/s), each call's at the
windows that call encoded (read from its `tile_kernel` launch grid),
summed over the calls of the traced batch, over the device time of every
kernel those calls launched (the flash launch inside each included)."""

from portbench import stats


def read(obs: dict):
    return stats.tail_roofline_pct(obs, "closed_loop")
