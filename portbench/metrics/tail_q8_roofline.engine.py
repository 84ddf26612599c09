"""tail_q8_roofline.engine: the int8 encoder tail's least time (its int8
products at 1,979 TOP/s, its attention at 989 TFLOP/s, or its bytes at
3.35 TB/s, over the slot batch's rows) over the device time of every
kernel its calls launched in the traced stretch."""

from portbench import stats


def read(obs: dict):
    return stats.tail_roofline_pct(obs, "open_loop")
