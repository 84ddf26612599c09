"""tail_q8_roofline.engine: the int8 encoder tail's least time (its int8
products at 1,979 TOP/s, its attention at 989 TFLOP/s, or its bytes at
3.35 TB/s), each call's at the windows that call encoded (read from its
`tile_kernel` launch grid), summed over the calls in the traced stretch,
over the device time of every kernel those calls launched."""

from portbench import stats


def read(obs: dict):
    return stats.tail_roofline_pct(obs, "open_loop")
