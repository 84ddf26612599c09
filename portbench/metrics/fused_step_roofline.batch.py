"""fused_step_roofline.batch: the fused decoder step's least time (every
layer's weights and fp32 vectors, the cross K/V and the live self rows
read once at 3.35 TB/s, or its bf16 operations at 989 TFLOP/s, the
larger), each launch at the batch's rows and its own self length, summed
over every `fused_step_kernel` launch of the traced batch, over those
launches' device time."""

from portbench import stats


def read(obs: dict):
    return stats.fused_roofline_pct(obs, "closed_loop")
