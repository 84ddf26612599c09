"""The port's operators: plain attention, and the two hand-written CUDA
kernels of the main path (encoder_block_tail, cache_append_rows), each
with its plain PyTorch twin."""
