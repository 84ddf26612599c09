"""The port's operators: the attention size dispatch with its plain
attention, and the three hand-written CUDA kernels of the main paths
(encoder_block_tail, flash_attention, cache_append_rows), each with its
plain PyTorch twin."""
