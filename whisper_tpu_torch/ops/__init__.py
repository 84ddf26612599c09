"""The port's operators: the attention size dispatch with its plain
attention and its int8-cache form, and the hand-written CUDA kernels of
the main paths (encoder_block_tail, flash_attention, cache_append_rows
and cache_append_rows_ragged, decode_attention_q8_bh and
decode_attention_q8, fused_decoder_step), each with its plain PyTorch
twin."""
