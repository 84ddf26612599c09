"""Shared pieces of the benchmark's own CPU tests (run them with
`python -m pytest portbench/tests -q`; the ones marked `cuda` run on a
card)."""

from __future__ import annotations

import pytest

# tiny's published sizes in the configuration files' keys (the v2 token
# ids, as medium's): the CPU tests run the cells at this width
TINY = {"d_model": 384, "encoder_attention_heads": 6,
        "decoder_attention_heads": 6, "encoder_layers": 4,
        "decoder_layers": 4, "encoder_ffn_dim": 1536, "decoder_ffn_dim": 1536,
        "num_mel_bins": 80, "vocab_size": 51865, "transcribe_token_id": 50359,
        "prev_sot_token_id": 50361, "no_timestamps_token_id": 50363}


def tiny_overrides(workload: str, **cell) -> dict:
    """Overrides that run a cell at tiny's width on the CPU, small."""
    base = {"model": "tiny", "slots": 2, "batch": 4, "drain_s": 20,
            "sample": {"requests": 3, "rows": 4},
            "trace": {"at_s": 0.5, "length_s": 1.0, "batch": 0}}
    if workload == "turbo.engine32":
        base.update(rate=1.0, policy={"dec_bits": 8, "cross_bits": 8},
                    control={"policy": {"dec_bits": 4, "cross_bits": 4}})
    base.update(cell)
    return {"config": TINY, "cell": base,
            "traffic": {"max_new": 20, "clips": 3, "pool_batches": 1}}


@pytest.fixture
def cuda_device():
    """Skips unless a CUDA device is present (decided here, at run time)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"
