"""Multi-process parallelism on torch.distributed (whisper_tpu/parallel):
the (dp, sp, tp, pp) mesh and its sharding rules (mesh.py), dp/tp/sp
sharded transcription (inference.py), GPipe over the stacked layers with
its train step (pipeline_parallel.py), the expert-parallel MoE
demonstration (expert.py), process initialization (multihost.py) and the
launcher of a world of processes (launch.py). The collectives that GSPMD
inserts in the JAX package are written out in ops/collectives.py, below
the model that calls them.
"""

from whisper_tpu_torch.parallel.mesh import (
    activation_shardings,
    make_mesh,
    param_pspecs,
    shard_params,
)
