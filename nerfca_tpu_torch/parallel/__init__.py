"""Data and depth parallelism over ``torch.distributed`` (port of
``nerfca_tpu/parallel``).

  - **Data parallelism**: every rank draws the same global ray batch, takes
    its slice of the ray axis (``'data'``), and computes its share of the
    global loss and gradients: through the fused-loss kernel K3 with the
    global ray count (``ops/cuda/fused_train.py::
    fused_train_loss_and_grads_sharded``), or on the autograd paths (K1/K2
    or plain, the fine pass, the static step) through the autograd
    collectives of :mod:`nerfca_tpu_torch.parallel.collectives`; one
    all-reduce completes the gradients. Parameters are replicated and every
    rank applies the same update. See :mod:`nerfca_tpu_torch.parallel.mesh`.
  - **Depth parallelism**: the samples of each ray are split over a
    ``'depth'`` axis and the partial Beer-Lambert sums are all-reduced
    (:mod:`nerfca_tpu_torch.parallel.depth_shard`).

Both compose on a 2-D ``('data', 'depth')`` mesh. :mod:`.multihost` brings
up the process group.
"""

from nerfca_tpu_torch.parallel.mesh import (
    RaySharding,
    batch_sharding,
    make_mesh,
    replicate,
    shard_batch,
)
from nerfca_tpu_torch.parallel.depth_shard import depth_sharded_render

__all__ = [
    "RaySharding",
    "make_mesh",
    "batch_sharding",
    "replicate",
    "shard_batch",
    "depth_sharded_render",
]
