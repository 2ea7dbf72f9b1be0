# coding=utf-8
"""The data axis of the parallel strategies: one process per GPU, DDP or
FSDP over a `"data"` device mesh, and the explicit collectives of the
global-batch contrastive loss (port of the JAX package's `parallel/`)."""
from .collectives import all_gather, all_gather_local_grads, psum
from .mesh import (DATA_AXIS, MODEL_AXIS, PIPE_AXIS, create_mesh,
                   data_shard_geometry, fetch_replicated, init_distributed,
                   load_replicated, process_barrier, shard_batch,
                   shard_params, world_size)
