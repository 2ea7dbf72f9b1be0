# coding=utf-8
"""The data and model axes of the parallel strategies: one process per GPU,
DDP or FSDP over the `"data"` axis, Megatron tensor and sequence
parallelism over the `"model"` axis, and the explicit collectives of the
global-batch contrastive loss and of the parallel blocks (port of the JAX
package's `parallel/`)."""
from .collectives import (all_gather, all_gather_local_grads, copy_to_model,
                          gather_tokens, gather_whole_tokens, psum,
                          reduce_from_model, reduce_scatter_tokens,
                          split_tokens)
from .mesh import (DATA_AXIS, MODEL_AXIS, PIPE_AXIS, Axes, axes_of,
                   create_mesh, data_shard_geometry, fetch_replicated,
                   gather_state, init_distributed, load_replicated,
                   param_shardings, process_barrier, shard_batch,
                   shard_params, shard_tokens, slice_state, unshard_tokens,
                   world_size)
