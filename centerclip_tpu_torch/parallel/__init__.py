# coding=utf-8
"""The data, model and pipe axes of the parallel strategies: one process
per GPU, DDP or FSDP over the `"data"` axis, Megatron tensor and sequence
parallelism over the `"model"` axis, GPipe pipeline parallelism over the
`"pipe"` axis, and the explicit collectives of the global-batch
contrastive loss, of the parallel blocks and of the stage hop (port of the
JAX package's `parallel/`)."""
from .collectives import (all_gather, all_gather_local_grads, copy_to_model,
                          from_last_stage, gather_tokens, gather_whole_tokens,
                          psum, reduce_from_model, reduce_scatter_tokens,
                          split_tokens, stage_hop, to_stages)
from .mesh import (DATA_AXIS, MODEL_AXIS, PIPE_AXIS, Axes, axes_of,
                   create_mesh, data_shard_geometry, fetch_replicated,
                   gather_state, init_distributed, load_replicated,
                   param_shardings, process_barrier, shard_batch,
                   shard_params, shard_tokens, slice_state, stage_model,
                   unshard_tokens, world_size)
from .pipeline import context_pipe_size, pick_microbatches, pipeline_blocks
