# coding=utf-8
"""The data axis: process group, device mesh, loader shards and the DDP /
FSDP wrappers (port of the JAX package's `parallel/mesh.py`).

The JAX package runs one process per host over a `"data"` mesh of all its
chips.  The port keeps PyTorch's idiom, the reference's own (main.py:54-62,
123-125): one process per GPU, started by `torchrun` (`RANK`, `WORLD_SIZE`,
`LOCAL_RANK`, `MASTER_ADDR`, `MASTER_PORT`), NCCL for CUDA tensors and
gloo for CPU tensors, and a `torch.distributed.device_mesh` whose one axis
has JAX's name, `"data"`.  Each rank runs on `cuda:LOCAL_RANK`.

* Plain data parallelism wraps the model in `DistributedDataParallel`: the
  parameters are replicated and the gradients averaged over the ranks.
* `fsdp` applies `fully_shard` to every transformer block and to the root:
  each parameter is split on its first axis (`Shard(0)`), all-gathered
  where a layer uses it and its gradient reduce-scattered; the optimizer's
  moments follow the parameters (`zeros_like` of a sharded parameter is
  sharded).  JAX shards the largest axis that the data extent divides
  (`mesh.py:224-277`); the placement differs, the function computed does
  not.  Scalars (`logit_scale`) and the cluster modules that a vision block
  carries but the tower calls before the block stay replicated, as JAX
  leaves a parameter without a divisible axis: their gradients are
  averaged by `reduce_replicated_grads`.

Tensor and pipeline parallelism (the `"model"` and `"pipe"` axes) are not
ported yet (ROADMAP.md section 1, items 1.3 and 1.4): `create_mesh`
raises on them.
"""
from __future__ import annotations

import contextlib
import datetime
import logging
import os
from typing import Any, Dict, Iterator, Mapping, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from .. import resolve_device

logger = logging.getLogger(__name__)

DATA_AXIS = "data"
MODEL_AXIS = "model"
PIPE_AXIS = "pipe"

# the process group's timeout, which every collective and barrier of a run
# gets: rank 0's evaluation and checkpoint can take minutes while the other
# ranks wait (the JAX package's barrier timeout, `mesh.py:280-299`)
GROUP_TIMEOUT = datetime.timedelta(hours=1)


def world_size() -> int:
    """The number of processes of the run (1 without a process group)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    """This process's rank (0 without a process group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def init_distributed(device=None, backend: Optional[str] = None
                     ) -> torch.device:
    """Join the process group the `torchrun` environment describes, and
    return this rank's device.

    Without that environment (no `WORLD_SIZE`) the run is one process: no
    group, and the device is `resolve_device(device)`.  Under `torchrun`
    the rank runs on `cuda:LOCAL_RANK` unless `device` names another
    (`"cpu"` for the tests); a rank that finds no GPU raises.  The backend
    is NCCL for a CUDA device and gloo for the CPU unless `backend` names
    one.  An initialised group is kept as it is."""
    if "WORLD_SIZE" not in os.environ:
        return resolve_device(device)
    local = int(os.environ.get("LOCAL_RANK", 0))
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"rank {os.environ.get('RANK')} finds no CUDA device: "
                f"centerclip_tpu_torch runs one process per GPU")
        device = torch.device("cuda", local)
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        backend = backend or ("nccl" if device.type == "cuda" else "gloo")
        dist.init_process_group(
            backend, timeout=GROUP_TIMEOUT,
            device_id=device if backend == "nccl" else None)
    return device


def create_mesh(data_parallel: int = 0, tensor_parallel: int = 1,
                pipeline_parallel: int = 1, sequence_parallel: bool = False,
                device_type: str = "cuda"):
    """The `"data"` device mesh over every rank, or None in a run of one
    process without a process group (the model then runs unwrapped).

    `data_parallel <= 0` means every rank (the analogue of the reference
    counting GPUs); another value must equal the world size, since every
    rank is one data shard (JAX raises on an extent the devices do not
    divide, `mesh.py:84-87`).  The model and pipe axes are not ported."""
    if tensor_parallel > 1 or sequence_parallel:
        raise NotImplementedError(
            "tensor and sequence parallelism are not ported yet "
            "(ROADMAP.md section 1, item 1.3)")
    if pipeline_parallel > 1:
        raise NotImplementedError(
            "pipeline parallelism is not ported yet (ROADMAP.md section 1, "
            "item 1.4)")
    world = world_size()
    if data_parallel > 0 and data_parallel != world:
        raise ValueError(
            f"data extent {data_parallel} does not match the {world} "
            f"process(es) of the run: start one process per data shard "
            f"(torchrun --nproc_per_node {data_parallel}) or pass 0")
    if not dist.is_initialized():
        return None
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, (world,),
                            mesh_dim_names=(DATA_AXIS,))


def data_shard_geometry(tensor_parallel: int = 1, pipeline_parallel: int = 1,
                        count: Optional[int] = None,
                        index: Optional[int] = None,
                        local_devices: int = 1) -> Tuple[int, int]:
    """`(shard_index, shard_count)` for the host data pipeline (JAX
    `mesh.py:116-142`, the same arithmetic).

    With a pure data mesh every process owns a distinct run of batch rows,
    so the loader shards by process: the DistributedSampler analogue
    (reference data_dataloaders.py:26-39).  When the mesh's second axis
    (model or pipe) is wider than one process's devices, consecutive
    processes share the same data-axis rows and must read the same rows.
    The process `count` and `index` default to the process group's; a
    port process drives one GPU (`local_devices = 1`)."""
    pc = world_size() if count is None else count
    pi = process_index() if index is None else index
    second = max(int(tensor_parallel), 1) * max(int(pipeline_parallel), 1)
    if pc == 1 or second <= local_devices:
        return pi, pc
    if second % local_devices:
        raise ValueError(
            f"model/pipe extent {second} spans a fractional process "
            f"(local devices {local_devices}); pick extents so one "
            f"process's devices divide the second mesh axis")
    group = second // local_devices  # processes sharing one row set
    return pi // group, pc // group


def shard_batch(batch: Mapping[str, Any], device: torch.device
                ) -> Dict[str, torch.Tensor]:
    """A rank's rows of the global batch to its device: {input_ids,
    attention_mask, video, video_mask} as numpy arrays or tensors (the
    loader already read only this rank's rows); token ids become int64.  A
    pinned tensor is copied as it is, so the copy does not block the
    host."""
    out = {}
    for key in ("input_ids", "attention_mask", "video", "video_mask"):
        t = torch.as_tensor(batch[key]).to(device, non_blocking=True)
        out[key] = t.long() if key == "input_ids" else t
    return out


def is_shard(t) -> bool:
    """True for an FSDP shard (a DTensor)."""
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def is_sharded(module: nn.Module) -> bool:
    """True when any parameter of `module` is an FSDP shard (a DTensor)."""
    return any(is_shard(p) for p in module.parameters())


def local(t: torch.Tensor) -> torch.Tensor:
    """This rank's part of a tensor: the local shard of a DTensor (sharing
    its storage, so an in-place update under `torch.no_grad` updates the
    shard), else the tensor."""
    return t.to_local() if is_shard(t) else t


def shard_like(full: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """This rank's shard of the full tensor `full`, laid out as the DTensor
    `like` (no communication: every rank holds `full`)."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(full.to(like.device, like.dtype),
                             like.device_mesh, like.placements,
                             src_data_rank=None).to_local()


def _gather_shards(t) -> torch.Tensor:
    """The whole tensor of an FSDP shard (`Shard(0)` on the 1-D data mesh):
    the ranks' row chunks (`torch.chunk`'s, the last ones shorter or
    empty), padded to one size, all-gathered by the plain collective and
    trimmed.  (`DTensor.full_tensor`'s functional collectives crash over
    gloo with CUDA tensors; the plain all-gather runs on both
    backends.)"""
    from torch.distributed.tensor import Shard
    if tuple(t.placements) != (Shard(0),):
        raise ValueError(f"expected a Shard(0) tensor, got {t.placements}")
    group = t.device_mesh.get_group()
    part = t.to_local().detach()
    rows = -(-t.shape[0] // dist.get_world_size(group))
    padded = part.new_zeros((rows, *t.shape[1:]))
    padded[:part.shape[0]] = part
    parts = [torch.empty_like(padded)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, padded, group=group)
    return torch.cat(parts)[:t.shape[0]]


def fetch_replicated(tree):
    """COLLECTIVE: a nested dict of tensors with every FSDP shard gathered
    to its full tensor, as copies on the host (JAX `mesh.py:154-169`).

    Rank 0's evaluation, export and checkpoint need whole tensors; the
    all-gather of a sharded tensor is a collective, so every rank calls
    this (in the same order) before rank 0 alone writes.  Tensors that are
    not sharded are copied as they are; other leaves pass through."""
    if isinstance(tree, Mapping):
        return {k: fetch_replicated(v) for k, v in tree.items()}
    if is_shard(tree):
        return _gather_shards(tree).cpu()
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().clone()
    return tree


@torch.no_grad()
def load_replicated(module: nn.Module,
                    state_dict: Mapping[str, torch.Tensor]) -> None:
    """Load full tensors into `module`, as `load_state_dict(strict=True)`
    does, whether its parameters are whole or FSDP shards (each rank keeps
    its shard of each full tensor): the inverse of `fetch_replicated`."""
    if not is_sharded(module):
        module.load_state_dict(state_dict, strict=True)
        return
    own = module.state_dict(keep_vars=True)
    missing = sorted(set(own) - set(state_dict))
    unexpected = sorted(set(state_dict) - set(own))
    if missing or unexpected:
        raise KeyError(f"state dict keys differ from the model's: missing "
                       f"{missing}, unexpected {unexpected}")
    for key, t in own.items():
        src = state_dict[key]
        if is_shard(t):
            local(t).copy_(shard_like(src, t))
        else:
            t.copy_(src)


def _blocks(model: nn.Module) -> Iterator[nn.Module]:
    """Every residual block of every transformer stack of the model (the
    CLIP towers, seqTransf's and the cross model's)."""
    for m in model.modules():
        blocks = getattr(m, "resblocks", None)
        if isinstance(blocks, nn.ModuleList):
            yield from blocks


def shard_params(model: nn.Module, mesh, fsdp: bool = False,
                 find_unused_parameters: bool = False) -> nn.Module:
    """The module a train step calls: `model` itself without a mesh;
    `DistributedDataParallel(model)` for plain data parallelism; with
    `fsdp`, `model` after `fully_shard` per transformer block and on the
    root (the module docstring).  The freeze mask must be set before:
    frozen parameters (`requires_grad=False`) are not reduced."""
    if mesh is None:
        return model
    if not fsdp:
        from torch.nn.parallel import DistributedDataParallel
        device = next(model.parameters()).device
        return DistributedDataParallel(
            model, device_ids=[device.index] if device.type == "cuda"
            else None, process_group=mesh.get_group(),
            find_unused_parameters=find_unused_parameters)
    from torch.distributed.fsdp import fully_shard
    for block in list(_blocks(model)):
        # a vision block's cluster module runs before the block, outside
        # the block's forward, so it stays out of the block's shards
        inter = getattr(block, "tokencluster_inter", None)
        fully_shard(block, mesh=mesh, ignored_params=set(
            inter.parameters()) if inter is not None else None)
    fully_shard(model, mesh=mesh, ignored_params={
        p for p in model.parameters() if p.dim() == 0})
    return model


def unwrap(module: nn.Module) -> nn.Module:
    """The model inside a DDP wrapper (an FSDP model is its own)."""
    return getattr(module, "module", module)


@contextlib.contextmanager
def gradient_sync(module: nn.Module, enabled: bool):
    """Run a backward with (enabled) or without the wrapper's gradient
    reduction: DDP's `no_sync`, FSDP2's `set_requires_gradient_sync`.
    Gradient accumulation reduces only on its last micro-batch."""
    if enabled:
        yield
    elif hasattr(module, "no_sync"):
        with module.no_sync():
            yield
    elif hasattr(module, "set_requires_gradient_sync"):
        module.set_requires_gradient_sync(False)
        try:
            yield
        finally:
            module.set_requires_gradient_sync(True)
    else:
        yield


@torch.no_grad()
def reduce_replicated_grads(module: nn.Module) -> None:
    """Average over the ranks the gradients of an FSDP model's parameters
    that are not sharded (FSDP reduces only its shards).  A no-op for a
    model without shards: DDP reduces every gradient itself."""
    if not is_sharded(module) or world_size() == 1:
        return
    for p in module.parameters():
        if p.grad is not None and not is_shard(p):
            dist.all_reduce(p.grad, op=dist.ReduceOp.SUM)
            p.grad.div_(world_size())


def process_barrier(name: str) -> None:
    """Hold every rank here until all arrive (JAX `mesh.py:280-299`); a
    no-op in one process.  Rank 0's evaluation and checkpoint can take
    minutes: the group's timeout (`GROUP_TIMEOUT`, one hour) covers them.
    Without the barrier a rank that finished its epoch would run ahead
    into the next epoch's collectives, or exit, while rank 0 still
    writes."""
    if world_size() <= 1:
        return
    logger.debug("barrier %s", name)
    dist.barrier()
