# coding=utf-8
"""The data, model and pipe axes: process groups, the device mesh, loader
shards, the tensor-parallel slices, the pipeline's stages and the DDP /
FSDP wrappers (port of the JAX package's `parallel/mesh.py`).

The JAX package runs one process per host over a `"data"` mesh of all its
chips, folded into `(data, model)` under tensor parallelism and into
`(data, pipe)` under pipeline parallelism.  The port
keeps PyTorch's idiom, the reference's own (main.py:54-62, 123-125): one
process per GPU, started by `torchrun` (`RANK`, `WORLD_SIZE`,
`LOCAL_RANK`, `MASTER_ADDR`, `MASTER_PORT`), NCCL for CUDA tensors and
gloo for CPU tensors, and a `torch.distributed.device_mesh` with JAX's
axis names.  Each rank runs on `cuda:LOCAL_RANK`.

* Plain data parallelism wraps the model in `DistributedDataParallel`
  over the data group: the parameters are replicated and the gradients
  averaged over the data shards.
* `fsdp` applies `fully_shard` over the data axis to every transformer
  block and to the root: each parameter is split on its first axis
  (`Shard(0)`), all-gathered where a layer uses it and its gradient
  reduce-scattered; the optimizer's moments follow the parameters
  (`zeros_like` of a sharded parameter is sharded).  JAX shards the
  largest axis that the data extent divides (`mesh.py:224-277`); the
  placement differs, the function computed does not.  Scalars
  (`logit_scale`) and the cluster modules that a vision block carries but
  the tower calls before the block stay replicated, as JAX leaves a
  parameter without a divisible axis: their gradients are averaged by
  `reduce_replicated_grads`.
* Tensor parallelism (`tensor_parallel > 1`) folds the ranks into
  `(data, model)`, the model axis fastest-varying as JAX's
  `reshape(data, second)` (`mesh.py:88`): ranks `i * tp .. i * tp + tp - 1`
  form a model group and read the same rows (`data_shard_geometry`).  A
  block's parameters are split Megatron-style by their owner's name
  (`_tp_spec`, JAX `mesh.py:200-221`): `in_proj` and `c_fc` column-parallel,
  `out_proj.weight` and `c_proj.weight` row-parallel, the rest replicated.
  `in_proj` is split per head: a rank keeps the q, k and v rows of its
  `H / tp` heads, so that kernel A takes its packed `[B, L, 3 D / tp]`
  projection as `H / tp` whole heads (JAX splits contiguous columns and
  GSPMD reshards around its attention).  The slices are plain tensors;
  `fetch_replicated` gathers them (and any FSDP shard of them) to the whole
  tensors of the canonical schema, and `load_replicated` takes whole
  tensors back to a rank's slices.  The block's collectives are
  `collectives.py`'s Megatron operators.
* Sequence parallelism (`sequence_parallel`, with tensor parallelism)
  keeps the towers' residual stream token-split over the model group
  within a run of blocks (`shard_tokens` / `unshard_tokens`, the
  counterpart of JAX's `shard_tokens`, `mesh.py:92-113`), padded to
  `ceil(L / tp)` tokens a rank.  A block's LayerNorm parameters and
  row-parallel biases then see 1 / tp of the tokens:
  `reduce_sequence_parallel_grads` sums their gradients over the model
  group.

* Pipeline parallelism (`pipeline_parallel > 1`) folds the ranks into
  `(data, pipe)`, the pipe axis fastest-varying as JAX's (`mesh.py:
  56-89`): ranks `i * pp .. i * pp + pp - 1` form a pipe group, read the
  same rows and run the towers' block runs on the GPipe schedule
  (`parallel/pipeline.py`), stage `j` holding blocks `[j n / pp, (j + 1)
  n / pp)` of a run of `n`.  The parameters and the optimizer's moments
  stay whole on every rank, as JAX's `param_shardings` leaves them (it
  has no pipe case): only the compute is per stage.  The pipeline's
  autograd Function hands every rank the whole gradient of each
  pipelined block (each stage's gathered over the pipe group), and every
  other parameter is computed alike on each stage, so DDP or FSDP then
  averages over the data group only.  Under FSDP the towers' blocks are
  sharded with the root, not one by one: a stage never runs the other
  stages' blocks.  Tensor and pipeline parallelism do not combine, as in
  JAX.
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import logging
import os
from dataclasses import dataclass
from typing import (Any, Dict, Iterable, Iterator, List, Mapping, Optional,
                    Tuple)

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
                device_type: str = "cuda", heads: Iterable[int] = ()):
    """The device mesh over every rank: `("data",)`, `("data", "model")`
    with `tensor_parallel > 1` or `("data", "pipe")` with
    `pipeline_parallel > 1`; None in a run of one process without a
    process group (the model then runs unwrapped).

    `data_parallel` counts processes, one per GPU, as the JAX package's
    counts devices (`mesh.py:56-89`); `<= 0` means every process, and
    another value must equal the world size (a process cannot sit out).
    The data extent is then `world / tensor_parallel` (or `/
    pipeline_parallel`).  Raises ValueError when tensor and pipeline
    parallelism are combined (JAX `mesh.py:79-81`), when either does not
    divide the world (JAX `mesh.py:85-87`), when `tensor_parallel` does
    not divide the `heads` of every block stack of the model, and when
    `sequence_parallel` comes without tensor parallelism."""
    tp = max(int(tensor_parallel), 1)
    pp = max(int(pipeline_parallel), 1)
    if tp > 1 and pp > 1:
        raise ValueError("tensor_parallel and pipeline_parallel cannot be "
                         "combined on one mesh")
    if sequence_parallel and tp == 1:
        raise ValueError("sequence_parallel requires tensor_parallel > 1")
    uneven = sorted({h for h in heads if h % tp})
    if uneven:
        raise ValueError(
            f"model extent {tp} does not divide the {uneven} heads of a "
            f"block stack: each rank takes whole heads")
    world = world_size()
    if data_parallel > 0 and data_parallel != world:
        raise ValueError(
            f"data extent {data_parallel} does not match the {world} "
            f"process(es) of the run: --data_parallel counts processes, "
            f"one per GPU (torchrun --nproc_per_node {data_parallel}), or "
            f"pass 0")
    if world % tp:
        raise ValueError(f"model extent {tp} does not divide the {world} "
                         f"process(es) of the run")
    if world % pp:
        raise ValueError(f"pipe extent {pp} does not divide the {world} "
                         f"process(es) of the run")
    if not dist.is_initialized():
        return None
    from torch.distributed.device_mesh import init_device_mesh
    if tp == 1 and pp == 1:
        return init_device_mesh(device_type, (world,),
                                mesh_dim_names=(DATA_AXIS,))
    second, name = (tp, MODEL_AXIS) if tp > 1 else (pp, PIPE_AXIS)
    mesh = init_device_mesh(device_type, (world // second, second),
                            mesh_dim_names=(DATA_AXIS, name))
    if pp > 1:
        # a first collective on every rank of each pipe group, so that
        # the schedule's point-to-point batches, which leave out the
        # stages idle at a tick, find their communicator set up
        dist.barrier(group=mesh.get_group(PIPE_AXIS))
    return mesh


@dataclass(frozen=True)
class Axes:
    """A rank's place on the mesh, as the model's modules read it: the data
    group (the global-batch gather, gradient averages); under tensor
    parallelism the model group, its extent, this rank's index on it and
    whether the towers split their tokens over it (`sp`); under pipeline
    parallelism the pipe group, its extent and this rank's stage, and the
    GPipe microbatch count (0: `pipeline.pick_microbatches`)."""
    data_group: Any
    data_size: int
    model_group: Any = None
    model_size: int = 1
    model_rank: int = 0
    sp: bool = False
    pipe_group: Any = None
    pipe_size: int = 1
    stage: int = 0
    microbatches: int = 0

    @property
    def tp(self) -> bool:
        return self.model_size > 1

    @property
    def pp(self) -> bool:
        return self.pipe_size > 1


def mesh_axes(mesh, sequence_parallel: bool = False,
              microbatches: int = 0) -> Optional[Axes]:
    """The `Axes` of this rank on `mesh` (None without a mesh)."""
    if mesh is None:
        return None
    names = mesh.mesh_dim_names or ()
    if PIPE_AXIS in names:
        data, pipe = mesh.get_group(DATA_AXIS), mesh.get_group(PIPE_AXIS)
        return Axes(data, dist.get_world_size(data), pipe_group=pipe,
                    pipe_size=dist.get_world_size(pipe),
                    stage=dist.get_rank(pipe),
                    microbatches=int(microbatches))
    if MODEL_AXIS not in names:
        group = mesh.get_group()
        return Axes(group, dist.get_world_size(group))
    data, model = mesh.get_group(DATA_AXIS), mesh.get_group(MODEL_AXIS)
    return Axes(data, dist.get_world_size(data), model,
                dist.get_world_size(model), dist.get_rank(model),
                bool(sequence_parallel))


def axes_of(module: nn.Module) -> Optional[Axes]:
    """The `Axes` `shard_params` gave a model (None for one that runs
    alone)."""
    return getattr(unwrap(module), "axes", None)


def block_heads(model: nn.Module) -> List[int]:
    """The head count of every block of the model (`_blocks`)."""
    return [b.attn.heads for b in _blocks(model)]


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


def shard_tokens(x: torch.Tensor, axes: Axes) -> torch.Tensor:
    """Sequence parallelism's layout of a run's residual stream (JAX
    `shard_tokens`, `mesh.py:92-113`): this rank's `ceil(L / tp)` tokens
    of a [batch, L, ...] stream every rank of the model group holds whole
    (zero-padded past L on the last ranks)."""
    from .collectives import split_tokens
    return split_tokens(x, axes.model_group)


def unshard_tokens(x: torch.Tensor, axes: Axes, length: int
                   ) -> torch.Tensor:
    """The inverse of `shard_tokens`: the whole [batch, length, ...] stream
    on every rank of the model group, where a cluster layer, a DeepCluster
    head, `ln_post` or the EOT pick needs every token."""
    from .collectives import gather_whole_tokens
    return gather_whole_tokens(x, axes.model_group, length)


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
    """True when the model's parameters are not whole: FSDP shards
    (DTensors) or tensor-parallel slices.  Its forward then needs every
    rank, and its state dict `fetch_replicated`."""
    axes = axes_of(module)
    return (axes is not None and axes.tp) or any(
        is_shard(p) for p in module.parameters())


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


# -------------------------------------------------- tensor-parallel slices
HEADS, COLUMN, ROW = "heads", "column", "row"


def _tp_spec(key: str) -> Optional[str]:
    """How tensor parallelism splits the parameter of torch key `key`
    (JAX `mesh.py:200-221`, by the owner's name, in every block of
    `_blocks`): `HEADS` for `in_proj` (its q, k and v rows per head),
    `COLUMN` for `c_fc` (output features: rows of the weight, the bias),
    `ROW` for the weights of `out_proj` and `c_proj` (input features:
    columns), None (replicated) for everything else, their biases
    included: they add after the reduction."""
    if ".resblocks." not in key:
        return None
    if key.endswith((".attn.in_proj_weight", ".attn.in_proj_bias")):
        return HEADS
    if key.endswith((".mlp.c_fc.weight", ".mlp.c_fc.bias")):
        return COLUMN
    if key.endswith((".attn.out_proj.weight", ".mlp.c_proj.weight")):
        return ROW
    return None


def param_shardings(keys: Iterable[str]) -> Dict[str, Optional[str]]:
    """The tensor-parallel split of every parameter, by torch key
    (`_tp_spec`): the counterpart of JAX's `param_shardings`
    (`mesh.py:247-264`), whose FSDP half is `fully_shard`'s here."""
    return {k: _tp_spec(k) for k in keys}


def take_slice(whole: torch.Tensor, spec: str, size: int, rank: int
               ) -> torch.Tensor:
    """Rank `rank`'s slice of a whole parameter split `spec` over `size`
    ranks (a copy)."""
    if spec == HEADS:           # [3 D, ...] -> q, k, v rows of its heads
        parts = whole.reshape(3, size, -1, *whole.shape[1:])[:, rank]
        return parts.reshape(-1, *whole.shape[1:]).clone()
    if spec == COLUMN:
        return whole.chunk(size, dim=0)[rank].clone()
    return whole.chunk(size, dim=1)[rank].contiguous()


def join_slices(parts: List[torch.Tensor], spec: str) -> torch.Tensor:
    """The whole parameter from every rank's slice, in rank order: the
    inverse of `take_slice`."""
    if spec == HEADS:
        rest = parts[0].shape[1:]
        stacked = torch.stack([p.reshape(3, -1, *rest) for p in parts], 1)
        return stacked.reshape(-1, *rest)
    return torch.cat(parts, dim=0 if spec == COLUMN else 1)


def slice_state(state: Mapping[str, Any], axes: Optional[Axes]
                ) -> Dict[str, Any]:
    """A whole state dict (torch keys) to this rank's tensor-parallel
    slices (`_tp_spec`); the other entries as they are (no
    communication)."""
    if axes is None or not axes.tp:
        return dict(state)
    return {k: take_slice(t, _tp_spec(k), axes.model_size, axes.model_rank)
            if _tp_spec(k) is not None else t for k, t in state.items()}


def gather_state(state: Mapping[str, Any], axes: Optional[Axes]
                 ) -> Dict[str, Any]:
    """COLLECTIVE over the model group: the inverse of `slice_state`, each
    slice all-gathered (in the dict's order, the same on every rank) and
    joined to the whole tensor, on its device."""
    if axes is None or not axes.tp:
        return dict(state)
    out = {}
    for key, t in state.items():
        spec = _tp_spec(key)
        if spec is not None and isinstance(t, torch.Tensor):
            t = t.detach().contiguous()
            parts = [torch.empty_like(t) for _ in range(axes.model_size)]
            dist.all_gather(parts, t, group=axes.model_group)
            t = join_slices(parts, spec)
        out[key] = t
    return out


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


def fetch_replicated(tree, axes: Optional[Axes] = None):
    """COLLECTIVE: a nested dict of tensors with every FSDP shard gathered
    over the data group and, with `axes` under tensor parallelism, every
    slice over the model group (`gather_state`, by torch key), as whole
    copies on the host (JAX `mesh.py:154-169`).

    Rank 0's evaluation, export and checkpoint need whole tensors; the
    gathers are collectives, so every rank calls this (in the same order)
    before rank 0 alone writes.  Tensors that are neither are copied as
    they are; other leaves pass through."""
    def unshard(t):
        if is_shard(t):
            return _gather_shards(t)
        return t.detach() if isinstance(t, torch.Tensor) else t

    def host(t):
        return t.cpu().clone() if isinstance(t, torch.Tensor) else t
    if not isinstance(tree, Mapping):
        return host(unshard(tree))
    whole = gather_state({k: v if isinstance(v, Mapping) else unshard(v)
                          for k, v in tree.items()}, axes)
    return {k: fetch_replicated(v, axes) if isinstance(v, Mapping)
            else host(v) for k, v in whole.items()}


@torch.no_grad()
def copy_part(t: torch.Tensor, whole: torch.Tensor) -> None:
    """Copy into `t` its part of `whole`: the FSDP shard of an FSDP
    parameter or moment, else all of it."""
    if is_shard(t):
        local(t).copy_(shard_like(whole, t))
    else:
        t.copy_(whole)


@torch.no_grad()
def load_replicated(module: nn.Module,
                    state_dict: Mapping[str, torch.Tensor]) -> None:
    """Load whole tensors into `module`, as `load_state_dict(strict=True)`
    does, whether its parameters are whole, FSDP shards or
    tensor-parallel slices (each rank keeps its part of each whole
    tensor: `slice_state`, then `copy_part`): the inverse of
    `fetch_replicated`."""
    if not is_sharded(module):
        module.load_state_dict(state_dict, strict=True)
        return
    own = module.state_dict(keep_vars=True)
    missing = sorted(set(own) - set(state_dict))
    unexpected = sorted(set(state_dict) - set(own))
    if missing or unexpected:
        raise KeyError(f"state dict keys differ from the model's: missing "
                       f"{missing}, unexpected {unexpected}")
    parts = slice_state(state_dict, axes_of(module))
    for key, t in own.items():
        copy_part(t, parts[key])


def _blocks(model: nn.Module) -> Iterator[nn.Module]:
    """Every residual block of every transformer stack of the model (the
    CLIP towers, seqTransf's and the cross model's)."""
    for m in model.modules():
        blocks = getattr(m, "resblocks", None)
        if isinstance(blocks, nn.ModuleList):
            yield from blocks


@torch.no_grad()
def split_model(model: nn.Module, axes: Axes) -> None:
    """Replace every block's column- and row-parallel parameters by this
    rank's slices (`_tp_spec`), give each attention its `H / tp` local
    heads, and hand `axes` to the model, its block stacks and their
    blocks.  The towers' stacks (`token_split`) split their tokens when
    `axes.sp` (the JAX towers' `sp`); the header blocks (seqTransf, the
    cross model) do not, as in JAX."""
    params = dict(model.named_parameters())
    for key, spec in param_shardings(params).items():
        if spec is None:
            continue
        p = params[key]
        owner_key, name = key.rsplit(".", 1)
        owner = model.get_submodule(owner_key)
        setattr(owner, name, nn.Parameter(
            take_slice(p.data, spec, axes.model_size, axes.model_rank),
            requires_grad=p.requires_grad))
    whole_tokens = dataclasses.replace(axes, sp=False)
    model.axes = axes
    for m in model.modules():
        blocks = getattr(m, "resblocks", None)
        if isinstance(blocks, nn.ModuleList):
            m.axes = axes if getattr(m, "token_split", False) \
                else whole_tokens
            for block in blocks:
                block.axes = m.axes
                block.attn.heads //= axes.model_size


def stage_model(model: nn.Module, axes: Axes) -> None:
    """Hand `axes` (with its pipe group) to the model and to the towers'
    block stacks (`token_split`), whose training forward then runs its
    block runs on the GPipe schedule; the header blocks (seqTransf, the
    cross model) stay sequential, as in JAX."""
    model.axes = axes
    for m in model.modules():
        if isinstance(getattr(m, "resblocks", None), nn.ModuleList) \
                and getattr(m, "token_split", False):
            m.axes = axes


def shard_params(model: nn.Module, mesh, fsdp: bool = False,
                 find_unused_parameters: bool = False,
                 sequence_parallel: bool = False,
                 microbatches: int = 0) -> nn.Module:
    """The module a train step calls: `model` itself without a mesh; under
    tensor parallelism `model` split first (`split_model`), under pipeline
    parallelism its towers staged (`stage_model`); then
    `DistributedDataParallel(model)` over the data group, or with `fsdp`
    `model` after `fully_shard` over the data axis per transformer block
    and on the root (the module docstring; under pipeline parallelism the
    towers' blocks with the root).  The freeze mask must be set before:
    frozen parameters (`requires_grad=False`) are not reduced."""
    if mesh is None:
        return model
    axes = mesh_axes(mesh, sequence_parallel, microbatches)
    if axes.tp:
        split_model(model, axes)
        mesh = mesh[DATA_AXIS]
    elif axes.pp:
        stage_model(model, axes)
        mesh = mesh[DATA_AXIS]
    else:
        model.axes = axes
    if not fsdp:
        from torch.nn.parallel import DistributedDataParallel
        device = next(model.parameters()).device
        return DistributedDataParallel(
            model, device_ids=[device.index] if device.type == "cuda"
            else None, process_group=axes.data_group,
            find_unused_parameters=find_unused_parameters)
    from torch.distributed.fsdp import fully_shard
    staged = {id(b) for m in model.modules()
              if getattr(m, "token_split", False) and axes.pp
              for b in m.resblocks}
    for block in list(_blocks(model)):
        if id(block) in staged:
            continue
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


def _all_reduce_flat(grads: List[torch.Tensor], group) -> None:
    """Sum `grads` over `group` in place, as one flat all-reduce."""
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    for g, f in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(f.view_as(g))


@torch.no_grad()
def reduce_replicated_grads(module: nn.Module) -> None:
    """Average over the data group the gradients of an FSDP model's
    parameters that are not sharded (FSDP reduces only its shards).  A
    no-op for a model without shards: DDP reduces every gradient
    itself."""
    axes = axes_of(module)
    if axes is None or axes.data_size == 1 or not any(
            is_shard(p) for p in module.parameters()):
        return
    grads = [p.grad for p in module.parameters()
             if p.grad is not None and not is_shard(p)]
    _all_reduce_flat(grads, axes.data_group)
    torch._foreach_div_(grads, float(axes.data_size))


@torch.no_grad()
def reduce_sequence_parallel_grads(module: nn.Module) -> None:
    """Sum over the model group the gradients that sequence parallelism
    leaves partial: a token-split block's LayerNorm weights and biases and
    its row-parallel biases (`out_proj.bias`, `c_proj.bias`), each rank's
    over its own tokens (kernel D's dgamma and dbeta, the bias sums).
    Without sequence parallelism they are whole and equal on every rank of
    the group, and are left alone."""
    axes = axes_of(module)
    if axes is None or not axes.sp:
        return
    grads = []
    for block in _blocks(unwrap(module)):
        if block.axes.sp:
            for p in (block.ln_1.weight, block.ln_1.bias, block.ln_2.weight,
                      block.ln_2.bias, block.attn.out_proj.bias,
                      block.mlp.c_proj.bias):
                if p.grad is not None:
                    grads.append(local(p.grad))
    _all_reduce_flat(grads, axes.model_group)


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
