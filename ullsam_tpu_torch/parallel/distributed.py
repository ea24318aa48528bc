"""Process groups, the ("data", "model") mesh of ranks and the collectives
of data and tensor parallelism (``ullsam_tpu/parallel/distributed.py``).

The JAX package runs one controller over all devices and lets XLA insert
the collectives. The port runs one process a rank, so the collectives are
written out:

* ``initialize`` starts ``torch.distributed`` from an explicit
  ``init_method`` or from the launcher's variables (the JAX package's
  ``JAX_COORDINATOR_ADDRESS`` / ``JAX_NUM_PROCESSES`` / ``JAX_PROCESS_ID``,
  then torchrun's ``MASTER_ADDR`` / ``WORLD_SIZE`` / ``RANK``); with none of
  them it does nothing and the process is rank 0 of 1. The backend follows
  the device: NCCL for ``cuda``, gloo for ``cpu``; gloo on the card only
  when the caller asks for it (two ranks that share one GPU, which NCCL
  refuses). Under NCCL a ``cuda`` device without an index binds the rank
  to card ``LOCAL_RANK`` (torchrun's), else ``rank % device_count``.
* ``Mesh`` is the layout of ranks, rank = data_index * tp + model_index,
  with one process group along each axis. A mesh without a process group
  (one process) makes every collective here the identity.
* The autograd ops of Megatron tensor parallelism: ``copy_to_model``
  (identity forward, all-reduce of the gradient) before a column-parallel
  linear, ``reduce_from_model`` (all-reduce forward, identity backward)
  after a row-parallel one, and ``gather_from_model`` (all-gather forward,
  the rank's slice of the gradient backward) for a weight stored sharded
  but used whole. ``gathered(module)`` swaps such weights in for the
  duration of a block.

gloo moves CUDA tensors through the host and supports only broadcast and
all-reduce for them, so an all-gather under gloo of a CUDA tensor is an
all-reduce of a zero-filled buffer in which each rank wrote its slice (the
sum is exact: every element is one rank's value plus zeros).
"""

from __future__ import annotations

import contextlib
import os
from typing import List, Optional

import torch
import torch.distributed as dist

Tensor = torch.Tensor


def _int_env(name: str, default):
    v = os.environ.get(name)
    return int(v) if v not in (None, "") else default


def initialize(init_method: Optional[str] = None,
               world_size: Optional[int] = None,
               rank: Optional[int] = None, backend: Optional[str] = None,
               device="cuda") -> bool:
    """Start the default process group if the caller or the environment
    asks for one; returns whether a group is up. ``init_method`` is a
    ``tcp://host:port`` or ``file://`` URL (the tests use a file in a
    temporary directory). ``backend`` defaults to NCCL when ``device`` is
    a CUDA device, gloo otherwise."""
    if dist.is_initialized():
        return True
    world_size = world_size or _int_env("JAX_NUM_PROCESSES",
                                        _int_env("WORLD_SIZE", None))
    rank = rank if rank is not None else _int_env(
        "JAX_PROCESS_ID", _int_env("RANK", None))
    if init_method is None:
        coord = os.environ.get("JAX_COORDINATOR_ADDRESS")
        if coord:
            init_method = coord if "://" in coord else f"tcp://{coord}"
        elif os.environ.get("MASTER_ADDR") and world_size:
            init_method = "env://"
    if init_method is None and world_size in (None, 1):
        return False  # one process
    if backend is None:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    if backend == "nccl" and torch.device(device).type == "cuda":
        torch.cuda.set_device(rank_device_index(device, rank or 0))
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size or 1, rank=rank or 0)
    return True


def rank_device_index(device, rank: int) -> int:
    """The card a rank runs on: ``device``'s own index when it names one,
    else ``LOCAL_RANK``, else ``rank`` modulo the cards this process
    sees (one process a card, ranks numbered host by host)."""
    index = torch.device(device).index
    if index is not None:
        return index
    local = _int_env("LOCAL_RANK", None)
    if local is not None:
        return local
    return rank % max(1, torch.cuda.device_count())


def shutdown() -> None:
    """Destroy the default group, if any."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main_process() -> bool:
    """Rank-0 gating (the reference's dist.get_rank() == 0 checks)."""
    return process_index() == 0


def local_device_count() -> int:
    """The CUDA devices this process sees, or 1 (the CPU)."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 1


def barrier() -> None:
    if dist.is_initialized():
        dist.barrier()


class Mesh:
    """The ("data", "model") layout of ``dp * tp`` ranks: rank r is data
    index r // tp and model index r % tp (the JAX package's
    ``devices.reshape(dp, tp)``). ``data_group`` holds the ranks of this
    model index, ``model_group`` those of this data index; both are None in
    one process without a process group. A mesh is shared, never copied."""

    def __init__(self, dp: int, tp: int, rank: int = 0,
                 data_group=None, model_group=None,
                 backend: Optional[str] = None):
        self.dp, self.tp, self.rank = dp, tp, rank
        self.data_group, self.model_group = data_group, model_group
        self.backend = backend

    @property
    def data_index(self) -> int:
        return self.rank // self.tp

    @property
    def model_index(self) -> int:
        return self.rank % self.tp

    @property
    def shape(self) -> dict:
        return {"data": self.dp, "model": self.tp}

    def __deepcopy__(self, memo):
        return self

    def __repr__(self) -> str:
        return (f"Mesh(dp={self.dp}, tp={self.tp}, rank={self.rank}, "
                f"backend={self.backend})")


# ---------------------------------------------------------------------------
# collectives that take a None group as one rank
# ---------------------------------------------------------------------------


def all_reduce_(t: Tensor, group) -> Tensor:
    """Sum ``t`` in place over ``group`` (None: unchanged)."""
    if group is not None:
        dist.all_reduce(t, group=group)
    return t


def all_gather(t: Tensor, dim: int, mesh: Mesh) -> Tensor:
    """The model group's slices of a tensor, concatenated along ``dim`` in
    model-index order."""
    group, n = mesh.model_group, mesh.tp
    if group is None or n == 1:
        return t
    t = t.contiguous()
    if t.is_cuda and dist.get_backend(group) == "gloo":
        shape = list(t.shape)
        size = shape[dim]
        shape[dim] = size * n
        full = t.new_zeros(shape)
        full.narrow(dim, mesh.model_index * size, size).copy_(t)
        dist.all_reduce(full, group=group)
        return full
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=dim)


def broadcast_(t: Tensor, group, src: int = 0) -> Tensor:
    """Rank ``src``'s ``t`` (a global rank) into every rank's ``t``."""
    if group is not None:
        dist.broadcast(t, src=src, group=group)
    return t


def broadcast_object(obj, group, src: int = 0):
    """Rank ``src``'s picklable ``obj`` on every rank of ``group``."""
    if group is None:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src, group=group)
    return box[0]


def gather_to_main(t: Tensor) -> Optional[List[Tensor]]:
    """Every rank's ``t`` (same shape and dtype on each) on rank 0 of the
    default group, in rank order, on ``t``'s device; None on the other
    ranks. One process: ``[t]``. Under gloo the tensors go through the
    host (gloo gathers only CPU tensors)."""
    if not dist.is_initialized():
        return [t]
    rank, world = dist.get_rank(), dist.get_world_size()
    src = t.contiguous()
    if src.dtype == torch.bool:      # gathered as bytes
        src = src.view(torch.uint8)
    if dist.get_backend() == "gloo":
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(world)] if rank == 0 \
        else None
    dist.gather(src, parts, dst=0)
    if parts is None:
        return None
    return [p.to(t.device).view(t.dtype) for p in parts]


def global_denominator(count: Tensor, mesh: Optional[Mesh]) -> Tensor:
    """The denominator of a masked mean under data parallelism: with no
    data group ``count.clamp_min(1)``; with one, the count summed over the
    data ranks, clamped at 1, divided by dp. Each rank's sum over it then
    averages, over the ranks, to the whole batch's mean, and so does its
    gradient (``partitioning.sync_grads`` takes the mean)."""
    group = None if mesh is None else mesh.data_group
    if group is None:
        return count.clamp_min(1)
    total = all_reduce_(count.detach().float().clone(), group).clamp_min(1.0)
    return total if mesh.dp == 1 else total / mesh.dp


# ---------------------------------------------------------------------------
# the autograd ops of tensor parallelism
# ---------------------------------------------------------------------------


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.mesh.model_group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return all_reduce_(x.contiguous().clone(), mesh.model_group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, shard, dim, mesh):
        ctx.dim, ctx.mesh = dim, mesh
        return all_gather(shard, dim, mesh)

    @staticmethod
    def backward(ctx, g):
        # every model rank used the same whole tensor on the same
        # activations, so the whole gradient is the same on each: keep
        # this rank's slice
        size = g.shape[ctx.dim] // ctx.mesh.tp
        return (g.narrow(ctx.dim, ctx.mesh.model_index * size,
                         size).contiguous(), None, None)


def copy_to_model(x: Tensor, mesh: Optional[Mesh]) -> Tensor:
    """The input of a column-parallel linear: x forward, the gradient
    summed over the model group backward."""
    if mesh is None or mesh.model_group is None:
        return x
    return _CopyToModel.apply(x, mesh)


def reduce_from_model(x: Tensor, mesh: Optional[Mesh]) -> Tensor:
    """The output of a row-parallel linear: the partial products summed
    over the model group forward, the gradient as it is backward."""
    if mesh is None or mesh.model_group is None:
        return x
    return _ReduceFromModel.apply(x, mesh)


def gather_from_model(shard: Tensor, dim: int, mesh: Mesh) -> Tensor:
    return _GatherFromModel.apply(shard, dim, mesh)


def row_parallel_linear(module: torch.nn.Module, x: Tensor,
                        mesh: Optional[Mesh]) -> Tensor:
    """``module(x)`` for a ``Linear`` or ``QuantLinear`` whose weight holds
    this rank's input columns: the partial product without the bias,
    summed over the model group, then the bias once. Without a mesh, just
    ``module(x)``."""
    if mesh is None or mesh.model_group is None:
        return module(x)
    from ullsam_tpu_torch.ops import layers as L

    if isinstance(module, L.QuantLinear):
        y = L.linear_int8(x, module.qweight, module.qscale, None)
    else:
        y = L.linear(x, module.weight, None)
    y = reduce_from_model(y, mesh)
    return y if module.bias is None else y + module.bias.to(y.dtype)


# ---------------------------------------------------------------------------
# weights stored sharded, used whole
# ---------------------------------------------------------------------------


def _swap_in(module: torch.nn.Module) -> List[tuple]:
    """Replace each of ``module``'s own sharded parameters marked
    ``tp_gather`` by the whole tensor gathered from its shards; returns
    what to put back. A parameter already swapped is left alone."""
    swapped = []
    for name, p in list(module._parameters.items()):
        info = getattr(p, "tp_gather", None)
        if info is not None:
            module._parameters[name] = gather_from_model(p, *info)
            swapped.append((name, p))
    return swapped


def _swap_out(module: torch.nn.Module, swapped: List[tuple]) -> None:
    for name, p in swapped:
        module._parameters[name] = p


@contextlib.contextmanager
def gathered(module: torch.nn.Module):
    """Inside the block, every sharded ``tp_gather`` parameter of
    ``module`` and its submodules reads as the whole tensor (a
    differentiable all-gather); outside, as the rank's shard. A module
    with none costs one walk over its submodules."""
    done = []
    try:
        for m in module.modules():
            s = _swap_in(m)
            if s:
                done.append((m, s))
        yield
    finally:
        for m, s in done:
            _swap_out(m, s)


def _gather_pre_hook(module, args):
    module.__dict__.setdefault("_tp_swapped", []).append(_swap_in(module))


def _gather_post_hook(module, args, out):
    _swap_out(module, module.__dict__["_tp_swapped"].pop())


def gather_on_call(module: torch.nn.Module) -> None:
    """Make ``module(...)`` see its ``tp_gather`` parameters whole (for a
    module that is called, such as the embedding and the vocab head)."""
    if not getattr(module, "_tp_hooked", False):
        module.register_forward_pre_hook(_gather_pre_hook)
        module.register_forward_hook(_gather_post_hook)
        module._tp_hooked = True
