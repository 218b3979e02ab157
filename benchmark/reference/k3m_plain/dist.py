"""The world of processes a step runs in, and what the model reads of it.

The counterpart of the 'data' axis of the JAX package's mesh
(k3m_tpu/train/mesh.py: `make_mesh` :29-37, `shard_batch` :106-118).
There, one jitted program computes every term over the one global batch,
which `make_array_from_process_local_data` lays out from each host's rows
in process order; so a data-parallel step is the one-device step on that
batch (tests/test_multidevice.py). Here each rank runs its own rows, and an
N-rank step computes the same function:

  * every loss is the sum over the rank's rows divided by the global count
    (`World.sum_counts`, an all-reduce that carries no gradient), so the
    ranks' losses add up to the global loss and the trainer sums the
    gradients over the ranks (train/dist.py `all_reduce_grads`);
  * what one row reads of other rows (the structure aggregator's zero-pair
    carry and LPM entity negatives, the NCE negatives) comes from
    `gather_rows` / `all_gather_rows`; `GatherRows`' backward all-reduces
    the incoming gradient and keeps this rank's rows, so the gradient of
    another rank's loss reaches this rank's activations;
  * random draws that span the batch are made at the global shape and
    sliced to this rank's rows (model/random.py), and the attention
    kernels key their Philox mask by the global row (`row0`).

The dim-0 contract. The model reads the world made active for one forward
by `use(world, rows)`, where `rows` is this rank's batch rows in that
forward; `window(n)` gives (this rank's first global row, the global rows)
for a tensor whose dim 0 is those rows, and raises for any other leading
size, so a tensor of some other layout (two items stacked into 2B rows,
rows flattened with positions) cannot be taken for the batch; the
in_batch_pairs rows enter by name (`pair_rows`), and so do the copies of
the batch that packed_passes stacks into one image stack (`stacked`,
whose rows `windows` gives as one slice of the global rows per copy). With no
world active, or a world of one, the model runs the one-process code and
keeps its numbers bit for bit.

Tensor parallelism (the 'model' axis of the JAX package's mesh,
k3m_tpu/train/mesh.py:29-58). The world is a grid of `size / n_model`
data groups of `n_model` model ranks, laid out as JAX's
`reshape(n_data, n_model)`: rank r is data index r // n_model and model
index r % n_model, so a model group is n_model consecutive ranks. Every
batch semantic above reads the data axis (`data_rank`, `data_size`, the
data group): the ranks of one model group hold the same rows, and each
holds its shard of the sharded weights (train/mesh.py). The model's
sharded layers meet in the model group through Megatron's two conjugate
functions: `copy_to_model` (identity forward, model-group all-reduce of
the gradient) where a replicated activation enters a column-parallel
layer, and `reduce_from_model` (model-group all-reduce forward, identity
backward) where a row-parallel layer's partial sums leave it. The
barriers, `any_flag` and `all_reduce_sum` without an axis span the whole
world. With n_model 1 there is no model group and every number is the
data-parallel one.

Every collective is an `all_reduce` or a `broadcast`, which both backends
carry: NCCL for CUDA devices, gloo for the CPU. Under gloo (which lets
several ranks share one card, train/dist.py) the helpers always copy CUDA
tensors to a host buffer and back.
"""

from __future__ import annotations

import contextlib
import contextvars
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as tdist


@dataclass
class World:
    """One rank of a world of `size` processes, a grid of `size // n_model`
    data groups of `n_model` model ranks. `group` is False for the world
    of one that no launcher configured: no process group, and every
    collective is the identity. `data_group` and `model_group` are this
    rank's sub-groups (train/dist.py `init_world`); None is the whole world
    for the data axis where n_model is 1, and no group for the model axis.
    `traffic`: per axis ("world", "data", "model"), [collectives, bytes,
    host seconds] of the all-reduces this rank ran (host seconds include
    gloo's host copies; under NCCL they are the enqueue alone)."""
    rank: int = 0
    size: int = 1
    device: torch.device = torch.device("cpu")
    backend: Optional[str] = None
    group: bool = False
    n_model: int = 1
    data_group: Any = None
    model_group: Any = None
    traffic: Dict[str, List] = field(default_factory=dict, compare=False, repr=False)

    def __post_init__(self):
        if self.n_model < 1 or self.size % self.n_model:
            raise ValueError(f"--n_model {self.n_model} does not divide the world of "
                             f"{self.size} processes")

    # ------------------------------------------------------------ layout

    @property
    def data_rank(self) -> int:
        """This rank's data index: the rows of the global batch it holds."""
        return self.rank // self.n_model

    @property
    def data_size(self) -> int:
        """The data groups, each holding 1 / data_size of the global batch."""
        return self.size // self.n_model

    @property
    def model_rank(self) -> int:
        """This rank's model index: the shard of the sharded weights it holds."""
        return self.rank % self.n_model

    @property
    def distributed(self) -> bool:
        """Whether other ranks hold rows of the global batch."""
        return self.data_size > 1

    def local_rows(self, global_rows: int, what: str) -> int:
        """A rank's rows of a global batch, which the data groups split
        evenly (root pretrain.py:168-172); raises if it does not divide."""
        if global_rows % self.data_size:
            raise ValueError(f"{what} {global_rows} not divisible by the {self.data_size} "
                             "data groups")
        return global_rows // self.data_size

    # ------------------------------------------------------- collectives

    def _group(self, axis: Optional[str]):
        """(process group, whether there is anything to reduce over) of an
        axis: None the whole world, "data" this rank's data group, "model"
        its model group."""
        if axis is None:
            return None, self.group
        if axis == "data":
            # n_model 1: the whole world, even a world of one (as before the model axis)
            return self.data_group, self.group and (self.n_model == 1 or self.data_size > 1)
        if axis == "model":
            return self.model_group, self.group and self.n_model > 1
        raise ValueError(f"unknown axis {axis}")

    def _reduce(self, t: torch.Tensor, op, axis: Optional[str] = None) -> torch.Tensor:
        """`op(buffer)` on `t` in place, through a host copy under gloo,
        in fp32 for 16-bit floats (the sum of a row and zeros is exact in
        any type; gradients are summed in fp32); counted in `traffic`."""
        t0 = time.perf_counter()
        buf = t.float() if t.dtype in (torch.bfloat16, torch.float16) else t
        if self.backend == "gloo" and buf.is_cuda:
            buf = buf.cpu()
        op(buf)
        if buf is not t:
            t.copy_(buf)
        n = self.traffic.setdefault(axis or "world", [0, 0, 0.0])
        n[0] += 1
        n[1] += buf.numel() * buf.element_size()
        n[2] += time.perf_counter() - t0
        return t

    def all_reduce_sum(self, t: torch.Tensor, axis: Optional[str] = None) -> torch.Tensor:
        """Sum `t` over the ranks of `axis` (None: the whole world), in
        place; returns `t`."""
        group, any_other = self._group(axis)
        if not any_other:
            return t
        return self._reduce(t, lambda b: tdist.all_reduce(b, op=tdist.ReduceOp.SUM,
                                                          group=group), axis)

    def all_reduce_max(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """The elementwise max of `t` over the ranks of `axis`, in place."""
        group, any_other = self._group(axis)
        if not any_other:
            return t
        return self._reduce(t, lambda b: tdist.all_reduce(b, op=tdist.ReduceOp.MAX,
                                                          group=group), axis)

    def broadcast(self, t: torch.Tensor, src: int = 0, axis: Optional[str] = None) -> torch.Tensor:
        """Rank `src`'s `t` (a rank of the whole world, in `axis`'s group)
        on every rank of `axis`, in place; returns `t`."""
        group, any_other = self._group(axis)
        if not any_other:
            return t
        return self._reduce(t, lambda b: tdist.broadcast(b, src=src, group=group), axis)

    def barrier(self) -> None:
        if self.group:
            flag = torch.zeros(1, device=self._flag_device())
            self.all_reduce_sum(flag)

    def any_flag(self, flag: bool) -> bool:
        """Whether any rank's `flag` is set (every rank gets the same)."""
        if not self.group:
            return bool(flag)
        t = torch.tensor([1.0 if flag else 0.0], device=self._flag_device())
        return bool(self.all_reduce_sum(t).item() > 0)

    def _flag_device(self) -> torch.device:
        return self.device if self.backend == "nccl" else torch.device("cpu")

    def sum_counts(self, count: torch.Tensor) -> torch.Tensor:
        """The global value of a count (or any sum) over the data groups'
        rows, without gradient; the count itself where no other data group
        holds rows."""
        if not self.distributed:
            return count
        return self.all_reduce_sum(count.detach().clone(), "data")

    def all_gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """[data_size * L, ...]: every data group's `x` [L, ...] in data
        order, on every rank (this rank's rows placed at data_rank * L in a
        zeroed buffer, then summed over the data group); `x` itself where
        no other data group holds rows. No gradient."""
        if not self.distributed:
            return x
        L = x.shape[0]
        buf = torch.zeros((self.data_size * L,) + tuple(x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        buf[self.data_rank * L:(self.data_rank + 1) * L] = x.detach()
        return self.all_reduce_sum(buf, "data")

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """`all_gather_rows` with a gradient (GatherRows)."""
        if not self.distributed:
            return x
        return GatherRows.apply(x, self)

    def broadcast_module(self, module: torch.nn.Module) -> None:
        """Data index 0's parameters and buffers on every rank of each data
        group (under tensor parallelism each model index broadcasts its own
        shard)."""
        if not self.group:
            return
        src = self.model_rank if self.n_model > 1 else 0
        with torch.no_grad():
            for t in list(module.parameters()) + list(module.buffers()):
                self.broadcast(t.data, src, "data")

    def close(self) -> None:
        """Leave the process group (every rank calls it)."""
        if self.group and tdist.is_initialized():
            tdist.destroy_process_group()
        self.group = False


class GatherRows(torch.autograd.Function):
    """`World.all_gather_rows` with a backward: the incoming gradient of
    the gathered rows summed over the ranks, of which this rank keeps its
    own rows."""

    @staticmethod
    def forward(ctx, x, world: World):
        ctx.world = world
        return world.all_gather_rows(x)

    @staticmethod
    def backward(ctx, grad):
        world = ctx.world
        g = grad.float().contiguous().clone()
        world.all_reduce_sum(g, "data")
        L = g.shape[0] // world.data_size
        return g[world.data_rank * L:(world.data_rank + 1) * L].to(grad.dtype), None


# ------------------------------------------------------ the model axis

class _CopyToModel(torch.autograd.Function):
    """Identity forward; the gradient summed over the model group (each
    model rank holds the part of it that its shard of the next layer
    sends back)."""

    @staticmethod
    def forward(ctx, x, world: World):
        ctx.world = world
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.world.all_reduce_sum(grad.contiguous().clone(), "model"), None


class _ReduceFromModel(torch.autograd.Function):
    """The partial sums of the model ranks summed over the model group;
    identity backward (every model rank needs the whole gradient)."""

    @staticmethod
    def forward(ctx, x, world: World):
        return world.all_reduce_sum(x.contiguous().clone(), "model")

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFromModel(torch.autograd.Function):
    """Every model rank's column slice of `x` [..., n] gathered into the
    full [..., n * n_model] on each rank (placed in a zeroed buffer and
    summed over the model group: exact in any type). Backward: each model
    rank's copy of the gathered tensor feeds only its own part of the
    model, so the gradient of the one gathered tensor is the sum of the
    ranks' incoming gradients, of which this rank keeps its columns."""

    @staticmethod
    def forward(ctx, x, world: World):
        ctx.world = world
        n = x.shape[-1]
        buf = x.new_zeros(tuple(x.shape[:-1]) + (n * world.n_model,))
        buf[..., world.model_rank * n:(world.model_rank + 1) * n] = x
        return world.all_reduce_sum(buf, "model")

    @staticmethod
    def backward(ctx, grad):
        world = ctx.world
        g = world.all_reduce_sum(grad.contiguous().clone(), "model")
        n = g.shape[-1] // world.n_model
        return g[..., world.model_rank * n:(world.model_rank + 1) * n], None


def model_world(n_model: int, world: Optional[World] = None) -> World:
    """`world`, else the active world; it must have the `n_model` model
    ranks a sharded layer was split over (train/mesh.py `shard_model`)."""
    world = world or current()
    if world.n_model != n_model:
        raise ValueError(f"a layer sharded over {n_model} model ranks runs in a world of "
                         f"{world.n_model} (pass the trainer's world to the forward)")
    return world


def copy_to_model(x: torch.Tensor, n_model: int, world: Optional[World] = None) -> torch.Tensor:
    """`x`, replicated on the model ranks, as it enters a layer sharded over
    `n_model` of them (_CopyToModel); `x` itself where n_model is 1.
    `world`: where no world is active (a recompute in the backward), the
    one the forward ran in."""
    if n_model == 1:
        return x
    return _CopyToModel.apply(x, model_world(n_model, world))


def reduce_from_model(x: torch.Tensor, n_model: int,
                      world: Optional[World] = None) -> torch.Tensor:
    """The sum over the `n_model` model ranks of their partial `x`
    (_ReduceFromModel); `x` itself where n_model is 1."""
    if n_model == 1:
        return x
    return _ReduceFromModel.apply(x, model_world(n_model, world))


def gather_from_model(x: torch.Tensor, n_model: int,
                      world: Optional[World] = None) -> torch.Tensor:
    """The full last dim of a column-parallel output `x` (_GatherFromModel)
    on every one of the `n_model` model ranks: where a layer's heads do not
    divide n_model, each rank runs every head on the gathered Q/K/V;
    `x` itself where n_model is 1."""
    if n_model == 1:
        return x
    return _GatherFromModel.apply(x, model_world(n_model, world))


def model_max(x: torch.Tensor, n_model: int, world: Optional[World] = None) -> torch.Tensor:
    """The elementwise max of `x` over the `n_model` model ranks, without
    gradient."""
    if n_model == 1:
        return x.detach()
    return model_world(n_model, world).all_reduce_max(x.detach().clone(), "model")


# --------------------------------------------------- the active world

_ONE = World()
_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("k3m_world", default=None)
_STACKED: contextvars.ContextVar = contextvars.ContextVar("k3m_stacked", default=1)


@contextlib.contextmanager
def use(world: Optional[World], rows: int):
    """Make `world` the one the enclosed forward reads (`current()`), with
    `rows` this rank's batch rows in it (the dim-0 contract, `window`).
    None: the batch is the global one."""
    token = _ACTIVE.set((world or _ONE, int(rows)))
    try:
        yield world
    finally:
        _ACTIVE.reset(token)


@contextlib.contextmanager
def pair_rows(rows: int):
    """The rows of `in_batch_pairs` (k3m_tpu/model/encoder.py:122-129) for
    the enclosed code: the global pairs are B x B rows, row i * B + j
    pairing text row i with row j of the other stream (B the global
    batch), and this rank holds the pairs of its own text rows, which are
    rows data_rank * `rows` .. of them in data order, `rows` = its batch
    rows times B. `window` then reads dim 0 as those pair rows."""
    active = _ACTIVE.get()
    if active is None:
        yield
        return
    token = _ACTIVE.set((active[0], int(rows)))
    try:
        yield
    finally:
        _ACTIVE.reset(token)


@contextlib.contextmanager
def stacked(copies: int):
    """The image rows of `packed_passes` (k3m_tpu/model/encoder.py:199-202)
    for the enclosed code: a tensor whose dim 0 is `copies` copies of this
    rank's batch rows, one after another, is read as copy h's row b at
    global row h * G + row0 + b (G the global batch rows, row0 this rank's
    first), so that N ranks draw for each copy what one process draws for
    it (`windows`). The batch rows themselves keep their window."""
    token = _STACKED.set(int(copies))
    try:
        yield
    finally:
        _STACKED.reset(token)


def current() -> World:
    """The active world; a world of one where none is active."""
    active = _ACTIVE.get()
    return _ONE if active is None else active[0]


def windows(rows: int) -> Tuple[List[Tuple[int, int]], int]:
    """([(first global row, rows), ...], global rows) for a tensor whose dim
    0 is this rank's `rows` batch rows, laid out in data order (one slice),
    or, under `stacked(k)`, k copies of them (one slice per copy, adjacent
    slices merged: one slice in a world of one data rank). Raises for any
    other leading size."""
    active = _ACTIVE.get()
    if active is None:
        return [(0, rows)], rows
    world, batch = active
    copies = _STACKED.get()
    row0, total = world.data_rank * batch, world.data_size * batch
    if rows == batch:
        return [(row0, rows)], total
    if copies > 1 and rows == copies * batch:
        if world.data_size == 1:
            return [(0, rows)], rows
        return [(h * total + row0, batch) for h in range(copies)], copies * total
    raise ValueError(f"dim 0 of {rows} rows is not this rank's batch of {batch} "
                     "rows: a draw or gather over the batch needs the batch "
                     "on dim 0 (k3m_tpu_torch/dist.py)")


def window(rows: int) -> Tuple[int, int]:
    """(first global row of this rank, global rows) for a tensor whose dim
    0 is this rank's `rows` batch rows, laid out in data order. Raises if
    `rows` is not the batch rows that `use` made active, or is copies of
    them (`stacked`) that are not one slice of the global rows."""
    spans, total = windows(rows)
    if len(spans) != 1:
        raise ValueError(f"dim 0 of {rows} rows holds {len(spans)} copies of the batch, "
                         "which are not one slice of the global rows (dist.windows)")
    return spans[0][0], total
