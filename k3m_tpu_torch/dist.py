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
rows flattened with positions) cannot be taken for the batch. With no
world active, or a world of one, the model runs the one-process code and
keeps its numbers bit for bit.

Every collective is an `all_reduce` or a `broadcast`, which both backends
carry: NCCL for CUDA devices, gloo for the CPU. Under gloo (which lets
several ranks share one card, train/dist.py) the helpers always copy CUDA
tensors to a host buffer and back.
"""

from __future__ import annotations

import contextlib
import contextvars
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.distributed as tdist


@dataclass
class World:
    """One rank of a world of `size` processes. `group` is False for the
    world of one that no launcher configured: no process group, and every
    collective is the identity."""
    rank: int = 0
    size: int = 1
    device: torch.device = torch.device("cpu")
    backend: Optional[str] = None
    group: bool = False

    # ------------------------------------------------------------ layout

    @property
    def distributed(self) -> bool:
        """Whether other ranks hold rows of the global batch."""
        return self.size > 1

    def local_rows(self, global_rows: int, what: str) -> int:
        """A rank's rows of a global batch, which the ranks split evenly
        (root pretrain.py:168-172); raises if it does not divide."""
        if global_rows % self.size:
            raise ValueError(f"{what} {global_rows} not divisible by the {self.size} "
                             "processes")
        return global_rows // self.size

    # ------------------------------------------------------- collectives

    def _reduce(self, t: torch.Tensor, op) -> torch.Tensor:
        """`op(buffer)` on `t` in place, through a host copy under gloo,
        in fp32 for 16-bit floats (the sum of a row and zeros is exact in
        any type; gradients are summed in fp32)."""
        buf = t.float() if t.dtype in (torch.bfloat16, torch.float16) else t
        if self.backend == "gloo" and buf.is_cuda:
            buf = buf.cpu()
        op(buf)
        if buf is not t:
            t.copy_(buf)
        return t

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """Sum `t` over the ranks, in place; returns `t`."""
        if not self.group:
            return t
        return self._reduce(t, lambda b: tdist.all_reduce(b, op=tdist.ReduceOp.SUM))

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank `src`'s `t` on every rank, in place; returns `t`."""
        if not self.group:
            return t
        return self._reduce(t, lambda b: tdist.broadcast(b, src=src))

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
        """The global value of a count (or any sum) over the ranks' rows,
        without gradient; the count itself where no other rank holds rows."""
        if not self.distributed:
            return count
        return self.all_reduce_sum(count.detach().clone())

    def all_gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """[size * L, ...]: every rank's `x` [L, ...] in rank order, on
        every rank (this rank's rows placed at rank * L in a zeroed buffer,
        then summed over the ranks); `x` itself in a world of one. No
        gradient."""
        if not self.distributed:
            return x
        L = x.shape[0]
        buf = torch.zeros((self.size * L,) + tuple(x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        buf[self.rank * L:(self.rank + 1) * L] = x.detach()
        return self.all_reduce_sum(buf)

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """`all_gather_rows` with a gradient (GatherRows)."""
        if not self.distributed:
            return x
        return GatherRows.apply(x, self)

    def broadcast_module(self, module: torch.nn.Module, src: int = 0) -> None:
        """Rank `src`'s parameters and buffers on every rank."""
        if not self.group:
            return
        with torch.no_grad():
            for t in list(module.parameters()) + list(module.buffers()):
                self.broadcast(t.data, src)

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
        world.all_reduce_sum(g)
        L = g.shape[0] // world.size
        return g[world.rank * L:(world.rank + 1) * L].to(grad.dtype), None


# --------------------------------------------------- the active world

_ONE = World()
_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("k3m_world", default=None)


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


def current() -> World:
    """The active world; a world of one where none is active."""
    active = _ACTIVE.get()
    return _ONE if active is None else active[0]


def window(rows: int) -> Tuple[int, int]:
    """(first global row of this rank, global rows) for a tensor whose dim
    0 is this rank's `rows` batch rows, laid out in rank order. Raises if
    `rows` is not the batch rows that `use` made active."""
    active = _ACTIVE.get()
    if active is None:
        return 0, rows
    world, batch = active
    if rows != batch:
        raise ValueError(f"dim 0 of {rows} rows is not this rank's batch of {batch} "
                         "rows: a draw or gather over the batch needs the batch "
                         "on dim 0 (k3m_tpu_torch/dist.py)")
    return world.rank * rows, world.size * rows
