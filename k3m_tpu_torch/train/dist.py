"""Launching a world of processes, and the trainer's collectives.

The counterpart of the JAX package's `maybe_init_distributed`
(k3m_tpu/utils/jax_setup.py:29-69): `init_from_env` joins the process
group a launcher configured (torchrun's variables or the JAX package's
K3M_* ones) and returns its `World` (k3m_tpu_torch/dist.py, which holds
the global-batch semantics the model reads). `all_reduce_grads` sums a
step's gradients over the ranks, "the gradients all-reduced by XLA" of
k3m_tpu/train/mesh.py:1-17: each rank's loss is already its share of the
global batch's, so the sum is the one-process gradient.

The backend is NCCL for CUDA devices and gloo for the CPU.
`K3M_DIST_BACKEND=gloo` lets several ranks share one card (NCCL refuses
two ranks on one device).
"""

from __future__ import annotations

import datetime
import os
from typing import Iterable, List, Optional

import torch
import torch.distributed as tdist

from k3m_tpu_torch.dist import World

# fp32 elements per bucket of the gradient all-reduce (256 MiB)
BUCKET_ELEMENTS = 64 * 2 ** 20
DEFAULT_TIMEOUT_S = 1800


# ---------------------------------------------------------------- world

def init_world(rank: int, size: int, init_method: str, device="cuda",
               backend: Optional[str] = None,
               timeout_s: float = DEFAULT_TIMEOUT_S, n_model: int = 1) -> World:
    """Join the process group of `size` ranks at `init_method` (tcp://,
    file:// or env://) as `rank`. `device`: "cpu", or a CUDA device
    (cuda:LOCAL_RANK, which must exist). The backend is NCCL for a CUDA
    device and gloo for the CPU, unless `backend` names one. `n_model` > 1
    lays the ranks out as `size // n_model` data groups of `n_model`
    consecutive model ranks (k3m_tpu/train/mesh.py:30-38) and makes both
    kinds of sub-group; it must divide `size`."""
    if n_model < 1 or size % n_model:
        raise ValueError(f"--n_model {n_model} does not divide the world of {size} processes")
    dev = torch.device(device)
    if dev.type == "cuda":
        index = 0 if dev.index is None else dev.index
        if not torch.cuda.is_available() or index >= torch.cuda.device_count():
            raise RuntimeError(f"rank {rank}: no CUDA device {index} for this rank "
                               f"({torch.cuda.device_count()} visible); pass "
                               "--device cpu to run on the CPU")
        dev = torch.device("cuda", index)
        torch.cuda.set_device(dev)
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the nccl backend needs a CUDA device")
    kw = dict(device_id=dev) if backend == "nccl" else {}
    timeout = datetime.timedelta(seconds=timeout_s)
    tdist.init_process_group(backend, init_method=init_method, rank=rank,
                             world_size=size, timeout=timeout, **kw)
    world = World(rank=rank, size=size, device=dev, backend=backend, group=True,
                  n_model=n_model)
    if n_model > 1:
        # every rank makes every group, in the same order (new_group's contract)
        for m in range(n_model):
            g = tdist.new_group(list(range(m, size, n_model)), timeout=timeout)
            if m == world.model_rank:
                world.data_group = g
        for d in range(size // n_model):
            g = tdist.new_group(list(range(d * n_model, (d + 1) * n_model)), timeout=timeout)
            if d == world.data_rank:
                world.model_group = g
    return world


def init_from_env(device="cuda", n_model: int = 1) -> World:
    """The world a launcher configured, else a world of one on `device`;
    `n_model` model ranks in each data group (init_world).

    torchrun: RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT. The
    JAX package's variables: K3M_COORDINATOR_ADDRESS (host:port of rank 0,
    or an init URL such as file:///path), K3M_NUM_PROCESSES,
    K3M_PROCESS_ID; LOCAL_RANK where set, else 0 (one process per host).
    K3M_DIST_INIT_TIMEOUT: seconds for the group's setup and each
    collective (default 1800). K3M_DIST_BACKEND: nccl or gloo (gloo lets
    ranks share one card). A CUDA `device` becomes cuda:LOCAL_RANK."""
    env = os.environ
    if env.get("K3M_COORDINATOR_ADDRESS"):
        addr = env["K3M_COORDINATOR_ADDRESS"]
        init_method = addr if "://" in addr else f"tcp://{addr}"
        rank, size = int(env["K3M_PROCESS_ID"]), int(env["K3M_NUM_PROCESSES"])
    elif env.get("WORLD_SIZE"):
        missing = [k for k in ("RANK", "MASTER_ADDR", "MASTER_PORT") if not env.get(k)]
        if missing:
            raise ValueError(f"WORLD_SIZE is set but {', '.join(missing)} is not "
                             "(launch with torchrun, or set the K3M_* variables)")
        init_method = "env://"
        rank, size = int(env["RANK"]), int(env["WORLD_SIZE"])
    else:
        from k3m_tpu_torch.device import resolve_device
        return World(device=resolve_device(device), n_model=n_model)
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", int(env.get("LOCAL_RANK", "0")))
    timeout = float(env.get("K3M_DIST_INIT_TIMEOUT") or DEFAULT_TIMEOUT_S)
    return init_world(rank, size, init_method, dev, env.get("K3M_DIST_BACKEND") or None,
                      timeout, n_model)


# ------------------------------------------------- the gradients

def all_reduce_grads(world: World, params: Iterable[torch.nn.Parameter]) -> int:
    """Sum the gradients over the rank's data group (the whole world where
    n_model is 1), in place, in flat fp32 buckets of at most
    BUCKET_ELEMENTS; returns the bytes one rank sends into the
    all-reduces. A parameter without a gradient takes zeros first, so that
    every rank reduces the same buckets. Under tensor parallelism each
    model rank sums its own shard over its data group; the model group's
    conjugate collectives made a replicated parameter's gradient whole on
    each of its ranks, and those gradients are then averaged over the
    model group: equal in exact arithmetic, they differ by the rounding of
    atomics in the backward (the embedding gradients' on the card), which
    would otherwise let the ranks' copies of a replicated weight drift
    apart step by step (`shard_model` marks the split parameters
    `tp_split`)."""
    if not world.group:
        return 0
    params = list(params)
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    nbytes = 0
    if world.n_model == 1 or world.data_size > 1:
        nbytes += _all_reduce_buckets(world, [p.grad for p in params], "data")
    if world.n_model > 1:
        nbytes += _all_reduce_buckets(
            world, [p.grad for p in params if not getattr(p, "tp_split", False)], "model",
            1.0 / world.n_model)
    return nbytes


def _all_reduce_buckets(world: World, grads: List[torch.Tensor], axis: str,
                        scale: float = 1.0) -> int:
    """Sum `grads` over `axis`, times `scale`, in buckets of at most
    BUCKET_ELEMENTS; returns the bytes."""
    nbytes, bucket, n = 0, [], 0
    for g in grads:
        if bucket and n + g.numel() > BUCKET_ELEMENTS:
            nbytes += _all_reduce_flat(world, bucket, axis, scale)
            bucket, n = [], 0
        bucket.append(g)
        n += g.numel()
    if bucket:
        nbytes += _all_reduce_flat(world, bucket, axis, scale)
    return nbytes


def _all_reduce_flat(world: World, tensors: List[torch.Tensor], axis: str,
                     scale: float) -> int:
    """Sum `tensors` over `axis` through one flat fp32 buffer, times
    `scale`; returns its bytes."""
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    world.all_reduce_sum(flat, axis)
    if scale != 1.0:
        flat.mul_(scale)
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()
    return flat.numel() * flat.element_size()
