"""Data parallelism on ``torch.distributed`` (port of
``puzzlefusion_plusplus_tpu/parallel/mesh.py``).

The JAX package shards the leading dimension of a *global* batch over a ``data`` mesh and
replicates parameters and optimizer state; its jitted step is written over the global batch,
so every masked mean, the batch statistics, the quantizer's perplexity, the verifier's
precision and recall and the gradient are those of the global batch. The port keeps that
meaning with one process a rank (``parallel/launch.py``):

* every rank builds the same global batch and keeps its rows (``shard_batch``);
* a mean over the batch is a local sum over a global count: the count comes from
  ``global_sum`` (no gradient), the sum stays local, so that the ranks' losses add up to the
  global loss; a statistic that the forward pass needs whole (MaskedBatchNorm's mean and
  variance) goes through ``all_reduce_sum``, whose backward all-reduces the gradient;
* after ``backward`` the ranks **sum** their gradients (``all_reduce_gradients``): the sum
  of the ranks' gradients of their shares is the gradient of the global loss. DDP's default,
  each rank's own mean averaged over the ranks, differs whenever the ranks hold different
  numbers of valid parts or edges;
* parameters and buffers start equal (``replicate``) and stay equal, since every rank takes
  the same optimizer step on the same summed gradient.

Every function here works on the default process group (the reductions also on a given
``group``, such as the dry run's data axis) and is the identity (no collective) when no
group of more than one rank exists, so the one-process path runs unchanged. The model layer
reduces only over a group it is handed (``data_group``), so a model run on some ranks alone
(an evaluation on rank 0) computes its own batch's statistics.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from puzzlefusion_plusplus_tpu_torch.utils import profiling


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world(group=None) -> int:
    """Ranks in ``group`` (the default group), 1 outside a process group."""
    return dist.get_world_size(group) if initialized() else 1


def rank() -> int:
    return dist.get_rank() if initialized() else 0


def is_main() -> bool:
    """Rank 0 of the default group, the rank that writes files."""
    return rank() == 0


def data_group():
    """The group a data-parallel trainer reduces its batch statistics over: the default
    group where it has more than one rank, else None (this process's batch alone). A model
    is handed it (``models/vqvae.py::VQVAE.reduce_over``) and never looks for a group."""
    return dist.group.WORLD if world() > 1 else None


def barrier() -> None:
    if world() > 1:
        dist.barrier()


def world_size(num_devices: int, device, batch_size: int | None = None) -> int:
    """The data-parallel world size that ``trainer.num_devices`` asks for on ``device``.

    -1 means every visible card on ``cuda`` and one process on the CPU; on the CPU any
    positive count runs that many processes. Asking for more cards than are visible raises
    (the JAX module would shrink the mesh without a word). Inside a process group the group's
    size is the answer, and ``num_devices`` must be -1 or equal to it. A ``batch_size`` that
    the world size does not divide raises, as ``shard_batch`` would."""
    device = torch.device(device)
    if initialized():
        w = world()
        if num_devices not in (-1, w):
            raise ValueError(f"trainer.num_devices={num_devices} inside a process group of "
                             f"{w} ranks")
    elif num_devices == -1:
        w = torch.cuda.device_count() if device.type == "cuda" else 1
    elif num_devices < 1:
        raise ValueError(f"trainer.num_devices={num_devices}: must be -1 or positive")
    elif device.type == "cuda" and num_devices > torch.cuda.device_count():
        raise ValueError(f"trainer.num_devices={num_devices} but only "
                         f"{torch.cuda.device_count()} CUDA devices are visible")
    else:
        w = num_devices
    if batch_size is not None and batch_size % w:
        raise ValueError(f"batch size {batch_size} is not divisible by the world size {w}")
    return w


def shard_batch(batch: dict, rank: int, world: int) -> dict:
    """This rank's rows of a global batch: every array's leading dimension is cut into
    ``world`` equal blocks (lists, such as file paths, too); a size the world does not
    divide raises ValueError (pad first with ``pad_batch_to_devices``)."""
    if world == 1:
        return batch
    out = {}
    for k, v in batch.items():
        n = len(v)
        if n % world:
            raise ValueError(f"batch dim {n} of {k!r} is not divisible by {world} ranks")
        per = n // world
        out[k] = v[rank * per:(rank + 1) * per]
    return out


def pad_batch_to_devices(batch: dict, n_devices: int) -> tuple[dict, int]:
    """Pad a possibly-ragged final batch up to a multiple of ``n_devices``.

    Returns (padded batch, real count). Padding repeats row 0; callers mask metrics by count.
    (A copy of the JAX package's numpy function.)"""
    sizes = {x.shape[0] for x in batch.values()}
    assert len(sizes) == 1, f"inconsistent batch dims {sizes}"
    n = sizes.pop()
    pad = (-n) % n_devices
    if pad == 0:
        return batch, n
    padded = {k: np.concatenate([x, np.repeat(x[:1], pad, axis=0)], axis=0)
              for k, x in batch.items()}
    return padded, n


def replicate(module: torch.nn.Module) -> torch.nn.Module:
    """Broadcast ``module``'s parameters and buffers from rank 0, one flattened bucket per
    dtype."""
    if world() == 1:
        return module
    tensors = [t.data for t in (*module.parameters(), *module.buffers())]
    # dtypes in order of first appearance: a set's order differs between processes, and the
    # ranks' broadcasts must come in one order
    for dtype in dict.fromkeys(t.dtype for t in tensors):
        same = [t for t in tensors if t.dtype == dtype]
        flat = _flatten_dense_tensors(same)
        dist.broadcast(flat, 0)
        for t, v in zip(same, _unflatten_dense_tensors(flat, same)):
            t.copy_(v)
    return module


@torch.no_grad()
def all_reduce_gradients(model: torch.nn.Module, group=None) -> None:
    """Sum every gradient over the ranks in one flattened bucket. Each rank's loss is its
    share of the global loss, so the sum is the global loss's gradient. A DTensor
    parameter's gradient is summed shard by shard."""
    if world(group) == 1:
        return
    with profiling.span("pfpp.train.allreduce"):
        grads = [p.grad for p in model.parameters() if p.grad is not None]
        local = [g.to_local() if hasattr(g, "to_local") else g for g in grads]
        flat = _flatten_dense_tensors(local)
        dist.all_reduce(flat, group=group)
        for g, v in zip(local, _unflatten_dense_tensors(flat, local)):
            g.copy_(v)


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks; the backward sums the incoming gradients over the ranks, since
    every rank's output feeds every rank's loss."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """Differentiable sum of ``x`` over the ranks (``x`` itself on one rank)."""
    return x if world(group) == 1 else _AllReduceSum.apply(x, group)


@torch.no_grad()
def global_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """Sum of ``x`` over the ranks, without a gradient: the global count of a masked mean."""
    if world(group) == 1:
        return x
    out = x.detach().clone()
    dist.all_reduce(out, group=group)
    return out


@torch.no_grad()
def global_sums(values: dict, group=None) -> dict:
    """Sum every scalar of ``values`` over the ranks in one all-reduce."""
    if world(group) == 1:
        return values
    keys = list(values)
    flat = torch.stack([values[k].detach().float().reshape(()) for k in keys])
    dist.all_reduce(flat, group=group)
    return dict(zip(keys, flat.unbind()))


def all_ranks(flag: bool) -> bool:
    """``flag`` holds on every rank (a MIN all-reduce)."""
    if world() == 1:
        return flag
    t = torch.tensor([int(flag)], device="cuda" if dist.get_backend() == "nccl" else "cpu")
    dist.all_reduce(t, op=dist.ReduceOp.MIN)
    return bool(t.item())


def gather_rows(results: dict, n_real: int) -> dict:
    """Every rank's numpy result arrays, concatenated in rank (row) order and cut to the
    first ``n_real`` rows (the rest repeat row 0, ``pad_batch_to_devices``)."""
    if world() == 1:
        return {k: np.asarray(v)[:n_real] for k, v in results.items()}
    parts: list = [None] * world()
    dist.all_gather_object(parts, results)
    return {k: np.concatenate([np.asarray(p[k]) for p in parts])[:n_real] for k in results}


def seed_ranks(seed: int) -> None:
    """Seed the global RNG (dropout) with ``seed`` plus the rank inside a process group of
    several ranks, so that the ranks draw different dropout masks."""
    if world() > 1:
        torch.manual_seed(seed + rank())
