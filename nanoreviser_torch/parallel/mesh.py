"""The data-parallel mesh: one process per card, joined by a process group.

Counterpart of ``nanoreviser_tpu/parallel/mesh.py``. The JAX package
builds a 1-D device mesh with axis "dp" and lets XLA insert the gradient
psum. Here the axis is the processes of a ``torch.distributed`` group,
each driving one device, and the training step reduces explicitly
(``models/layers.py`` for the BN moments, ``train/step.py`` for the
gradients). ``batch_sharding`` and ``replicated_sharding`` have no
counterpart: a process holds its slice of every batch
(``dist.local_batch_slice``) and a full replica of the parameters.

On the CPU, processes on one host split its cores: each runs torch on
its share of the usable CPUs.

Backend. Every process joins the gloo group of ``dist.initialize``
first. ``make_mesh`` then gathers each process's (host, device) over it
and takes NCCL when the pairs are all distinct and the device is a card,
gloo otherwise: NCCL refuses two ranks on one device, and several
processes sharing one card is what a one-card machine allows. Every rank
sees the same pairs, so every rank decides the same.
"""

from __future__ import annotations

import os
import socket
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class Mesh:
    """This process's place on the ``dp`` axis. ``group`` is None when the
    world is one process (nothing to reduce)."""

    group: object
    rank: int
    world: int
    device: torch.device
    backend: str | None

    @property
    def distributed(self) -> bool:
        return self.world > 1


class _AllReduceSum(torch.autograd.Function):
    """Sum over the group; its backward sums the incoming gradients the
    same way, so that every process's backward is the global one's."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist

        ctx.group = group
        x = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        import torch.distributed as dist

        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(x: torch.Tensor, mesh: "Mesh") -> torch.Tensor:
    """Differentiable sum of ``x`` over the mesh's processes (what
    ``torch.distributed.nn.functional.all_reduce`` computes; that function
    is deprecated in recent torch)."""
    return _AllReduceSum.apply(x, mesh.group)


def choose_backend(pairs: list, device_type: str) -> str:
    """"nccl" when the device is a card and no two processes share a
    (host, device) pair, else "gloo"."""
    if device_type == "cuda" and len(set(pairs)) == len(pairs):
        return "nccl"
    return "gloo"


def _resolve(device, rank: int) -> torch.device:
    """None means the card: process k takes cuda:(k % device count)."""
    from ..train.loop import resolve_device

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None and torch.cuda.is_available():
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    dev = resolve_device(dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return dev


def make_mesh(device=None) -> Mesh:
    """The ``dp`` mesh of this process. Multi-process runs call
    ``dist.initialize`` first; without it the mesh is this process alone."""
    import torch.distributed as dist

    from ..dist import process_info

    rank, world = process_info()
    dev = _resolve(device, rank)
    if world == 1:
        return Mesh(None, 0, 1, dev, None)
    pairs: list = [None] * world
    dist.all_gather_object(pairs, (socket.gethostname(), str(dev)))
    if dev.type == "cpu":
        # processes that share a host's CPUs share its cores: oversubscribed
        # OpenMP threads spin against each other across the collectives
        # (20x slower steps with 8 threads each for two processes on 8 CPUs)
        n_local = sum(host == pairs[rank][0] for host, _ in pairs)
        share = max(1, len(os.sched_getaffinity(0)) // n_local)
        if torch.get_num_threads() > share:
            torch.set_num_threads(share)
    backend = choose_backend(pairs, dev.type)
    # new_group is collective: every rank calls it with the same backend
    group = dist.new_group(backend=backend) if backend == "nccl" else dist.group.WORLD
    return Mesh(group, rank, world, dev, backend)


def shard_params(params: dict, mesh: Mesh, dtype=torch.float32) -> dict:
    """The parameter tree (numpy or tensors) as tensors of ``dtype`` on the
    mesh's device, the trained leaves requiring grad: this process's
    replica. Every process starts from the same seed or file, so the
    replicas are equal, and the summed gradients keep them so."""
    from ..train.step import params_to_torch

    return params_to_torch(params, mesh.device, dtype)
