"""The ('data', 'space') layout of the world's ranks, and the placement
helpers.

Counterpart of neural_lam_tpu/parallel/mesh.py. A JAX mesh is a grid of
devices with named axes; here a `Mesh` is the world's ranks laid out as
n_data x n_space, rank = data_index * n_space + space_index, with a
torch.distributed group along each axis: `space_group` (the n_space
consecutive ranks that shard one model's grid, `grid_sharded.py`) and
`data_group` (the ranks of one space index, which split the batches and
average gradients). In a single process every group is None and every
helper is the identity.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from . import distributed


@dataclasses.dataclass(frozen=True)
class Mesh:
    n_data: int
    n_space: int
    data_index: int
    space_index: int
    space_group: object = None  # None when n_space == 1
    data_group: object = None  # None when n_data == 1
    host_data_group: object = None  # gloo twin of data_group
    world_group: object = None  # None in a single process (no world)


_MESHES: dict = {}


def make_mesh(n_data: int | None = None, n_space: int = 1) -> Mesh:
    """The mesh over every rank of the world (n_data defaults to the
    world's size over n_space). Its groups are made once per shape, by
    every rank in the same order (`torch.distributed.new_group` is
    collective): call it on every rank."""
    w = distributed.world()
    size, rank = (w.size, w.rank) if w is not None else (1, 0)
    if n_data is None:
        n_data = size // n_space
    if n_data * n_space != size:
        raise ValueError(
            f"a mesh of {n_data} x {n_space} ranks needs a world of "
            f"{n_data * n_space} processes; this one has {size}")
    key = (n_data, n_space)
    if key in _MESHES:
        return _MESHES[key]
    space_group = data_group = host_data_group = world_group = None
    if w is not None:
        # a world of one rank too: its collectives run on its backend
        world_group = dist.group.WORLD
    if size > 1:
        for d in range(n_data):
            ranks = list(range(d * n_space, (d + 1) * n_space))
            if n_space > 1:
                g = dist.new_group(ranks)
                if rank in ranks:
                    space_group = g
        for s in range(n_space):
            ranks = list(range(s, size, n_space))
            if n_data > 1:
                g = dist.new_group(ranks)
                hg = (g if w.backend == "gloo"
                      else dist.new_group(ranks, backend="gloo"))
                if rank in ranks:
                    data_group, host_data_group = g, hg
    mesh = Mesh(n_data=n_data, n_space=n_space,
                data_index=rank // n_space, space_index=rank % n_space,
                space_group=space_group, data_group=data_group,
                host_data_group=host_data_group, world_group=world_group)
    _MESHES[key] = mesh
    return mesh


def grid_block(x, mesh: Mesh, num_grid: int, dim: int = -2):
    """This rank's block of the grid axis `dim` of `x`, the grid padded
    with zeros to n_space equal blocks of ceil(num_grid / n_space) rows."""
    block = -(-num_grid // mesh.n_space)
    lo = mesh.space_index * block
    hi = min(lo + block, num_grid)
    part = x.narrow(dim, lo, max(hi - lo, 0))
    pad = block - part.shape[dim]
    if pad:
        shape = list(part.shape)
        shape[dim] = pad
        part = torch.cat([part, part.new_zeros(shape)], dim=dim)
    return part


def replicate(model, mesh: Mesh, optimizer=None):
    """Rank 0's parameters (and buffers, and the optimizer's state
    tensors) on every rank, broadcast over the world, so every rank starts
    from the same values. Identity in a single process."""
    if mesh.world_group is None:
        return model
    tensors = [p.data for p in model.parameters()]
    tensors += list(model.buffers())
    if optimizer is not None:
        for state in optimizer.state.values():
            tensors += [v for v in state.values()
                        if isinstance(v, torch.Tensor)]
    host = distributed.world().host_group
    for t in tensors:
        # the nccl backend takes device tensors only (AdamW keeps its step
        # count on the host)
        dist.broadcast(t, src=0, group=host if t.device.type == "cpu"
                       else mesh.world_group)
    return model
