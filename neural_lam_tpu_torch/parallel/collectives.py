"""The collectives of the sharded schemes, with the gradients the JAX
package's `shard_map` gives them.

The grid scheme (`grid_sharded.py`) runs one model on the `space` ranks
of a data group: each rank holds a block of the grid and a part of every
edge set, mesh node state is replicated, and the full prediction is
gathered onto every rank, where the loss is computed. In JAX this is a
`shard_map` body with `check_vma=False` (grid_sharded.py:463-475 of the
JAX package); its transpose decides the gradients:

* `psum` of a partial aggregation transposes to a `psum`;
* an output sharded over `space` (the prediction) hands each shard its
  own block of the cotangent;
* an output replicated over `space` (a latent model's KL) hands each
  shard its cotangent divided by the number of shards;
* the replicated parameters' cotangents are summed over the shards.

Inside a rank, the cotangent of a replicated tensor is then that rank's
share of the true cotangent, and the shares sum to it over the group:
`psum`'s backward all-reduces them where a partial sum needs the whole;
`gather_blocks` passes the block the rank computed; `replicated_out`
divides a cotangent that every rank received whole. The parameter
gradients are summed over the space group (`reduce_gradients`). Either
naive choice, a backward of the gather that sums over the ranks or a
plain average of the gradients over the space group, scales some
parameter's gradient by the number of shards.

Data parallelism averages the summed gradients over the data group, as
the JAX `data` axis does (the loss is a mean over the batch).

Every collective is a plain `torch.distributed` call on the tensor's
device; with the gloo backend on CUDA tensors gloo stages them through
host memory itself. A bf16 tensor is reduced in fp32 and rounded once.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

# collectives issued by this module since the counters were last reset,
# and their payload bytes (what chip_smoke.py reports per step)
counts = {"all_reduce": 0, "all_gather": 0, "bytes": 0}


def reset_counts():
    for k in counts:
        counts[k] = 0


def _count(kind, t):
    counts[kind] += 1
    counts["bytes"] += t.numel() * t.element_size()


def all_reduce_(t, group):
    """In-place sum of `t` over `group` (a bf16 tensor summed in fp32)."""
    if t.dtype == torch.bfloat16:
        wide = t.float()
        all_reduce_(wide, group)
        t.copy_(wide)
        return t
    _count("all_reduce", t)
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group), None


def psum(x, group):
    """Sum of the ranks' partial tensors over `group`; identity for None.
    Backward: the cotangent all-reduced (JAX: psum transposes to psum)."""
    if group is None:
        return x
    return _PSum.apply(x, group)


class _GatherBlocks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        n = dist.get_world_size(group)
        ctx.rank, ctx.dim, ctx.block = (dist.get_rank(group), dim,
                                        x.shape[dim])
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(n)]
        _count("all_gather", x)
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.rank * ctx.block, ctx.block), None, None


def gather_blocks(x, group, dim):
    """The ranks' equal blocks of `x` along `dim`, concatenated in rank
    order over `group`; identity for None. Backward: this rank's block of
    the cotangent (JAX: an output sharded over the axis)."""
    if group is None:
        return x
    return _GatherBlocks.apply(x, group, dim)


class _ReplicatedOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, n):
        ctx.n = n
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


def replicated_out(x, group):
    """`x`, computed alike on every rank of `group`, leaving the sharded
    region; its cotangent is divided by the group's size (JAX: an output
    replicated over the axis). Identity for None."""
    if group is None:
        return x
    return _ReplicatedOut.apply(x, dist.get_world_size(group))


def reduce_gradients(params, group, n_data):
    """After backward: each parameter's gradient summed over `group` (the
    whole world: the space ranks' shares add up, then divided by `n_data`,
    the data ranks' gradients averaged), in one all-reduce of a flat
    buffer. A parameter without a gradient keeps none (every rank runs
    the same operations, so the same parameters have gradients on every
    rank), and the optimizer skips it as in a single process."""
    params = [p for p in params if p.grad is not None]
    if group is None or not params:
        return
    flat = torch.cat([p.grad.reshape(-1).float() for p in params])
    all_reduce_(flat, group)
    if n_data > 1:
        flat /= n_data
    offset = 0
    for p in params:
        n = p.numel()
        p.grad.copy_(flat[offset:offset + n].view_as(p.grad))
        offset += n
