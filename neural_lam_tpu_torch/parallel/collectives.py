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

The mesh-node-sharded schemes (`mesh_rs`, `mesh_halo`) add three
collectives inside the body, each with the transpose JAX gives it:

* `reduce_scatter` (JAX's tiled `psum_scatter`): the ranks' partial sums
  summed, each rank keeping its block; backward, an all-gather of the
  cotangent blocks;
* `all_gather` (JAX's tiled `all_gather` inside the body): every rank's
  block, concatenated; backward, the cotangent reduce-scattered, each
  rank keeping the sum of every rank's cotangent of its block. This is
  not `gather_blocks`, whose output leaves the body and whose backward
  keeps the rank's own cotangent block: that would drop the other ranks'
  cotangents of the rows this rank sent them;
* `ppermute` (JAX's `ppermute` over the pairs (s, s + shift)): rank s
  sends to rank s + shift and receives from rank s - shift, zeros where
  there is none; backward, the inverse permutation (shift negated).

Data parallelism averages the summed gradients over the data group, as
the JAX `data` axis does (the loss is a mean over the batch).

Every collective is a plain `torch.distributed` call on the tensor's
device, except where the backend does not take a device tensor for it
(`HOST_STAGED`: gloo's point-to-point calls read CUDA pointers as host
ones): the tensor is then copied to host memory, the call is issued
there, and the result is copied back. The choice is the backend's,
fixed here, never found by catching an error; each staged call is
counted. A bf16 tensor is reduced in fp32 and rounded once; gathers and
permutations move bf16 as it is.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

KINDS = ("all_reduce", "all_gather", "reduce_scatter", "ppermute")
# collectives issued by this module since the counters were last reset,
# by kind, their payload bytes (the tensor this rank contributes: its
# partial sums, its block, the rows it sends), by kind and in all, and
# how many of them were staged through host memory (what chip_smoke.py
# reports per step)
counts = {**{k: 0 for k in KINDS}, **{f"{k}_bytes": 0 for k in KINDS},
          "bytes": 0, "host_staged": 0}

# the collectives a backend does not take on CUDA tensors, staged through
# host memory: gloo's send and recv read a CUDA tensor's device pointer as
# a host one ("Bad address"), while its all_reduce, all_gather and
# reduce_scatter_tensor take CUDA tensors (probes/torch_gloo_cuda_probe.py
# on the H100, torch 2.11)
HOST_STAGED = {"gloo": frozenset({"ppermute"})}


def reset_counts():
    for k in counts:
        counts[k] = 0


def _count(kind, t, staged=False):
    n = t.numel() * t.element_size()
    counts[kind] += 1
    counts[f"{kind}_bytes"] += n
    counts["bytes"] += n
    counts["host_staged"] += bool(staged)


def _staged(kind, t, group):
    """Whether `group`'s backend takes `t` for collective `kind` only
    through host memory."""
    return (t.device.type == "cuda"
            and kind in HOST_STAGED.get(dist.get_backend(group), ()))


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


def _all_gather(x, group, dim):
    """The ranks' equal blocks of `x` along `dim`, in rank order."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    _count("all_gather", x)
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def _reduce_scatter(x, group, dim):
    """The sum over `group` of `x`, cut into the group's equal blocks
    along `dim`: this rank's block (a bf16 tensor summed in fp32)."""
    if x.dtype == torch.bfloat16:
        return _reduce_scatter(x.float(), group, dim).to(torch.bfloat16)
    n = dist.get_world_size(group)
    x0 = x.movedim(dim, 0).contiguous()
    out = x0.new_empty((x0.shape[0] // n, *x0.shape[1:]))
    _count("reduce_scatter", x0)
    dist.reduce_scatter_tensor(out, x0, group=group)
    return out.movedim(0, dim)


def _ppermute(x, group, shift):
    """Rank s's `x` at rank s + shift, over `group`; zeros at a rank
    without a source (s - shift outside the group)."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    x = x.contiguous()
    out = torch.zeros_like(x)
    staged = _staged("ppermute", x, group)
    send, recv = (x.cpu(), out.cpu()) if staged else (x, out)
    ops = []
    if 0 <= r + shift < n:
        ops.append(dist.P2POp(dist.isend, send,
                              dist.get_global_rank(group, r + shift), group))
    if 0 <= r - shift < n:
        ops.append(dist.P2POp(dist.irecv, recv,
                              dist.get_global_rank(group, r - shift), group))
    if ops:
        _count("ppermute", x if 0 <= r + shift < n else x[:0], staged)
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    if staged:
        out.copy_(recv)
    return out


class _GatherBlocks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.rank, ctx.dim, ctx.block = (dist.get_rank(group), dim,
                                        x.shape[dim])
        return _all_gather(x, group, dim)

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


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.group, ctx.dim), None, None


def all_gather(x, group, dim):
    """The ranks' equal blocks of `x` along `dim`, concatenated in rank
    order over `group`, inside the sharded region; identity for None.
    Backward: the cotangent reduce-scattered, this rank's block summed
    over the ranks (JAX: a tiled all_gather transposes to a tiled
    psum_scatter)."""
    if group is None:
        return x
    return _AllGather.apply(x, group, dim)


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _reduce_scatter(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.group, ctx.dim), None, None


def reduce_scatter(x, group, dim):
    """The ranks' partial tensors summed over `group`, cut into equal
    blocks along `dim`: this rank's block (dim's size must divide by the
    group's); identity for None. Backward: the cotangent blocks
    all-gathered (JAX: a tiled psum_scatter transposes to a tiled
    all_gather)."""
    if group is None:
        return x
    return _ReduceScatter.apply(x, group, dim)


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, shift):
        ctx.group, ctx.shift = group, shift
        return _ppermute(x, group, shift)

    @staticmethod
    def backward(ctx, g):
        return _ppermute(g, ctx.group, -ctx.shift), None, None


def ppermute(x, group, shift):
    """Each rank s of `group` sends `x` to rank s + shift and returns what
    rank s - shift sent, zeros where s - shift is outside the group (JAX's
    ppermute over the pairs (s, s + shift)). Backward: the inverse
    permutation, the cotangent sent back from s + shift to s."""
    if group is None:
        return x if shift == 0 else torch.zeros_like(x)
    return _PPermute.apply(x, group, shift)


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
