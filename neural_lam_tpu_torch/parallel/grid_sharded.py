"""The grid spatial scheme: any model family grid-sharded over the space
ranks, mesh node state replicated.

Counterpart of the first scheme of neural_lam_tpu/parallel/grid_sharded.py
(its lines 1-505), for one process per device:

- grid nodes live in contiguous blocks, one a space rank (the grid padded
  to n_space equal blocks); the grid embedder, the g2m messages and the
  whole decoder run on the rank's own block;
- g2m edges are split by their sender's grid block: each rank's partial
  aggregation into the (replicated) bottom mesh level is all-reduced once
  a step;
- m2g edges are split by their receiver's grid block, local given the
  replicated mesh representation;
- every mesh-level edge set (m2m, up, down) is split into n_space
  balanced contiguous edge chunks (`dense_min_virt=0`: a rank computes
  messages for its own edges only); each interaction net all-reduces its
  partial aggregation (HiLAMParallel: one all-reduce per level a layer),
  and the aggregation MLPs of the mesh nodes run on every rank.

Each rank builds only its own part of every set, padded to the common
sizes the JAX package gives its stacked sets (`_stack_edgesets`; the
other ranks' sizes follow from their degree counts), so that
every rank takes the same route per set: the flat kernels K2/K3 (and the
flat-grid K1/K4) where `flat_eligible`, the batched P1-P3 otherwise.

`spatialize(model, mesh)` returns a copy of the model whose
`predict_step` cuts the inputs to the rank's block, runs the family's own
predict step on a twin that holds the rank's part of the graph, and
gathers the prediction whole onto every rank; rollout, loss, training and
evaluation are the family's. Gradients follow the JAX `shard_map`
transpose (`collectives.py`): after backward, `collectives.
reduce_gradients` sums the parameter gradients over the space group.

The mesh-node-sharded schemes of the JAX package (`mesh_rs`,
`mesh_halo`: `spatial.py`'s partitions and halo plans, reduce-scatter,
`SplitSend` and frontier splits) are not ported (ROADMAP.md queue 1,
item 6); `spatialize_scheme` raises for them.
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch

from ..ops.message_passing import EdgeSet, virt_rows
from .collectives import gather_blocks, replicated_out
from .mesh import Mesh, grid_block


def _pad_axis(arr, size, axis=0, fill=0):
    pad = [(0, 0)] * arr.ndim
    pad[axis] = (0, size - arr.shape[axis])
    return np.pad(arr, pad, constant_values=fill)


def _np(t):
    return t.detach().cpu().numpy()


def _real_edges(es: EdgeSet):
    """(senders, receivers, features) of the set's real edge slots, in
    slot (receiver-major) order."""
    keep = _np(es.mask)[:, 0] > 0
    return _np(es.senders)[keep], _np(es.receivers)[keep], \
        _np(es.features)[keep]


def _fold_slots(es: EdgeSet, device):
    """(rec_slots, rec_mask) of a set's virtual-row fold, also for a
    virt_identity set (one row a receiver, in order), whose padded twin
    may have to fold by gathers when another rank's part is not
    virt_identity."""
    if es.rec_slots is not None:
        return es.rec_slots.to(device), es.rec_mask.to(device)
    return (torch.arange(es.num_rec, device=device)[:, None],
            torch.ones((es.num_rec, 1), device=device))


def _padded_rows(receivers, num_rec: int, K: int, dense_min_virt=1):
    """(padded virtual rows, virt_identity) of the dense layout
    `EdgeSet.from_local` gives edges into these receivers, from their
    in-degrees alone."""
    n_virt, _, num_virt_pad = virt_rows(
        np.bincount(receivers, minlength=num_rec), K, dense_min_virt)
    return num_virt_pad, bool(np.all(n_virt == 1))


def _split_edgeset(es: EdgeSet, n_shards: int, shard: int, select,
                   device, num_send: int, num_rec: int,
                   dense_min_virt: int = 1) -> EdgeSet:
    """Rank `shard`'s part of `es`: `select(s, send, recv)` gives rank s's
    (edge mask, senders, receivers) in its local index spaces. Only the
    rank's own dense set is built (on the CPU, with the set's K), then
    padded to the sizes the JAX package's `_stack_edgesets` gives every
    rank's part, which follow from the parts' degree counts: the largest
    number of edge slots (padding slots: sender 0, zero features, mask 0;
    padding virtual rows map to receiver num_rec - 1), and a transposed
    layout over the padded slot space with one K for every rank, padded
    alike."""
    send, recv, feat = _real_edges(es)
    K = es.dense_k
    parts = [select(s, send, recv) for s in range(n_shards)]
    rows = [_padded_rows(rcv, num_rec, K, dense_min_virt)
            for _, _, rcv in parts]
    v_max = max(r for r, _ in rows)
    m_max = v_max * K
    identity = all(i for _, i in rows)
    k_t = int(min(8, max(1, -(-max(rcv.size for _, _, rcv in parts)
                             // max(num_send, 1)))))
    tv_max = max(_padded_rows(snd, num_send, k_t)[0] for _, snd, _ in parts)

    keep, snd, rcv = parts[shard]
    own = EdgeSet.from_local(
        snd, rcv, feat[keep], num_send=num_send, num_rec=num_rec,
        dense_force_k=K, dense_min_virt=dense_min_virt, device="cpu",
        build_transpose=False)
    send_p = _pad_axis(_np(own.senders), m_max)
    mask_p = _pad_axis(_np(own.mask), m_max)
    virt_p = _pad_axis(_np(own.virt_to_rec), v_max, fill=num_rec - 1)
    real = np.nonzero(mask_p[:, 0] > 0)[0]
    t_own = EdgeSet.from_local(
        real.astype(np.int64), send_p[real],
        np.zeros((real.size, 0), np.float32), num_send=m_max,
        num_rec=num_send, dense_force_k=k_t, device="cpu",
        build_transpose=False)
    t_virt = _pad_axis(_np(t_own.virt_to_rec), tv_max, fill=num_send - 1)
    t_slots, t_mask = _fold_slots(t_own, device)

    def t(a):
        return torch.as_tensor(a, device=device)

    transposed = EdgeSet(
        senders=t(_pad_axis(_np(t_own.senders), tv_max * k_t)),
        receivers=t(np.repeat(t_virt, k_t)),
        features=torch.zeros((tv_max * k_t, 0), device=device),
        gather_table=torch.zeros((1, 1), dtype=torch.int32, device=device),
        mask=t(_pad_axis(_np(t_own.mask), tv_max * k_t)),
        virt_to_rec=t(t_virt), rec_slots=t_slots, rec_mask=t_mask,
        num_send=m_max, num_rec=num_send, dense_k=k_t, num_virt=tv_max,
        virt_identity=False)
    slots, slot_mask = (None, None) if identity else _fold_slots(own, device)
    return EdgeSet(
        senders=t(send_p), receivers=t(np.repeat(virt_p, K)),
        features=t(_pad_axis(_np(own.features), m_max)),
        gather_table=torch.zeros((1, 1), dtype=torch.int32, device=device),
        mask=t(mask_p), virt_to_rec=t(virt_p), rec_slots=slots,
        rec_mask=slot_mask, num_send=num_send, num_rec=num_rec, dense_k=K,
        num_virt=v_max, virt_identity=identity, transposed=transposed)


def _chunk_edgeset(es: EdgeSet, n_shards: int, shard: int,
                   device) -> EdgeSet:
    """Rank `shard`'s chunk of one mesh-level set split into n_shards
    balanced contiguous edge chunks (receiver-major order keeps each
    chunk's receiver range narrow). Node index spaces stay global (mesh
    node state is replicated); dense_min_virt=0 keeps each chunk's edge-MLP
    cost proportional to its own edges."""
    E = int((_np(es.mask)[:, 0] > 0).sum())
    bounds = [E * s // n_shards for s in range(n_shards + 1)]

    def select(s, send, recv):
        keep = np.zeros(E, bool)
        keep[bounds[s]:bounds[s + 1]] = True
        return keep, send[keep], recv[keep]

    return _split_edgeset(es, n_shards, shard, select, device,
                          num_send=es.num_send, num_rec=es.num_rec,
                          dense_min_virt=0)


@dataclasses.dataclass(frozen=True)
class GridShard:
    """One rank's part of the graph."""

    g2m: EdgeSet  # senders: the rank's grid block; receivers: bottom mesh
    m2g: EdgeSet  # senders: bottom mesh; receivers: the rank's grid block
    m2m: tuple  # per-level edge chunks (global mesh node indices)
    up: tuple
    down: tuple
    grid_static: torch.Tensor  # (block, d_static), zero rows past the grid
    n_shards: int
    shard: int
    block: int
    num_grid: int


def build_grid_shard(graph, n_shards: int, grid_static_features,
                     shard: int, device=None) -> GridShard:
    """Rank `shard`'s `GridShard` of `graph` over n_shards space ranks."""
    device = device or graph.g2m.senders.device
    ng = graph.num_grid_nodes
    nm0 = graph.level_sizes[0]
    block = -(-ng // n_shards)

    def by_sender(s, send, recv):
        keep = send // block == s
        return keep, send[keep] - s * block, recv[keep]

    def by_receiver(s, send, recv):
        keep = recv // block == s
        return keep, send[keep], recv[keep] - s * block

    stat = torch.as_tensor(grid_static_features, device=device)
    mesh = Mesh(n_data=1, n_space=n_shards, data_index=0, space_index=shard)
    return GridShard(
        g2m=_split_edgeset(graph.g2m, n_shards, shard, by_sender, device,
                           num_send=block, num_rec=nm0),
        m2g=_split_edgeset(graph.m2g, n_shards, shard, by_receiver, device,
                           num_send=nm0, num_rec=block),
        m2m=tuple(_chunk_edgeset(es, n_shards, shard, device)
                  for es in graph.m2m),
        up=tuple(_chunk_edgeset(es, n_shards, shard, device)
                 for es in graph.up),
        down=tuple(_chunk_edgeset(es, n_shards, shard, device)
                   for es in graph.down),
        grid_static=grid_block(stat, mesh, ng, dim=0),
        n_shards=int(n_shards), shard=int(shard), block=int(block),
        num_grid=int(ng),
    )


def _split_latent_ctx(ctx, mesh: Mesh, num_grid: int):
    """The twin's copy of a rollout ctx: a latent model's per-step target
    (grid-sized) cut to the rank's block; the latent noise stays whole
    (mesh state is replicated, and so is the noise over the space
    ranks)."""
    if ctx is None:
        return None
    ctx = dict(ctx)
    if ctx.get("latent_target") is not None:
        ctx["latent_target"] = grid_block(ctx["latent_target"], mesh,
                                          num_grid)
    return ctx


def spatialize(model, mesh: Mesh):
    """A copy of `model` whose predict_step is grid-sharded over the
    mesh's space ranks (the batch stays the data group's). It shares the
    model's parameters; call it on every rank of the space group."""
    if getattr(model.args, "mesh_aggr", "sum") != "sum":
        raise ValueError(
            "the grid scheme all-reduces partial sums of the mesh edge "
            "chunks; mean aggregation would divide by per-rank counts "
            "(mesh_aggr must be 'sum')")
    base_cls = type(model)
    part = build_grid_shard(model.graph, mesh.n_space,
                            model.statics.grid_static_features,
                            mesh.space_index, model.device)

    # the rank's twin: the family's own class over its part of the graph,
    # its partial aggregations all-reduced over the space group
    local = copy.copy(model)
    local.graph = dataclasses.replace(
        model.graph, g2m=part.g2m, m2g=part.m2g, m2m=part.m2m, up=part.up,
        down=part.down)
    local.statics = dataclasses.replace(
        model.statics, grid_static_features=part.grid_static)
    local._g2m_psum_axis = mesh.space_group
    local._mesh_psum_axis = mesh.space_group

    def predict_step(self, prev_state, prev_prev_state, forcing, ctx=None):
        if ctx is None:
            ctx = self.precompute_rollout_ctx()
        ng = part.num_grid

        def blk(x):
            return grid_block(x, mesh, ng)

        ctx_p = _split_latent_ctx(ctx, mesh, ng)
        out, std = base_cls.predict_step(
            self._twin, blk(prev_state), blk(prev_prev_state), blk(forcing),
            ctx_p)
        if ctx_p is not None and "_latent_kl" in ctx_p:
            ctx["_latent_kl"] = replicated_out(ctx_p["_latent_kl"],
                                               mesh.space_group)
        out = gather_blocks(out, mesh.space_group, dim=1)[:, :ng]
        if std is not None:
            std = gather_blocks(std, mesh.space_group, dim=1)[:, :ng]
        return out, std

    def precompute_rollout_ctx(self):
        """The twin's rollout ctx: the static embeddings of the rank's
        part of the graph, computed once a rollout."""
        return base_cls.precompute_rollout_ctx(self._twin)

    cls = type("GridSharded" + base_cls.__name__, (base_cls,),
               {"predict_step": predict_step,
                "precompute_rollout_ctx": precompute_rollout_ctx})
    sp = copy.copy(model)
    sp.__class__ = cls
    # plain attributes, outside the module tree: the twin shares the
    # parameters, and the state dict stays the model's
    object.__setattr__(sp, "_twin", local)
    object.__setattr__(sp, "spatial", part)
    object.__setattr__(sp, "mesh", mesh)
    return sp


SCHEMES = ("grid", "mesh_rs", "mesh_halo")


def check_scheme(scheme: str):
    """Raise unless `scheme` is one the port runs: "grid"."""
    if scheme not in SCHEMES:
        raise ValueError(f"unknown spatial scheme {scheme!r}; one of "
                         f"{SCHEMES}")
    if scheme != "grid":
        raise NotImplementedError(
            f"--spatial_scheme {scheme}: the mesh-node-sharded schemes "
            "(mesh_rs, mesh_halo) are not ported yet (ROADMAP.md queue 1, "
            "item 6); the grid scheme is")


def spatialize_scheme(model, mesh: Mesh, scheme: str = "grid"):
    """`spatialize` for the train CLI's --spatial_scheme: "grid" only."""
    check_scheme(scheme)
    return spatialize(model, mesh)
