"""The spatial schemes: any model family sharded over the space ranks.

Counterpart of neural_lam_tpu/parallel/grid_sharded.py, for one process
per device. The grid scheme (`spatialize`, the JAX file's lines 1-505):
grid-sharded, mesh node state replicated:

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

The mesh-node-sharded schemes (`spatialize_rs`, the JAX file's lines
506-1011; `--spatial_scheme mesh_rs | mesh_halo`) shard the bottom mesh
level's node rows too, in contiguous owner blocks (padded to n_space
equal blocks):

- mesh_rs: the g2m partial sums are reduce-scattered to the owners
  (`apply_interaction_net`'s psum_mode="scatter"), and the mesh state is
  the rank's owned rows from there on (its aggregation MLPs too). The
  bottom m2m set is split by receiver owner into an interior set (owned
  senders) and a frontier set that reads the all-gathered table; the
  gather moves the transformed owned rows (`SplitSendLazy`,
  `split_send_tf`). The decoder all-gathers the transformed owned rows
  (`_m2g_sender_tf`). Hierarchical graphs: up[0] split by sender owner,
  down[0] by receiver owner, the upper levels as the grid scheme's
  balanced chunks with an all-reduce a GNN (`_hi_psum_axis`).
- mesh_halo: every level's node rows are owned, and every edge set whose
  senders another rank owns reads them through a cut-edge halo
  (`halo.py`: ppermute rounds of just the rows other ranks' edges
  reference); the g2m partial sums of rows another rank owns are pushed
  to it and added there (`halo._halo_fold`). A rank's sender table is
  [owned ++ imports], its sets' sender ids remapped on the host; the
  split sets' interior edges read the owned rows, the frontier edges the
  import buffer (`SplitSend`). No collective of the step is an
  all-reduce (the gradients' reduction, after backward, is).

Every rank builds only its own part of every set, padded to the common
sizes, as for the grid scheme; the gradients follow the JAX `shard_map`
transpose (`collectives.py`: a reduce-scatter's backward all-gathers, an
all-gather's reduce-scatters, a ppermute's runs the inverse
permutation).
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch

from ..ops.message_passing import (
    EdgeSet,
    SplitSend,
    SplitSendLazy,
    node_transform_flat,
    virt_rows,
)
from ..ops.mlp import store
from .collectives import all_gather, gather_blocks, replicated_out
from .halo import (
    _build_gather_halo,
    _build_push_halo,
    _halo_exchange,
    _halo_fold,
    _remap_to_extended,
)
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


def _split_latent_ctx(ctx, mesh: Mesh, num_grid: int, latent_rows=None):
    """The twin's copy of a rollout ctx: a latent model's per-step target
    (grid-sized) cut to the rank's block. The latent noise stays whole
    under the grid scheme (mesh state is replicated, and so is the noise
    over the space ranks); with `latent_rows` (the mesh-node schemes: the
    latent field on the owned bottom rows) it is the noise drawn for the
    whole mesh, zero-padded to n_space blocks, cut to the rank's block:
    each row keeps the draw one process gives it."""
    if ctx is None:
        return None
    ctx = dict(ctx)
    if ctx.get("latent_target") is not None:
        ctx["latent_target"] = grid_block(ctx["latent_target"], mesh,
                                          num_grid)
    if latent_rows is not None and ctx.get("latent_eps") is not None:
        ctx["latent_eps"] = grid_block(ctx["latent_eps"], mesh, latent_rows,
                                       dim=1)
    return ctx


def _sharded_copy(model, mesh: Mesh, part, local, name, latent_rows=None):
    """A copy of `model` whose predict_step cuts the inputs to the rank's
    grid block, runs the family's own predict step on `local` (the twin
    over the rank's part of the graph, `part`), and gathers the
    prediction whole onto every rank. A latent model's KL leaves as
    `replicated_out` (the grid scheme's replicated mesh), or, with
    `latent_rows` (the mesh-node schemes, its rows sharded with the
    owned mesh rows), gathered by blocks with the padded tail cut off."""
    base_cls = type(model)
    group = mesh.space_group
    ng = part.num_grid

    def predict_step(self, prev_state, prev_prev_state, forcing, ctx=None):
        if ctx is None:
            ctx = self.precompute_rollout_ctx()

        def blk(x):
            return grid_block(x, mesh, ng)

        ctx_p = _split_latent_ctx(ctx, mesh, ng, latent_rows)
        out, std = base_cls.predict_step(
            self._twin, blk(prev_state), blk(prev_prev_state), blk(forcing),
            ctx_p)
        if ctx_p is not None and "_latent_kl" in ctx_p:
            kl = ctx_p["_latent_kl"]
            ctx["_latent_kl"] = (
                replicated_out(kl, group) if latent_rows is None
                else gather_blocks(kl, group, dim=1)[:, :latent_rows])
        out = gather_blocks(out, group, dim=1)[:, :ng]
        if std is not None:
            std = gather_blocks(std, group, dim=1)[:, :ng]
        return out, std

    def precompute_rollout_ctx(self):
        """The twin's rollout ctx: the static embeddings of the rank's
        part of the graph, computed once a rollout."""
        return base_cls.precompute_rollout_ctx(self._twin)

    cls = type(name + base_cls.__name__, (base_cls,),
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


def _check_sum(model, what):
    if getattr(model.args, "mesh_aggr", "sum") != "sum":
        raise ValueError(
            f"{what}; mean aggregation would divide by per-rank counts "
            "(mesh_aggr must be 'sum')")


def spatialize(model, mesh: Mesh):
    """A copy of `model` whose predict_step is grid-sharded over the
    mesh's space ranks (the batch stays the data group's). It shares the
    model's parameters; call it on every rank of the space group."""
    _check_sum(model, "the grid scheme all-reduces partial sums of the "
               "mesh edge chunks")
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
    return _sharded_copy(model, mesh, part, local, "GridSharded")




# --- the mesh-node-sharded schemes (mesh_rs, mesh_halo) -------------------


def _owned_chunk(es: EdgeSet, n_shards: int, shard: int, rec_block: int,
                 device, num_send=None, sender_map=None,
                 split=None) -> EdgeSet:
    """Rank `shard`'s part of `es` split by RECEIVER owner (contiguous
    blocks of `rec_block` receiver rows): all in-edges of its owned
    receivers, in local receiver ids, so its sums need no collective
    (the JAX package's `_owned_chunk_edgeset`). `sender_map(s, ids)`
    rewrites rank s's sender ids (mesh_halo: [owned ++ imports]
    positions). `split` cuts the part into an interior set (senders the
    rank owns) with a `.frontier` set (the others):
      {"kind": "compact", "own": X}: after sender_map, ids < X are owned
        (interior, num_send X) and ids >= X index the halo import buffer
        (frontier, rebased by -X);
      {"kind": "global", "own_block": blk}: owner = id // blk; the
        interior rebased to the owned block, the frontier keeping the
        global ids into the all-gathered table."""
    num_send = num_send or es.num_send

    def part(s, send, recv):
        keep = recv // rec_block == s
        snd = send[keep]
        if sender_map is not None:
            snd = sender_map(s, snd)
        return keep, snd, recv[keep] - s * rec_block

    if split is None:
        return _split_edgeset(es, n_shards, shard, part, device,
                              num_send=num_send, num_rec=rec_block,
                              dense_min_virt=0)
    cache = {}

    def halves(s, send, recv):
        if s not in cache:
            keep, snd, rcv = part(s, send, recv)
            if split["kind"] == "compact":
                interior = snd < split["own"]
                in_snd, fr_snd = snd[interior], snd[~interior] - split["own"]
            else:
                raw = send[keep]
                blk = split["own_block"]
                interior = raw // blk == s
                in_snd, fr_snd = raw[interior] - s * blk, snd[~interior]
            idx = np.nonzero(keep)[0]
            k_in, k_fr = np.zeros_like(keep), np.zeros_like(keep)
            k_in[idx[interior]] = True
            k_fr[idx[~interior]] = True
            cache[s] = ((k_in, in_snd, rcv[interior]),
                        (k_fr, fr_snd, rcv[~interior]))
        return cache[s]

    if split["kind"] == "compact":
        in_num, fr_num = split["own"], num_send - split["own"]
    else:
        in_num, fr_num = split["own_block"], num_send
    interior = _split_edgeset(es, n_shards, shard,
                              lambda s, a, b: halves(s, a, b)[0], device,
                              num_send=in_num, num_rec=rec_block,
                              dense_min_virt=0)
    frontier = _split_edgeset(es, n_shards, shard,
                              lambda s, a, b: halves(s, a, b)[1], device,
                              num_send=max(int(fr_num), 1),
                              num_rec=rec_block, dense_min_virt=0)
    return dataclasses.replace(interior, frontier=frontier)


def _sender_owned_chunk(es: EdgeSet, n_shards: int, shard: int,
                        send_block: int, device) -> EdgeSet:
    """Rank `shard`'s part of `es` split by SENDER owner, in local sender
    ids: its messages read the owned rows alone, and the ranks' partial
    sums over the (whole) receiver set are all-reduced (the JAX package's
    `_sender_owned_chunk_edgeset`)."""
    def part(s, send, recv):
        keep = send // send_block == s
        return keep, send[keep] - s * send_block, recv[keep]

    return _split_edgeset(es, n_shards, shard, part, device,
                          num_send=send_block, num_rec=es.num_rec,
                          dense_min_virt=0)


@dataclasses.dataclass(frozen=True)
class RSShard:
    """One rank's part of the graph under a mesh-node-sharded scheme (the
    JAX package's stacked `RSShard` at the rank's index)."""

    g2m: EdgeSet  # senders: the grid block; receivers: padded level 0
    #               (mesh_rs) or the compact [owned ++ pushed] rows (halo)
    m2g: EdgeSet  # senders: the all-gathered padded level 0 (mesh_rs) or
    #               [owned ++ m2g halo imports]; receivers: the grid block
    m2m: tuple
    up: tuple
    down: tuple
    grid_static: torch.Tensor  # (block, d_static)
    # per-level static features as the rank's twin reads them: mesh_rs,
    # level 0 padded to nm_pad and the upper levels whole; mesh_halo,
    # level 0 in the compact [owned ++ pushed] rows (the JAX package's
    # mesh_static0_c) and the upper levels' owned rows (mesh_static_own)
    mesh_static: tuple
    n_shards: int
    shard: int
    block: int
    num_grid: int
    num_mesh: int
    mblock: int
    halo: bool = False
    # mesh_halo: per edge set, the rank's send list (its row of the JAX
    # package's (S, X) array) and the static ppermute plan
    mm_send_idx: tuple = ()
    up_send_idx: tuple = ()
    down_send_idx: tuple = ()
    mg_send_idx: torch.Tensor | None = None
    g2m_add_pos: torch.Tensor | None = None  # (Yg,) owner-local positions
    mm_plans: tuple = ()
    up_plans: tuple = ()
    down_plans: tuple = ()
    mg_plan: tuple = ()
    g2m_plan: tuple = ()


def build_rs_shard(graph, n_shards: int, grid_static_features, shard: int,
                   device=None, halo: bool = False) -> RSShard:
    """Rank `shard`'s `RSShard` of `graph` over n_shards space ranks:
    mesh_rs, or with `halo` mesh_halo (the JAX package's
    `build_rs_shard`)."""
    device = device or graph.g2m.senders.device
    S = n_shards
    ng = graph.num_grid_nodes
    nm = graph.level_sizes[0]
    block = -(-ng // S)
    mblock = -(-nm // S)
    nm_pad = mblock * S
    # per-level owned-block sizes (level 0: mblock)
    mblocks = [-(-n_l // S) for n_l in graph.level_sizes]
    statics = [_np(f).astype(np.float32) for f in graph.mesh_static_features]

    def t(a):
        return torch.as_tensor(a, device=device)

    halo_extra = {}
    g2m_rec_map = mg_sender_map = None
    g2m_num_rec = mg_num_send = nm_pad
    if halo:
        def gather_plan(es, send_blk, rec_blk):
            """(plan, the rank's send list, the sender-id remap into the
            [owned ++ imports] space, that space's width) of one set."""
            send, recv, _ = _real_edges(es)
            plan, send_idx, remap = _build_gather_halo(
                send, np.minimum(recv // rec_blk, S - 1), send_blk, S)

            def smap(s, gids):
                return _remap_to_extended(gids, s, send_blk, remap, S)

            return (plan, t(send_idx[shard].astype(np.int64)), smap,
                    send_blk + sum(w for _, w in plan))

        # m2m[l]: level-l senders and receivers; up[l]: level l to l+1;
        # down[l]: level l+1 to l
        mm = [gather_plan(es, mblocks[lv], mblocks[lv])
              for lv, es in enumerate(graph.m2m)]
        up_p = [gather_plan(es, mblocks[lv], mblocks[lv + 1])
                for lv, es in enumerate(graph.up)]
        down_p = [gather_plan(es, mblocks[lv + 1], mblocks[lv])
                  for lv, es in enumerate(graph.down)]
        mg_plan, mg_send_idx, mg_sender_map, mg_num_send = gather_plan(
            graph.m2g, mblock, block)
        # g2m push halo: sums into the compact [owned ++ pushed] rows, the
        # pushed rows sent to their owners
        send, recv, _ = _real_edges(graph.g2m)
        g2m_plan, push_pos, add_pos, yg = _build_push_halo(
            recv, np.minimum(send // block, S - 1), mblock, S)
        g2m_num_rec = mblock + yg

        def g2m_rec_map(s, gids):
            return _remap_to_extended(gids, s, mblock, push_pos, S)

        # level-0 statics in the rank's compact rows, the upper levels'
        # owned rows: no level is embedded whole on any rank
        ms0 = _pad_axis(statics[0], nm_pad)
        ms0_c = np.zeros((g2m_num_rec, ms0.shape[1]), np.float32)
        ms0_c[:mblock] = ms0[shard * mblock:(shard + 1) * mblock]
        for gid, pos in push_pos[shard].items():
            ms0_c[pos] = ms0[gid]
        mesh_static = (t(ms0_c),) + tuple(
            t(_pad_axis(f, mblocks[lv] * S)[
                shard * mblocks[lv]:(shard + 1) * mblocks[lv]])
            for lv, f in enumerate(statics[1:], start=1))
        halo_extra = dict(
            halo=True,
            mm_send_idx=tuple(p[1] for p in mm),
            up_send_idx=tuple(p[1] for p in up_p),
            down_send_idx=tuple(p[1] for p in down_p),
            mg_send_idx=mg_send_idx,
            g2m_add_pos=t(add_pos[shard].astype(np.int64)),
            mm_plans=tuple(p[0] for p in mm),
            up_plans=tuple(p[0] for p in up_p),
            down_plans=tuple(p[0] for p in down_p),
            mg_plan=mg_plan, g2m_plan=g2m_plan)
    else:
        mesh_static = (t(_pad_axis(statics[0], nm_pad)),) + tuple(
            t(f) for f in statics[1:])

    # g2m by sender grid block, into the padded level-0 rows (their sums
    # reduce-scatter evenly to the owners) or the compact rows (halo)
    def g2m_part(s, send, recv):
        keep = send // block == s
        rcv = recv[keep]
        if g2m_rec_map is not None:
            rcv = g2m_rec_map(s, rcv)
        return keep, send[keep] - s * block, rcv

    # m2g by receiver grid block, from the all-gathered padded table or
    # the compact [owned ++ imports] table (sender ids remapped here)
    def m2g_part(s, send, recv):
        keep = recv // block == s
        snd = send[keep]
        if mg_sender_map is not None:
            snd = mg_sender_map(s, snd)
        return keep, snd, recv[keep] - s * block

    if halo:
        def csplit(plan, own):
            return {"kind": "compact", "own": own} if plan else None

        m2m = tuple(
            _owned_chunk(es, S, shard, mblocks[lv], device,
                         num_send=mm[lv][3], sender_map=mm[lv][2],
                         split=csplit(mm[lv][0], mblocks[lv]))
            for lv, es in enumerate(graph.m2m))
        up = tuple(
            _owned_chunk(es, S, shard, mblocks[lv + 1], device,
                         num_send=up_p[lv][3], sender_map=up_p[lv][2],
                         split=csplit(up_p[lv][0], mblocks[lv]))
            for lv, es in enumerate(graph.up))
        down = tuple(
            _owned_chunk(es, S, shard, mblocks[lv], device,
                         num_send=down_p[lv][3], sender_map=down_p[lv][2],
                         split=csplit(down_p[lv][0], mblocks[lv + 1]))
            for lv, es in enumerate(graph.down))
    else:
        # level-0 m2m by receiver owner, split (the frontier reads the
        # all-gathered padded table); up[0] by sender owner (its messages
        # read the owned rows); down[0] by receiver owner; the upper
        # levels' sets as the grid scheme's balanced chunks
        m2m = (_owned_chunk(graph.m2m[0], S, shard, mblock, device,
                            num_send=nm_pad,
                            split={"kind": "global", "own_block": mblock}),
               ) + tuple(_chunk_edgeset(es, S, shard, device)
                         for es in graph.m2m[1:])
        up = tuple(_sender_owned_chunk(es, S, shard, mblock, device)
                   if i == 0 else _chunk_edgeset(es, S, shard, device)
                   for i, es in enumerate(graph.up))
        down = tuple(_owned_chunk(es, S, shard, mblock, device)
                     if i == 0 else _chunk_edgeset(es, S, shard, device)
                     for i, es in enumerate(graph.down))
    stat = torch.as_tensor(grid_static_features, device=device)
    return RSShard(
        g2m=_split_edgeset(graph.g2m, S, shard, g2m_part, device,
                           num_send=block, num_rec=g2m_num_rec),
        m2g=_split_edgeset(graph.m2g, S, shard, m2g_part, device,
                           num_send=mg_num_send, num_rec=block),
        m2m=m2m, up=up, down=down,
        grid_static=grid_block(stat, Mesh(1, S, 0, shard), ng, dim=0),
        mesh_static=mesh_static, n_shards=int(S), shard=int(shard),
        block=int(block), num_grid=int(ng), num_mesh=int(nm),
        mblock=int(mblock), **halo_extra)


def spatialize_rs(model, mesh: Mesh, halo: bool = False):
    """A copy of `model` sharded over the mesh's space ranks with the
    bottom mesh level's node rows owned by the ranks (mesh_rs), or with
    `halo` every level's (mesh_halo: cut-edge halo exchanges instead of
    the all-gathers). Counterpart of the JAX package's `spatialize_rs`;
    it shares the model's parameters; call it on every rank of the space
    group. A latent model's noise is the whole mesh's draw, each rank
    keeping its owned rows (the JAX package draws over the padded rows),
    and its KL is gathered from the ranks' owned rows."""
    _check_sum(model, "the mesh-node schemes reduce-scatter or fold partial "
               "sums")
    group = mesh.space_group
    part = build_rs_shard(model.graph, mesh.n_space,
                          model.statics.grid_static_features,
                          mesh.space_index, model.device, halo=halo)
    local = copy.copy(model)

    if halo:
        send_lists = {"m2m": (part.mm_send_idx, part.mm_plans),
                      "up": (part.up_send_idx, part.up_plans),
                      "down": (part.down_send_idx, part.down_plans)}

        def hi_send(rep, kind, idx):
            """Edge set (kind, idx)'s senders: the owned rows paired with
            the halo rows this rank's edges read from other ranks."""
            idxs, plans = send_lists[kind]
            if not plans[idx]:
                return rep
            return SplitSend(rep, _halo_exchange(rep, idxs[idx], plans[idx],
                                                 group))

        def gather0(rep):
            return hi_send(rep, "m2m", 0)

        def gather_m2g(rep):
            # the fused decoder reads whole rows per grid node: the
            # concatenated [owned ++ m2g imports] table
            return torch.cat([rep, _halo_exchange(
                rep, part.mg_send_idx, part.mg_plan, group)], dim=1)

        def g2m_fold(aggregated, rec_rep, agg_axis, rec_axis):
            return _halo_fold(aggregated, rec_rep, agg_axis, rec_axis,
                              part.g2m_add_pos, part.g2m_plan, part.mblock,
                              group)

        local._m2g_sender_rep = gather_m2g
        local._g2m_psum_mode = g2m_fold
    else:
        def gather_full(rep, axis=1):
            return all_gather(rep, group, dim=axis)

        def gather0(rep):
            # the owned rows and a deferred all-gather: the interior edges
            # read the owned rows, the frontier round the gathered table,
            # whose rows the round transforms before the gather
            return SplitSendLazy(rep, gather_full)

        def m2g_sender_tf(mesh_rep, w_j, cd):
            # the owned rows transformed (and rounded) before the gather
            return gather_full(store(node_transform_flat(mesh_rep, w_j, cd),
                                     cd), axis=0)

        local._m2g_sender_rep = gather_full
        local._m2g_sender_tf = m2g_sender_tf
        local._g2m_psum_mode = "scatter"
    local.graph = dataclasses.replace(
        model.graph, g2m=part.g2m, m2g=part.m2g, m2m=part.m2m, up=part.up,
        down=part.down, mesh_static_features=part.mesh_static)
    local.statics = dataclasses.replace(
        model.statics, grid_static_features=part.grid_static)
    local._g2m_psum_axis = group
    # the bottom level is receiver-owned: its sums are the rank's own
    local._mesh_psum_axis = None
    local._mesh_sender_rep = gather0
    if model.hierarchical:
        if halo:
            # every level receiver-owned; every set reads its halo imports
            local._hi_psum_axis = lambda rec_level: None
            local._hi_sender_rep = hi_send
        else:
            # the upper levels keep the grid scheme's chunks and
            # all-reduces; only m2m[0] reads distributed senders (up[0] is
            # split by sender owner)
            local._hi_psum_axis = (
                lambda rec_level: None if rec_level == 0 else group)
            local._hi_sender_rep = (
                lambda rep, kind, idx:
                gather0(rep) if (kind, idx) == ("m2m", 0) else rep)
    latent_rows = part.num_mesh if getattr(model, "is_latent",
                                           False) else None
    return _sharded_copy(model, mesh, part, local,
                         "HaloSharded" if halo else "RSSharded", latent_rows)


SCHEMES = ("grid", "mesh_rs", "mesh_halo")


def check_scheme(scheme: str):
    """Raise unless `scheme` is one of `SCHEMES`."""
    if scheme not in SCHEMES:
        raise ValueError(f"unknown spatial scheme {scheme!r}; one of "
                         f"{SCHEMES}")


def spatialize_scheme(model, mesh: Mesh, scheme: str = "grid"):
    """The sharded copy for the train CLI's --spatial_scheme: `spatialize`
    (grid) or `spatialize_rs` (mesh_rs; mesh_halo with halo=True)."""
    check_scheme(scheme)
    if scheme == "grid":
        return spatialize(model, mesh)
    return spatialize_rs(model, mesh, halo=scheme == "mesh_halo")
