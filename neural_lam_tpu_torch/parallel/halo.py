"""Cut-edge halo plans and exchanges of the `mesh_halo` scheme.

Counterpart of the halo part of neural_lam_tpu/parallel/spatial.py (its
`_build_gather_halo`, `_build_push_halo`, `_remap_to_extended`,
`_halo_exchange`, `_halo_fold_agg` and `_halo_fold`). Under `mesh_halo`
every mesh level's node rows live with their owner rank (contiguous
blocks), and an edge set whose senders another rank owns reads them
through a halo: each rank sends only the rows that other ranks' edges
reference, in static rounds of `collectives.ppermute` (one round a rank
offset d = dst - src, as wide as the widest pair at that offset).

The plan builders are host-side numpy, copied from the JAX package so
that both packages lay out the same tables: a rank's extended sender
table is [its owned rows ++ the import segments in plan order], and a
push plan (the g2m partial sums) lays out a compact aggregation [owned
rows ++ the rows pushed to other owners]. The exchanges run on tensors,
with the gradients of JAX's transpose (`collectives.ppermute`'s inverse
permutation; the row gathers and adds transpose to adds and gathers).
"""

from __future__ import annotations

import numpy as np
import torch

from .collectives import ppermute


def _build_gather_halo(send_global, dst_shard, owner_blk, S):
    """Plan a gather-type halo exchange: each shard sends the rows it owns
    that other shards' edges reference.

    send_global: (E,) global sender row ids; dst_shard: (E,) shard that
    consumes each edge; owner_blk: rows per owner block. Returns
    (plan, send_idx, remap):
      plan      static tuple of (offset, width) ppermute rounds, where
                offset = dst - src and width = max over shards of the
                unique rows sent for that offset;
      send_idx  (S, X_tot) int32 owner-LOCAL rows each shard sends,
                grouped by plan segment (padded with 0);
      remap     per-dst-shard dict {global row id -> extended-table
                position}, where the extended table is
                [owned rows (owner_blk) ++ import segments (X_tot)] and
                import segment d holds the rows received from shard s-d
                in the sender's list order.
    """
    send_global = np.asarray(send_global, np.int64)
    owner = np.minimum(send_global // owner_blk, S - 1)
    pairs = {}
    for dst in range(S):
        sel = dst_shard == dst
        for src in np.unique(owner[sel]):
            if src == dst:
                continue
            rows = np.unique(send_global[sel & (owner == src)])
            pairs[(int(src), dst)] = rows
    offsets = sorted({dst - src for (src, dst) in pairs})
    widths = {
        d: max([len(r) for (src, dst), r in pairs.items()
                if dst - src == d] or [0])
        for d in offsets
    }
    x_tot = sum(widths.values())
    send_idx = np.zeros((S, max(x_tot, 1)), np.int32)
    remap = [dict() for _ in range(S)]
    base = 0
    for d in offsets:
        for src in range(S):
            dst = src + d
            if not 0 <= dst < S:
                continue
            rows = pairs.get((src, dst))
            if rows is None:
                continue
            send_idx[src, base:base + len(rows)] = rows - src * owner_blk
            for j, gid in enumerate(rows):
                remap[dst][int(gid)] = owner_blk + base + j
        base += widths[d]
    plan = tuple((int(d), int(widths[d])) for d in offsets)
    return plan, send_idx[:, :max(x_tot, 1)], remap


def _build_push_halo(recv_global, src_shard, owner_blk, S):
    """Plan a push/scatter-type halo (partial aggregation rows to owners).

    recv_global: (E,) global receiver row ids; src_shard: (E,) shard that
    produces each edge's message. Returns (plan, compact_pos, add_pos,
    y_tot): `compact_pos` maps each shard's edges into a compact
    aggregation layout [owned rows (owner_blk) ++ push segments (y_tot)];
    after exchanging push segments (plan rounds), the receiving shard adds
    segment d's rows at its owner-local `add_pos` positions (sentinel
    owner_blk marks padding).
    """
    recv_global = np.asarray(recv_global, np.int64)
    owner = np.minimum(recv_global // owner_blk, S - 1)
    pairs = {}
    for src in range(S):
        sel = src_shard == src
        for dst in np.unique(owner[sel]):
            if dst == src:
                continue
            rows = np.unique(recv_global[sel & (owner == dst)])
            pairs[(src, int(dst))] = rows
    offsets = sorted({dst - src for (src, dst) in pairs})
    widths = {
        d: max([len(r) for (src, dst), r in pairs.items()
                if dst - src == d] or [0])
        for d in offsets
    }
    y_tot = sum(widths.values())
    # per-source-shard: compact position of each pushed global row
    push_pos = [dict() for _ in range(S)]
    add_pos = np.full((S, max(y_tot, 1)), owner_blk, np.int32)
    base = 0
    for d in offsets:
        for src in range(S):
            dst = src + d
            if not 0 <= dst < S:
                continue
            rows = pairs.get((src, dst))
            if rows is None:
                continue
            for j, gid in enumerate(rows):
                push_pos[src][int(gid)] = owner_blk + base + j
            # receiver dst gets this segment from shard dst - d == src
            add_pos[dst, base:base + len(rows)] = rows - dst * owner_blk
        base += widths[d]
    plan = tuple((int(d), int(widths[d])) for d in offsets)
    return plan, push_pos, add_pos, y_tot


def _remap_to_extended(gids, s, blk, remap, n_shards):
    """Owner-local position for shard s's OWNED rows, extended/compact
    position (from a halo plan's per-shard remap/push dict) for remote
    rows. The owner is clamped to the last shard (`np.minimum(gids //
    blk, S - 1)`), as the plans clamp it."""
    gids = np.asarray(gids, np.int64)
    own = np.minimum(gids // blk, n_shards - 1)
    out = gids - s * blk
    table = remap[s]
    for i in np.nonzero(own != s)[0]:
        out[i] = table[int(gids[i])]
    return out


def _halo_exchange(owned, send_idx, plan, group):
    """Gather-type cut-edge halo: export owned rows other ranks reference.

    owned: (B, R, h) rows this rank owns; send_idx: (X_tot,) owner-local
    rows to export, grouped by plan segment; plan: ((offset, width), ...)
    ppermute rounds over `group`. Returns the (B, X_tot, h) import buffer:
    the segment of offset d holds the rows received from rank s - d, in
    the sender's list order (the layout `_build_gather_halo`'s remap
    indexes). A round moves width x B x h values: the cut-edge rows only,
    where an all-gather would move the whole table."""
    if not plan:
        return owned[:, :0]
    buf = owned.index_select(1, send_idx)
    outs, base = [], 0
    for d, w in plan:
        outs.append(ppermute(buf[:, base:base + w], group, d))
        base += w
    return torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]


def _halo_fold_agg(aggregated, agg_axis, add_pos, plan, mblock, group):
    """Push-type cut-edge halo fold: compact [owned ++ pushed] partial
    sums -> the owned rows' sums. Each pushed segment (a plan round) is
    sent to its owner rank and added there at the static `add_pos`
    positions (the sentinel row mblock takes the padding)."""
    a = aggregated.movedim(agg_axis, 0)
    own = torch.cat([a[:mblock], torch.zeros_like(a[:1])])
    base = mblock
    for d, w in plan:
        recv = ppermute(a[base:base + w], group, d)
        own = own.index_add(0, add_pos[base - mblock:base - mblock + w],
                            recv)
        base += w
    return own[:mblock].movedim(0, agg_axis)


def _halo_fold(aggregated, rec_rep, agg_axis, rec_axis, add_pos, plan,
               mblock, group):
    """`_halo_fold_agg` and the owned rows of rec_rep: the callable
    `psum_mode` of `apply_interaction_net` (flat (N, B*h) and batched
    (B, N, h) sums, named by agg_axis and rec_axis)."""
    own = _halo_fold_agg(aggregated, agg_axis, add_pos, plan, mblock, group)
    return own, rec_rep.narrow(rec_axis, 0, mblock)
