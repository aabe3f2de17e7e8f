"""Interaction network (Battaglia et al. 2016) on the dense edge layout.

Counterpart of neural_lam_tpu/ops/message_passing.py's dense routes.
Reference behavior (ref: neural_lam/interaction_net.py:10-131):

    messages   = EdgeMLP(concat(edge_rep, send_rep[senders], rec_rep[receivers]))
    aggregated = sum(messages -> receivers)
    rec_out    = rec_rep + AggrMLP(concat(rec_rep, aggregated))
    edge_out   = edge_rep + messages            (if update_edges)

Layouts kept from the JAX package (so the tests compare like with like):

* flat node-major `(rows, B*h)` activations, batch element b in columns
  [b*h, (b+1)*h) of each row (the flat route, kernels K2/K3 in
  `edge_flat.py`), or batched `(B, rows, h)` (the batched route, kernels
  P1-P3 in `edge.py`). `apply_interaction_net` picks the route per edge
  set as the JAX package does (`flat_eligible`: at least `_FLAT_MIN_VIRT`
  virtual rows and B*h a multiple of 128), and `expand_edge_rep` gives an
  evolving edge state the layout of its set's route;
* the dense K-slot virtual-row `EdgeSet` (`EdgeSet.from_local`): every
  receiver owns ceil(deg/K) contiguous virtual rows of K edge slots, padding
  slots carry sender 0, zero features and mask 0.

The first EdgeMLP layer is split: concat(e, x_j, x_i) @ W ==
e @ W_e + x_j @ W_j + x_i @ W_i, with the node terms computed per node and
read per edge. The fused edge kernels (`edge_flat.py`) read the sender
term by index straight from the node table. Aggregation is the masked
K-slot sum inside the kernels, then a deterministic gather fold of virtual
rows to receivers (`_rec_fold`) -- no atomics, so every run sums in the
same order. The backward's sender gradient is the same kind of fold over
the transposed layout (`EdgeSet.fold_senders`).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from ..parallel.collectives import psum, reduce_scatter
from . import edge, edge_flat
from .mlp import (MLP, apply_mlp, apply_mlp_concat, finish_mlp, init_mlp,
                  mm, store)
from .segment import build_gather_table

# the JAX package's dispatch between its two kernel families: an edge set
# takes the flat route when it has at least this many virtual rows (and
# B*h is a multiple of 128), the batched route otherwise
_FLAT_MIN_VIRT = 512
# the most virtual rows a receiver for which the JAX package's flat route
# folds by gather (`_rec_fold`, fp32 sums of a bf16 virt); past it, as on
# its batched route, it folds by `segment_sum` in virt's dtype
_JAX_GATHER_FOLD_MAX = 16


def virt_rows(counts: np.ndarray, K: int, dense_min_virt: int = 1):
    """(virtual rows per receiver, their total, the total padded) of a
    dense layout with K slots a row over receivers of in-degree `counts`
    (`EdgeSet.from_local`). The rows are padded (all-masked) to a multiple
    of 256 (64 for small sets): the JAX package's layout, kept so both
    packages agree on every shape."""
    n_virt_per_rec = np.maximum(-(-counts // K), dense_min_virt)
    num_virt = int(n_virt_per_rec.sum())
    tile = 256 if num_virt >= 2048 else 64
    return n_virt_per_rec, num_virt, -(-max(num_virt, 1) // tile) * tile


@dataclasses.dataclass(frozen=True)
class EdgeSet:
    """A static directed edge set in the dense K-slot virtual-row layout.

    senders: (M,) int32 local sender ids per edge slot (0 at padding).
    receivers: (M,) int32 receiver id per edge slot.
    features: (M, d_edge_f) static (normalized) edge features.
    gather_table: (num_rec, max_deg) int32 padded incoming-slot-id table.
    mask: (M, 1) 1.0 for real edge slots.
    virt_to_rec: (num_virt,) int32 virtual-row -> receiver map.
    rec_slots / rec_mask: (num_rec, R) virtual-row ids of each receiver and
    their validity, for the gather fold; None when virt_identity.
    transposed: the same dense layout built over this set's REAL slots as
    edges and its senders as receivers (the JAX package's
    `EdgeSet.transposed`), for the scatter-free sender-gradient fold
    `fold_senders`; None when the set has no real slot.
    frontier: on a rank's part of a receiver-owned set of the
    mesh-node-sharded schemes (`parallel/grid_sharded.py`), this set holds
    the INTERIOR edges (senders the rank owns, indexed in its owned rows)
    and `frontier` the edges whose senders come through the collective
    (indexed in the all-gathered table or the halo import buffer); a
    round over such a set takes a `SplitSend` sender table. None
    elsewhere.
    """

    senders: torch.Tensor
    receivers: torch.Tensor
    features: torch.Tensor
    gather_table: torch.Tensor
    mask: torch.Tensor
    virt_to_rec: torch.Tensor
    rec_slots: torch.Tensor | None
    rec_mask: torch.Tensor | None
    num_send: int
    num_rec: int
    dense_k: int
    num_virt: int
    # True when (pre-padding) every receiver had exactly one virtual row in
    # order: aggregation is then virt[:num_rec]
    virt_identity: bool
    transposed: "EdgeSet | None" = None
    frontier: "EdgeSet | None" = None

    @staticmethod
    def from_local(senders: np.ndarray, receivers: np.ndarray,
                   features: np.ndarray, num_send: int, num_rec: int,
                   dense_cap: int | None = None, device="cuda",
                   build_transpose: bool = True,
                   dense_force_k: int | None = None,
                   dense_min_virt: int = 1):
        """Build the dense layout from already-local index arrays.

        Pads the edge list so every receiver owns contiguous K-slot virtual
        rows (receiver-major). With the default cap K=8, a receiver of
        degree d owns ceil(d/K) virtual rows. Padding slots have sender 0,
        zero features and mask 0. The slot order and padding are those of
        the JAX package's `EdgeSet.from_local(dense=True)`.

        dense_force_k pins K (the per-shard sets of one sharded edge set
        share it; any K is valid, a higher degree just takes more virtual
        rows). dense_min_virt=0 gives a receiver of degree 0 no virtual
        row at all (the per-shard edge chunks of `parallel/grid_sharded.py`,
        which see every receiver but few of their edges): its fold sums
        nothing and it aggregates to 0.
        """
        senders = np.asarray(senders)
        receivers = np.asarray(receivers)
        features = np.asarray(features, dtype=np.float32)
        K = dense_cap or 8
        counts = np.bincount(receivers, minlength=num_rec)
        K = min(K, max(int(counts.max()), 1))
        if dense_force_k is not None:
            K = int(dense_force_k)
        n_virt_per_rec, num_virt, num_virt_pad = virt_rows(
            counts, K, dense_min_virt)
        virt_start = np.concatenate(([0], np.cumsum(n_virt_per_rec)))[:-1]
        virt_identity = bool(np.all(n_virt_per_rec == 1))
        order = np.argsort(receivers, kind="stable")
        starts = np.concatenate(([0], np.cumsum(counts)))[:-1]
        within = np.arange(len(receivers)) - starts[receivers[order]]
        r_sorted = receivers[order]
        slots = (virt_start[r_sorted] + within // K) * K + within % K
        M_pad = num_virt_pad * K
        d_feat = features.shape[1]
        send_p = np.zeros(M_pad, np.int32)
        feat_p = np.zeros((M_pad, d_feat), np.float32)
        mask = np.zeros((M_pad, 1), np.float32)
        send_p[slots] = senders[order]
        feat_p[slots] = features[order]
        mask[slots] = 1.0
        virt_to_rec = np.concatenate([
            np.repeat(np.arange(num_rec, dtype=np.int32), n_virt_per_rec),
            np.full(num_virt_pad - num_virt, num_rec - 1, np.int32),
        ])
        # gather-based virt->receiver fold layout. The JAX package caps
        # this at 16 rows per receiver (beyond it a TPU scatter was
        # cheaper); the port always folds by gather, so it has no cap. A
        # receiver without virtual rows (dense_min_virt=0) reads row 0, or
        # the last row past the end, masked: it sums nothing.
        rec_slots = rec_mask = None
        if not virt_identity and num_rec:
            r_fold = max(int(n_virt_per_rec.max()), 1)
            jj = np.arange(r_fold)[None, :]
            cnt = n_virt_per_rec[:, None]
            rec_slots = torch.as_tensor(
                np.minimum(virt_start[:, None]
                           + np.minimum(jj, np.maximum(cnt - 1, 0)),
                           num_virt_pad - 1).astype(np.int64),
                device=device,
            )
            rec_mask = torch.as_tensor((jj < cnt).astype(np.float32),
                                       device=device)
        recv_p = np.repeat(virt_to_rec, K)
        table, _ = build_gather_table(recv_p, num_rec)
        transposed = None
        real = np.nonzero(mask[:, 0] > 0)[0]
        if build_transpose and real.size:
            # transposed dense layout: "edges" are this set's real slot
            # ids, "receivers" its sender nodes; the cap near the mean
            # out-degree is the JAX package's
            cap = int(min(8, max(1, -(-real.size // max(num_send, 1)))))
            transposed = EdgeSet.from_local(
                real.astype(np.int64), send_p[real],
                np.zeros((real.size, 0), np.float32), num_send=M_pad,
                num_rec=num_send, dense_cap=cap, device=device,
                build_transpose=False,
            )

        def t(a):
            return torch.as_tensor(a, device=device)

        return EdgeSet(
            senders=t(send_p),
            receivers=t(recv_p),
            features=t(feat_p),
            gather_table=t(table),
            mask=t(mask),
            virt_to_rec=t(virt_to_rec),
            rec_slots=rec_slots,
            rec_mask=rec_mask,
            num_send=int(num_send),
            num_rec=int(num_rec),
            dense_k=K,
            num_virt=num_virt_pad,
            virt_identity=virt_identity,
            transposed=transposed,
        )

    def fold_senders(self, d_slots):
        """(M, W) per-slot sender cotangents -> (num_send, W) table
        gradient: d_table[s] = sum of d_slots over the REAL slots whose
        sender is s (padding slots stay out).

        Counterpart of the backward of the JAX package's `gather_send_flat`
        (`_gather_rows_T_bwd`): masked row gathers over the transposed
        layout, summed in a fixed order, then the virtual-row fold. No
        scatter and no float atomics, so the card repeats its sums. The
        sums run in fp32 (the fp32 mask widens a bf16 d_slots) and the
        result is rounded once to d_slots' dtype, as the JAX function
        does."""
        t = self.transposed
        if t is None:
            return d_slots.new_zeros((self.num_send, d_slots.shape[1]))
        slots = t.senders.view(t.num_virt, t.dense_k)
        masks = t.mask.view(t.num_virt, t.dense_k)
        virt = None
        for k in range(t.dense_k):
            part = d_slots.index_select(0, slots[:, k]) * masks[:, k, None]
            virt = part if virt is None else virt + part
        return _fold_virt(t, virt).to(d_slots.dtype)


class InteractionNet(nn.Module):
    """Parameters of one interaction net: edge MLP (3h in) + aggr MLP (2h in)
    (recipes per ref: neural_lam/interaction_net.py:65-66)."""

    def __init__(self, edge_mlp: MLP, aggr_mlp: MLP):
        super().__init__()
        self.edge_mlp = edge_mlp
        self.aggr_mlp = aggr_mlp


def _inet_recipes(input_dim: int, hidden_layers: int, hidden_dim):
    """(edge MLP recipe [3h, ...], aggregation MLP recipe [2h, ...])."""
    if hidden_dim is None:
        hidden_dim = input_dim
    return ([3 * input_dim] + [hidden_dim] * (hidden_layers + 1),
            [2 * input_dim] + [hidden_dim] * (hidden_layers + 1))


def init_interaction_net(input_dim: int, *, hidden_layers: int = 1,
                         hidden_dim: int | None = None,
                         generator: torch.Generator | None = None
                         ) -> InteractionNet:
    edge_recipe, aggr_recipe = _inet_recipes(input_dim, hidden_layers,
                                             hidden_dim)
    return InteractionNet(
        init_mlp(edge_recipe, layer_norm=True, generator=generator),
        init_mlp(aggr_recipe, layer_norm=True, generator=generator),
    )


class ChunkedInteractionNet(nn.Module):
    """Parameters of a chunked interaction net (HiLAMParallel's processor
    layer; the reference's SplitMLPs): one edge MLP per edge chunk and one
    aggregation MLP per node chunk (mesh level), with the recipes of
    `InteractionNet`'s. The state-dict keys are the JAX package's pytree
    (`edge_mlps.{c}.layers.{i}.w`, `aggr_mlps.{l}.ln.scale`, ...)."""

    def __init__(self, edge_mlps: list, aggr_mlps: list):
        super().__init__()
        self.edge_mlps = nn.ModuleList(edge_mlps)
        self.aggr_mlps = nn.ModuleList(aggr_mlps)


def init_interaction_net_chunked(input_dim: int, n_edge_chunks: int,
                                 n_node_chunks: int, *,
                                 hidden_layers: int = 1,
                                 hidden_dim: int | None = None,
                                 generator: torch.Generator | None = None
                                 ) -> ChunkedInteractionNet:
    """A chunked interaction net: one MLP per chunk (the JAX package's
    `init_interaction_net_chunked`)."""
    edge_recipe, aggr_recipe = _inet_recipes(input_dim, hidden_layers,
                                             hidden_dim)
    return ChunkedInteractionNet(
        [init_mlp(edge_recipe, layer_norm=True, generator=generator)
         for _ in range(n_edge_chunks)],
        [init_mlp(aggr_recipe, layer_norm=True, generator=generator)
         for _ in range(n_node_chunks)],
    )


class SplitSend(NamedTuple):
    """Sender tables of a split (interior/frontier) sharded edge set:
    `owned`, the rank's own sender rows (the interior edges' table), and
    `imports`, the rows the FRONTIER edges index (a halo import buffer).
    The sharded sender hooks return it instead of the concatenated
    [owned ++ imports] table, so that the interior round does not wait
    for the collective (the JAX package's overlap structure)."""

    owned: torch.Tensor
    imports: torch.Tensor


class SplitSendLazy:
    """A SplitSend whose imports come from a deferred collective:
    `gather(x, axis)` all-gathers x along its node axis over the space
    ranks. Deferring lets the round transform the owned rows first and
    gather the transformed (and, in bf16, rounded) table
    (`split_send_tf`): no rank transforms rows it does not own, and bf16
    halves the gathered bytes; transform-then-gather is row for row the
    same math as gather-then-transform."""

    __slots__ = ("owned", "gather")

    def __init__(self, owned, gather):
        self.owned = owned
        self.gather = gather

    @property
    def imports(self):
        """The raw rows gathered (for a round that cannot transform
        first: the batched route)."""
        return self.gather(self.owned, 1 if self.owned.dim() == 3 else 0)

    def imports_tf(self, tf_owned):
        """The gathered table of already-transformed flat (n_owned, W)
        rows."""
        return self.gather(tf_owned, 0)


_SPLIT_SEND_TYPES = (SplitSend, SplitSendLazy)


def split_send_tf(edge_mlp: MLP, send, batch_size: int, compute_dtype=None):
    """(tf_owned, tf_imports): the flat sender transforms x @ W_j of a
    split sender table, stored in the compute dtype. A `SplitSendLazy`
    gathers the transformed owned rows; a `SplitSend`'s imports (a few
    halo rows) are transformed where they are."""
    w0 = edge_mlp.layers[0].w
    h = w0.shape[0] // 3
    w_j = w0[h:2 * h]

    def tf(x):
        t = (node_transform_from_flat(x, w_j, batch_size, compute_dtype)
             if x.dim() == 2 else node_transform_flat(x, w_j, compute_dtype))
        return store(t, compute_dtype)

    tf_owned = tf(send.owned)
    if isinstance(send, SplitSendLazy):
        return tf_owned, send.imports_tf(tf_owned)
    return tf_owned, tf(send.imports)


def embed_edge_features(embedder: MLP, edges: EdgeSet, compute_dtype=None):
    """The edge-feature embedding (M, h); an (interior, frontier) pair for
    a split set."""
    emb = apply_mlp(embedder, edges.features, compute_dtype)
    if edges.frontier is not None:
        return emb, apply_mlp(embedder, edges.frontier.features,
                              compute_dtype)
    return emb


def flatten_nodes(x):
    """(B, N, h) -> (N, B*h)."""
    B, N, h = x.shape
    return x.transpose(0, 1).reshape(N, B * h)


def unflatten_nodes(x_f, batch_size: int):
    """(N, B*h) -> (B, N, h)."""
    N, W = x_f.shape
    return x_f.reshape(N, batch_size, W // batch_size).transpose(0, 1)


def node_transform_flat(x, w, compute_dtype=None):
    """(B, N, h_in) @ (h_in, h_out) -> flat (N, B*h_out), fp32.

    With a compute_dtype both operands are rounded to it (`mlp.mm`): the
    JAX package's `_einsum_f32acc` does so off the CPU only, and the port
    follows the accelerator."""
    return flatten_nodes(mm(x, w, compute_dtype))


def node_transform_from_flat(x_f, w, batch_size: int, compute_dtype=None):
    """Flat (N, B*h_in) -> flat (N, B*h_out): the same (h_in, h_out) matmul
    on every batch group of columns (operands rounded as in
    `node_transform_flat`)."""
    N = x_f.shape[0]
    return mm(x_f.reshape(N, batch_size, -1), w,
              compute_dtype).reshape(N, -1)


def apply_mlp_concat_flat(mlp: MLP, parts: list, compute_dtype=None):
    """apply_mlp_concat emitting flat (N, B*h) node-major output.

    parts: (B, N, d_i) batched or (N, d_i) shared-across-batch tensors."""
    w0 = mlp.layers[0].w
    offset = 0
    acc = None
    for p in parts:
        d = p.shape[-1]
        t = mm(p, w0[offset:offset + d], compute_dtype)
        t = t.transpose(0, 1) if p.dim() == 3 else t[:, None, :]
        acc = t if acc is None else acc + t
        offset += d
    x = finish_mlp(mlp, acc + mlp.layers[0].b, compute_dtype)  # (N, B, h)
    return x.reshape(x.shape[0], -1)


def flat_eligible(edges: EdgeSet, batch_size: int, h: int) -> bool:
    """Whether the flat route (K2/K3) applies to this dense edge set: the
    JAX package's `flat_eligible` without its Pallas-mode switch."""
    return (batch_size * h) % 128 == 0 and edges.num_virt >= _FLAT_MIN_VIRT


def kernel_mlp(mlp: MLP) -> bool:
    """The JAX package's gate for its fused kernels (`two_layer_ln` and
    `fused_layer` in `apply_interaction_net`, `fusable` in
    `edge_messages_and_virt`, `embed_applicable`,
    `grid_update_applicable`): a 2-layer MLP with an output LayerNorm
    (`hidden_layers=1`). Any other MLP takes the plain route on either
    device, as the JAX package's takes its XLA route."""
    return len(mlp.layers) == 2 and mlp.ln is not None


def flat_route(edges: EdgeSet, batch_size: int, h: int, mlp: MLP) -> bool:
    """Whether a round of the edge MLP `mlp` over `edges` takes the flat
    route: a kernel MLP on a `flat_eligible` set. Deeper MLPs keep every
    set batched, as on the JAX package's XLA route, where no set is
    flat."""
    return kernel_mlp(mlp) and flat_eligible(edges, batch_size, h)


def expand_edge_rep(edges: EdgeSet, emb, batch_size: int,
                    kernels: bool = True):
    """Initial edge state from the static embedding (M, h), in the layout
    `apply_interaction_net` uses for this set: flat (M, B*h) on the flat
    route, else batched (B, M, h) (a broadcast view). `kernels`: whether
    the rounds that read the state have kernel MLPs (`kernel_mlp`); if
    not, the state is batched on every set. A split set takes and gives
    (interior, frontier) pairs, the frontier in the interior's layout
    (its sums then add to the interior's without a transpose)."""
    if edges.frontier is not None:
        emb_i, emb_f = emb
        if kernels and flat_eligible(edges, batch_size, emb_i.shape[-1]):
            return emb_i.repeat(1, batch_size), emb_f.repeat(1, batch_size)
        return (emb_i[None].expand(batch_size, *emb_i.shape),
                emb_f[None].expand(batch_size, *emb_f.shape))
    if kernels and flat_eligible(edges, batch_size, emb.shape[-1]):
        return emb.repeat(1, batch_size)
    return emb[None].expand(batch_size, *emb.shape)


def _gather_virt_rows(rec_t, edges: EdgeSet):
    """Receiver rows (..., N_rec, W) -> (..., N_virt, W) per virtual row,
    flat or batched; padding rows map to receiver num_rec-1."""
    if edges.virt_identity:
        extra = edges.num_virt - edges.num_rec
        if extra == 0:
            return rec_t
        last = rec_t[..., -1:, :]
        return torch.cat(
            [rec_t, last.expand(*last.shape[:-2], extra, last.shape[-1])],
            dim=-2)
    return rec_t.index_select(-2, edges.virt_to_rec)


def _rec_fold(virt, rec_slots, rec_mask):
    """Gather-based virt->receiver fold over the row axis (-2): R masked
    row gathers summed in a fixed order (deterministic, unlike an atomic
    scatter-add), in the dtype of virt * rec_mask: a bf16 virt times the
    fp32 mask sums in fp32, times a bf16 mask in bf16."""
    out = None
    for j in range(rec_slots.shape[1]):
        part = virt.index_select(-2, rec_slots[:, j]) * rec_mask[:, j, None]
        out = part if out is None else out + part
    return out


def _fold_virt(edges: EdgeSet, virt, in_virt_dtype=False):
    """(..., N_virt, W) virtual-row sums -> (..., N_rec, W) receiver sums.

    The sums run in fp32, or, with in_virt_dtype, in virt's dtype, one row
    after the other: the rounding of the JAX package's `segment_sum` fold
    (bit for bit on a bf16 virt), which its batched route takes, and its
    flat route past `_JAX_GATHER_FOLD_MAX` rows a receiver. Both are the
    same gather fold here; only the dtype of the sums differs."""
    if edges.virt_identity:
        return virt[..., :edges.num_rec, :]
    mask = edges.rec_mask.to(virt.dtype) if in_virt_dtype else edges.rec_mask
    return _rec_fold(virt, edges.rec_slots, mask)


def _fold_virt_flat(edges: EdgeSet, virt_f):
    """(N_virt, W) flat virtual-row sums -> (N_rec, W): the JAX package's
    flat-route fold, a gather fold in fp32 up to `_JAX_GATHER_FOLD_MAX`
    rows a receiver and a `segment_sum` in virt's dtype past it."""
    return _fold_virt(
        edges, virt_f, in_virt_dtype=edges.rec_slots is not None
        and edges.rec_slots.shape[1] > _JAX_GATHER_FOLD_MAX)


def _virt_counts(edges: EdgeSet):
    """(N_rec, 1) real in-degree per receiver (min 1)."""
    per_virt = edges.mask.view(edges.num_virt, edges.dense_k).sum(
        dim=-1, keepdim=True
    )
    return _fold_virt(edges, per_virt).clamp_min(1.0)


def _aggr_mlp_mixed(mlp: MLP, rec_rep, aggregated_f, compute_dtype=None):
    """AggrMLP(concat(rec_rep, aggregated)) with rec_rep in (B, N, h) and
    aggregated in flat (N, B*h)."""
    w0 = mlp.layers[0].w
    B, N, d = rec_rep.shape
    agg = aggregated_f.reshape(N, B, d).transpose(0, 1)
    x = (mm(rec_rep, w0[:d], compute_dtype) + mm(agg, w0[d:], compute_dtype)
         + mlp.layers[0].b)
    return finish_mlp(mlp, x, compute_dtype)


def edge_round_flat(edge_mlp: MLP, edges: EdgeSet, send_rep, rec_rep,
                    edge_rep_flat=None, *, ew=None, compute_dtype=None,
                    send_tf=None):
    """One flat edge-MLP round: (edge_out_flat | None, virt_flat).

    rec_rep in (B, N, h); send_rep either (B, N, h) batched or already flat
    (N_send, B*h). Edge state either static `ew` (M, h) = emb @ W_e + b0
    (rollout-invariant GNNs: K2) or evolving flat `edge_rep_flat` (M, B*h)
    (processor layers: K3). With a compute_dtype, the node transforms and
    the edge state are stored in it before the kernel, which then runs its
    instance of that dtype and returns its outputs in it. send_tf: the
    sender transform x @ W_j already made (flat, stored in the compute
    dtype: `split_send_tf`); send_rep is then ignored."""
    cd = compute_dtype
    w0 = edge_mlp.layers[0].w
    b0 = edge_mlp.layers[0].b
    h = w0.shape[0] // 3
    w_e, w_j, w_i = w0[:h], w0[h:2 * h], w0[2 * h:]
    B = rec_rep.shape[0]
    if send_tf is None:
        if send_rep.dim() == 2:
            send_tf = node_transform_from_flat(send_rep, w_j, B, cd)
        else:
            send_tf = node_transform_flat(send_rep, w_j, cd)
        send_tf = store(send_tf, cd)
    rec_rows = _gather_virt_rows(
        store(node_transform_flat(rec_rep, w_i, cd), cd), edges)
    mask_p = edges.mask.view(edges.num_virt, edges.dense_k)
    w2, b2 = edge_mlp.layers[1].w, edge_mlp.layers[1].b
    ln = edge_mlp.ln
    if edge_rep_flat is not None:
        return edge_flat.edge_layer_flat(
            store(edge_rep_flat, cd), send_tf, edges.senders, rec_rows, mask_p,
            w_e, b0, w2, b2, ln.scale, ln.bias, fold=edges.fold_senders,
        )
    assert ew is not None, "flat static path requires precomputed ew"
    virt = edge_flat.edge_tail_sum_flat(
        send_tf, edges.senders, ew, rec_rows, mask_p, w2, b2,
        ln.scale, ln.bias, fold=edges.fold_senders,
    )
    return None, virt


def _scatter_to_owner(aggregated, rec_rep, group, agg_axis, rec_axis):
    """Reduce-scatter the ranks' partial sums to the receivers' owner
    ranks (contiguous equal blocks; `build_rs_shard` pads the receivers to a
    multiple of the group's size) and cut rec_rep to the owned rows, so
    that the aggregation MLP runs on the rank's rows alone. agg_axis and
    rec_axis name the receiver axis of each (flat (N, B*h) sums beside a
    batched (B, N, h) rec_rep on the flat route)."""
    block = aggregated.shape[agg_axis] // dist.get_world_size(group)
    return (reduce_scatter(aggregated, group, agg_axis),
            rec_rep.narrow(rec_axis, dist.get_rank(group) * block, block))


def _combine_partial(aggregated, rec_rep, psum_axis, psum_mode, aggr,
                     agg_axis, rec_axis):
    """(receiver sums, rec_rep) after the ranks' partial sums over
    `psum_axis` are combined: all-reduced ("allreduce"), reduce-scattered
    to their owners ("scatter", rec_rep cut to the owned rows), or by a
    callable `psum_mode(aggregated, rec_rep, agg_axis=, rec_axis=)` (the
    halo scheme's push fold). The last two implement sum aggregation
    alone, as the JAX package asserts."""
    if psum_axis is None:
        return aggregated, rec_rep
    if psum_mode != "allreduce" and aggr != "sum":
        raise ValueError("the scatter and fold modes implement sum "
                         "aggregation (mesh_aggr must be 'sum')")
    if callable(psum_mode):
        return psum_mode(aggregated, rec_rep, agg_axis=agg_axis,
                         rec_axis=rec_axis)
    if psum_mode == "scatter":
        return _scatter_to_owner(aggregated, rec_rep, psum_axis, agg_axis,
                                 rec_axis)
    if psum_mode != "allreduce":
        raise ValueError(f"unknown psum_mode {psum_mode!r}")
    return psum(aggregated, psum_axis), rec_rep


def _apply_inet_flat(inet: InteractionNet, edges: EdgeSet, send_rep,
                     rec_rep, edge_rep_flat=None, *, update_edges, aggr,
                     ew=None, compute_dtype=None, psum_axis=None,
                     psum_mode="allreduce"):
    """Flat interaction-net round. rec_rep in (B, N, h); returns rec_out
    (B, N_rec, h) and, when update_edges, the flat edge state. psum_axis:
    the process group whose ranks each hold a part of the edge set; their
    partial receiver sums are combined after the fold as `psum_mode`
    says (`_combine_partial`; "scatter" and a fold return the owned
    rows' rec_out)."""
    assert aggr in ("sum", "mean"), f"Unknown aggregation method: {aggr}"
    edge_out, virt = edge_round_flat(
        inet.edge_mlp, edges, send_rep, rec_rep, edge_rep_flat, ew=ew,
        compute_dtype=compute_dtype,
    )
    aggregated, rec_rep = _combine_partial(
        _fold_virt_flat(edges, virt), rec_rep, psum_axis, psum_mode, aggr,
        agg_axis=0, rec_axis=1)
    if aggr == "mean":
        aggregated = aggregated / _virt_counts(edges)
    rec_out = rec_rep + _aggr_mlp_mixed(inet.aggr_mlp, rec_rep, aggregated,
                                        compute_dtype)
    if update_edges:
        return rec_out, edge_out
    return rec_out


def edge_messages_and_virt(edge_mlp: MLP, edges: EdgeSet, send_rep,
                           rec_rep, edge_rep=None, *, update_edges=False,
                           with_messages=False, ew=None, compute_dtype=None):
    """One batched edge-MLP round: (edge_out or messages (B, M, h) | None,
    virt (B, N_virt, h)). The edge term is the evolving state `edge_rep`
    (B, M, h), updated by P3 (`edge.edge_layer`) when update_edges and
    read by P1 (`edge.edge_tail` on a materialised x0) otherwise, or the
    static `ew` (M, h) = emb @ W_e + b0 of an update_edges=False round,
    read by P2 (`edge.edge_tail_sum`). With update_edges the first output
    is edge_out = edge_rep + messages, which P3 computes in the kernel;
    with with_messages (P1 on an evolving state: HiLAMParallel's chunks)
    it is the messages, as the JAX function returns them; else None
    (hierarchical read-out sweeps).

    With a compute_dtype, the casts are the JAX package's call sites': P3's
    node transforms take the stored activation times the fp32 weight (its
    `jnp.dot` promotes), P1's and P2's round both operands (`mlp.mm`); P2
    and P3 get their inputs stored in the compute dtype and run that
    instance, while P1's x0 = (emb @ W_e + b0) + gathered + rec_rows is
    promoted to fp32 by its fp32 first term and runs the fp32 instance
    (its messages and virt are fp32).

    An edge MLP that is not a `kernel_mlp` takes the JAX package's XLA
    tail instead (`_plain_edge_round`), on either device."""
    if not kernel_mlp(edge_mlp):
        return _plain_edge_round(edge_mlp, edges, send_rep, rec_rep, edge_rep,
                                 update_edges=update_edges,
                                 with_messages=with_messages, ew=ew,
                                 compute_dtype=compute_dtype)
    cd = compute_dtype
    w0, b0 = edge_mlp.layers[0].w, edge_mlp.layers[0].b
    h = w0.shape[0] // 3
    w_e, w_j, w_i = w0[:h], w0[h:2 * h], w0[2 * h:]
    K = edges.dense_k
    tail = (edge_mlp.layers[1].w, edge_mlp.layers[1].b, edge_mlp.ln.scale,
            edge_mlp.ln.bias)
    if update_edges:
        # the activation promoted to the fp32 weight (JAX's `jnp.dot`)
        send_t = store(send_rep.float() @ w_j, cd)
        rec_rows = _gather_virt_rows(store(rec_rep.float() @ w_i, cd), edges)
        return edge.edge_layer(store(edge_rep, cd), send_t, edges.senders,
                               rec_rows, edges.mask, w_e, b0, *tail, K)
    send_t = store(mm(send_rep, w_j, cd), cd)
    rec_rows = _gather_virt_rows(store(mm(rec_rep, w_i, cd), cd), edges)
    if ew is not None:
        return edge.edge_tail_sum(send_t, edges.senders, ew, rec_rows, *tail,
                                  edges.mask, K, with_messages=False)
    x0 = edge.sum_x0(mm(edge_rep, w_e, cd) + b0, send_t, edges.senders,
                     rec_rows, K)
    return edge.edge_tail(x0, *tail, edges.mask, K,
                          with_messages=with_messages)


def _plain_edge_round(edge_mlp: MLP, edges: EdgeSet, send_rep, rec_rep,
                      edge_rep=None, *, update_edges, with_messages, ew,
                      compute_dtype=None):
    """`edge_messages_and_virt` for an edge MLP of any depth: the JAX
    function's XLA tail, in plain PyTorch. Both node transforms round
    their operands (`mlp.mm`); x0 = ew (or edge_rep @ W_e + b0) +
    send_t[senders] + rec_rows repeated, fp32; then the later layers
    (`finish_mlp`: the output stored in the compute dtype before the
    LayerNorm), the messages times the fp32 mask summed over each
    virtual row's K slots."""
    cd = compute_dtype
    w0, b0 = edge_mlp.layers[0].w, edge_mlp.layers[0].b
    h = w0.shape[0] // 3
    w_e, w_j, w_i = w0[:h], w0[h:2 * h], w0[2 * h:]
    K = edges.dense_k
    send_t = mm(send_rep, w_j, cd)
    rec_rows = _gather_virt_rows(mm(rec_rep, w_i, cd), edges)
    if ew is None:
        ew = mm(edge_rep, w_e, cd) + b0
    messages = finish_mlp(edge_mlp, edge.sum_x0(ew, send_t, edges.senders,
                                                rec_rows, K), cd)
    masked = messages * edges.mask
    virt = masked.reshape(*masked.shape[:-2], edges.num_virt, K,
                          masked.shape[-1]).sum(dim=-2)
    if update_edges:
        return edge_rep + messages, virt
    return (messages if with_messages else None), virt


def check_edge_layout(edges: EdgeSet, edge_rep, batch_size: int, h: int,
                      flat: bool):
    """Raise unless edge_rep has the layout of its set's route: flat (M,
    B*h) or batched (B, M, h), as `expand_edge_rep` lays it out."""
    M = edges.senders.shape[0]
    want = (M, batch_size * h) if flat else (batch_size, M, h)
    if tuple(edge_rep.shape) != want:
        raise ValueError(
            f"edge state of shape {tuple(edge_rep.shape)} for a set on the "
            f"{'flat' if flat else 'batched'} route, which takes {want}: "
            "build it with expand_edge_rep")


def _apply_inet_split(inet: InteractionNet, edges: EdgeSet, send, rec_rep,
                      edge_rep=None, *, update_edges, aggr, ew=None,
                      compute_dtype=None):
    """One round over a split (interior/frontier) set of the
    mesh-node-sharded schemes, the counterpart of the JAX package's
    `_apply_inet_split`: the interior round reads `send.owned`, the
    frontier round `send.imports`; the receiver sums of both add up
    (receiver-owned sets: no collective on the sums). The frontier takes
    the interior's route, whatever its own size: on the flat route K2 or
    K3 on each, from the split sender transforms (`split_send_tf`); on
    the batched route P2 (static ew) or P1 on a materialised x0 (an edge
    state; with its messages when update_edges, which the glue adds to the
    state), as the JAX function's `edge_messages_and_virt` calls. The
    edge state, ew and the new edge state are (interior, frontier)
    pairs. The message set is the unsplit set's; only the order of the
    receiver sums differs."""
    fr = edges.frontier
    if aggr != "sum":
        raise ValueError("split sets implement sum aggregation "
                         "(mesh_aggr must be 'sum')")
    cd = compute_dtype
    er_i, er_f = edge_rep if edge_rep is not None else (None, None)
    ew_i, ew_f = ew if ew is not None else (None, None)
    B, h = rec_rep.shape[0], rec_rep.shape[-1]
    flat = flat_route(edges, B, h, inet.edge_mlp)
    if edge_rep is not None:
        check_edge_layout(edges, er_i, B, h, flat)
        check_edge_layout(fr, er_f, B, h, flat)
    if flat:
        tf_o, tf_i = split_send_tf(inet.edge_mlp, send, B, cd)
        eo_i, virt_i = edge_round_flat(inet.edge_mlp, edges, None, rec_rep,
                                       er_i, ew=ew_i, compute_dtype=cd,
                                       send_tf=tf_o)
        eo_f, virt_f = edge_round_flat(inet.edge_mlp, fr, None, rec_rep,
                                       er_f, ew=ew_f, compute_dtype=cd,
                                       send_tf=tf_i)
        aggregated = _fold_virt_flat(edges, virt_i) + _fold_virt_flat(
            fr, virt_f)
        rec_out = rec_rep + _aggr_mlp_mixed(inet.aggr_mlp, rec_rep,
                                            aggregated, cd)
    else:
        m_i, virt_i = edge_messages_and_virt(
            inet.edge_mlp, edges, send.owned, rec_rep, er_i,
            with_messages=update_edges, ew=ew_i, compute_dtype=cd)
        m_f, virt_f = edge_messages_and_virt(
            inet.edge_mlp, fr, send.imports, rec_rep, er_f,
            with_messages=update_edges, ew=ew_f, compute_dtype=cd)
        aggregated = (_fold_virt(edges, virt_i, in_virt_dtype=True)
                      + _fold_virt(fr, virt_f, in_virt_dtype=True))
        rec_out = rec_rep + apply_mlp_concat(inet.aggr_mlp,
                                             [rec_rep, aggregated], cd)
        eo_i = None if m_i is None else er_i + m_i
        eo_f = None if m_f is None else er_f + m_f
    if update_edges:
        return rec_out, (eo_i, eo_f)
    return rec_out


def apply_interaction_net(inet: InteractionNet, edges: EdgeSet, send_rep,
                          rec_rep, edge_rep=None, *, update_edges=True,
                          aggr="sum", ew=None, compute_dtype=None,
                          psum_axis=None, psum_mode="allreduce"):
    """One interaction-net round on a dense edge set, on the route the JAX
    package takes for it (`flat_route`: `flat_eligible` and a kernel MLP).

    send_rep (B, N_send, h), rec_rep (B, N_rec, h). The edge term is either
    the evolving state `edge_rep` (flat (M, B*h) on the flat route, batched
    (B, M, h) on the batched one, as `expand_edge_rep` lays it out) or, for
    update_edges=False, the static `ew` (M, h) = emb @ W_e + b0.

    Flat route: `_apply_inet_flat` (K2 or K3). Batched route:
    `edge_messages_and_virt` (P1, P2 or P3; the plain tail for an edge MLP
    of another depth). Returns rec_out (B, N_rec, h)
    and, when update_edges, the new edge state in the same layout. With
    compute_dtype=torch.bfloat16 (the JAX package's bf16 path): fp32
    parameters, node and edge states stored in bf16, and each product
    rounded as its JAX call site rounds it.

    psum_axis (a process group, or None): the set is one rank's part of a
    sharded edge set (`parallel/grid_sharded.py`), and the ranks' partial
    receiver sums are combined over the group after the virtual-row fold,
    before the aggregation MLP: all-reduced (`parallel.collectives.psum`,
    whose backward all-reduces the cotangent), or with psum_mode=
    "scatter" reduce-scattered to the receivers' owners and the rank's
    owned rows of rec_out returned (the mesh_rs scheme), or folded by a
    callable psum_mode (the mesh_halo scheme's push fold).

    send_rep may be a `SplitSend` (or `SplitSendLazy`) for a split set
    (`edges.frontier`): `_apply_inet_split`, with no collective on the
    sums (receiver-owned sets)."""
    if aggr not in ("sum", "mean"):
        raise ValueError(f"Unknown aggregation method: {aggr}")
    if edge_rep is None and (ew is None or update_edges):
        raise ValueError("pass an edge state, or a static ew with "
                         "update_edges=False")
    if isinstance(send_rep, _SPLIT_SEND_TYPES) != (edges.frontier
                                                  is not None):
        raise ValueError("a split set (edges.frontier) takes a SplitSend "
                         "sender table, and a SplitSend a split set")
    if edge_rep is not None:
        ew = None  # an edge state takes precedence
    if edges.frontier is not None:
        if psum_axis is not None:
            raise ValueError("split sets are receiver-owned: their sums "
                             "need no collective")
        return _apply_inet_split(inet, edges, send_rep, rec_rep, edge_rep,
                                 update_edges=update_edges, aggr=aggr, ew=ew,
                                 compute_dtype=compute_dtype)
    B, h = rec_rep.shape[0], rec_rep.shape[-1]
    flat = flat_route(edges, B, h, inet.edge_mlp)
    if edge_rep is not None:
        check_edge_layout(edges, edge_rep, B, h, flat)
    if flat:
        return _apply_inet_flat(inet, edges, send_rep, rec_rep, edge_rep,
                                update_edges=update_edges, aggr=aggr, ew=ew,
                                compute_dtype=compute_dtype,
                                psum_axis=psum_axis, psum_mode=psum_mode)
    edge_out, virt = edge_messages_and_virt(
        inet.edge_mlp, edges, send_rep, rec_rep, edge_rep,
        update_edges=update_edges, ew=ew, compute_dtype=compute_dtype,
    )
    aggregated, rec_rep = _combine_partial(
        _fold_virt(edges, virt, in_virt_dtype=True), rec_rep, psum_axis,
        psum_mode, aggr, agg_axis=1, rec_axis=1)
    if aggr == "mean":
        aggregated = aggregated / _virt_counts(edges)
    rec_out = rec_rep + apply_mlp_concat(inet.aggr_mlp, [rec_rep, aggregated],
                                         compute_dtype)
    if update_edges:
        return rec_out, edge_out
    return rec_out
