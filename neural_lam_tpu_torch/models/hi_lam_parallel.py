"""Hi-LAM Parallel: every hierarchical edge set in one fused round a layer.

Counterpart of neural_lam_tpu/models/hi_lam_parallel.py (ref:
neural_lam/models/hi_lam_parallel.py:12-99). The reference concatenates
the m2m, up and down edge sets into one edge array and runs one
interaction-net stack whose MLPs are chunked per edge set and per node
level (SplitMLPs). Per processor layer:

    messages_c  = EdgeMLP_c(edge chunk c)                 (per chunk)
    aggregated  = sum of all chunks' messages per node    (all chunks)
    node_l     += AggrMLP_l(concat(node_l, aggregated_l)) (per level)
    edges_c    += messages_c

As in the JAX package, node states stay per-level tensors and each chunk
is its graph's dense EdgeSet, on the route `flat_route` gives it: a
flat chunk runs `edge_round_flat` (K3, edge state (M, B*h)), a batched
one P1 on a materialised x0 with its messages (`edge_messages_and_virt`,
edge state (B, M, h); with MLPs of another depth every chunk is batched
and takes the plain tail, as on the JAX package's XLA route). Each
chunk's receiver sums go into its level's batched accumulator in chunk
order, and each level then takes its aggregation MLP. The parameters nest as the JAX package's
(`processor.{layer}.edge_mlps.{chunk}`, `.aggr_mlps.{level}`), so
`convert.params_from_jax` loads a JAX HiLAMParallel tree key for key.

Under the sharded schemes (`parallel/grid_sharded.py`) each chunk is a
rank's part of its edge set. Each level's partial sums are all-reduced
once a layer (over `_hi_psum_axis(level)`: every level under the grid
scheme, the upper levels under mesh_rs, none under mesh_halo) before its
aggregation MLP. A chunk whose senders come through a collective (its
`_hi_sender_rep` a `SplitSend`: m2m[0] under mesh_rs, every chunk with a
halo plan under mesh_halo) runs as the JAX model's `SplitSend` branch: an
interior and a frontier round on the interior's route, from the split
sender transforms (`split_send_tf`) on the flat route. The JAX model's
TPU window layout (`win=`) is dropped, as for every model.
"""

from __future__ import annotations

from torch import nn

from ..ops.message_passing import (
    _SPLIT_SEND_TYPES,
    _fold_virt,
    _fold_virt_flat,
    check_edge_layout,
    edge_messages_and_virt,
    edge_round_flat,
    flat_route,
    init_interaction_net_chunked,
    split_send_tf,
    unflatten_nodes,
)
from ..ops.mlp import apply_mlp_concat
from ..parallel.collectives import psum
from .base_hi_graph_model import BaseHiGraphModel


class HiLAMParallel(BaseHiGraphModel):
    def __init__(self, args, config, datastore, graph, device="cuda",
                 generator=None):
        super().__init__(args, config, datastore, graph, device, generator)
        # chunk c sends from level _chunk_send_level[c] to level
        # _chunk_rec_level[c]: m2m levels, then up, then down (ref:
        # hi_lam_parallel.py:26-32)
        L = self.num_levels
        self._chunk_send_level = (
            list(range(L)) + list(range(L - 1)) + list(range(1, L)))
        self._chunk_rec_level = (
            list(range(L)) + list(range(1, L)) + list(range(L - 1)))
        # (kind, index) of each chunk, for `_hi_sender_rep`
        self._chunk_kinds = ([("m2m", i) for i in range(L)]
                             + [("up", i) for i in range(L - 1)]
                             + [("down", i) for i in range(L - 1)])

    def _chunk_edge_sets(self):
        g = self.graph
        return list(g.m2m) + list(g.up) + list(g.down)

    def init_hi_processor_params(self, generator):
        h, hl = self.args.hidden_dim, self.args.hidden_layers
        L = self.num_levels
        self.processor = nn.ModuleList(
            init_interaction_net_chunked(h, 3 * L - 2, L, hidden_layers=hl,
                                         generator=generator)
            for _ in range(self.args.processor_layers))

    def aggregate_chunks(self, inet, mesh_rep_levels, edge_reps):
        """The edge half of one fused round of the chunked interaction net
        `inet`: (per-level receiver sums (B, N_l, h), new chunk edge
        states), every chunk's sums added into its level in chunk order
        (ref: hi_lam_parallel.py:59-82), then each level's sums
        all-reduced over `_hi_psum_axis(level)` (one collective a level
        where the level's chunks are split over the ranks)."""
        cd = self.compute_dtype
        B, h = mesh_rep_levels[0].shape[0], mesh_rep_levels[0].shape[-1]
        aggregated = [None] * self.num_levels
        new_edge_reps = []
        for c, es in enumerate(self._chunk_edge_sets()):
            send = self._hi_sender_rep(
                mesh_rep_levels[self._chunk_send_level[c]],
                *self._chunk_kinds[c])
            rec_l = self._chunk_rec_level[c]
            rec = mesh_rep_levels[rec_l]
            mlp = inet.edge_mlps[c]
            flat = flat_route(es, B, h, mlp)
            if isinstance(send, _SPLIT_SEND_TYPES):
                agg_c, new_edge = self._split_chunk(mlp, es, send, rec,
                                                    edge_reps[c], flat)
            elif flat:
                check_edge_layout(es, edge_reps[c], B, h, flat)
                # the level accumulators stay batched, so that flat and
                # batched chunks sum into the same level
                new_edge, virt = edge_round_flat(mlp, es, send, rec,
                                                 edge_reps[c],
                                                 compute_dtype=cd)
                agg_c = unflatten_nodes(_fold_virt_flat(es, virt), B)
            else:
                check_edge_layout(es, edge_reps[c], B, h, flat)
                messages, virt = edge_messages_and_virt(
                    mlp, es, send, rec, edge_reps[c], with_messages=True,
                    compute_dtype=cd)
                agg_c = _fold_virt(es, virt, in_virt_dtype=True)
                new_edge = edge_reps[c] + messages
            aggregated[rec_l] = (agg_c if aggregated[rec_l] is None
                                 else aggregated[rec_l] + agg_c)
            new_edge_reps.append(new_edge)
        aggregated = [psum(a, self._hi_psum_axis(lvl))
                      for lvl, a in enumerate(aggregated)]
        return aggregated, new_edge_reps

    def _split_chunk(self, mlp, es, send, rec, edge_rep, flat):
        """A split chunk's (receiver sums (B, N, h), new (interior,
        frontier) edge states) (ref: the JAX model's SplitSend branch):
        the interior round reads the owned rows, the frontier round the
        imports, both on the interior's route (`flat`)."""
        cd = self.compute_dtype
        B, h = rec.shape[0], rec.shape[-1]
        fr = es.frontier
        er_i, er_f = edge_rep
        check_edge_layout(es, er_i, B, h, flat)
        check_edge_layout(fr, er_f, B, h, flat)
        if flat:
            tf_o, tf_i = split_send_tf(mlp, send, B, cd)
            ne_i, virt_i = edge_round_flat(mlp, es, None, rec, er_i,
                                           compute_dtype=cd, send_tf=tf_o)
            ne_f, virt_f = edge_round_flat(mlp, fr, None, rec, er_f,
                                           compute_dtype=cd, send_tf=tf_i)
            return unflatten_nodes(_fold_virt_flat(es, virt_i)
                                   + _fold_virt_flat(fr, virt_f),
                                   B), (ne_i, ne_f)
        m_i, virt_i = edge_messages_and_virt(mlp, es, send.owned, rec, er_i,
                                             with_messages=True,
                                             compute_dtype=cd)
        m_f, virt_f = edge_messages_and_virt(mlp, fr, send.imports, rec,
                                             er_f, with_messages=True,
                                             compute_dtype=cd)
        return (_fold_virt(es, virt_i, in_virt_dtype=True)
                + _fold_virt(fr, virt_f, in_virt_dtype=True),
                (er_i + m_i, er_f + m_f))

    def processor_layer(self, inet, mesh_rep_levels, edge_reps):
        """One fused round over every chunk (ref: hi_lam_parallel.py:
        55-99): (new level states, new chunk edge states), each level
        updated by its aggregation MLP on its receiver sums."""
        aggregated, new_edge_reps = self.aggregate_chunks(
            inet, mesh_rep_levels, edge_reps)
        new_levels = [
            rep + apply_mlp_concat(inet.aggr_mlps[lvl], [rep, agg],
                                   self.compute_dtype)
            for lvl, (rep, agg) in enumerate(zip(mesh_rep_levels,
                                                 aggregated))
        ]
        return new_levels, new_edge_reps

    def hi_processor_step(self, mesh_rep_levels, mesh_same_rep, mesh_up_rep,
                          mesh_down_rep):
        """(ref: hi_lam_parallel.py:55-99)"""
        L = self.num_levels
        edge_reps = list(mesh_same_rep) + list(mesh_up_rep) + list(
            mesh_down_rep)
        for inet in self.processor:
            mesh_rep_levels, edge_reps = self.processor_layer(
                inet, mesh_rep_levels, edge_reps)
        return (mesh_rep_levels, edge_reps[:L], edge_reps[L:2 * L - 1],
                edge_reps[2 * L - 1:])
