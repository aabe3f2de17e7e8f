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
is its graph's dense EdgeSet, on the route `flat_eligible` gives it: a
flat chunk runs `edge_round_flat` (K3, edge state (M, B*h)), a batched
one P1 on a materialised x0 with its messages (`edge_messages_and_virt`,
edge state (B, M, h)). Each chunk's receiver sums go into its level's
batched accumulator in chunk order, and each level then takes its
aggregation MLP. The parameters nest as the JAX package's
(`processor.{layer}.edge_mlps.{chunk}`, `.aggr_mlps.{level}`), so
`convert.params_from_jax` loads a JAX HiLAMParallel tree key for key.

Under the grid scheme (`parallel/grid_sharded.py`) each chunk is a rank's
part of its edge set, and each level's partial sums are all-reduced once
a layer (over `_mesh_psum_axis`) before its aggregation MLP. Left out:
the JAX model's `SplitSend` branch and `split_send_tf`, which belong to
the mesh-node-sharded schemes (`mesh_rs`, `mesh_halo`: ROADMAP.md queue
1, item 6), and its TPU window layout (`win=`), which the port dropped
for every model.
"""

from __future__ import annotations

from torch import nn

from ..ops.message_passing import (
    _check_inet,
    _fold_virt,
    _fold_virt_flat,
    check_edge_layout,
    edge_messages_and_virt,
    edge_round_flat,
    flat_eligible,
    init_interaction_net_chunked,
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
        all-reduced over `_mesh_psum_axis` (one collective a level, under
        the grid scheme)."""
        _check_inet(inet)
        cd = self.compute_dtype
        B, h = mesh_rep_levels[0].shape[0], mesh_rep_levels[0].shape[-1]
        aggregated = [None] * self.num_levels
        new_edge_reps = []
        for c, es in enumerate(self._chunk_edge_sets()):
            send = mesh_rep_levels[self._chunk_send_level[c]]
            rec_l = self._chunk_rec_level[c]
            rec = mesh_rep_levels[rec_l]
            mlp = inet.edge_mlps[c]
            flat = flat_eligible(es, B, h)
            check_edge_layout(es, edge_reps[c], B, h, flat)
            if flat:
                # the level accumulators stay batched, so that flat and
                # batched chunks sum into the same level
                new_edge, virt = edge_round_flat(mlp, es, send, rec,
                                                 edge_reps[c],
                                                 compute_dtype=cd)
                agg_c = unflatten_nodes(_fold_virt_flat(es, virt), B)
            else:
                messages, virt = edge_messages_and_virt(
                    mlp, es, send, rec, edge_reps[c], with_messages=True,
                    compute_dtype=cd)
                agg_c = _fold_virt(es, virt, in_virt_dtype=True)
                new_edge = edge_reps[c] + messages
            aggregated[rec_l] = (agg_c if aggregated[rec_l] is None
                                 else aggregated[rec_l] + agg_c)
            new_edge_reps.append(new_edge)
        aggregated = [psum(a, self._mesh_psum_axis) for a in aggregated]
        return aggregated, new_edge_reps

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
