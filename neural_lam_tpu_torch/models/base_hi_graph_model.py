"""Hierarchical graph model base: per-level embedders, init/read-out sweeps.

Counterpart of neural_lam_tpu/models/base_hi_graph_model.py (ref:
neural_lam/models/base_hi_graph_model.py:12-235): a mesh-init GNN sweep
bottom -> top over the up edges, an abstract processor, and a read-out
sweep top -> bottom over the down edges (no edge update); only the bottom
level enters the encoder and decoder. Every round is an
`apply_interaction_net` on the route the JAX package takes for its edge
set, so a level's small sets run the batched kernels (P1, P3) beside the
flat ones (K3) of the large sets.
"""

from __future__ import annotations

from torch import nn

from ..ops.message_passing import (
    apply_interaction_net,
    embed_edge_features,
    expand_edge_rep,
    init_interaction_net,
)
from ..ops.mlp import apply_mlp, init_mlp
from .base_graph_model import BaseGraphModel, expand_to_batch


class BaseHiGraphModel(BaseGraphModel):
    def __init__(self, args, config, datastore, graph, device="cuda",
                 generator=None):
        if not graph.hierarchical:
            raise ValueError("a hierarchical model needs a hierarchical graph")
        super().__init__(args, config, datastore, graph, device, generator)

    @property
    def num_levels(self) -> int:
        return len(self.graph.level_sizes)

    # --- sharding hooks (parallel/grid_sharded.py). Unsharded and under
    # the grid scheme every hierarchical GNN combines its partial sums
    # over `_mesh_psum_axis` and reads its senders as they are; the
    # mesh-node-sharded schemes override both by level and edge set ---

    def _hi_psum_axis(self, rec_level):
        """The group to all-reduce a hierarchical GNN's partial sums over,
        by its RECEIVERS' level (mesh_rs: None at the receiver-owned
        bottom level; mesh_halo: None at every level)."""
        return self._mesh_psum_axis

    def _hi_sender_rep(self, rep, kind, idx):
        """Hook: the table the edge set `kind` ("m2m", "up" or "down")
        `idx` reads its SENDERS from; `rep` by default, a `SplitSend` where
        the senders' level is distributed (mesh_rs: m2m[0]; mesh_halo:
        every set with a halo plan)."""
        return rep

    def get_num_mesh(self):
        """All mesh nodes; all but the bottom level are ignored in
        encode/decode (ref: base_hi_graph_model.py:102-113)."""
        num_mesh_nodes = sum(self.graph.level_sizes)
        return num_mesh_nodes, num_mesh_nodes - self.graph.level_sizes[0]

    def init_extra_params(self, generator):
        g = self.graph
        end = self.mlp_blueprint_end
        L = self.num_levels

        def mlps(d_in, n):
            return nn.ModuleList(init_mlp([d_in] + end, generator=generator)
                                 for _ in range(n))

        self.mesh_embedders = mlps(g.mesh_static_features[0].shape[1], L)
        self.mesh_same_embedders = mlps(g.m2m[0].features.shape[1], L)
        self.mesh_up_embedders = mlps(g.up[0].features.shape[1], L - 1)
        self.mesh_down_embedders = mlps(g.down[0].features.shape[1], L - 1)
        self.mesh_init_gnns = self.gnns(L - 1, generator)
        self.mesh_read_gnns = self.gnns(L - 1, generator)
        self.init_hi_processor_params(generator)

    def gnns(self, n, generator):
        """n interaction nets of the model's width."""
        h, hl = self.args.hidden_dim, self.args.hidden_layers
        return nn.ModuleList(
            init_interaction_net(h, hidden_layers=hl, generator=generator)
            for _ in range(n)
        )

    def init_hi_processor_params(self, generator):
        raise NotImplementedError

    def embedd_mesh_nodes(self):
        """Bottom level only (ref: base_hi_graph_model.py:115-122)."""
        return apply_mlp(self.mesh_embedders[0],
                         self.graph.mesh_static_features[0],
                         self.compute_dtype)

    def precompute_process_ctx(self):
        """Level and edge-set embeddings, once per rollout."""
        g, cd = self.graph, self.compute_dtype

        def embed(embedders, sets):
            # (interior, frontier) pairs where the sharded sets are split
            return [embed_edge_features(e, es, cd)
                    for e, es in zip(embedders, sets)]

        return {
            "upper_mesh_emb": [
                apply_mlp(e, f, cd) for e, f in zip(
                    self.mesh_embedders[1:], g.mesh_static_features[1:])],
            "same_emb": embed(self.mesh_same_embedders, g.m2m),
            "up_emb": embed(self.mesh_up_embedders, g.up),
            "down_emb": embed(self.mesh_down_embedders, g.down),
        }

    def process_step(self, mesh_rep, batch_size, ctx):
        """(ref: base_hi_graph_model.py:124-217)"""
        g = self.graph
        mesh_rep_levels = [mesh_rep] + [
            expand_to_batch(e, batch_size) for e in ctx["upper_mesh_emb"]
        ]
        # edge states in the layout apply_interaction_net uses per edge set
        # (flat (M, B*h) on the flat route, batched (B, M, h) otherwise)
        mesh_same_rep, mesh_up_rep, mesh_down_rep = (
            [expand_edge_rep(es, e, batch_size, self.kernel_mlps)
             for es, e in zip(sets, embs)]
            for sets, embs in ((g.m2m, ctx["same_emb"]), (g.up, ctx["up_emb"]),
                               (g.down, ctx["down_emb"]))
        )

        # MESH INIT: sweep bottom -> top over up edges (update edges)
        for level_l, gnn in enumerate(self.mesh_init_gnns, start=1):
            mesh_rep_levels[level_l], mesh_up_rep[level_l - 1] = (
                apply_interaction_net(
                    gnn, g.up[level_l - 1],
                    self._hi_sender_rep(mesh_rep_levels[level_l - 1], "up",
                                        level_l - 1),
                    mesh_rep_levels[level_l], mesh_up_rep[level_l - 1],
                    compute_dtype=self.compute_dtype,
                    psum_axis=self._hi_psum_axis(level_l),
                )
            )

        mesh_rep_levels, _, _, mesh_down_rep = self.hi_processor_step(
            mesh_rep_levels, mesh_same_rep, mesh_up_rep, mesh_down_rep
        )

        # READ OUT: sweep top -> bottom over down edges (no edge update)
        for level_l, gnn in zip(range(self.num_levels - 2, -1, -1),
                                reversed(self.mesh_read_gnns)):
            mesh_rep_levels[level_l] = apply_interaction_net(
                gnn, g.down[level_l],
                self._hi_sender_rep(mesh_rep_levels[level_l + 1], "down",
                                    level_l),
                mesh_rep_levels[level_l], mesh_down_rep[level_l],
                update_edges=False, compute_dtype=self.compute_dtype,
                psum_axis=self._hi_psum_axis(level_l),
            )
        return mesh_rep_levels[0]

    def hi_processor_step(self, mesh_rep_levels, mesh_same_rep, mesh_up_rep,
                          mesh_down_rep):
        raise NotImplementedError
