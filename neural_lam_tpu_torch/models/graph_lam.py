"""Flat (non-hierarchical) GraphCast/Keisler-style model.

Counterpart of neural_lam_tpu/models/graph_lam.py (ref:
neural_lam/models/graph_lam.py:12-91): mesh and m2m embedders and a
processor stack of interaction nets over the single merged multiscale m2m
edge set, each layer one interaction net on the route the JAX package
takes for the set (K3 on the flat route, P3 on the batched one).
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
from .base_graph_model import BaseGraphModel


class GraphLAM(BaseGraphModel):
    def __init__(self, args, config, datastore, graph, device="cuda",
                 generator=None):
        if graph.hierarchical:
            raise ValueError("GraphLAM does not use a hierarchical mesh graph")
        super().__init__(args, config, datastore, graph, device, generator)

    @property
    def m2m(self):
        return self.graph.m2m[0]

    @property
    def mesh_static(self):
        return self.graph.mesh_static_features[0]

    def get_num_mesh(self):
        return self.graph.level_sizes[0], 0

    def init_extra_params(self, generator):
        mesh_dim = self.mesh_static.shape[1]
        m2m_dim = self.m2m.features.shape[1]
        h, hl = self.args.hidden_dim, self.args.hidden_layers
        end = self.mlp_blueprint_end
        self.mesh_embedder = init_mlp([mesh_dim] + end, generator=generator)
        self.m2m_embedder = init_mlp([m2m_dim] + end, generator=generator)
        self.processor = nn.ModuleList(
            init_interaction_net(h, hidden_layers=hl, generator=generator)
            for _ in range(self.args.processor_layers)
        )

    def embedd_mesh_nodes(self):
        return apply_mlp(self.mesh_embedder, self.mesh_static,
                         self.compute_dtype)

    def precompute_process_ctx(self):
        # an (interior, frontier) pair on a split m2m (mesh_rs, mesh_halo)
        return {"m2m_emb": embed_edge_features(self.m2m_embedder, self.m2m,
                                               self.compute_dtype)}

    def process_step(self, mesh_rep, batch_size, ctx):
        """Processor stack sharing the single m2m edge set
        (ref: graph_lam.py:73-91)."""
        edge_rep = expand_edge_rep(self.m2m, ctx["m2m_emb"], batch_size,
                                   self.kernel_mlps)
        for layer in self.processor:
            mesh_rep, edge_rep = apply_interaction_net(
                layer, self.m2m, self._mesh_sender_rep(mesh_rep), mesh_rep,
                edge_rep,
                update_edges=True, aggr=self.args.mesh_aggr,
                compute_dtype=self.compute_dtype,
                psum_axis=self._mesh_psum_axis,
            )
        return mesh_rep
