"""Hi-LAM: sequential down/up sweeps through the hierarchy per layer.

Counterpart of neural_lam_tpu/models/hi_lam.py (ref:
neural_lam/models/hi_lam.py:11-207): per processor layer, a down sweep
(top -> bottom, alternating a down-edge GNN and a same-level GNN) then an
up sweep (bottom -> top, alternating an up-edge GNN and a same-level GNN),
with distinct GNN stacks per direction and layer. The parameter lists nest
as the JAX package's do (`mesh_down_gnns[layer][level]`, ...), so
`convert.params_from_jax` loads a JAX HiLAM tree key for key.
"""

from __future__ import annotations

from torch import nn

from ..ops.message_passing import apply_interaction_net
from .base_hi_graph_model import BaseHiGraphModel


class HiLAM(BaseHiGraphModel):
    def init_hi_processor_params(self, generator):
        L = self.num_levels
        P = self.args.processor_layers

        def stacks(n):
            return nn.ModuleList(self.gnns(n, generator) for _ in range(P))

        self.mesh_down_gnns = stacks(L - 1)
        self.mesh_down_same_gnns = stacks(L)
        self.mesh_up_gnns = stacks(L - 1)
        self.mesh_up_same_gnns = stacks(L)

    def mesh_down_step(self, mesh_rep_levels, mesh_same_rep, mesh_down_rep,
                       down_gnns, same_gnns):
        """(ref: hi_lam.py:82-124)"""
        g, cd = self.graph, self.compute_dtype
        top = self.num_levels - 1
        # same-level processing on the top level
        mesh_rep_levels[-1], mesh_same_rep[-1] = self._same_level(
            same_gnns[-1], top, mesh_rep_levels[-1], mesh_same_rep[-1])
        for level_l, down_gnn, same_gnn in zip(
                range(self.num_levels - 2, -1, -1), reversed(down_gnns),
                reversed(same_gnns[:-1])):
            new_node_rep, mesh_down_rep[level_l] = apply_interaction_net(
                down_gnn, g.down[level_l],
                self._hi_sender_rep(mesh_rep_levels[level_l + 1], "down",
                                    level_l),
                mesh_rep_levels[level_l], mesh_down_rep[level_l],
                compute_dtype=cd, psum_axis=self._hi_psum_axis(level_l),
            )
            mesh_rep_levels[level_l], mesh_same_rep[level_l] = (
                self._same_level(same_gnn, level_l, new_node_rep,
                                 mesh_same_rep[level_l]))
        return mesh_rep_levels, mesh_same_rep, mesh_down_rep

    def _same_level(self, gnn, level, rep, edge_rep):
        """One same-level (m2m) round at `level`: (rep, edge state)."""
        return apply_interaction_net(
            gnn, self.graph.m2m[level],
            self._hi_sender_rep(rep, "m2m", level), rep, edge_rep,
            compute_dtype=self.compute_dtype,
            psum_axis=self._hi_psum_axis(level))

    def mesh_up_step(self, mesh_rep_levels, mesh_same_rep, mesh_up_rep,
                     up_gnns, same_gnns):
        """(ref: hi_lam.py:126-163)"""
        g, cd = self.graph, self.compute_dtype
        # same-level processing on level 0
        mesh_rep_levels[0], mesh_same_rep[0] = self._same_level(
            same_gnns[0], 0, mesh_rep_levels[0], mesh_same_rep[0])
        for level_l, (up_gnn, same_gnn) in enumerate(
                zip(up_gnns, same_gnns[1:]), start=1):
            new_node_rep, mesh_up_rep[level_l - 1] = apply_interaction_net(
                up_gnn, g.up[level_l - 1],
                self._hi_sender_rep(mesh_rep_levels[level_l - 1], "up",
                                    level_l - 1),
                mesh_rep_levels[level_l], mesh_up_rep[level_l - 1],
                compute_dtype=cd, psum_axis=self._hi_psum_axis(level_l),
            )
            mesh_rep_levels[level_l], mesh_same_rep[level_l] = (
                self._same_level(same_gnn, level_l, new_node_rep,
                                 mesh_same_rep[level_l]))
        return mesh_rep_levels, mesh_same_rep, mesh_up_rep

    def hi_processor_step(self, mesh_rep_levels, mesh_same_rep, mesh_up_rep,
                          mesh_down_rep):
        """(ref: hi_lam.py:165-207)"""
        for down_gnns, down_same_gnns, up_gnns, up_same_gnns in zip(
                self.mesh_down_gnns, self.mesh_down_same_gnns,
                self.mesh_up_gnns, self.mesh_up_same_gnns):
            mesh_rep_levels, mesh_same_rep, mesh_down_rep = (
                self.mesh_down_step(mesh_rep_levels, mesh_same_rep,
                                    mesh_down_rep, down_gnns, down_same_gnns)
            )
            mesh_rep_levels, mesh_same_rep, mesh_up_rep = self.mesh_up_step(
                mesh_rep_levels, mesh_same_rep, mesh_up_rep, up_gnns,
                up_same_gnns,
            )
        return mesh_rep_levels, mesh_same_rep, mesh_up_rep, mesh_down_rep
