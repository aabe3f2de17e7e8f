"""Encode-process-decode skeleton over a loaded graph.

Counterpart of neural_lam_tpu/models/base_graph_model.py (ref:
neural_lam/models/base_graph_model.py:12-177): grid/g2m/m2g embedders, the
g2m encoder GNN, an abstract processor, the m2g decoder GNN with the
residual grid MLP and the output MLP (no LayerNorm), and delta prediction
with diff-stat rescale and residual over prev_state.

`predict_step` takes the JAX package's two routes, chosen by the same test
(`_flat_grid_eligible`): the flat-grid route (`_predict_step_flat_grid`),
where the grid side stays in the flat (N, B*h) layout from the embedder
(K1) through the g2m encoder (K2) to the fused decoder (K4); and the
batched route, where the grid MLPs are plain matrix products and g2m and
m2g are interaction nets on whichever route `apply_interaction_net` picks
for them (P2 on the batched route, e.g. at batch 1).

With `compute_dtype="bfloat16"` the model follows the JAX package's bf16
path: parameters fp32, node, edge and grid representations stored in
bf16, each product's operands rounded as its JAX call site rounds them,
the kernels' bf16 instances; the output residual over the fp32 state
stays fp32 (`_finish_output`: bf16 times fp32 promotes).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..graph.storage import LoadedGraph
from ..ops import embed, grid_update
from ..ops.message_passing import (
    _apply_inet_flat,
    apply_interaction_net,
    flat_eligible,
    flatten_nodes,
    init_interaction_net,
    kernel_mlp,
    node_transform_flat,
    unflatten_nodes,
)
from ..ops.mlp import apply_mlp, apply_mlp_concat, init_mlp, store
from .ar_model import ARModelBase, ModelArgs


def expand_to_batch(x, batch_size):
    """(N, d) -> (B, N, d) broadcast (ref: ar_model.py:204-209)."""
    return x[None].expand(batch_size, *x.shape)


class BaseGraphModel(ARModelBase):
    # set on a rank's twin by the sharded schemes (parallel/grid_sharded.py):
    # _g2m_psum_axis -- the process group over which the ranks' partial g2m
    # aggregations are combined; _mesh_psum_axis -- the group to all-reduce
    # the partial mesh-level (m2m/up/down) aggregations over, set when
    # those edge sets are per-rank edge chunks. None outside a sharded run.
    _g2m_psum_axis = None
    _mesh_psum_axis = None
    # how the g2m partials combine (`apply_interaction_net`'s psum_mode):
    # "allreduce" (grid scheme); "scatter" (mesh_rs: reduce-scattered to
    # the owners of the bottom mesh rows, mesh state the rank's owned rows
    # from there on) or a halo fold (mesh_halo), each paired with sender
    # hooks below that bring the other ranks' rows in
    _g2m_psum_mode = "allreduce"

    def _mesh_sender_rep(self, mesh_rep):
        """Hook: the table the bottom mesh level's edge SENDERS read.
        Identity while mesh state is whole on every rank; the
        mesh-node-sharded schemes return a `SplitSend` of the owned rows
        and their all-gather or halo imports."""
        return mesh_rep

    def _m2g_sender_rep(self, mesh_rep):
        """Hook: the m2g decoder's sender table (batched route).
        `_mesh_sender_rep` by default; the sharded schemes give the whole
        all-gathered table (mesh_rs) or [owned ++ m2g halo imports]
        (mesh_halo)."""
        return self._mesh_sender_rep(mesh_rep)

    def _m2g_sender_tf(self, mesh_rep, w_j, cd):
        """Hook: the transformed flat m2g sender table (N_send, B*h) that
        the fused decoder (K4) gathers from, stored in the compute dtype.
        mesh_rs transforms the owned rows first and all-gathers the
        transformed table."""
        return store(node_transform_flat(self._m2g_sender_rep(mesh_rep),
                                         w_j, cd), cd)

    def __init__(self, args: ModelArgs, config, datastore,
                 graph: LoadedGraph, device="cuda",
                 generator: torch.Generator | None = None):
        super().__init__(args, config, datastore, device)
        self.graph = graph
        assert graph.num_grid_nodes == self.num_grid_nodes, (
            f"graph has {graph.num_grid_nodes} grid nodes but datastore has "
            f"{self.num_grid_nodes}"
        )
        self.hierarchical = graph.hierarchical
        # [hidden_dim] * (hidden_layers + 1) (ref: base_graph_model.py:48)
        self.mlp_blueprint_end = [args.hidden_dim] * (args.hidden_layers + 1)
        self.num_mesh_nodes, _ = self.get_num_mesh()
        self._init_params(generator)

    # --- abstract over mesh structure (ref: base_graph_model.py:82-104) ---

    def get_num_mesh(self):
        raise NotImplementedError

    def embedd_mesh_nodes(self):
        raise NotImplementedError

    def process_step(self, mesh_rep, batch_size, ctx):
        raise NotImplementedError

    def init_extra_params(self, generator):
        """Subclass parameters (mesh embedders + processor)."""
        raise NotImplementedError

    # --- parameters (same tree as the JAX package's init_params) ---

    def _init_params(self, generator):
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        g2m_dim = self.graph.g2m.features.shape[1]
        m2g_dim = self.graph.m2g.features.shape[1]
        h = self.args.hidden_dim
        hl = self.args.hidden_layers
        end = self.mlp_blueprint_end
        self.grid_embedder = init_mlp([self.grid_dim] + end,
                                      generator=generator)
        self.g2m_embedder = init_mlp([g2m_dim] + end, generator=generator)
        self.m2g_embedder = init_mlp([m2g_dim] + end, generator=generator)
        self.g2m_gnn = init_interaction_net(h, hidden_layers=hl,
                                            generator=generator)
        self.encoding_grid_mlp = init_mlp([h] + end, generator=generator)
        self.m2g_gnn = init_interaction_net(h, hidden_layers=hl,
                                            generator=generator)
        # no output LN (ref: base_graph_model.py:76-80)
        self.output_map = init_mlp([h] * (hl + 1) + [self.grid_output_dim],
                                   layer_norm=False, generator=generator)
        self.init_extra_params(generator)
        # every MLP of the model has one depth: whether they are the fused
        # kernels' 2-layer MLPs (hidden_layers=1), or every round takes
        # the plain route, as the JAX package's XLA route
        self.kernel_mlps = kernel_mlp(self.g2m_gnn.edge_mlp)
        self.to(self.device)

    # --- forward (ref: base_graph_model.py:106-177) ---

    def _static_edge_ctx(self, inet, embedder, edges):
        """Rollout-invariant edge term of an update_edges=False GNN:
        ew = emb @ W_e + b0, (M, h); with a compute_dtype, the stored
        embedding times the fp32 weight (JAX's `jnp.dot` promotes) and ew
        stored in the compute dtype. A split set's frontier gets its own
        ("ew_f")."""
        cd = self.compute_dtype
        w0 = inet.edge_mlp.layers[0].w
        d = w0.shape[0] // 3

        def ew(es):
            emb = apply_mlp(embedder, es.features, cd)
            return store(emb.float() @ w0[:d] + inet.edge_mlp.layers[0].b,
                         cd)

        ctx = {"ew": ew(edges)}
        if edges.frontier is not None:
            ctx["ew_f"] = ew(edges.frontier)
        return ctx

    def precompute_rollout_ctx(self):
        """Embeddings of static graph features, computed once per rollout
        (the reference recomputes them every step,
        ref: base_graph_model.py:127-130)."""
        ctx = {
            "mesh_emb": self.embedd_mesh_nodes(),
            "g2m": self._static_edge_ctx(self.g2m_gnn, self.g2m_embedder,
                                         self.graph.g2m),
            "m2g": self._static_edge_ctx(self.m2g_gnn, self.m2g_embedder,
                                         self.graph.m2g),
        }
        ctx.update(self.precompute_process_ctx())
        return ctx

    def precompute_process_ctx(self):
        """Subclass hook: processor-related rollout-invariant tensors."""
        return {}

    def _finish_output(self, net_output, prev_state):
        """Split std head, rescale the delta, residual over prev_state
        (ref: base_graph_model.py:160-177)."""
        if self.output_std:
            pred_delta_mean, pred_std_raw = net_output.chunk(2, dim=-1)
            pred_std = F.softplus(pred_std_raw)
        else:
            pred_delta_mean = net_output
            pred_std = None
        rescaled_delta_mean = (
            pred_delta_mean * self.statics.diff_std + self.statics.diff_mean
        )
        return prev_state + rescaled_delta_mean, pred_std

    def _embed_grid_f(self, prev_state, prev_prev_state, forcing, B):
        """Flat (N, B*h) grid embedding (K1) of concat(prev, prev-prev,
        forcing, static); with a compute_dtype, the input is rounded to it
        and K1's instance of that dtype stores its output in it."""
        stat = self.statics.grid_static_features
        xb = store(torch.cat([prev_state, prev_prev_state, forcing,
                              expand_to_batch(stat, B)], dim=-1),
                   self.compute_dtype)
        emb = self.grid_embedder
        return embed.embed_grid_flat(
            flatten_nodes(xb), emb.layers[0].w, emb.layers[0].b,
            emb.layers[1].w, emb.layers[1].b, emb.ln.scale, emb.ln.bias, B,
        )

    def _predict_step_flat_grid(self, prev_state, prev_prev_state, forcing,
                                ctx, batch_size):
        """Flat-grid predict step: embedder (K1), g2m encoder (K2),
        processor (subclass), fused m2g decoder (K4)."""
        B = batch_size
        h = self.args.hidden_dim
        cd = self.compute_dtype
        ge_f = self._embed_grid_f(prev_state, prev_prev_state, forcing,
                                  B)  # (N_grid, B*h)

        mesh_rep = _apply_inet_flat(
            self.g2m_gnn, self.graph.g2m, ge_f,
            expand_to_batch(ctx["mesh_emb"], B),
            update_edges=False, aggr="sum", ew=ctx["g2m"]["ew"],
            compute_dtype=cd, psum_axis=self._g2m_psum_axis,
            psum_mode=self._g2m_psum_mode,
        )  # (B, N_mesh, h); the owned rows under the mesh-node schemes

        mesh_rep = self.process_step(mesh_rep, B, ctx)

        m2g = self.graph.m2g
        w0m = self.m2g_gnn.edge_mlp.layers[0].w
        send_tf = self._m2g_sender_tf(mesh_rep, w0m[h:2 * h], cd)
        net_f = grid_update.grid_update_flat(
            send_tf, m2g.senders, ctx["m2g"]["ew"], ge_f,
            m2g.mask.view(m2g.num_virt, m2g.dense_k),
            grid_update.pack_grid_update_params(self),
            fold=m2g.fold_senders,
        )  # (num_virt, B*d_out)
        net_output = unflatten_nodes(net_f[:m2g.num_rec], B)
        return self._finish_output(net_output, prev_state)

    def _flat_grid_eligible(self, batch_size: int) -> bool:
        """Whether the flat-grid route applies (the JAX package's gates):
        g2m and m2g both on the flat route, the fused decoder's structure
        (a virt_identity m2g, 2-layer MLPs with the reference LayerNorm
        layout) and K1's and K2's (`embed_applicable`, a 2-layer g2m edge
        MLP with LayerNorm)."""
        h = self.args.hidden_dim
        g = self.graph
        return (grid_update.grid_update_applicable(self, g.m2g)
                and kernel_mlp(self.grid_embedder)
                and kernel_mlp(self.g2m_gnn.edge_mlp)
                and flat_eligible(g.m2g, batch_size, h)
                and flat_eligible(g.g2m, batch_size, h))

    def _inet_static(self, inet, edges, send_rep, rec_rep, ctx_entry,
                     psum_axis=None, psum_mode="allreduce"):
        """update_edges=False interaction net on the rollout-invariant
        edge term ew (M, h) (an (interior, frontier) pair on a split
        set)."""
        ew = ctx_entry["ew"]
        if edges.frontier is not None:
            ew = (ew, ctx_entry["ew_f"])
        return apply_interaction_net(inet, edges, send_rep, rec_rep,
                                     update_edges=False, ew=ew,
                                     compute_dtype=self.compute_dtype,
                                     psum_axis=psum_axis,
                                     psum_mode=psum_mode)

    def predict_step(self, prev_state, prev_prev_state, forcing, ctx=None):
        batch_size = prev_state.shape[0]
        cd = self.compute_dtype
        if ctx is None:
            ctx = self.precompute_rollout_ctx()
        if self._flat_grid_eligible(batch_size):
            return self._predict_step_flat_grid(
                prev_state, prev_prev_state, forcing, ctx, batch_size,
            )
        grid_emb = apply_mlp_concat(
            self.grid_embedder,
            [prev_state, prev_prev_state, forcing,
             expand_to_batch(self.statics.grid_static_features, batch_size)],
            cd,
        )  # (B, N_grid, h)
        mesh_rep = self._inet_static(
            self.g2m_gnn, self.graph.g2m, grid_emb,
            expand_to_batch(ctx["mesh_emb"], batch_size), ctx["g2m"],
            psum_axis=self._g2m_psum_axis, psum_mode=self._g2m_psum_mode,
        )  # (B, N_mesh, h); the owned rows under the mesh-node schemes
        grid_rep = grid_emb + apply_mlp(self.encoding_grid_mlp, grid_emb, cd)
        mesh_rep = self.process_step(mesh_rep, batch_size, ctx)
        grid_rep = self._inet_static(self.m2g_gnn, self.graph.m2g,
                                     self._m2g_sender_rep(mesh_rep),
                                     grid_rep, ctx["m2g"])  # (B, N_grid, h)
        net_output = apply_mlp(self.output_map, grid_rep, cd)
        return self._finish_output(net_output, prev_state)
