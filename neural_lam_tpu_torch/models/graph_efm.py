"""Graph-EFM-style latent-variable ensemble models.

Counterpart of neural_lam_tpu/models/graph_efm.py (after Oskarsson et al.
2024, arXiv:2406.04759; the reference has no latent-variable model):

* A latent random field z lives on the bottom-level mesh nodes, d_z per
  node.
* Prior p(z | X_t, X_{t-1}): one interaction-net round over the
  bottom-level m2m edge set on the encoded mesh representation, then an
  MLP head emitting (mu, sigma_raw); sigma = softplus(sigma_raw) + 1e-4
  (softplus op by op as JAX computes it, so the bf16 path rounds where
  JAX's does).
* Posterior q(z | X_t, X_{t-1}, Y): the target state is embedded and
  encoded to the mesh through its own g2m interaction net; the posterior
  GNN runs on mesh_rep + target_mesh and emits its own (mu, sigma).
* z (reparametrized, or the mean when no noise is given) is mapped to
  hidden width and added to the bottom-level mesh representation before
  the family's processor (GraphLAM's stack, or HiLAM's sweeps).
* Training maximizes a per-step ELBO over the AR unroll,
  recon + kl_beta * mean KL(q || p); with `--loss crps_ens` it minimizes
  the fair-ensemble CRPS of `crps_members` prior-sampled rollouts.
* Ensembles draw z ~ p per member and step (`ensemble.sample_rollout`);
  deterministic evaluation uses the prior mean, so every inherited
  val/test path works unchanged.

The prior and posterior GNNs and the posterior's g2m net are
update_edges=False interaction nets on static edges: K2 on the flat route,
P2 on the batched one (`apply_interaction_net`), with their rollout-
invariant edge terms in `precompute_process_ctx`. Latent plumbing rides
a per-step copy of the rollout ctx: callers put "latent_eps" (and, in
training, "latent_target") into it, and `process_step` leaves the step's
KL under "_latent_kl". Every normal draw goes through
`ensemble.draw_normal` from an explicit torch.Generator.

Registry names: `graph_efm` (flat multiscale mesh, or the global
icosahedral one) and `hi_efm` (hierarchical mesh).
"""

from __future__ import annotations

import dataclasses

import torch

from .. import ensemble
from ..ops.message_passing import init_interaction_net
from ..ops.mlp import apply_mlp, init_mlp
from .base_graph_model import expand_to_batch
from .graph_lam import GraphLAM
from .hi_lam import HiLAM

_SIGMA_FLOOR = 1e-4


def _softplus(x):
    """softplus as `jax.nn.softplus` computes it (`jnp.logaddexp(x, 0)`:
    max(x, 0) + log1p(exp(-|x|))), op by op, so that a bf16 x is rounded
    where the JAX program rounds it (three times, where F.softplus rounds
    once)."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


class LatentMeshMixin:
    """The latent-field machinery of GraphEFM and HiEFM. Mixed in before
    the family's class, so `process_step` wraps the family's processor on
    both predict routes."""

    is_latent = True

    def __init__(self, args, config, datastore, graph, device="cuda",
                 generator=None):
        # --loss crps_ens: the second training stage (fair CRPS over
        # prior-sampled rollouts; no posterior, no KL). The evaluation
        # paths keep a pointwise loss for the inherited metrics.
        crps_train = args.loss == "crps_ens"
        if crps_train:
            args = dataclasses.replace(args, loss="wmse")
        super().__init__(args, config, datastore, graph, device, generator)
        self.crps_train = crps_train
        # the latent field lives on the bottom mesh level
        self.latent_num_nodes = int(self.graph.level_sizes[0])
        self.kl_beta = float(args.kl_beta)
        self.crps_members = int(args.crps_members)
        # (row offset, global batch) of this rank's rows when data
        # parallelism splits the batch (set by the trainer): a rank draws
        # the global batch's noise and keeps its own rows, so each row
        # draws what one process would draw for it
        self.batch_rows = None

    @property
    def _latent_edges(self):
        """The bottom-level m2m edge set (the only one of a flat model)."""
        return self.graph.m2m[0]

    # --- parameters (the JAX package's keys) ---

    def init_extra_params(self, generator):
        super().init_extra_params(generator)
        h, hl = self.args.hidden_dim, self.args.hidden_layers
        self.latent_dim = d_z = int(self.args.latent_dim)
        end = self.mlp_blueprint_end
        head = [h] * (hl + 1) + [2 * d_z]
        self.latent_m2m_embedder = init_mlp(
            [self._latent_edges.features.shape[1]] + end, generator=generator)
        self.prior_gnn = init_interaction_net(h, hidden_layers=hl,
                                              generator=generator)
        self.prior_head = init_mlp(head, layer_norm=False,
                                   generator=generator)
        self.post_target_embedder = init_mlp([self.num_state_vars] + end,
                                             generator=generator)
        self.post_g2m_gnn = init_interaction_net(h, hidden_layers=hl,
                                                 generator=generator)
        self.post_gnn = init_interaction_net(h, hidden_layers=hl,
                                             generator=generator)
        self.post_head = init_mlp(head, layer_norm=False,
                                  generator=generator)
        self.latent_map = init_mlp([d_z] + end, generator=generator)

    def precompute_process_ctx(self):
        ctx = super().precompute_process_ctx()
        # the static edge terms of the extra update_edges=False GNNs
        ctx["prior_m2m"] = self._static_edge_ctx(
            self.prior_gnn, self.latent_m2m_embedder, self._latent_edges)
        ctx["post_m2m"] = self._static_edge_ctx(
            self.post_gnn, self.latent_m2m_embedder, self._latent_edges)
        ctx["post_g2m"] = self._static_edge_ctx(
            self.post_g2m_gnn, self.g2m_embedder, self.graph.g2m)
        return ctx

    # --- the latent field ---

    def _gauss_head(self, inet, head, edge_ctx, mesh_rep):
        """One bottom-m2m interaction round and an MLP head ->
        (mu, sigma), sigma = softplus + 1e-4, in the compute dtype."""
        # the senders through `_mesh_sender_rep`: the owned rows and their
        # all-gather or halo imports under the mesh-node-sharded schemes
        rep = self._inet_static(inet, self._latent_edges,
                                self._mesh_sender_rep(mesh_rep), mesh_rep,
                                edge_ctx, psum_axis=self._mesh_psum_axis)
        mu, sigma_raw = apply_mlp(head, rep, self.compute_dtype).chunk(
            2, dim=-1)
        return mu, _softplus(sigma_raw) + _SIGMA_FLOOR

    def encode_target_mesh(self, target_state, ctx, batch_size):
        """The posterior's conditioning: the target state embedded and
        encoded to the mesh by its own g2m interaction net."""
        tgt_emb = apply_mlp(self.post_target_embedder, target_state,
                            self.compute_dtype)
        return self._inet_static(
            self.post_g2m_gnn, self.graph.g2m, tgt_emb,
            expand_to_batch(ctx["mesh_emb"], batch_size), ctx["post_g2m"],
            psum_axis=self._g2m_psum_axis, psum_mode=self._g2m_psum_mode)

    def process_step(self, mesh_rep, batch_size, ctx):
        """Prior (and, given a target, posterior and KL), then z = mu +
        sigma * eps (mu without eps) added through `latent_map` to the
        bottom-level mesh representation, then the family's processor."""
        mu_p, sigma_p = self._gauss_head(self.prior_gnn, self.prior_head,
                                         ctx["prior_m2m"], mesh_rep)
        post_mesh = ctx.get("latent_post_mesh")
        if post_mesh is None and ctx.get("latent_target") is not None:
            post_mesh = self.encode_target_mesh(ctx["latent_target"], ctx,
                                                batch_size)
        if post_mesh is not None:
            mu_q, sigma_q = self._gauss_head(self.post_gnn, self.post_head,
                                             ctx["post_m2m"],
                                             mesh_rep + post_mesh)
            # KL(q || p) per (batch, mesh node), summed over d_z
            ctx["_latent_kl"] = (
                torch.log(sigma_p) - torch.log(sigma_q)
                + (sigma_q.square() + (mu_q - mu_p).square())
                / (2.0 * sigma_p.square())
                - 0.5
            ).sum(dim=-1)
            mu, sigma = mu_q, sigma_q
        else:
            mu, sigma = mu_p, sigma_p
        eps = ctx.get("latent_eps")
        z = mu if eps is None else mu + sigma * eps
        mesh_rep = mesh_rep + apply_mlp(self.latent_map, z,
                                        self.compute_dtype)
        return super().process_step(mesh_rep, batch_size, ctx)

    # --- training ---

    def _fallback_generator(self, batch_times):
        """The noise of a call without a generator: a function of the
        batch's times, so different batches differ and a batch repeats
        its draws (the JAX package folds the times into a fixed key)."""
        return ensemble.step_generator(
            17, int(batch_times.sum().item()) % 2**63, self.device)

    def training_loss(self, batch, generator=None):
        """The per-step ELBO over the AR unroll (its own step loop, so
        `remat` does not apply, as in the JAX package), or with --loss
        crps_ens the fair CRPS of `crps_members` prior-sampled rollouts.
        One `ensemble.draw_normal` of (B, N_latent, d_z) a step."""
        init_states, target_states, forcing_features, batch_times = batch
        if generator is None:
            generator = self._fallback_generator(batch_times)
        mask = self.interior_mask_bool()
        if self.crps_train:
            ens = ensemble.sample_rollout(
                self, init_states, forcing_features, target_states,
                generator, n_members=self.crps_members)
            return torch.mean(ensemble.crps_ensemble(ens, target_states,
                                                     mask=mask))
        statics = self.statics
        B = target_states.shape[0]
        ctx = self.precompute_rollout_ctx()
        prev_prev_state, prev_state = init_states[:, 0], init_states[:, 1]
        preds, stds, kls = [], [], []
        for t in range(target_states.shape[1]):
            target_t = target_states[:, t]
            eps = ensemble.draw_rows(
                self, (B, self.latent_num_nodes, self.latent_dim), generator)
            # the target rides in the step's ctx; process_step encodes it
            ctx_t = {**ctx, "latent_eps": eps, "latent_target": target_t}
            pred, pred_std = self.predict_step(
                prev_state, prev_prev_state, forcing_features[:, t], ctx_t)
            new_state = (statics.boundary_mask * target_t
                         + statics.interior_mask * pred)
            preds.append(new_state)
            stds.append(pred_std)
            kls.append(ctx_t["_latent_kl"])
            prev_prev_state, prev_state = prev_state, new_state
        prediction = torch.stack(preds, dim=1)  # (B, T, N, d)
        pred_std = (torch.stack(stds, dim=1) if self.output_std
                    else statics.per_var_std)
        recon = torch.mean(self.loss_fn(prediction, target_states, pred_std,
                                        mask=mask))
        return recon + self.kl_beta * torch.stack(kls).mean()


class GraphEFM(LatentMeshMixin, GraphLAM):
    """Flat-mesh latent-variable model (also on the global icosahedral
    mesh)."""


class HiEFM(LatentMeshMixin, HiLAM):
    """Hierarchical latent-variable model, the configuration of
    arXiv:2406.04759: the latent field on the bottom mesh level, injected
    before the init sweep; the prior and posterior GNNs over the
    bottom-level m2m set."""
