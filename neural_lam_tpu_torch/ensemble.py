"""Ensemble forecasts: sampled rollouts and their scores.

Counterpart of neural_lam_tpu/ensemble.py. An ensemble is sampled from
either kind of probabilistic model:

* an `output_std` model (the reference's Gaussian output head, ref:
  neural_lam/models/base_graph_model.py:161-171): at every
  autoregressive step each member samples its next state from the
  predicted Gaussian (interior only; the boundary stays forced);
* a latent model (`models/graph_efm.py`): each member draws its own prior
  latent field every step, and the decoder mean is the member's state.

Members advance in parallel, folded into the batch axis sample-major
(`repeat_interleave`: the m members of a sample are consecutive rows, as
the JAX package's `jnp.repeat` lays them out), so B x m picks the edge
sets' routes.

Scores: the ensemble mean and spread, the fair-ensemble CRPS

    CRPS ~ mean_i |x_i - y| - 1/(2 m (m-1)) sum_{i,j} |x_i - x_j|

(the pair sum by the sorted-member identity, never the pairwise tensor),
the rank histogram, and the spread-skill ratio.

Noise: every normal draw of the latent models and of this module goes
through `draw_normal`, from an explicit `torch.Generator` on the model's
device. The port's noise is deterministic in the seed (and, in training,
the step: `step_generator`), but its bits are not JAX's threefry bits;
the tests hand JAX's draws to the port through `draw_normal`.
"""

from __future__ import annotations

import numpy as np
import torch

from .metrics import mask_and_reduce_metric


def draw_normal(shape, generator: torch.Generator):
    """Standard-normal fp32 draws of `shape` from `generator`, on the
    generator's device."""
    return torch.randn(tuple(shape), generator=generator,
                       device=generator.device, dtype=torch.float32)


def draw_rows(model, shape, generator: torch.Generator, members: int = 1):
    """`draw_normal(shape)` for the model's rows of a batch (shape[0] =
    rows x members): when data parallelism gives this rank rows
    [offset, offset + b) of a global batch of B (`model.batch_rows`), the
    global batch's draw is made and this rank's rows kept, so every row
    draws what a single process draws for it."""
    rows = getattr(model, "batch_rows", None)
    if rows is None:
        return draw_normal(shape, generator)
    offset, global_b = rows
    b = shape[0] // members
    full = draw_normal((global_b * members,) + tuple(shape[1:]), generator)
    return full[offset * members:(offset + b) * members]


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """A generator on `device` whose stream is a function of (seed, step)
    alone, as the JAX trainer's `fold_in(PRNGKey(seed), step)`: a run
    resumed at a step draws what an uninterrupted run draws there."""
    state = np.random.SeedSequence([seed % 2**64, step % 2**64])
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(int(state.generate_state(1, np.uint64)[0]))
    return gen


def sample_rollout(model, init_states, forcing_features, true_states,
                   generator: torch.Generator, n_members: int = 5):
    """An ensemble of AR rollouts, (B, n_members, T, N, d).

    init_states (B, 2, N, d); forcing (B, T, N, d_f); true_states
    (B, T, N, d) (boundary forcing only). One `draw_normal` a step: the
    latent field (B*m, N_latent, d_z) of a latent model, the state noise
    (B*m, N, d) of an output_std one. Differentiable (the CRPS training
    loss runs through it); wrap it in torch.no_grad() to forecast."""
    is_latent = bool(getattr(model, "is_latent", False))
    if not (model.output_std or is_latent):
        raise ValueError("ensemble sampling needs an output_std or "
                         "latent-variable model")
    statics = model.statics
    B = init_states.shape[0]

    def rep(x):
        # fold the member axis into the batch: (B, ...) -> (B * m, ...)
        return x.repeat_interleave(n_members, dim=0)

    init_r, forcing_r, true_r = (rep(init_states), rep(forcing_features),
                                 rep(true_states))
    ctx = model.precompute_rollout_ctx()
    prev_prev_state, prev_state = init_r[:, 0], init_r[:, 1]
    preds = []
    for t in range(forcing_r.shape[1]):
        if is_latent:
            eps = draw_rows(model, (prev_state.shape[0],
                                    model.latent_num_nodes, model.latent_dim),
                            generator, n_members)
            sampled, _ = model.predict_step(
                prev_state, prev_prev_state, forcing_r[:, t],
                {**ctx, "latent_eps": eps})
        else:
            mean, std = model.predict_step(prev_state, prev_prev_state,
                                           forcing_r[:, t], ctx)
            sampled = mean + std * draw_rows(model, mean.shape, generator,
                                             n_members)
        new_state = (statics.boundary_mask * true_r[:, t]
                     + statics.interior_mask * sampled)
        preds.append(new_state)
        prev_prev_state, prev_state = prev_state, new_state
    preds = torch.stack(preds, dim=1)  # (B*m, T, N, d)
    return preds.reshape(B, n_members, *preds.shape[1:])


def ensemble_mean_spread(ens):
    """(B, m, T, N, d) -> the member mean and spread (std over members,
    ddof 0 as the JAX function's `std`)."""
    return ens.mean(dim=1), ens.std(dim=1, correction=0)


def crps_ensemble(ens, target, mask=None, average_grid=True, sum_vars=True):
    """Fair-ensemble CRPS estimate. ens: (B, m, T, N, d); target:
    (B, T, N, d). Reduction as metrics.mask_and_reduce_metric."""
    m = ens.shape[1]
    skill = (ens - target[:, None]).abs().mean(dim=1)  # (B, T, N, d)
    if m > 1:
        # sum_{i,j} |x_i - x_j| = 2 sum_k (2k - 1 - m) x_(k) (k from 1) over
        # the sorted members: exact, and no (B, m, m, T, N, d) tensor
        srt = torch.sort(ens, dim=1).values
        coeff = (2.0 * torch.arange(1, m + 1, device=ens.device) - 1.0
                 - m).to(ens.dtype)
        pair_sum = 2.0 * torch.tensordot(coeff, srt, dims=([0], [1]))
        spread = pair_sum / (2.0 * m * (m - 1))
    else:
        spread = torch.zeros_like(skill)
    return mask_and_reduce_metric(skill - spread, mask, average_grid,
                                  sum_vars)


def rank_histogram(ens, target, mask=None):
    """Counts (B, T, m + 1) of the observation's rank among the members
    (the number of members strictly below it) over the counted grid
    points (mask: bool (N,), None = all) and variables; uniform for a
    calibrated ensemble."""
    m = ens.shape[1]
    ranks = (ens < target[:, None]).sum(dim=1)  # (B, T, N, d) in [0, m]
    w = (torch.ones(ens.shape[-2], device=ens.device) if mask is None
         else mask.to(torch.float32))
    # one bin at a time: no (B, T, N, d, m + 1) one-hot
    counts = [((ranks == r) * w[:, None]).sum(dim=(-2, -1))
              for r in range(m + 1)]
    return torch.stack(counts, dim=-1)


def evaluate_ensemble(model, batch, generator: torch.Generator,
                      n_members: int = 5, per_sample: bool = False):
    """`score_ensemble` of `n_members` members that `sample_rollout`
    draws for one batch (init_states, target_states, forcing, _) from
    `generator`, over the model's interior grid points."""
    init_states, target_states, forcing, _ = batch
    ens = sample_rollout(model, init_states, forcing, target_states,
                         generator, n_members)
    return score_ensemble(ens, target_states, model.interior_mask_bool(),
                          per_sample)


def score_ensemble(ens, target, mask, per_sample: bool = False):
    """Per-lead-time scores of members ens (B, m, T, N, d) against target
    (B, T, N, d) over the grid points of mask (bool (N,)): crps, ens_rmse
    (of the ensemble mean), spread, ens_var (member variance, ddof 1) and
    ens_se (squared error of the mean), each (T,), and rank_hist
    (T, m + 1). With per_sample every entry keeps a leading B axis;
    without, the batch mean is taken and ssr (`spread_skill_ratio`)
    added."""
    n_members = ens.shape[1]
    mean, spread = ensemble_mean_spread(ens)
    crps = crps_ensemble(ens, target, mask=mask)  # (B, T)
    w = mask.to(mean.dtype)
    se = (mean - target).square() * w[:, None]
    rmse = torch.sqrt(se.sum(dim=-2) / w.sum()).mean(dim=-1)  # (B, T)
    spread_t = (spread * w[:, None]).sum(dim=-2).mean(dim=-1) / w.sum()
    # the spread-skill ratio's two ingredients, kept apart so that batches
    # sum correctly
    var = (ens.var(dim=1, correction=1) if n_members > 1
           else torch.zeros_like(mean))
    ens_var = (var * w[:, None]).sum(dim=-2).mean(dim=-1) / w.sum()
    ens_se = se.sum(dim=-2).mean(dim=-1) / w.sum()
    out = {"crps": crps, "ens_rmse": rmse, "spread": spread_t,
           "ens_var": ens_var, "ens_se": ens_se,
           "rank_hist": rank_histogram(ens, target, mask=mask)}
    if not per_sample:
        out = {k: v.mean(dim=0) for k, v in out.items()}
        out["ssr"] = spread_skill_ratio(out["ens_var"].cpu().numpy(),
                                        out["ens_se"].cpu().numpy(),
                                        n_members)
    return out


def spread_skill_ratio(ens_var, ens_se, n_members):
    """sqrt((m+1)/m * var / se), the fair spread-skill ratio (numpy): ~1
    for a reliable m-member ensemble, <1 under-, >1 over-dispersed."""
    scale = (n_members + 1) / max(n_members, 1)
    return np.sqrt(scale * np.asarray(ens_var)
                   / np.maximum(np.asarray(ens_se), 1e-30))
