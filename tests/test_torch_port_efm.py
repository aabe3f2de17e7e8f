"""The port's latent models GraphEFM and HiEFM against the JAX package's,
with JAX's noise replayed into the port (`latent_helpers`).

GraphEFM on a 16x16 LAM DummyDatastore (multiscale mesh) and HiEFM on a
24x12 global DummyGlobalDatastore (icosahedral mesh at 2 refinements, 2
levels of 162 and 42 nodes), 1 processor layer, hidden 64, latent_dim 32, the port's seeded weights given to the JAX
model (`jax_params_from_port`, the inverse of `convert.params_from_jax`). The JAX side runs its CPU route (Pallas off)
once per model, compiled at XLA's lowest optimization level
(`run_compiled`); the port runs two of its routes at batch 2:

* batched: every set on P2/P3 (16x16 and the small global sets have
  fewer than 512 virtual rows);
* flat: `_FLAT_MIN_VIRT` lowered to 1, so every set is flat: K1, K2 on
  g2m, on the posterior's g2m and on m2m[0] for the prior and posterior
  GNNs, K3, K4.

Held, tolerances stated per check:
* one predict step with the prior mean (no noise), sampled (replayed
  eps), and sampled from the posterior given a target: within 1e-4 (as
  the GraphLAM and HiLAM tests: ~20 chained fp32 MLPs summed in another
  order on each side); the posterior's KL within 1e-4;
* the ELBO (recon + kl_beta * mean KL over a 2-step unroll) within 1e-5
  relative, its gradients per parameter within 5e-4 of the JAX
  gradient's max abs (as the HiLAM tests);
* `--loss crps_ens` (fair CRPS over 2 prior-sampled members), the same
  limits;
* remat leaves both latent losses as they are (their own step loops, as
  in the JAX package): bit-equal with and without it;
* without a generator the noise is a function of the batch's times.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_lam_tpu.config import (
    DatastoreSelection as JDatastoreSelection,
    NeuralLAMConfig as JNeuralLAMConfig,
)
from neural_lam_tpu.datastore.dummy import DummyDatastore as JDummyDatastore
from neural_lam_tpu.datastore.dummy_global import (
    DummyGlobalDatastore as JDummyGlobalDatastore,
)
from neural_lam_tpu.graph.build import create_graph as j_create_graph
from neural_lam_tpu.graph.global_mesh import (
    create_global_graph as j_create_global_graph,
)
from neural_lam_tpu.graph.storage import graph_from_bundle as j_graph_from_bundle
from neural_lam_tpu.models import MODELS as J_MODELS
from neural_lam_tpu.models.ar_model import ModelArgs as JModelArgs
from neural_lam_tpu.ops import message_passing as jmp
from neural_lam_tpu_torch.config import DatastoreSelection, NeuralLAMConfig
from neural_lam_tpu_torch.convert import params_from_jax
from neural_lam_tpu_torch.datastore.dummy import DummyDatastore
from neural_lam_tpu_torch.datastore.dummy_global import DummyGlobalDatastore
from neural_lam_tpu_torch.graph.build import create_graph
from neural_lam_tpu_torch.graph.global_mesh import create_global_graph
from neural_lam_tpu_torch.graph.storage import graph_from_bundle
from neural_lam_tpu_torch.models import MODELS
from neural_lam_tpu_torch.models.ar_model import ModelArgs
from neural_lam_tpu_torch.ops import message_passing as tmp

from .latent_helpers import (  # noqa: F401 (one_torch_thread: autouse)
    jax_params_from_port,
    one_torch_thread,
    replay,
    run_compiled,
    split_draws,
)

B, T, D_Z, CRPS_MEMBERS = 2, 2, 32, 2
# model -> (datastore kind, layers)
MODEL_CASES = {"graph_efm": ("dummydata", 1), "hi_efm": ("dummydata_global", 1)}
ROUTES = {"batched": None, "flat": 1}  # -> _FLAT_MIN_VIRT


def _build(kind, layers, tmp_path_factory, model):
    if kind == "dummydata":
        jds = JDummyDatastore(grid_shape=(16, 16), n_timesteps=10)
        tds = DummyDatastore(grid_shape=(16, 16), n_timesteps=10)
        jb = j_create_graph(str(tmp_path_factory.mktemp("jg")),
                            jds.get_xy("state", stacked=False),
                            n_max_levels=None, hierarchical=False)
        tb = create_graph(str(tmp_path_factory.mktemp("tg")),
                          tds.get_xy("state", stacked=False),
                          n_max_levels=None, hierarchical=False)
    else:
        jds = JDummyGlobalDatastore(n_lon=24, n_lat=12, n_timesteps=10)
        tds = DummyGlobalDatastore(n_lon=24, n_lat=12, n_timesteps=10)
        jb = j_create_global_graph("", jds.get_xy("state"), refinements=2,
                                   n_levels=2, hierarchical=True)
        tb = create_global_graph("", tds.get_xy("state"), refinements=2,
                                 n_levels=2, hierarchical=True)
    jargs = JModelArgs(hidden_dim=64, processor_layers=layers,
                       latent_dim=D_Z, crps_members=CRPS_MEMBERS)
    jm = J_MODELS[model](jargs, JNeuralLAMConfig(
        datastore=JDatastoreSelection(kind, "")), jds, j_graph_from_bundle(jb))
    tm = MODELS[model](
        ModelArgs(hidden_dim=64, processor_layers=layers, latent_dim=D_Z,
                  crps_members=CRPS_MEMBERS),
        NeuralLAMConfig(datastore=DatastoreSelection(kind, "")), tds,
        graph_from_bundle(tb, device="cpu"), device="cpu",
        generator=torch.Generator().manual_seed(0))
    return jm, jax_params_from_port(jm, tm), tm


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """model -> (jax model, jax params, port model, inputs, jax outputs):
    every JAX number the tests read, computed once per model."""
    assert jmp._pallas_mode() == "off"
    out = {}
    for model, (kind, layers) in MODEL_CASES.items():
        jm, params, tm = _build(kind, layers, tmp_path_factory, model)
        rng = np.random.default_rng(7)
        n, d = tm.num_grid_nodes, tm.num_state_vars
        inputs = dict(
            init=rng.standard_normal((B, 2, n, d)).astype(np.float32),
            forcing=rng.standard_normal(
                (B, T, n, tm.num_forcing_vars * 3)).astype(np.float32),
            true=rng.standard_normal((B, T, n, d)).astype(np.float32),
            eps=rng.standard_normal(
                (B, tm.latent_num_nodes, D_Z)).astype(np.float32),
            times=np.arange(B * T, dtype=np.int64).reshape(B, T))
        j = {k: jnp.asarray(v) for k, v in inputs.items()}

        def steps(params):
            ctx = jm.precompute_rollout_ctx(params)
            args = (params, j["init"][:, 1], j["init"][:, 0],
                    j["forcing"][:, 0])
            mean, _ = jm.predict_step(*args, ctx=dict(ctx))
            sampled, _ = jm.predict_step(
                *args, ctx={**ctx, "latent_eps": j["eps"]})
            post_ctx = {**ctx, "latent_eps": j["eps"],
                        "latent_target": j["true"][:, 0]}
            post, _ = jm.predict_step(*args, ctx=post_ctx)
            return mean, sampled, post, post_ctx["_latent_kl"]

        batch = (j["init"], j["true"], j["forcing"],
                 j["times"].astype(jnp.int32))
        loss_grad = jax.value_and_grad(jm.training_loss)
        ref = {"steps": [np.asarray(a)
                         for a in run_compiled(steps, params)],
               "elbo": run_compiled(loss_grad, params, batch,
                                    jax.random.PRNGKey(11))}
        if model == "graph_efm":
            jm.crps_train = True
            ref["crps"] = run_compiled(jax.value_and_grad(jm.training_loss),
                                       params, batch, jax.random.PRNGKey(12))
            jm.crps_train = False
        out[model] = (jm, params, tm, inputs, ref)
    return out


@pytest.fixture(params=sorted(ROUTES))
def route(request, monkeypatch):
    if ROUTES[request.param] is not None:
        monkeypatch.setattr(tmp, "_FLAT_MIN_VIRT", ROUTES[request.param])
    return request.param


def _tbatch(inputs):
    return tuple(torch.as_tensor(inputs[k])
                 for k in ("init", "true", "forcing", "times"))


def _close(got, want, limit, what):
    got = got.detach().numpy() if torch.is_tensor(got) else got
    gap = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert got.shape == np.shape(want), what
    assert gap.max() <= limit, (what, gap.max())


def _check_grads(tm, jgrads, what):
    want = params_from_jax(jax.tree.map(np.asarray, jgrads))
    assert set(want) == {k for k, _ in tm.named_parameters()}
    for k, p in tm.named_parameters():
        # a parameter the loss does not reach (the posterior's, under
        # crps_ens) has no gradient in torch and a zero one in JAX
        got = p.grad if p.grad is not None else torch.zeros_like(p)
        scale = float(want[k].abs().max())
        _close(got, want[k].numpy(), 5e-4 * max(scale, 1e-30),
               f"{what} grad {k}")


@pytest.mark.parametrize("model", sorted(MODEL_CASES))
def test_params_from_jax_covers_every_parameter(built, model):
    """Every port parameter, the latent ones included, maps to the JAX
    tree key for key and shape for shape, and back."""
    _, params, tm, _, _ = built[model]
    sd = params_from_jax(jax.tree.map(np.asarray, params))
    assert set(sd) == set(tm.state_dict())
    for k, v in tm.state_dict().items():
        assert torch.equal(v, sd[k]), k
    for k in ("prior_gnn.edge_mlp.layers.0.w", "prior_head.layers.1.w",
              "post_target_embedder.ln.scale", "post_g2m_gnn.aggr_mlp.ln.bias",
              "post_head.layers.0.b", "latent_map.layers.0.w",
              "latent_m2m_embedder.layers.0.w"):
        assert k in sd, k
    assert "prior_head.ln.scale" not in sd  # heads have no LayerNorm
    assert tm.latent_num_nodes == tm.graph.level_sizes[0]


@pytest.mark.parametrize("model", sorted(MODEL_CASES))
def test_predict_step_and_kl_match_jax(built, model, route):
    """Prior mean, sampled and posterior-sampled predict steps within 1e-4
    of JAX's, the posterior's KL within 1e-4; on the flat route the latent
    GNNs run K2's plain version on m2m[0]."""
    _, _, tm, inputs, ref = built[model]
    want_mean, want_sampled, want_post, want_kl = ref["steps"]
    assert tmp.flat_eligible(tm.graph.m2m[0], B, 64) == (route == "flat")
    tb = {k: torch.as_tensor(v) for k, v in inputs.items()}
    args = (tb["init"][:, 1], tb["init"][:, 0], tb["forcing"][:, 0])
    with torch.no_grad():
        ctx = tm.precompute_rollout_ctx()
        mean, _ = tm.predict_step(*args, dict(ctx))
        sampled, _ = tm.predict_step(*args, {**ctx, "latent_eps": tb["eps"]})
        post_ctx = {**ctx, "latent_eps": tb["eps"],
                    "latent_target": tb["true"][:, 0]}
        post, _ = tm.predict_step(*args, post_ctx)
    _close(mean, want_mean, 1e-4, "prior mean step")
    _close(sampled, want_sampled, 1e-4, "sampled step")
    _close(post, want_post, 1e-4, "posterior step")
    _close(post_ctx["_latent_kl"], want_kl, 1e-4, "KL")
    assert post_ctx["_latent_kl"].shape == (B, tm.latent_num_nodes)
    # the noise moves the step; the prior mean is the noiseless step
    assert float((sampled - mean).abs().max()) > 1e-3


@pytest.mark.parametrize("model", sorted(MODEL_CASES))
def test_elbo_and_grads_match_jax(built, model, route, monkeypatch):
    """The ELBO over a 2-step unroll with JAX's per-step draws replayed:
    the loss within 1e-5 relative, each gradient within 5e-4 x its JAX
    max abs."""
    _, _, tm, inputs, ref = built[model]
    want_loss, want_grads = ref["elbo"]
    left = replay(monkeypatch, split_draws(
        jax.random.PRNGKey(11), T, (B, tm.latent_num_nodes, D_Z)))
    tm.zero_grad(set_to_none=True)
    loss = tm.training_loss(_tbatch(inputs), generator=torch.Generator())
    loss.backward()
    assert not left
    loss = float(loss.detach())
    assert abs(loss - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    _check_grads(tm, want_grads, f"{model} {route} ELBO")


def test_crps_ens_and_grads_match_jax(built, route, monkeypatch):
    """GraphEFM's `--loss crps_ens`: the fair CRPS of 2 prior-sampled
    members (B x m = 4 rows) with JAX's draws replayed, the loss within
    1e-5 relative and its gradients within 5e-4 x max abs."""
    _, _, tm, inputs, ref = built["graph_efm"]
    want_loss, want_grads = ref["crps"]
    left = replay(monkeypatch, split_draws(
        jax.random.PRNGKey(12), T,
        (B * CRPS_MEMBERS, tm.latent_num_nodes, D_Z)))
    monkeypatch.setattr(tm, "crps_train", True)
    tm.zero_grad(set_to_none=True)
    loss = tm.training_loss(_tbatch(inputs), generator=torch.Generator())
    loss.backward()
    assert not left
    loss = float(loss.detach())
    assert abs(loss - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    _check_grads(tm, want_grads, f"crps_ens {route}")


def test_crps_ens_flag_keeps_a_pointwise_eval_loss(built):
    """`loss="crps_ens"` selects the CRPS training stage and keeps wmse
    for the evaluation metrics, as the JAX mixin swaps it."""
    tm = built["graph_efm"][2]
    net = MODELS["graph_efm"](
        dataclasses.replace(tm.args, loss="crps_ens", hidden_dim=8),
        NeuralLAMConfig(datastore=DatastoreSelection("dummydata", "")),
        tm.datastore, tm.graph, device="cpu")
    assert net.crps_train and net.args.loss == "wmse"
    assert net.crps_members == CRPS_MEMBERS and net.latent_dim == D_Z
    assert not tm.crps_train and net.kl_beta == 1e-3


def test_remat_and_generator_fallback(built):
    """Remat leaves the ELBO and the CRPS loss and their gradients bit for
    bit as they are; without a generator the draws follow the batch's
    times (the same batch twice: the same loss; other times: another)."""
    _, _, tm, inputs, _ = built["graph_efm"]
    batch = _tbatch(inputs)

    def run(remat, crps, b=batch):
        tm.args = dataclasses.replace(tm.args, remat=remat)
        tm.crps_train = crps
        tm.zero_grad(set_to_none=True)
        loss = tm.training_loss(b)
        loss.backward()
        return float(loss.detach()), [
            None if p.grad is None else p.grad.clone()
            for p in tm.parameters()]

    args = tm.args
    try:
        for crps in (False, True):
            l0, g0 = run(False, crps)
            l1, g1 = run(True, crps)
            assert l0 == l1
            assert all((a is None and b is None) or torch.equal(a, b)
                       for a, b in zip(g0, g1))
        other = batch[:3] + (batch[3] + 1,)
        assert run(False, False, other)[0] != run(False, False)[0]
    finally:
        tm.args, tm.crps_train = args, False
