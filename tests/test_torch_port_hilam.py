"""The port's HiLAM against the JAX package's, on the same datastore,
hierarchical graph and weights (carried over with
`convert.params_from_jax`).

A 30x30 DummyDatastore gives a two-level hierarchy (81 and 9 mesh nodes),
hidden 64, 2 processor layers. The JAX side runs its CPU route (Pallas
off: the batched XLA path everywhere), the port two of its routes:

* batch 1 (B*h = 64): the batched route end to end -- plain grid MLPs, P2
  for g2m and m2g, P3 for every mesh round, P1 for the read-out;
* batch 2 with the port's `_FLAT_MIN_VIRT` lowered to 100: a mixed route
  -- g2m, m2g, m2m[0] and down[0] (128-192 virtual rows) flat (K1/K2/K3/
  K4), m2m[1] and up[0] (64 rows) batched (P3).

The training-loss gradients are held on both routes.

An 81x81 DummyDatastore gives a three-level hierarchy (729, 81 and 9 mesh
nodes): a middle level with its own m2m, up and down sets, and two down
sets in the read-out, both on P1 at batch 1 (the batched route).

Tolerances: 1e-4 on one predict step (as the GraphLAM tests: ~20 chained
fp32 MLPs whose sums run in another order on each side, on O(1)
activations); 5e-4 on a 3-step rollout (each step feeds the last one's
rounding back in); per parameter, the training-loss gradient within 5e-4
of the JAX gradient's max abs (as test_mean_aggregation_matches_jax).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from neural_lam_tpu.config import (
    DatastoreSelection as JDatastoreSelection,
    NeuralLAMConfig as JNeuralLAMConfig,
)
from neural_lam_tpu.datastore.dummy import DummyDatastore as JDummyDatastore
from neural_lam_tpu.graph.build import create_graph as j_create_graph
from neural_lam_tpu.graph.storage import graph_from_bundle as j_graph_from_bundle
from neural_lam_tpu.models import MODELS as J_MODELS
from neural_lam_tpu.models.ar_model import ModelArgs as JModelArgs
from neural_lam_tpu.ops import message_passing as jmp
from neural_lam_tpu_torch.config import DatastoreSelection, NeuralLAMConfig
from neural_lam_tpu_torch.convert import params_from_jax
from neural_lam_tpu_torch.datastore.dummy import DummyDatastore
from neural_lam_tpu_torch.graph.build import create_graph
from neural_lam_tpu_torch.graph.storage import graph_from_bundle
from neural_lam_tpu_torch.models.ar_model import ModelArgs
from neural_lam_tpu_torch.models.hi_lam import HiLAM
from neural_lam_tpu_torch.ops import message_passing as tmp

NX, T, LAYERS = 30, 3, 2
NX3 = 81  # the three-level hierarchy (see module doc)
# the port's flat-route threshold for the mixed route (see module doc)
MIXED_MIN_VIRT = 100
ROUTES = {"batched": (1, None), "mixed": (2, MIXED_MIN_VIRT)}


def _models(tmp_path_factory, nx):
    """(jax_model, jax_params, port_model) on an nx x nx grid."""
    assert jmp._pallas_mode() == "off"
    jds = JDummyDatastore(grid_shape=(nx, nx), n_timesteps=10)
    tds = DummyDatastore(grid_shape=(nx, nx), n_timesteps=10)
    jbundle = j_create_graph(str(tmp_path_factory.mktemp("jg")),
                             jds.get_xy("state", stacked=False),
                             n_max_levels=None, hierarchical=True)
    tbundle = create_graph(str(tmp_path_factory.mktemp("tg")),
                           tds.get_xy("state", stacked=False),
                           n_max_levels=None, hierarchical=True)
    jmodel = J_MODELS["hi_lam"](
        JModelArgs(hidden_dim=64, processor_layers=LAYERS),
        JNeuralLAMConfig(datastore=JDatastoreSelection("dummydata", "")),
        jds, j_graph_from_bundle(jbundle),
    )
    params = jmodel.init_params(jax.random.PRNGKey(0))
    tmodel = HiLAM(
        ModelArgs(hidden_dim=64, processor_layers=LAYERS),
        NeuralLAMConfig(datastore=DatastoreSelection("dummydata", "")),
        tds, graph_from_bundle(tbundle, device="cpu"), device="cpu",
    )
    tmodel.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    return jmodel, params, tmodel


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """(jax_model, jax_params, port_model) on the two-level hierarchy."""
    return _models(tmp_path_factory, NX)


@pytest.fixture(scope="module")
def models3(tmp_path_factory):
    """(jax_model, jax_params, port_model) on the three-level hierarchy."""
    return _models(tmp_path_factory, NX3)


@pytest.fixture(params=sorted(ROUTES))
def route(request, monkeypatch):
    """(batch size) with the port's dispatch set for the route."""
    B, min_virt = ROUTES[request.param]
    if min_virt is not None:
        monkeypatch.setattr(tmp, "_FLAT_MIN_VIRT", min_virt)
    return request.param, B


def _inputs(model, B):
    rng = np.random.default_rng(B)
    n, d = model.num_grid_nodes, model.num_state_vars
    d_f = model.num_forcing_vars * 3
    return (rng.standard_normal((B, 2, n, d)).astype(np.float32),
            rng.standard_normal((B, T, n, d_f)).astype(np.float32),
            rng.standard_normal((B, T, n, d)).astype(np.float32))


def test_graph_levels_and_routes(models, route):
    """The hierarchy has two levels with up/down sets of the JAX layout,
    and each route sends the sets where the module doc says."""
    _, _, tmodel = models
    name, B = route
    g = tmodel.graph
    assert g.level_sizes == (81, 9)
    assert [(s.dense_k, s.num_virt, s.virt_identity) for s in g.up] == [
        (8, 64, False)]
    assert [(s.dense_k, s.num_virt) for s in g.down] == [(1, 128)]
    flat = {k: tmp.flat_eligible(es, B, 64) for k, es in (
        ("g2m", g.g2m), ("m2g", g.m2g), ("m2m0", g.m2m[0]),
        ("m2m1", g.m2m[1]), ("up0", g.up[0]), ("down0", g.down[0]))}
    if name == "batched":
        assert not any(flat.values()) and not tmodel._flat_grid_eligible(B)
    else:
        assert flat == {"g2m": True, "m2g": True, "m2m0": True,
                        "m2m1": False, "up0": False, "down0": True}
        assert tmodel._flat_grid_eligible(B)


def test_params_from_jax_covers_every_parameter(models):
    """Every port parameter comes from the JAX tree, shape for shape, the
    nested per-layer and per-level lists included."""
    _, params, tmodel = models
    sd = params_from_jax(jax.tree.map(np.asarray, params))
    assert set(sd) == set(tmodel.state_dict())
    assert "mesh_down_gnns.1.0.edge_mlp.layers.0.w" in sd
    for k, v in tmodel.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), sd[k].numpy(), k)


def _check_predict_step(models, B):
    jmodel, params, tmodel = models
    init, forcing, _ = _inputs(tmodel, B)
    out_j, _ = jmodel.predict_step(params, jnp.asarray(init[:, 1]),
                                   jnp.asarray(init[:, 0]),
                                   jnp.asarray(forcing[:, 0]))
    with torch.no_grad():
        out_t, _ = tmodel.predict_step(torch.as_tensor(init[:, 1]),
                                       torch.as_tensor(init[:, 0]),
                                       torch.as_tensor(forcing[:, 0]))
    assert out_t.shape == (B, tmodel.num_grid_nodes, tmodel.num_state_vars)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=1e-4,
                               rtol=0)


def _check_unroll(models, B):
    jmodel, params, tmodel = models
    init, forcing, true = _inputs(tmodel, B)
    pred_j, _ = jmodel.unroll_prediction(
        params, jnp.asarray(init), jnp.asarray(forcing), jnp.asarray(true))
    with torch.no_grad():
        pred_t, _ = tmodel.unroll_prediction(
            torch.as_tensor(init), torch.as_tensor(forcing),
            torch.as_tensor(true))
    assert pred_t.shape == (B, T, tmodel.num_grid_nodes,
                            tmodel.num_state_vars)
    np.testing.assert_allclose(pred_t.numpy(), np.asarray(pred_j),
                               atol=5e-4, rtol=0)


def test_predict_step_matches_jax(models, route):
    """One predict step on each route (atol 1e-4, see module doc)."""
    _check_predict_step(models, route[1])


def test_unroll_prediction_matches_jax(models, route):
    """3-step rollout with boundary overwrite on each route (atol 5e-4,
    see module doc)."""
    _check_unroll(models, route[1])


def test_three_levels_match_jax(models3):
    """The three-level hierarchy (729/81/9 mesh nodes) at batch 1, the
    batched route with P1 on both read-out down sets: one predict step
    (atol 1e-4) and a 3-step rollout (atol 5e-4) against the JAX CPU
    route."""
    tmodel = models3[2]
    g = tmodel.graph
    assert g.level_sizes == (729, 81, 9)
    assert [s.dense_k for s in g.down] == [1, 1]
    assert not any(tmp.flat_eligible(es, 1, 64) for es in g.down)
    _check_predict_step(models3, 1)
    _check_unroll(models3, 1)


def _check_grads(models, B):
    """Gradient of training_loss at batch B for every parameter, within
    5e-4 of the JAX gradient's max abs."""
    jmodel, params, tmodel = models
    init, forcing, true = _inputs(tmodel, B)
    batch = (init, true[:, :1], forcing[:, :1], np.zeros((B, 1), np.int64))
    loss_j, g_j = jax.value_and_grad(jmodel.training_loss)(
        params, tuple(jnp.asarray(b) for b in batch))
    tmodel.zero_grad(set_to_none=True)
    loss_t = tmodel.training_loss(tuple(torch.as_tensor(b) for b in batch))
    loss_t.backward()
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j),
                               rtol=1e-5)
    want = params_from_jax(jax.tree.map(np.asarray, g_j))
    got = dict(tmodel.named_parameters())
    assert set(want) == set(got)
    for k, w in want.items():
        err = float((got[k].grad - w).abs().max())
        assert err <= 5e-4 * float(w.abs().max()) + 1e-7, (k, err)
    tmodel.zero_grad(set_to_none=True)


def test_training_loss_grads_match_jax_batch1(models):
    """Gradient of training_loss at batch 1 (the batched route: the
    P-kernels' autograd.Function backward through their plain versions)
    for every parameter, within 5e-4 of the JAX gradient's max abs."""
    _check_grads(models, 1)


def test_training_loss_grads_match_jax_mixed(models, monkeypatch):
    """Gradient of training_loss at batch 2 on the mixed route (flat K1-K4
    backward on g2m, m2g, m2m[0] and down[0]; P3's plain recompute on
    m2m[1] and up[0]), within 5e-4 of the JAX gradient's max abs."""
    monkeypatch.setattr(tmp, "_FLAT_MIN_VIRT", MIXED_MIN_VIRT)
    _check_grads(models, 2)
