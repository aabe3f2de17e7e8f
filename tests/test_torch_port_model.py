"""The port's GraphLAM against the JAX package's, on the same datastore,
graph and weights (carried over with `convert.params_from_jax`).

The JAX side runs its default CPU route (Pallas off: the batched XLA
path), the port the kernels' plain versions on one of its two routes. At
16x16 every edge set has fewer than 512 virtual rows, so the port's
dispatch sends them all to the batched route (P1-P3); the tests named
`*_matches_jax` lower its `_FLAT_MIN_VIRT` to 1 to keep the flat route
(K1-K4) covered, and the `*_batched_route_*` tests run the dispatch as it
is. Both are fp32; the JAX tests run matmuls at "highest" precision
(conftest).
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
from neural_lam_tpu.ops import mlp as jmlp
from neural_lam_tpu_torch.config import DatastoreSelection, NeuralLAMConfig
from neural_lam_tpu_torch.convert import params_from_jax
from neural_lam_tpu_torch.datastore.dummy import DummyDatastore
from neural_lam_tpu_torch.graph.build import create_graph
from neural_lam_tpu_torch.graph.storage import graph_from_bundle
from neural_lam_tpu_torch.models.ar_model import ModelArgs
from neural_lam_tpu_torch.models.graph_lam import GraphLAM
from neural_lam_tpu_torch.ops import message_passing as tmp
from neural_lam_tpu_torch.ops import mlp as tmlp

B, T, NX = 2, 3, 16


def _build_pair(tmp_path_factory, mesh_aggr="sum"):
    """(jax_model, jax_params, port_model) for a 16x16 DummyDatastore, hidden
    64, 2 processor layers."""
    assert jmp._pallas_mode() == "off"
    jds = JDummyDatastore(grid_shape=(NX, NX), n_timesteps=10)
    tds = DummyDatastore(grid_shape=(NX, NX), n_timesteps=10)
    np.testing.assert_array_equal(
        tds.get_dataarray("state", "train").values,
        jds.get_dataarray("state", "train").values,
    )
    jbundle = j_create_graph(str(tmp_path_factory.mktemp("jg")),
                             jds.get_xy("state", stacked=False),
                             n_max_levels=None, hierarchical=False)
    tbundle = create_graph(str(tmp_path_factory.mktemp("tg")),
                           tds.get_xy("state", stacked=False),
                           n_max_levels=None, hierarchical=False)
    jmodel = J_MODELS["graph_lam"](
        JModelArgs(hidden_dim=64, processor_layers=2, mesh_aggr=mesh_aggr),
        JNeuralLAMConfig(datastore=JDatastoreSelection("dummydata", "")),
        jds, j_graph_from_bundle(jbundle),
    )
    params = jmodel.init_params(jax.random.PRNGKey(0))
    tmodel = GraphLAM(
        ModelArgs(hidden_dim=64, processor_layers=2, mesh_aggr=mesh_aggr),
        NeuralLAMConfig(datastore=DatastoreSelection("dummydata", "")),
        tds, graph_from_bundle(tbundle, device="cpu"), device="cpu",
    )
    tmodel.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    return jmodel, params, tmodel


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    return _build_pair(tmp_path_factory)


@pytest.fixture
def flat_route(monkeypatch):
    """Every edge set of the 16x16 graph on the flat route."""
    monkeypatch.setattr(tmp, "_FLAT_MIN_VIRT", 1)


def _inputs(model):
    rng = np.random.default_rng(0)
    n, d = model.num_grid_nodes, model.num_state_vars
    d_f = model.num_forcing_vars * 3
    return (rng.standard_normal((B, 2, n, d)).astype(np.float32),
            rng.standard_normal((B, T, n, d_f)).astype(np.float32),
            rng.standard_normal((B, T, n, d)).astype(np.float32))


def test_params_from_jax_covers_every_parameter(models):
    """Every port parameter comes from the JAX tree, shape for shape."""
    _, params, tmodel = models
    sd = params_from_jax(jax.tree.map(np.asarray, params))
    assert set(sd) == set(tmodel.state_dict())
    for k, v in tmodel.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), sd[k].numpy(), k)


def _check_predict_step(models):
    jmodel, params, tmodel = models
    init, forcing, _ = _inputs(tmodel)
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


def test_predict_step_matches_jax(models, flat_route):
    """One predict step on the flat route. atol 1e-4: one step chains ~10
    fp32 MLPs whose sums run in another order on each side (flat kernels
    vs the batched XLA path) on O(1) activations."""
    assert _route(models) == "flat"
    _check_predict_step(models)


def test_predict_step_batched_route_matches_jax(models):
    """One predict step on the batched route (P2 for g2m and m2g, P3 for
    the processor), atol 1e-4 as on the flat route."""
    assert _route(models) == "batched"
    _check_predict_step(models)


def _route(models):
    """The route the port's dispatch gives every set of the 16x16 model
    at batch B."""
    g = models[2].graph
    flat = {tmp.flat_eligible(es, B, 64) for es in (g.g2m, g.m2g, g.m2m[0])}
    assert len(flat) == 1, flat
    return "flat" if flat.pop() else "batched"


def _check_unroll(models):
    jmodel, params, tmodel = models
    init, forcing, true = _inputs(tmodel)
    pred_j, std_j = jmodel.unroll_prediction(
        params, jnp.asarray(init), jnp.asarray(forcing), jnp.asarray(true))
    with torch.no_grad():
        pred_t, std_t = tmodel.unroll_prediction(
            torch.as_tensor(init), torch.as_tensor(forcing),
            torch.as_tensor(true))
    assert pred_t.shape == (B, T, tmodel.num_grid_nodes,
                            tmodel.num_state_vars)
    np.testing.assert_allclose(pred_t.numpy(), np.asarray(pred_j),
                               atol=5e-4, rtol=0)
    np.testing.assert_allclose(std_t.numpy(), np.asarray(std_j), rtol=1e-6)


def test_unroll_prediction_matches_jax(models, flat_route):
    """3-step rollout with boundary overwrite on the flat route. atol 5e-4:
    each step feeds the last one's rounding differences back in."""
    assert _route(models) == "flat"
    _check_unroll(models)


def test_unroll_prediction_batched_route_matches_jax(models):
    """The same rollout on the batched route, atol 5e-4."""
    assert _route(models) == "batched"
    _check_unroll(models)


@pytest.mark.parametrize("flat", [False, True])
def test_apply_mlp_concat_matches_jax(flat):
    """apply_mlp_concat / apply_mlp_concat_flat (first layer split over the
    concat parts, one part shared across the batch)."""
    rng = np.random.default_rng(5)
    n, h = 50, 64
    parts = [rng.standard_normal((B, n, 7)).astype(np.float32),
             rng.standard_normal((B, n, 5)).astype(np.float32),
             rng.standard_normal((n, 3)).astype(np.float32)]
    jp = jmlp.init_mlp(jax.random.PRNGKey(1), [15, h, h])
    tm = tmlp.init_mlp([15, h, h])
    tm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jp)))
    if flat:
        out_j = jmp.apply_mlp_concat_flat(jp, [jnp.asarray(p) for p in parts])
        out_t = tmp.apply_mlp_concat_flat(tm, [torch.as_tensor(p)
                                               for p in parts])
    else:
        shared = np.broadcast_to(parts[2], (B, n, 3))
        jparts = [jnp.asarray(parts[0]), jnp.asarray(parts[1]),
                  jnp.asarray(shared)]
        out_j = jmlp.apply_mlp_concat(jp, jparts)
        with torch.no_grad():
            out_t = tmlp.apply_mlp_concat(tm, [torch.as_tensor(np.array(p))
                                               for p in jparts])
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               atol=1e-5, rtol=1e-5)


def test_mean_aggregation_matches_jax(tmp_path_factory, flat_route):
    """mesh_aggr="mean" (the processor divides each receiver's sum by its
    real in-degree), flat route: one predict step within atol 1e-4 (as
    test_predict_step_matches_jax) and the gradient of the training loss
    for every parameter within 5e-4 * its JAX gradient's max abs (fp32
    sums in another order through ~10 chained MLPs and their backward)."""
    jmodel, params, tmodel = _build_pair(tmp_path_factory, mesh_aggr="mean")
    init, forcing, true = _inputs(tmodel)
    out_j, _ = jmodel.predict_step(params, jnp.asarray(init[:, 1]),
                                   jnp.asarray(init[:, 0]),
                                   jnp.asarray(forcing[:, 0]))
    with torch.no_grad():
        out_t, _ = tmodel.predict_step(torch.as_tensor(init[:, 1]),
                                       torch.as_tensor(init[:, 0]),
                                       torch.as_tensor(forcing[:, 0]))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=1e-4,
                               rtol=0)
    batch = (init, true[:, :1], forcing[:, :1],
             np.zeros((B, 1), np.int64))
    g_j = jax.grad(jmodel.training_loss)(
        params, tuple(jnp.asarray(b) for b in batch))
    tmodel.training_loss(tuple(torch.as_tensor(b) for b in batch)).backward()
    want = params_from_jax(jax.tree.map(np.asarray, g_j))
    got = dict(tmodel.named_parameters())
    for k, w in want.items():
        err = float((got[k].grad - w).abs().max())
        assert err <= 5e-4 * float(w.abs().max()) + 1e-7, (k, err)
