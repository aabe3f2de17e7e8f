"""The port's models with `--hidden_layers 2` (3-layer MLPs) against the
JAX package's.

The fused kernels take 2-layer MLPs with an output LayerNorm only. The
JAX package gates each of them on that structure (`embed_applicable`,
`two_layer_ln` and `fused_layer` in `apply_interaction_net`,
`grid_update_applicable`, `_flat_grid_eligible`), so a deeper model runs
its XLA route; the port's `kernel_mlp` / `flat_route` gates send it to
the plain PyTorch route on either device. The tests lower the port's
`_FLAT_MIN_VIRT` to 1 at B*h = 128, where every set would be flat with
2-layer MLPs, and assert that no kernel wrapper is called. Tolerances
are the model tests': 1e-4 on one step and a 2-step rollout, 5e-4 x max
abs on the `training_loss` gradients. The JAX side runs its CPU route.
"""

import numpy as np
import pytest
import torch
import yaml

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
from neural_lam_tpu_torch import entry, torch_compat
from neural_lam_tpu_torch.config import DatastoreSelection, NeuralLAMConfig
from neural_lam_tpu_torch.convert import params_from_jax
from neural_lam_tpu_torch.datastore.dummy import DummyDatastore
from neural_lam_tpu_torch.graph.build import create_graph
from neural_lam_tpu_torch.graph.storage import graph_from_bundle
from neural_lam_tpu_torch.models import MODELS
from neural_lam_tpu_torch.models.ar_model import ModelArgs
from neural_lam_tpu_torch.ops import edge, edge_flat, embed, grid_update
from neural_lam_tpu_torch.ops import message_passing as tmp

H, B, T, HL = 16, 8, 2, 2  # B*H = 128: flat-eligible sets at _FLAT_MIN_VIRT 1
FAMILIES = {"graph_lam": (16, False), "hi_lam": (27, True)}
KERNELS = ((embed, "embed_grid_flat"), (edge_flat, "edge_tail_sum_flat"),
           (edge_flat, "edge_layer_flat"), (grid_update, "grid_update_flat"),
           (edge, "edge_tail"), (edge, "edge_tail_sum"), (edge, "edge_layer"))

torch.set_num_threads(1)


def _pair(tmp_path_factory, name):
    """(jax_model, jax_params, port_model) of family `name` at HL hidden
    layers, one processor layer."""
    assert jmp._pallas_mode() == "off"
    nx, hier = FAMILIES[name]
    jds = JDummyDatastore(grid_shape=(nx, nx), n_timesteps=10)
    tds = DummyDatastore(grid_shape=(nx, nx), n_timesteps=10)
    jbundle = j_create_graph(str(tmp_path_factory.mktemp("jg")),
                             jds.get_xy("state", stacked=False),
                             n_max_levels=None, hierarchical=hier)
    tbundle = create_graph(str(tmp_path_factory.mktemp("tg")),
                           tds.get_xy("state", stacked=False),
                           n_max_levels=None, hierarchical=hier)
    kw = dict(hidden_dim=H, hidden_layers=HL, processor_layers=1)
    jmodel = J_MODELS[name](
        JModelArgs(**kw),
        JNeuralLAMConfig(datastore=JDatastoreSelection("dummydata", "")),
        jds, j_graph_from_bundle(jbundle))
    params = jmodel.init_params(jax.random.PRNGKey(0))
    tmodel = MODELS[name](
        ModelArgs(**kw),
        NeuralLAMConfig(datastore=DatastoreSelection("dummydata", "")),
        tds, graph_from_bundle(tbundle, device="cpu"), device="cpu")
    tmodel.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    return jmodel, params, tmodel


_PAIRS = {}


@pytest.fixture(params=sorted(FAMILIES))
def models(request, tmp_path_factory):
    if request.param not in _PAIRS:
        _PAIRS[request.param] = _pair(tmp_path_factory, request.param)
    return _PAIRS[request.param]


@pytest.fixture
def no_kernels(monkeypatch):
    """Every set flat-eligible (`_FLAT_MIN_VIRT` 1), and a record of each
    kernel wrapper's calls; the test asserts that there are none."""
    monkeypatch.setattr(tmp, "_FLAT_MIN_VIRT", 1)
    calls = []
    for mod, name in KERNELS:
        def wrapped(*a, _f=getattr(mod, name), _n=name, **kw):
            calls.append(_n)
            return _f(*a, **kw)
        monkeypatch.setattr(mod, name, wrapped)
    yield calls
    assert calls == []


def _inputs(model):
    rng = np.random.default_rng(0)
    n, d = model.num_grid_nodes, model.num_state_vars
    d_f = model.num_forcing_vars * 3
    return (rng.standard_normal((B, 2, n, d)).astype(np.float32),
            rng.standard_normal((B, T, n, d_f)).astype(np.float32),
            rng.standard_normal((B, T, n, d)).astype(np.float32))


@pytest.mark.parametrize("hl", [0, HL])
def test_every_family_builds_jax_parameter_tree(tmp_path, hl):
    """At hidden_layers 0 and 2 every family's state dict is the JAX tree
    key for key and shape for shape (the blueprint reaches every MLP: the
    interaction nets, HiLAMParallel's chunks, the latent heads), and the
    reference keys put the output LayerNorm after the last Linear."""
    jds = JDummyDatastore(grid_shape=(30, 30), n_timesteps=20)
    for name in sorted(MODELS):
        tmodel, _ = entry.build_model(model=name, nx=30, ny=30, hidden_dim=8,
                                      hidden_layers=hl, processor_layers=1,
                                      device="cpu")
        assert not tmodel.kernel_mlps
        jbundle = j_create_graph(str(tmp_path / name),
                                 jds.get_xy("state", stacked=False),
                                 n_max_levels=None,
                                 hierarchical=name.startswith("hi_"))
        jmodel = J_MODELS[name](
            JModelArgs(hidden_dim=8, hidden_layers=hl, processor_layers=1),
            JNeuralLAMConfig(datastore=JDatastoreSelection("dummydata", "")),
            jds, j_graph_from_bundle(jbundle))
        shapes = jax.eval_shape(jmodel.init_params, jax.random.PRNGKey(0))
        want = params_from_jax(jax.tree.map(
            lambda s: np.zeros(s.shape, np.float32), shapes))
        got = tmodel.state_dict()
        assert ({k: tuple(v.shape) for k, v in got.items()}
                == {k: tuple(v.shape) for k, v in want.items()}), name
    refs = {port: ref for ref, port, _ in torch_compat.param_key_map(got)}
    assert (refs[f"g2m_gnn.edge_mlp.layers.{hl}.w"]
            == f"g2m_gnn.edge_mlp.{2 * hl}.weight")
    assert (refs["g2m_gnn.edge_mlp.ln.scale"]
            == f"g2m_gnn.edge_mlp.{2 * hl + 1}.weight")


def test_step_and_rollout_match_jax(models, no_kernels):
    """One predict step and a 2-step rollout at batch 8 on the plain
    route, no kernel wrapper called (atol 1e-4)."""
    jmodel, params, tmodel = models
    assert not tmodel.kernel_mlps
    init, forcing, true = _inputs(tmodel)
    out_j, _ = jax.jit(jmodel.predict_step)(
        params, jnp.asarray(init[:, 1]), jnp.asarray(init[:, 0]),
        jnp.asarray(forcing[:, 0]))
    pred_j, _ = jax.jit(jmodel.unroll_prediction)(
        params, jnp.asarray(init), jnp.asarray(forcing), jnp.asarray(true))
    with torch.no_grad():
        out_t, _ = tmodel.predict_step(torch.as_tensor(init[:, 1]),
                                       torch.as_tensor(init[:, 0]),
                                       torch.as_tensor(forcing[:, 0]))
        pred_t, _ = tmodel.unroll_prediction(
            torch.as_tensor(init), torch.as_tensor(forcing),
            torch.as_tensor(true))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=1e-4,
                               rtol=0)
    assert pred_t.shape == (B, T, tmodel.num_grid_nodes,
                            tmodel.num_state_vars)
    np.testing.assert_allclose(pred_t.numpy(), np.asarray(pred_j),
                               atol=1e-4, rtol=0)


def test_training_loss_grads_match_jax(models, no_kernels):
    """`training_loss` and its gradient for every parameter, within 5e-4
    of the JAX gradient's max abs (the loss within 1e-5 relative)."""
    jmodel, params, tmodel = models
    init, forcing, true = _inputs(tmodel)
    batch = (init, true[:, :1], forcing[:, :1], np.zeros((B, 1), np.int64))
    loss_j, g_j = jax.jit(jax.value_and_grad(jmodel.training_loss))(
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


def test_train_predict_export_clis_take_hidden_layers(tmp_path,
                                                      monkeypatch):
    """`train.py --hidden_layers 2` trains a step and saves a checkpoint
    whose MLPs have three layers; `predict.py --hidden_layers 2`
    forecasts from it (finite), and `export.py --hidden_layers 2` exports
    it: the loaded program gives the eager step's output."""
    from neural_lam_tpu_torch import export, predict, train

    monkeypatch.chdir(tmp_path)
    with open("dummy.yaml", "w") as f:
        yaml.safe_dump({"n_points_1d": 10, "n_timesteps": 30,
                        "root": "dsroot"}, f)
    with open("config.yaml", "w") as f:
        yaml.safe_dump({"datastore": {"kind": "dummydata",
                                      "config_path": "dummy.yaml"}}, f)
    width = ["--hidden_dim", "8", "--hidden_layers", "2",
             "--processor_layers", "1", "--device", "cpu"]
    train.main(["--config_path", "config.yaml", *width, "--epochs", "1",
                "--max_steps", "1", "--batch_size", "2",
                "--ar_steps_eval", "2", "--val_steps_to_log", "1", "2",
                "--save_dir", "models", "--run_name", "r1"])
    state = torch.load(tmp_path / "models" / "r1" / "last" / "state.pt",
                       map_location="cpu", weights_only=False)
    assert "g2m_gnn.edge_mlp.layers.2.w" in state["model"]
    predict.main(["--config_path", "config.yaml", *width, "--load",
                  "models/r1/last", "--ar_steps", "2", "--out", "f.npz"])
    z = np.load(tmp_path / "f.npz", allow_pickle=True)
    assert z["state"].shape[0] == 2 and np.isfinite(z["state"]).all()
    export.main(["--config_path", "config.yaml", *width, "--load",
                 "models/r1/last", "--batch_size", "2", "--out", "m.pt2"])
    step = export.load_exported(tmp_path / "m.pt2")
    model, _, _ = predict.prepare(predict.parse_args(
        ["--config_path", "config.yaml", *width, "--load", "models/r1/last",
         "--out", "x.npz"]))
    rng = np.random.default_rng(0)
    n, d = model.num_grid_nodes, model.num_state_vars
    d_f = model.grid_dim - 2 * d - model.grid_static_dim
    inputs = [torch.as_tensor(rng.standard_normal(s).astype(np.float32))
              for s in ((2, n, d), (2, n, d), (2, n, d_f))]
    with torch.no_grad():
        want, _ = model.predict_step(*inputs)
    torch.testing.assert_close(step(*inputs)[0], want, rtol=0, atol=0)
