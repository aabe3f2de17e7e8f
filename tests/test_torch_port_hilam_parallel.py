"""The port's HiLAMParallel against the JAX package's, on the same
datastore, hierarchical graph and weights (carried over with
`convert.params_from_jax`), in fp32 on the CPU.

Two hierarchies, hidden 64:

* 30x30 DummyDatastore: two levels (81 and 9 mesh nodes), 4 chunks
  (m2m[0], m2m[1], up[0], down[0]), 2 processor layers;
* 81x81: three levels (729 / 81 / 9), 7 chunks, whose middle level sums
  an m2m, an up and a down chunk in one accumulator, 1 processor layer
  (test_torch_port_hilam_parallel_3level.py runs this file's model tests
  on it).

The JAX side runs its CPU route (Pallas off: the batched XLA path
everywhere, jitted), the port two of its routes, as
test_torch_port_hilam.py's (its fixtures' layout and limits):

* batch 1 (B*h = 64): the batched route end to end -- every processor
  chunk through P1 with its messages, P3 in the mesh-init sweep, P1
  without messages in the read-out;
* batch 2 with the port's `_FLAT_MIN_VIRT` lowered (to 100 at two
  levels, 150 at three): the mixed route -- the larger sets flat (K3 on
  their chunks), the others batched (P1 with messages).

Limits: 1e-4 on one predict step, 5e-4 on a 3-step rollout, the
training-loss gradient within 5e-4 of the JAX gradient's max abs per
parameter; one processor layer on JAX's own inputs (its per-level
receiver sums, new edge states and new level states) within 1e-4.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import neural_lam_tpu.models.hi_lam_parallel as jhlp
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
from neural_lam_tpu_torch import train
from neural_lam_tpu_torch.config import DatastoreSelection, NeuralLAMConfig
from neural_lam_tpu_torch.convert import params_from_jax
from neural_lam_tpu_torch.datastore.dummy import DummyDatastore
from neural_lam_tpu_torch.graph.build import create_graph
from neural_lam_tpu_torch.graph.storage import graph_from_bundle
from neural_lam_tpu_torch.models import MODELS, is_hierarchical
from neural_lam_tpu_torch.models.ar_model import ModelArgs
from neural_lam_tpu_torch.models.hi_lam_parallel import HiLAMParallel
from neural_lam_tpu_torch.ops import message_passing as tmp
from neural_lam_tpu_torch.ops.message_passing import (
    ChunkedInteractionNet,
    flatten_nodes,
    init_interaction_net_chunked,
    unflatten_nodes,
)

T, LAYERS = 3, 2
# the port's flat-route threshold for the mixed route (see module doc)
MIXED_MIN_VIRT = 100
ROUTES = {"batched": 1, "mixed": 2}  # route -> batch
# the hierarchies this file runs on; the 3-level one is
# test_torch_port_hilam_parallel_3level.py's, so that two test workers
# share the JAX runs
GRIDS = {"2-level": 30}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's side on one thread for this module: the suite's workers
    share the machine's cores, and these small tensors gain little from
    more (JAX's compiles dominate the time)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _models(tmp_path_factory, nx, layers=LAYERS):
    """(jax_model, jax_params, port_model) on an nx x nx grid with
    `layers` processor layers, the port's weights loaded strictly from
    the JAX tree."""
    assert jmp._pallas_mode() == "off"
    jds = JDummyDatastore(grid_shape=(nx, nx), n_timesteps=10)
    tds = DummyDatastore(grid_shape=(nx, nx), n_timesteps=10)
    jbundle = j_create_graph(str(tmp_path_factory.mktemp("jg")),
                             jds.get_xy("state", stacked=False),
                             n_max_levels=None, hierarchical=True)
    tbundle = create_graph(str(tmp_path_factory.mktemp("tg")),
                           tds.get_xy("state", stacked=False),
                           n_max_levels=None, hierarchical=True)
    jmodel = J_MODELS["hi_lam_parallel"](
        JModelArgs(hidden_dim=64, processor_layers=layers),
        JNeuralLAMConfig(datastore=JDatastoreSelection("dummydata", "")),
        jds, j_graph_from_bundle(jbundle),
    )
    params = jmodel.init_params(jax.random.PRNGKey(0))
    tmodel = HiLAMParallel(
        ModelArgs(hidden_dim=64, processor_layers=layers),
        NeuralLAMConfig(datastore=DatastoreSelection("dummydata", "")),
        tds, graph_from_bundle(tbundle, device="cpu"), device="cpu",
    )
    tmodel.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    return jmodel, params, tmodel


@pytest.fixture(scope="module", params=sorted(GRIDS))
def models(request, tmp_path_factory):
    """(jax_model, jax_params, port_model) on each hierarchy."""
    return _models(tmp_path_factory, GRIDS[request.param])


@pytest.fixture
def mixed_min_virt():
    """The port's flat-route threshold on the mixed route."""
    return MIXED_MIN_VIRT


@pytest.fixture(params=sorted(ROUTES))
def route(request, monkeypatch, mixed_min_virt):
    """(route name, batch size) with the port's dispatch set for it."""
    if request.param == "mixed":
        monkeypatch.setattr(tmp, "_FLAT_MIN_VIRT", mixed_min_virt)
    return request.param, ROUTES[request.param]


def _inputs(model, B):
    rng = np.random.default_rng(B)
    n, d = model.num_grid_nodes, model.num_state_vars
    d_f = model.num_forcing_vars * 3
    return (rng.standard_normal((B, 2, n, d)).astype(np.float32),
            rng.standard_normal((B, T, n, d_f)).astype(np.float32),
            rng.standard_normal((B, T, n, d)).astype(np.float32))


def jmodel_layers(models):
    """The JAX tree's processor layers."""
    return models[1]["processor"]


def _flat_chunks(tmodel, B):
    return [tmp.flat_eligible(es, B, 64) for es in tmodel._chunk_edge_sets()]


def test_chunks_and_routes(models, route):
    """Chunk order, sender and receiver levels as the JAX model's (m2m
    levels, then up, then down), and the route of each chunk."""
    jmodel, _, tmodel = models
    name, B = route
    L = tmodel.num_levels
    assert tmodel.graph.level_sizes == {2: (81, 9), 3: (729, 81, 9)}[L]
    assert tmodel._chunk_send_level == jmodel._chunk_send_level
    assert tmodel._chunk_rec_level == jmodel._chunk_rec_level
    assert len(tmodel._chunk_edge_sets()) == 3 * L - 2
    assert len(tmodel.processor) == len(jmodel_layers(models))
    assert all(len(p.edge_mlps) == 3 * L - 2 and len(p.aggr_mlps) == L
               for p in tmodel.processor)
    flat = _flat_chunks(tmodel, B)
    if name == "batched":
        assert not any(flat)
    elif L == 2:
        # m2m[0] and down[0] (128 rows) flat, m2m[1] and up[0] (64) not
        assert flat == [True, False, False, True]
    else:
        # m2m[0], up[0] and down[0] (192-768 rows) flat, the rest not: the
        # middle level sums flat and batched chunks
        assert flat == [True, False, False, True, False, True, False]


def test_params_from_jax_loads_strictly(models):
    """Every port parameter comes from the JAX tree, shape for shape,
    the chunked processor's edge_mlps and aggr_mlps included."""
    _, params, tmodel = models
    sd = params_from_jax(jax.tree.map(np.asarray, params))
    assert set(sd) == set(tmodel.state_dict())
    L = tmodel.num_levels
    last = len(tmodel.processor) - 1
    assert f"processor.{last}.edge_mlps.{3 * L - 3}.layers.0.w" in sd
    assert f"processor.{last}.aggr_mlps.{L - 1}.ln.scale" in sd
    for k, v in tmodel.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), sd[k].numpy(), k)
    with pytest.raises(RuntimeError, match="Missing key"):
        tmodel.load_state_dict({k: v for k, v in sd.items()
                                if ".aggr_mlps.0." not in k})


def test_chunked_interaction_net_layout():
    """The chunked net's state-dict keys and recipes: edge MLPs [3h, h,
    h] and aggregation MLPs [2h, h, h], each with an output LayerNorm, as
    the JAX package's `init_interaction_net_chunked`; at hidden_layers 2
    one Linear more each, and no kernel MLP."""
    inet = init_interaction_net_chunked(8, 3, 2)
    assert isinstance(inet, ChunkedInteractionNet)
    jp = jmp.init_interaction_net_chunked(jax.random.PRNGKey(0), 8, 3, 2)
    want = params_from_jax(jax.tree.map(np.asarray, jp))
    got = inet.state_dict()
    assert sorted(got) == sorted(want)
    for k in want:
        assert tuple(got[k].shape) == tuple(want[k].shape), k
    assert got["edge_mlps.2.layers.0.w"].shape == (24, 8)
    assert got["aggr_mlps.1.layers.0.w"].shape == (16, 8)
    # hidden_layers 2: 3-layer MLPs, which no kernel takes (the plain
    # route, `kernel_mlp`)
    deep = init_interaction_net_chunked(8, 3, 2, hidden_layers=2)
    assert all(len(m.layers) == 3 and not tmp.kernel_mlp(m)
               for m in [*deep.edge_mlps, *deep.aggr_mlps])


_JAX_STEPS = {}


def _jax_step(models, B):
    """(JAX predict-step output, the inputs its processor got) at batch
    B, from one jitted step with the processor's inputs recorded as it
    runs (numpy arrays: levels, same, up, down); cached per model."""
    jmodel, params, tmodel = models
    key = (id(jmodel), B)
    if key not in _JAX_STEPS:
        got = []
        real = jhlp.HiLAMParallel.hi_processor_step

        def record(self, p, *args):
            jax.debug.callback(
                lambda a: got.append(jax.tree.map(np.array, a)), args)
            return real(self, p, *args)

        init, forcing, _ = _inputs(tmodel, B)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jhlp.HiLAMParallel, "hi_processor_step", record)
            out, _ = jax.jit(jmodel.predict_step)(
                params, jnp.asarray(init[:, 1]), jnp.asarray(init[:, 0]),
                jnp.asarray(forcing[:, 0]))
            out = np.asarray(out)
        assert len(got) == 1
        _JAX_STEPS[key] = out, got[0]
    return _JAX_STEPS[key]


def test_predict_step_matches_jax(models, route):
    """One predict step on each route (atol 1e-4)."""
    tmodel = models[2]
    B = route[1]
    init, forcing, _ = _inputs(tmodel, B)
    out_j = _jax_step(models, B)[0]
    with torch.no_grad():
        out_t, _ = tmodel.predict_step(torch.as_tensor(init[:, 1]),
                                       torch.as_tensor(init[:, 0]),
                                       torch.as_tensor(forcing[:, 0]))
    assert out_t.shape == (B, tmodel.num_grid_nodes, tmodel.num_state_vars)
    np.testing.assert_allclose(out_t.numpy(), out_j, atol=1e-4, rtol=0)


def test_unroll_prediction_matches_jax(models, route):
    """3-step rollout with boundary overwrite on each route (atol
    5e-4)."""
    jmodel, params, tmodel = models
    B = route[1]
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


def _batch(tmodel, B):
    init, forcing, true = _inputs(tmodel, B)
    return (init, true[:, :1], forcing[:, :1], np.zeros((B, 1), np.int64))


def test_training_loss_grads_match_jax(models, route):
    """Gradient of training_loss on each route (P1's backward recomputed
    through its reference math on the batched chunks; K3's backward
    B3/B4 on the flat ones), within 5e-4 of the JAX gradient's max abs
    per parameter."""
    jmodel, params, tmodel = models
    batch = _batch(tmodel, route[1])
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


def test_processor_layer_matches_jax_on_its_inputs(models, route):
    """One processor layer alone, on the inputs JAX's own predict step
    gives its processor: each level's receiver sums (all its chunks,
    in chunk order), each chunk's new edge state (in the port's layout
    for its route) and each level's new state, against the JAX layer's,
    within 1e-4."""
    jmodel, params, tmodel = models
    B = route[1]
    levels, same, up, down = _jax_step(models, B)[1]
    aggs = []
    real_concat = jhlp.apply_mlp_concat

    def record_concat(p, parts, **kw):
        jax.debug.callback(lambda a: aggs.append(np.array(a)), parts[1],
                           ordered=True)
        return real_concat(p, parts, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jhlp, "apply_mlp_concat", record_concat)
        j_levels, *j_edges = jax.jit(
            lambda p, a: jmodel.hi_processor_step(
                {"processor": p["processor"][:1]}, *a))(
            params, jax.tree.map(jnp.asarray, (levels, same, up, down)))
        jax.effects_barrier()
    j_edges = [e for part in j_edges for e in part]

    flat = _flat_chunks(tmodel, B)
    edge_in = [torch.as_tensor(e) for e in list(same) + list(up) + list(down)]
    edge_in = [flatten_nodes(e) if f else e for e, f in zip(edge_in, flat)]
    lv_in = [torch.as_tensor(x) for x in levels]
    with torch.no_grad():
        t_aggs, t_edges = tmodel.aggregate_chunks(tmodel.processor[0],
                                                  lv_in, edge_in)
        t_levels, t_edges2 = tmodel.processor_layer(tmodel.processor[0],
                                                    lv_in, edge_in)
    assert len(aggs) == len(t_aggs) == tmodel.num_levels
    for lvl, (j, t) in enumerate(zip(aggs, t_aggs)):
        np.testing.assert_allclose(t.numpy(), j, atol=1e-4, rtol=0,
                                   err_msg=f"level {lvl} receiver sums")
    assert len(j_edges) == len(t_edges) == len(flat)
    for c, (j, t, t2, f) in enumerate(zip(j_edges, t_edges, t_edges2,
                                          flat)):
        assert tuple(t.shape) == ((j.shape[1], B * 64) if f else j.shape)
        torch.testing.assert_close(t2, t, rtol=0, atol=0)
        t = unflatten_nodes(t, B) if f else t
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-4,
                                   rtol=0, err_msg=f"chunk {c} edge state")
    for lvl, (j, t) in enumerate(zip(j_levels, t_levels)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-4,
                                   rtol=0, err_msg=f"level {lvl} state")


def test_edge_layout_is_checked(models, monkeypatch, mixed_min_virt):
    """The chunks' edge states must have the layout `expand_edge_rep`
    gives their route (the chunks bypass apply_interaction_net's check):
    on the mixed route, all-batched states raise, naming it."""
    _, _, tmodel = models
    monkeypatch.setattr(tmp, "_FLAT_MIN_VIRT", mixed_min_virt)
    sets = tmodel._chunk_edge_sets()
    with torch.no_grad():
        ctx = tmodel.precompute_process_ctx()
        embs = ctx["same_emb"] + ctx["up_emb"] + ctx["down_emb"]
        levels = [torch.zeros(2, n, 64) for n in tmodel.graph.level_sizes]
        tmodel.processor_layer(tmodel.processor[0], levels, [
            tmp.expand_edge_rep(es, e, 2) for es, e in zip(sets, embs)])
        with pytest.raises(ValueError, match="expand_edge_rep"):
            tmodel.processor_layer(tmodel.processor[0], levels, [
                e[None].expand(2, *e.shape) for e in embs])


def test_remat_gradients_are_bit_equal(tmp_path_factory, monkeypatch):
    """`ModelArgs.remat` (each predict step checkpointed) changes no bit
    of the training-loss gradients, at ar_steps 2 on the mixed route."""
    monkeypatch.setattr(tmp, "_FLAT_MIN_VIRT", MIXED_MIN_VIRT)
    tds = DummyDatastore(grid_shape=(30, 30), n_timesteps=10)
    graph = graph_from_bundle(create_graph(
        str(tmp_path_factory.mktemp("rg")), tds.get_xy("state", stacked=False),
        n_max_levels=None, hierarchical=is_hierarchical("hi_lam_parallel")),
        device="cpu")
    cfg = NeuralLAMConfig(datastore=DatastoreSelection("dummydata", ""))
    grads = []
    for remat in (False, True):
        m = MODELS["hi_lam_parallel"](
            ModelArgs(hidden_dim=64, processor_layers=1, remat=remat),
            cfg, tds, graph, device="cpu",
            generator=torch.Generator().manual_seed(3))
        init, forcing, true = _inputs(m, 2)
        batch = (init, true[:, :2], forcing[:, :2], np.zeros((2, 2), np.int64))
        m.training_loss(tuple(torch.as_tensor(b) for b in batch)).backward()
        grads.append({k: p.grad for k, p in m.named_parameters()})
    assert set(grads[0]) == set(grads[1])
    for k in grads[0]:
        torch.testing.assert_close(grads[1][k], grads[0][k], rtol=0, atol=0)


def test_train_cli_trains_and_evaluates(tmp_path, monkeypatch):
    """`train.main --model hi_lam_parallel --graph hierarchical` trains
    (bf16, remat, ar_steps 2) and saves `last`, which `--eval val` and
    `--eval test` score, on a 30x30 dummydata."""
    monkeypatch.chdir(tmp_path)
    (tmp_path / "dummy.yaml").write_text(
        "n_points_1d: 30\nn_timesteps: 30\nroot: dsroot\n")
    (tmp_path / "config.yaml").write_text(
        "datastore:\n  kind: dummydata\n  config_path: dummy.yaml\n")
    common = ["--config_path", "config.yaml", "--device", "cpu", "--model",
              "hi_lam_parallel", "--graph", "hierarchical", "--hidden_dim",
              "16", "--processor_layers", "1", "--batch_size", "2",
              "--ar_steps_eval", "2", "--val_steps_to_log", "1", "2",
              "--save_dir", "models", "--precision", "bf16"]
    assert train.main(common + ["--epochs", "1", "--max_steps", "2",
                                "--ar_steps_train", "2", "--remat",
                                "--run_name", "r1"]) is None
    run = tmp_path / "models" / "r1"
    logged = [json.loads(line) for line in
              (run / "metrics.jsonl").read_text().splitlines()]
    assert any(np.isfinite(r.get("train_loss", np.nan)) for r in logged)
    val = train.main(common + ["--eval", "val", "--load", str(run / "last"),
                               "--run_name", "v"])
    assert np.isfinite(val["val_mean_loss"])
    train.main(common + ["--eval", "test", "--load", str(run / "last"),
                         "--run_name", "t", "--n_example_pred", "0"])
    rmse = np.loadtxt(tmp_path / "models" / "t" / "test_rmse.csv",
                      delimiter=",")
    assert rmse.shape[0] == 2 and np.isfinite(rmse).all()
