"""The port's predict CLI and its checkpoint sources against the JAX
package, on the CPU.

* A JAX checkpoint (orbax), converted by `convert_jax_checkpoint.py`,
  forecast by the port's `predict.main` matches the JAX `predict.main` on
  the same checkpoint and sample: (port - JAX) / state_std within 5e-4 per
  element over 3 steps, for GraphLAM on the MDP fixture, GraphLAM on the
  MEPS fixture, HiLAM on a 30x30 dummydata (2 levels), and GraphLAM with
  `--output_std`. The .zarr and .npz files carry the same arrays, dims,
  attrs (apart from paths) and int64 valid times.
* A reference Neural-LAM state dict (`tests/torch_reference.py`) turns
  into the same port state dict as `params_from_jax` of the JAX
  `import_state_dict` of it, and the rollouts agree within 1e-4; the
  predict CLI forecasts from its Lightning `.ckpt`.
* Reference `.pt` graph directories convert both ways as the JAX
  package's do.
* What the port cannot forecast yet raises.

Both sides run their plain CPU routes at hidden width 16, 1 processor
layer.
"""

import json
import shutil

import jax
import numpy as np
import pytest
import torch
import yaml

import convert_jax_checkpoint
from neural_lam_tpu.checkpoint import save_checkpoint as j_save_checkpoint
from neural_lam_tpu.config import (
    DatastoreSelection as JDatastoreSelection,
    NeuralLAMConfig as JNeuralLAMConfig,
    load_config_and_datastore as j_load_config_and_datastore,
)
from neural_lam_tpu.dataset import WeatherDataset as JWeatherDataset
from neural_lam_tpu.dataset import collate as j_collate
from neural_lam_tpu.datastore.compute_standardization_stats import (
    main as meps_stats_main,
)
from neural_lam_tpu.datastore.dummy import DummyDatastore as JDummyDatastore
from neural_lam_tpu.datastore.mdp import MDPDatastore as JMDPDatastore
from neural_lam_tpu.datastore.zarr_reader import ZarrGroup as JZarrGroup
from neural_lam_tpu.graph.build import create_graph as j_create_graph
from neural_lam_tpu.graph.storage import graph_from_bundle as j_graph_from_bundle
from neural_lam_tpu.graph.torch_io import (
    graph_from_torch_dir as j_graph_from_torch_dir,
    torch_dir_from_bundle as j_torch_dir_from_bundle,
)
from neural_lam_tpu.models import MODELS as J_MODELS
from neural_lam_tpu.models.ar_model import ModelArgs as JModelArgs
from neural_lam_tpu.predict import main as j_predict_main
from neural_lam_tpu.torch_compat import import_state_dict as j_import_state_dict
from neural_lam_tpu_torch import predict, torch_compat, train
from neural_lam_tpu_torch.config import load_config_and_datastore
from neural_lam_tpu_torch.convert import params_from_jax
from neural_lam_tpu_torch.datastore.mdp import MDPDatastore
from neural_lam_tpu_torch.datastore.zarr_reader import ZarrGroup
from neural_lam_tpu_torch.graph.storage import (
    graph_from_bundle,
    load_graph_bundle,
)
from neural_lam_tpu_torch.graph.torch_io import (
    graph_from_torch_dir,
    torch_dir_from_bundle,
)
from neural_lam_tpu_torch.models import MODELS

from .mdp_fixture import make_mdp_dataset
from .meps_fixture import make_meps_dataset
from .torch_reference import TorchGraphLAM, TorchHiLAM

H, STEPS = 16, 3


def _dummy(root, n, name="dummy.yaml", **extra):
    """A dummydata datastore config with a persistent root; returns the
    neural-lam config's path."""
    (root / name).write_text(yaml.safe_dump(
        dict(n_points_1d=n, n_timesteps=40, root="dsroot", **extra)))
    cfg = root / "config.yaml"
    cfg.write_text(yaml.safe_dump({"datastore": {
        "kind": "dummydata", "config_path": name}}))
    return cfg


def _setup(case, root, monkeypatch):
    """(neural-lam config path, model, graph, split, extra model flags)."""
    root.mkdir(parents=True, exist_ok=True)
    if case == "mdp":
        # the 12x10 fixture has no interior inside the default 30-point
        # boundary frame: narrow it on both sides
        for cls in (MDPDatastore, JMDPDatastore):
            monkeypatch.setattr(cls.__init__, "__defaults__", (2,))
        ds_cfg = make_mdp_dataset(root)
        cfg = root / "config.yaml"
        cfg.write_text(yaml.safe_dump({"datastore": {
            "kind": "mdp", "config_path": ds_cfg.name}}))
        return cfg, "graph_lam", "g1level", "train", []
    if case == "meps":
        ds_cfg = make_meps_dataset(root)
        meps_stats_main(ds_cfg, step_length=2)
        cfg = root / "config.yaml"
        cfg.write_text(yaml.safe_dump({"datastore": {
            "kind": "npyfilesmeps", "config_path": ds_cfg.name}}))
        return cfg, "graph_lam", "1level", "test", []
    if case == "hilam":
        return _dummy(root, 30), "hi_lam", "hierarchical", "test", []
    return _dummy(root, 10), "graph_lam", "g1level", "test", ["--output_std"]


def _last_json(text):
    return json.loads(text.strip().splitlines()[-1])


@pytest.mark.filterwarnings("ignore:only using first ensemble member")
@pytest.mark.filterwarnings("ignore:Could not load diff mean/std")
@pytest.mark.parametrize("case", ["mdp", "meps", "hilam", "output_std"])
def test_converted_jax_checkpoint_forecasts_as_jax(case, tmp_path,
                                                   monkeypatch, capsys):
    """JAX checkpoint -> convert_jax_checkpoint.py -> the port's predict
    CLI, against the JAX predict CLI on the same checkpoint and sample."""
    cfg, model, graph, split, extra = _setup(case, tmp_path / "ds",
                                             monkeypatch)
    config, jds = j_load_config_and_datastore(cfg)
    # the JAX model builds the graph under the datastore's root; the port
    # loads the same files
    jmodel = J_MODELS[model](
        JModelArgs(graph=graph, hidden_dim=H, processor_layers=1,
                   output_std=bool(extra)), config, jds)
    params = jmodel.init_params(jax.random.PRNGKey(3))
    j_save_checkpoint(tmp_path / "jax", "best", params, meta={"step": 7})
    ckpt = convert_jax_checkpoint.convert(tmp_path / "jax" / "best",
                                          tmp_path / "port")
    assert ckpt == tmp_path / "port" / "best"
    assert json.loads((tmp_path / "port" / "best.meta.json").read_text())[
        "step"] == 7

    common = ["--config_path", str(cfg), "--model", model, "--graph", graph,
              "--hidden_dim", str(H), "--processor_layers", "1",
              "--ar_steps", str(STEPS), "--split", split,
              "--sample_idx", "-1"] + extra
    outs = ["f.zarr"] + (["f.npz"] if case == "output_std" else [])
    summaries = {}
    for out in outs:
        capsys.readouterr()
        j_predict_main(common + ["--load", str(tmp_path / "jax" / "best"),
                                 "--out", str(tmp_path / f"jax_{out}")])
        summaries["jax", out] = _last_json(capsys.readouterr().out)
        got = predict.main(common + ["--load", str(ckpt), "--device", "cpu",
                                     "--out", str(tmp_path / f"port_{out}")])
        summaries["port", out] = _last_json(capsys.readouterr().out)
        assert summaries["port", out] == {
            k: v for k, v in got.items() if k not in ("init_s", "rollout_s")}
    for out in outs:
        a, b = summaries["port", out], summaries["jax", out]
        assert a.pop("out").endswith(f"port_{out}")
        assert b.pop("out").endswith(f"jax_{out}")
        assert a == b

    _, tds = load_config_and_datastore(cfg)
    std = tds.get_standardization_dataarray("state")["state_std"]
    n, d = tds.num_grid_points, tds.get_num_data_vars("state")
    t, j = ZarrGroup(tmp_path / "port_f.zarr"), JZarrGroup(
        tmp_path / "jax_f.zarr")
    assert sorted(t.arrays) == sorted(j.arrays) == [
        "state", "state_feature", "time"]
    for name in t.arrays:
        assert t[name].dims == j[name].dims
        ta, ja = dict(t[name].attrs), dict(j[name].attrs)
        if name == "state":
            assert ta.pop("source_checkpoint") == str(ckpt)
            ja.pop("source_checkpoint")
        assert ta == ja, name
    pred = t["state"].read_full()
    assert pred.shape == (STEPS, n, d) and np.isfinite(pred).all()
    gap = np.abs(pred - j["state"].read_full()) / std
    assert gap.max() <= 5e-4, gap.max()
    times = t["time"].read_full()
    assert times.dtype == np.int64
    np.testing.assert_array_equal(times, j["time"].read_full())
    wd = JWeatherDataset(jds, split=split, ar_steps=STEPS)
    np.testing.assert_array_equal(times, wd[-1][3])
    assert list(t["state_feature"].read_full()) == list(
        j["state_feature"].read_full()) == list(tds.get_vars_names("state"))
    if case == "output_std":
        zt, zj = (np.load(tmp_path / f"{w}_f.npz") for w in ("port", "jax"))
        assert sorted(zt.files) == sorted(zj.files)
        np.testing.assert_array_equal(zt["state"], pred)
        assert zt["time"].dtype == zj["time"].dtype == np.int64
        np.testing.assert_array_equal(zt["time"], zj["time"])
        np.testing.assert_array_equal(zt["state_feature"],
                                      zj["state_feature"])
        # a converted checkpoint holds no optimizer state
        with pytest.raises(ValueError, match="converted from the JAX"):
            train.main(["--config_path", str(cfg), "--device", "cpu",
                        "--graph", graph, "--hidden_dim", str(H),
                        "--processor_layers", "1", "--output_std",
                        "--load", str(ckpt), "--restore_opt",
                        "--save_dir", str(tmp_path / "models")])


@pytest.fixture(scope="module")
def ref_env(tmp_path_factory):
    """A 30x28 dummydata with a persistent root holding the JAX package's
    multiscale and 2-level hierarchical graphs."""
    root = tmp_path_factory.mktemp("ref")
    cfg = _dummy(root, 0, grid_shape=[30, 28])
    jds = JDummyDatastore(grid_shape=(30, 28), n_timesteps=40)
    bundles = {}
    for name, hier in (("multiscale", False), ("hierarchical", True)):
        bundles[name] = j_create_graph(
            str(root / "dsroot" / "graph" / name),
            jds.get_xy("state", stacked=False),
            n_max_levels=2 if hier else None, hierarchical=hier)
    return cfg, jds, bundles


@pytest.mark.parametrize("model", ["graph_lam", "hi_lam"])
def test_reference_state_dict_loads_as_jax(model, ref_env, tmp_path):
    """A reference Neural-LAM state dict: the port's import equals
    params_from_jax of the JAX import, export inverts it, the port's
    rollout agrees with the reference model's within 1e-4, and (GraphLAM)
    the predict CLI forecasts from its Lightning .ckpt."""
    cfg, jds, bundles = ref_env
    graph = "multiscale" if model == "graph_lam" else "hierarchical"
    jconfig = JNeuralLAMConfig(datastore=JDatastoreSelection("dummydata", ""))
    jmodel = J_MODELS[model](JModelArgs(hidden_dim=8, processor_layers=2),
                             jconfig, jds,
                             j_graph_from_bundle(bundles[graph]))
    torch.manual_seed(0)
    cls = TorchGraphLAM if model == "graph_lam" else TorchHiLAM
    ref = cls(j_graph_from_bundle(bundles[graph], dense=False),
              jmodel.statics, jmodel.grid_dim, jmodel.grid_output_dim,
              hidden_dim=8, hidden_layers=1, n_proc=2)
    ref_sd = ref.state_dict()

    config, tds = load_config_and_datastore(cfg)
    from neural_lam_tpu_torch.models.ar_model import ModelArgs

    tmodel = MODELS[model](
        ModelArgs(hidden_dim=8, processor_layers=2), config, tds,
        graph_from_bundle(load_graph_bundle(
            str(tds.root_path / "graph" / graph)), "cpu"), device="cpu")
    got = torch_compat.import_state_dict(tmodel.state_dict(), ref_sd)
    want = params_from_jax(jax.tree.map(np.asarray, j_import_state_dict(
        jmodel.init_params(jax.random.PRNGKey(1)),
        {k: v.numpy() for k, v in ref_sd.items()})))
    assert sorted(got) == sorted(want) == sorted(tmodel.state_dict())
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
    exported = torch_compat.export_state_dict(got)
    for k, v in exported.items():
        np.testing.assert_array_equal(v, ref_sd[k].numpy(), k)
    with pytest.raises(KeyError, match="missing"):
        torch_compat.import_state_dict(
            tmodel.state_dict(), {k: v for k, v in ref_sd.items()
                                  if "output_map" not in k})
    with pytest.raises(KeyError, match="unused"):
        torch_compat.import_state_dict(
            tmodel.state_dict(), {**ref_sd, "extra.weight": np.zeros(2)})

    tmodel.load_state_dict(got)
    wd = JWeatherDataset(jds, split="test", ar_steps=STEPS)
    init, target, forcing, _ = j_collate([wd[-1]])
    with torch.no_grad():
        pred_ref = ref.unroll_prediction(torch.tensor(init),
                                         torch.tensor(forcing),
                                         torch.tensor(target)).numpy()
        pred_port, _ = tmodel.unroll_prediction(torch.tensor(init),
                                                torch.tensor(forcing),
                                                torch.tensor(target))
    np.testing.assert_allclose(pred_port.numpy(), pred_ref, atol=1e-4,
                               rtol=0)
    if model != "graph_lam":
        return
    ckpt = tmp_path / "min_val_loss.ckpt"
    torch.save({"state_dict": ref_sd, "epoch": 1, "global_step": 3,
                "hyper_parameters": {"hidden_dim": 8}}, ckpt)
    predict.main(["--config_path", str(cfg), "--graph", graph,
                  "--hidden_dim", "8", "--processor_layers", "2",
                  "--load", str(ckpt), "--ar_steps", str(STEPS),
                  "--device", "cpu", "--out", str(tmp_path / "f.npz")])
    stats = tds.get_standardization_dataarray("state")
    got = (np.load(tmp_path / "f.npz")["state"] - stats["state_mean"]) \
        / stats["state_std"]
    np.testing.assert_allclose(got, pred_ref[0], atol=1e-4, rtol=0)


def test_split_mlps_wait_for_hilam_parallel():
    with pytest.raises(NotImplementedError, match="item 4"):
        torch_compat.import_state_dict(
            {"processor.0.edge_mlp.layers.0.w": torch.zeros(2, 2)},
            {"processor.module_0.edge_mlp.mlps.0.0.weight": np.zeros((2, 2))})


@pytest.mark.parametrize("hier", [False, True])
def test_reference_graph_dirs_convert_as_jax(hier, ref_env, tmp_path):
    """A .pt directory written by the JAX package loads into the port as
    the JAX bundle's arrays, and one written by the port loads into the
    JAX package as the port bundle's."""
    _, _, bundles = ref_env
    bundle = bundles["hierarchical" if hier else "multiscale"]
    j_torch_dir_from_bundle(bundle, str(tmp_path / "j"), (30, 28))
    port = graph_from_torch_dir(str(tmp_path / "j"), (30, 28))
    torch_dir_from_bundle(port, str(tmp_path / "t"), (30, 28))
    back = j_graph_from_torch_dir(str(tmp_path / "t"), (30, 28))
    assert port.hierarchical == back.hierarchical == bundle.hierarchical
    for field in ("m2m_edge_index", "m2m_features", "mesh_static_features",
                  "mesh_up_edge_index", "mesh_up_features",
                  "mesh_down_edge_index", "mesh_down_features",
                  "g2m_edge_index", "g2m_features", "m2g_edge_index",
                  "m2g_features"):
        want = getattr(bundle, field)
        for got in (getattr(port, field), getattr(back, field)):
            if isinstance(want, list):
                assert len(got) == len(want), field
                for a, b in zip(got, want):
                    np.testing.assert_array_equal(a, b, field)
            else:
                np.testing.assert_array_equal(got, want, field)


@pytest.mark.parametrize("flags, error, match", [
    (["--ensemble_members", "1"], NotImplementedError, "item 5"),
    (["--precision", "bf16-mixed"], NotImplementedError, "item 2"),
    (["--model", "hi_lam_parallel"], ValueError, "item 4"),
    (["--model", "nonsense"], ValueError, "not one of"),
    (["--device", "cuda"], RuntimeError, "CUDA is not available"),
])
def test_unsupported_raises(flags, error, match, tmp_path):
    if torch.cuda.is_available() and "cuda" in flags:
        pytest.skip("a CUDA device is present: the default device works")
    cfg = _dummy(tmp_path, 10)
    device = [] if "--device" in flags else ["--device", "cpu"]
    with pytest.raises(error, match=match):
        predict.main(["--config_path", str(cfg), "--load", str(tmp_path),
                      "--out", str(tmp_path / "f.zarr")] + device + flags)
    shutil.rmtree(tmp_path / "dsroot", ignore_errors=True)
