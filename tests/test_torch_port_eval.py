"""The port's `train.py --eval val|test` against the JAX CLI, on the CPU.

A JAX checkpoint (orbax), converted by `convert_jax_checkpoint.py`, is
evaluated by the JAX `train.main --eval test` and by the port's
`train.main --eval test --device cpu`, for GraphLAM on the MDP fixture,
GraphLAM on the MEPS fixture, HiLAM on a 30x30 dummydata (2 levels) and
GraphLAM with `--output_std`, at a batch size that leaves a partial last
batch (the JAX CLI pads it, the port runs it as it is). Held:

* the same files in the run directory, the metrics log aside;
* `test_rmse.csv` and `test_mae.csv` within 5e-4 x state_std;
* `mean_spatial_loss.npy`, `spatial_loss_t*.npy` and the example
  forecasts `example_{pred,target}_1.npy` within 1e-4 of each array's
  largest magnitude;
* the printed dicts with equal keys and the returned values within the
  same limits; the metrics logs with the same keys line by line, the
  `--metrics_watch` values within 5e-4 x state_std;
* `--eval val` likewise (its printed keys, the mean loss within 1e-4
  relative, mse/mae within 5e-4 x state_std, squared for mse).

Where matplotlib does not import, the port's `--eval test` says so, draws
no figure and writes the same csv and npy files. `--ensemble_members`
raises. Both sides run their plain CPU routes at
hidden width 16, 1 processor layer.
"""

import json
import re
import sys

import jax
import numpy as np
import pytest

import convert_jax_checkpoint
import neural_lam_tpu_torch
from neural_lam_tpu import train as j_train
from neural_lam_tpu.checkpoint import save_checkpoint as j_save_checkpoint
from neural_lam_tpu.config import (
    load_config_and_datastore as j_load_config_and_datastore,
)
from neural_lam_tpu.models import MODELS as J_MODELS
from neural_lam_tpu.models.ar_model import ModelArgs as JModelArgs
from neural_lam_tpu_torch import train
from neural_lam_tpu_torch.config import load_config_and_datastore
from neural_lam_tpu_torch.dataset import WeatherDataset

from .test_torch_port_predict import _setup

H = 16
# (ar_steps_eval, batch size) per case: each split's sample count leaves
# a partial last batch at this batch size
SIZES = {"mdp": (1, 3), "meps": (1, 2), "hilam": (2, 2),
         "output_std": (2, 2)}


def _printed_keys(text):
    """The keys of the last dict printed (`print(dict)`) in `text`."""
    text = "\n" + text
    return re.findall(r"'(\w+)': ", text[text.rindex("\n{'"):])


def _metrics_log(run_dir):
    return [{k: v for k, v in json.loads(line).items() if k != "_time"}
            for line in (run_dir / "metrics.jsonl").read_text().splitlines()]


def _close(a, b, limit):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    assert np.isfinite(a).all()
    assert np.all(np.abs(a - b) <= limit), np.abs(a - b).max()


def _close_rel(a, b, rel=1e-4):
    _close(a, b, rel * np.abs(np.asarray(b, np.float64)).max())


def _recorder(monkeypatch, method, store):
    """Wrap the JAX Trainer's `method` to keep what it returns."""
    orig = getattr(j_train.Trainer, method)

    def wrapped(self, *args, **kwargs):
        store[method] = orig(self, *args, **kwargs)
        return store[method]

    monkeypatch.setattr(j_train.Trainer, method, wrapped)


@pytest.fixture
def converted(tmp_path, monkeypatch, request):
    """(case, config path, model, graph, extra flags, JAX checkpoint,
    converted checkpoint) for the case `request.param`."""
    case = request.param
    cfg, model, graph, _, extra = _setup(case, tmp_path / "ds", monkeypatch)
    config, jds = j_load_config_and_datastore(cfg)
    jmodel = J_MODELS[model](
        JModelArgs(graph=graph, hidden_dim=H, processor_layers=1,
                   output_std=bool(extra)), config, jds)
    params = jmodel.init_params(jax.random.PRNGKey(5))
    j_save_checkpoint(tmp_path / "jax", "best", params, meta={"step": 3})
    ckpt = convert_jax_checkpoint.convert(tmp_path / "jax" / "best",
                                          tmp_path / "port")
    return case, cfg, model, graph, extra, tmp_path / "jax" / "best", ckpt


def _argv(case, cfg, model, graph, extra, ckpt, save_dir, run, split):
    ar, batch = SIZES[case]
    return ["--config_path", str(cfg), "--model", model, "--graph", graph,
            "--hidden_dim", str(H), "--processor_layers", "1",
            "--batch_size", str(batch), "--ar_steps_eval", str(ar),
            "--val_steps_to_log", "1", "2", "--eval", split,
            "--load", str(ckpt), "--save_dir", str(save_dir),
            "--run_name", run, "--metrics_watch", "test_rmse",
            "--var_leads_metrics_watch", '{"0": [1, 2], "2": [1]}'] + extra


@pytest.mark.filterwarnings("ignore:only using first ensemble member")
@pytest.mark.filterwarnings("ignore:Could not load diff mean/std")
@pytest.mark.parametrize("converted", ["mdp", "meps", "hilam", "output_std"],
                         indirect=True)
def test_eval_test_matches_jax(converted, tmp_path, monkeypatch, capsys):
    case, cfg, model, graph, extra, jckpt, ckpt = converted
    ar, batch = SIZES[case]
    _, ds = load_config_and_datastore(cfg)
    n = len(WeatherDataset(ds, split="test", ar_steps=ar))
    assert n % batch, (n, batch)  # the last batch is partial
    std = ds.get_standardization_dataarray("state")["state_std"]
    runs = tmp_path / "runs"

    store = {}
    _recorder(monkeypatch, "test", store)
    capsys.readouterr()
    j_train.main(_argv(case, cfg, model, graph, extra, jckpt, runs, "jax",
                       "test"))
    j_out = capsys.readouterr().out
    got = train.main(_argv(case, cfg, model, graph, extra, ckpt, runs,
                           "port", "test") + ["--device", "cpu"])
    t_out = capsys.readouterr().out

    assert _printed_keys(t_out) == _printed_keys(j_out) == list(got)
    want = store["test"]
    assert list(got) == list(want)
    for k in got:
        if k.startswith("test_rmse") or k.startswith("test_mae"):
            _close(got[k], want[k], 5e-4 * std)
        else:
            _close_rel(got[k], want[k])

    jdir, tdir = runs / "jax", runs / "port"
    files = sorted(p.name for p in tdir.iterdir())
    assert files == sorted(p.name for p in jdir.iterdir())
    assert {"test_rmse.csv", "test_mae.csv", "test_rmse.pdf",
            "test_mae.pdf", "mean_spatial_loss.npy", "spatial_loss_t1.npy",
            "spatial_loss_t1.pdf", "example_pred_1.npy",
            "example_target_1.npy"} <= set(files)
    assert len([f for f in files if f.endswith(".png")]) == \
        ar * ds.get_num_data_vars("state")
    for name in ("test_rmse.csv", "test_mae.csv"):
        _close(np.loadtxt(tdir / name, delimiter=",", ndmin=2),
               np.loadtxt(jdir / name, delimiter=",", ndmin=2), 5e-4 * std)
    for name in files:
        if name.endswith(".npy"):
            _close_rel(np.load(tdir / name), np.load(jdir / name))

    t_log, j_log = _metrics_log(tdir), _metrics_log(jdir)
    assert [sorted(r) for r in t_log] == [sorted(r) for r in j_log]
    watch = [r for r in t_log if any(k.startswith("test_rmse_") for k in r)]
    assert watch and sorted(watch[0]) == sorted(
        f"test_rmse_{ds.get_vars_names('state')[v]}_step_{s}"
        for v, s in ((0, 1), (0, 2), (2, 1)) if s <= ar)
    for tr, jr in zip(t_log, j_log):
        for k in tr:
            if k.startswith("test_rmse_"):
                v = ds.get_vars_names("state").index(
                    k[len("test_rmse_"):].rsplit("_step_", 1)[0])
                _close(tr[k], jr[k], 5e-4 * std[v])
            else:
                _close_rel(tr[k], jr[k])


@pytest.mark.filterwarnings("ignore:only using first ensemble member")
@pytest.mark.filterwarnings("ignore:Could not load diff mean/std")
@pytest.mark.parametrize("converted", ["mdp", "meps", "hilam", "output_std"],
                         indirect=True)
def test_eval_val_matches_jax(converted, tmp_path, monkeypatch, capsys):
    case, cfg, model, graph, extra, jckpt, ckpt = converted
    ar, batch = SIZES[case]
    _, ds = load_config_and_datastore(cfg)
    n = len(WeatherDataset(ds, split="val", ar_steps=ar))
    assert n % batch, (n, batch)
    std = ds.get_standardization_dataarray("state")["state_std"]
    runs = tmp_path / "runs"

    store = {}
    _recorder(monkeypatch, "validate", store)
    capsys.readouterr()
    j_train.main(_argv(case, cfg, model, graph, extra, jckpt, runs, "jax",
                       "val"))
    j_out = capsys.readouterr().out
    got = train.main(_argv(case, cfg, model, graph, extra, ckpt, runs,
                           "port", "val") + ["--device", "cpu"])
    t_out = capsys.readouterr().out

    want = store["validate"]
    assert _printed_keys(t_out) == _printed_keys(j_out) == list(got) == \
        list(want)
    _close_rel(got["val_mean_loss"], want["val_mean_loss"])
    _close_rel(got["time_step_loss"], want["time_step_loss"])
    _close(got["mae"], want["mae"], 5e-4)
    _close(np.sqrt(got["mse"]), np.sqrt(want["mse"]), 5e-4)
    assert std.shape == got["mae"].shape[1:]


def test_ensemble_members_raise(tmp_path, monkeypatch):
    cfg, model, graph, _, extra = _setup("output_std", tmp_path / "ds",
                                         monkeypatch)
    with pytest.raises(NotImplementedError, match="queue 1, item 5"):
        train.main(["--config_path", str(cfg), "--device", "cpu",
                    "--graph", graph, "--output_std", "--eval", "test",
                    "--ensemble_members", "2"])


def test_eval_test_without_matplotlib(tmp_path, monkeypatch, capsys):
    cfg, model, graph, _, _ = _setup("mdp", tmp_path / "ds", monkeypatch)
    argv = ["--config_path", str(cfg), "--model", model, "--graph", graph,
            "--hidden_dim", str(H), "--processor_layers", "1",
            "--batch_size", "3", "--ar_steps_eval", "1",
            "--val_steps_to_log", "1", "--eval", "test",
            "--save_dir", str(tmp_path / "runs"), "--device", "cpu"]
    drawn = train.main(argv + ["--run_name", "drawn"])
    # hide matplotlib, and `vis` so that drawing would have to import it
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.delitem(sys.modules, "neural_lam_tpu_torch.vis",
                        raising=False)
    monkeypatch.delattr(neural_lam_tpu_torch, "vis", raising=False)
    capsys.readouterr()
    bare = train.main(argv + ["--run_name", "bare"])
    assert "matplotlib is not installed, no figures are drawn" in \
        capsys.readouterr().out
    assert bare == drawn
    files = sorted(p.name for p in (tmp_path / "runs" / "bare").iterdir())
    assert files == ["mean_spatial_loss.npy", "metrics.jsonl",
                     "spatial_loss_t1.npy", "test_mae.csv", "test_rmse.csv"]
    for name in files:
        if name.endswith(".csv") or name.endswith(".npy"):
            assert (tmp_path / "runs" / "bare" / name).read_bytes() == \
                (tmp_path / "runs" / "drawn" / name).read_bytes()
