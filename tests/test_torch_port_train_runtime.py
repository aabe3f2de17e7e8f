"""The rest of the port's training runtime against the JAX package's, on
the CPU.

* `--remat` (`ModelArgs.remat`): `training_loss` gradients with gradient
  checkpointing of the unroll are bit-equal to the port's without it, and
  within 5e-4 x max abs per parameter of `jax.value_and_grad` of the JAX
  model with `remat=True` (jitted; Pallas off: its XLA CPU route): GraphLAM at
  ar_steps 3 on the port's flat and batched routes, HiLAM on two levels
  at ar_steps 2.
* `--output_std --loss nll`: the training gradients within 5e-4 x max
  abs of JAX's.
* W&B: a stub `wandb` module receives the same calls, in the same order,
  from the port's `MetricsLogger` and from the JAX package's.
* Preemption: SIGTERM during `train.main` (a subprocess) saves `last`
  with "preempted": true, and `--load auto --restore_opt` resumes from
  its step; `--load auto` without a checkpoint starts afresh.
* `--profile_steps 2` writes a torch.profiler trace;
  `TrainFlags.ckpt_every_steps` saves `last` on its steps.
* `checkpoint.save_checkpoint`: a crash at any of its steps leaves a
  loadable checkpoint whose metadata is its own, and the next save
  finishes cleanly.
"""

import dataclasses
import json
import os
import shutil
import signal
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from neural_lam_tpu import train as jtrain
from neural_lam_tpu.config import (
    DatastoreSelection as JDatastoreSelection,
    NeuralLAMConfig as JNeuralLAMConfig,
)
from neural_lam_tpu.datastore.dummy import DummyDatastore as JDummyDatastore
from neural_lam_tpu.graph.build import create_graph as j_create_graph
from neural_lam_tpu.graph.storage import graph_from_bundle as j_graph_from_bundle
from neural_lam_tpu.models import MODELS as J_MODELS
from neural_lam_tpu.models.ar_model import ModelArgs as JModelArgs
from neural_lam_tpu_torch import checkpoint, train
from neural_lam_tpu_torch.config import DatastoreSelection, NeuralLAMConfig
from neural_lam_tpu_torch.convert import params_from_jax
from neural_lam_tpu_torch.dataset import WeatherDataModule, WeatherDataset
from neural_lam_tpu_torch.datastore.dummy import DummyDatastore
from neural_lam_tpu_torch.entry import build_model, train_steps
from neural_lam_tpu_torch.graph.build import create_graph
from neural_lam_tpu_torch.graph.storage import graph_from_bundle
from neural_lam_tpu_torch.models import MODELS
from neural_lam_tpu_torch.models.ar_model import ModelArgs
from neural_lam_tpu_torch.ops import message_passing as tmp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REL = 5e-4


def _models(tmp_path_factory, kind, nx, **args):
    """(jax_model, jax_params, port_model, port datastore) of `kind` on an
    nx x nx DummyDatastore, hidden 64, one processor layer, the same
    weights, with ModelArgs `args` on both sides."""
    jds = JDummyDatastore(grid_shape=(nx, nx), n_timesteps=20)
    tds = DummyDatastore(grid_shape=(nx, nx), n_timesteps=20)
    hier = kind == "hi_lam"
    jbundle = j_create_graph(str(tmp_path_factory.mktemp("jg")),
                             jds.get_xy("state", stacked=False),
                             n_max_levels=None, hierarchical=hier)
    tbundle = create_graph(str(tmp_path_factory.mktemp("tg")),
                           tds.get_xy("state", stacked=False),
                           n_max_levels=None, hierarchical=hier)
    jmodel = J_MODELS[kind](
        JModelArgs(hidden_dim=64, processor_layers=1, **args),
        JNeuralLAMConfig(datastore=JDatastoreSelection("dummydata", "")),
        jds, j_graph_from_bundle(jbundle))
    params = jmodel.init_params(jax.random.PRNGKey(0))
    tmodel = MODELS[kind](
        ModelArgs(hidden_dim=64, processor_layers=1, **args),
        NeuralLAMConfig(datastore=DatastoreSelection("dummydata", "")),
        tds, graph_from_bundle(tbundle, device="cpu"), device="cpu")
    tmodel.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    return jmodel, params, tmodel, tds


def _batch(tds, ar_steps, size=2):
    ds = WeatherDataset(tds, split="train", ar_steps=ar_steps)
    return tuple(np.stack(p) for p in zip(*(ds[i] for i in range(size))))


def _port_grads(tmodel, batch, remat):
    tmodel.args = dataclasses.replace(tmodel.args, remat=remat)
    tmodel.zero_grad(set_to_none=True)
    loss = tmodel.training_loss(tuple(torch.as_tensor(b) for b in batch))
    loss.backward()
    return float(loss.detach()), {k: p.grad.clone()
                                  for k, p in tmodel.named_parameters()}


_JAX_GRADS = {}


def _check_against_jax(jmodel, params, loss_t, grads_t, batch):
    key = (id(jmodel), tuple(b.tobytes() for b in batch))
    if key not in _JAX_GRADS:  # the two routes share the JAX side
        _JAX_GRADS[key] = jax.jit(jax.value_and_grad(jmodel.training_loss))(
            params, tuple(jnp.asarray(b) for b in batch))
    loss_j, g_j = _JAX_GRADS[key]
    np.testing.assert_allclose(loss_t, float(loss_j), rtol=1e-5)
    want = params_from_jax(jax.tree.map(np.asarray, g_j))
    assert set(want) == set(grads_t)
    for k, w in want.items():
        err = float((grads_t[k] - w).abs().max())
        assert err <= REL * float(w.abs().max()) + 1e-7, (k, err)


@pytest.fixture(scope="module")
def remat_graph_lam(tmp_path_factory):
    return _models(tmp_path_factory, "graph_lam", 12, remat=True)


@pytest.mark.parametrize("route", ["flat", "batched"])
def test_remat_grads_match_jax_graph_lam(remat_graph_lam, route,
                                         monkeypatch):
    """GraphLAM, ar_steps 3: remat gradients bit-equal to the port's
    without remat, and within 5e-4 x max of JAX's with remat."""
    jmodel, params, tmodel, tds = remat_graph_lam
    if route == "flat":
        monkeypatch.setattr(tmp, "_FLAT_MIN_VIRT", 1)
    assert tmp.flat_eligible(tmodel.m2m, 2, 64) == (route == "flat")
    batch = _batch(tds, 3)
    loss0, g0 = _port_grads(tmodel, batch, remat=False)
    loss1, g1 = _port_grads(tmodel, batch, remat=True)
    assert loss0 == loss1
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k
    _check_against_jax(jmodel, params, loss1, g1, batch)


def test_remat_grads_match_jax_hi_lam(tmp_path_factory):
    """HiLAM on two levels (30x30, batch 2), ar_steps 2, its dispatch as
    it is: the same checks."""
    jmodel, params, tmodel, tds = _models(tmp_path_factory, "hi_lam", 30,
                                          remat=True)
    assert len(tmodel.graph.level_sizes) == 2
    batch = _batch(tds, 2)
    loss0, g0 = _port_grads(tmodel, batch, remat=False)
    loss1, g1 = _port_grads(tmodel, batch, remat=True)
    assert loss0 == loss1
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k
    _check_against_jax(jmodel, params, loss1, g1, batch)


def test_output_std_nll_training_grads_match_jax(tmp_path_factory):
    """`--output_std --loss nll`: the training_loss gradients of GraphLAM
    (12x12, batch 2, one step) within 5e-4 x max of JAX's."""
    jmodel, params, tmodel, tds = _models(
        tmp_path_factory, "graph_lam", 12, output_std=True, loss="nll")
    batch = _batch(tds, 1)
    loss, grads = _port_grads(tmodel, batch, remat=False)
    _check_against_jax(jmodel, params, loss, grads, batch)


class _StubWandb(types.ModuleType):
    """Records every call a MetricsLogger makes."""

    def __init__(self):
        super().__init__("wandb")
        self.calls = []

    def init(self, **kw):
        self.calls.append(("init", kw))

    def define_metric(self, name, **kw):
        self.calls.append(("define_metric", name, kw))

    def log(self, data, step=None):
        self.calls.append(("log", data, step))

    def Image(self, fig):  # noqa: N802 (wandb's name)
        return ("Image", fig)


def test_wandb_calls_match_jax(tmp_path, monkeypatch):
    fig = object()
    seen = []
    for logger_cls in (jtrain.MetricsLogger, train.MetricsLogger):
        stub = _StubWandb()
        monkeypatch.setitem(sys.modules, "wandb", stub)
        logger = logger_cls(tmp_path, run_name="r", config={"model.a": 1},
                            val_steps=(1, 3), project="p")
        logger.log({"epoch": 0, "train_loss": np.float32(0.5),
                    "per_var": np.ones(3)}, step=7)
        logger.log({"val_mean_loss": 0.25})
        logger.log_image("test_rmse", fig)
        seen.append(stub.calls)
    assert seen[0] == seen[1]
    assert [c[0] for c in seen[1]] == ["init"] + ["define_metric"] * 3 + [
        "log"] * 3
    assert seen[1][0][1]["dir"] == str(tmp_path)


def test_logger_without_wandb_says_so(tmp_path, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "wandb", None)  # import fails
    logger = train.MetricsLogger(tmp_path)
    logger.log({"a": 1.0}, step=1)
    logger.log_image("x", object())
    out = capsys.readouterr().out
    assert out.count("wandb is not installed") == 1
    assert json.loads((tmp_path / "metrics.jsonl").read_text())["a"] == 1.0


def _cli_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    return env


@pytest.fixture
def dummy_config(tmp_path):
    """A 10x10 dummy datastore config with a persistent root (graph and
    checkpoints shared across processes); returns its directory."""
    (tmp_path / "dummy.yaml").write_text(
        "n_points_1d: 10\nn_timesteps: 30\nroot: dsroot\n")
    (tmp_path / "config.yaml").write_text(
        "datastore:\n  kind: dummydata\n  config_path: dummy.yaml\n")
    return tmp_path


CLI = ["--config_path", "config.yaml", "--device", "cpu", "--hidden_dim",
       "4", "--processor_layers", "1", "--batch_size", "2",
       "--ar_steps_eval", "2", "--val_steps_to_log", "1", "--save_dir",
       "models"]


def test_sigterm_saves_last_and_load_auto_resumes(dummy_config):
    """SIGTERM after the first logged epoch: the step finishes, `last` is
    saved with "preempted": true, exit code 0; a relaunch with `--load
    auto --restore_opt` and the same run name restores that step and
    trains on from it."""
    cwd, env = dummy_config, _cli_env()
    proc = subprocess.Popen(
        [sys.executable, "-m", "neural_lam_tpu_torch.train", *CLI,
         "--epochs", "10000", "--val_interval", "1000000",
         "--run_name", "pre"],
        cwd=cwd, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        metrics = cwd / "models" / "pre" / "metrics.jsonl"
        deadline = time.time() + 240
        while not (metrics.exists() and "train_loss" in metrics.read_text()):
            if proc.poll() is not None:
                raise AssertionError(f"train exited early:\n"
                                     f"{proc.communicate()[0]}")
            if time.time() > deadline:
                raise AssertionError("no epoch logged before the deadline")
            time.sleep(0.2)
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, out
    assert "Preemption signal received" in out
    meta = json.loads((cwd / "models" / "pre" / "last.meta.json")
                      .read_text())
    assert meta["preempted"] is True and meta["step"] > 0

    res = subprocess.run(
        [sys.executable, "-m", "neural_lam_tpu_torch.train", *CLI,
         "--epochs", "1", "--load", "auto", "--restore_opt",
         "--run_name", "pre"],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stdout + res.stderr
    assert f"(step {meta['step']})" in res.stdout
    meta2 = json.loads((cwd / "models" / "pre" / "last.meta.json")
                       .read_text())
    assert meta2["step"] > meta["step"] and "preempted" not in meta2


def test_load_auto_without_checkpoint_and_profile_steps(dummy_config,
                                                        monkeypatch, capsys):
    """In process: `--load auto` with no `last` starts afresh (step 0);
    `--profile_steps 2` writes a trace of steps 3-4 and prints the top
    ops."""
    monkeypatch.chdir(dummy_config)
    train.main(CLI + ["--epochs", "1", "--max_steps", "5", "--load", "auto",
                      "--profile_steps", "2", "--run_name", "prof",
                      "--num_workers", "2"])
    out = capsys.readouterr().out
    assert "--load auto: no checkpoint at" in out
    assert "top CPU ops:" in out
    traces = list((dummy_config / "models" / "prof" / "profile")
                  .glob("*.json"))
    assert len(traces) == 1 and traces[0].stat().st_size > 0
    assert json.loads(traces[0].read_text())["traceEvents"]


def test_ckpt_every_steps_saves_last(tmp_path):
    """`TrainFlags.ckpt_every_steps`: `last` is saved at every multiple of
    it (here step 2 of 3, with validation off)."""
    model, ds = build_model(nx=9, ny=9, hidden_dim=8, processor_layers=1,
                            n_timesteps=30, device="cpu")
    dm = WeatherDataModule(ds, ar_steps_train=1, ar_steps_eval=1,
                           batch_size=2)
    trainer = train.Trainer(model, train.TrainFlags(
        max_steps=3, ckpt_every_steps=2, val_interval=0,
        prefetch_batches=0), run_dir=tmp_path)
    assert len(trainer.fit(dm)) == 3
    meta = json.loads((tmp_path / "last.meta.json").read_text())
    assert meta == {"step": 2, "epoch": 0, "best_val_loss": float("inf")}


def _states(seed):
    g = torch.Generator().manual_seed(seed)
    return ({"w": torch.randn(3, 4, generator=g)},
            {"state": {0: {"exp_avg": torch.randn(3, 4, generator=g)}}},
            {"step": seed})


def _assert_loads_a_whole_checkpoint(path, allowed):
    """`path` loads, and its state and metadata are one of `allowed`."""
    model, opt, meta = checkpoint.load_checkpoint(path)
    for want in allowed:
        if meta == want[2]:
            assert torch.equal(model["w"], want[0]["w"])
            assert torch.equal(opt["state"][0]["exp_avg"],
                               want[1]["state"][0]["exp_avg"])
            return meta
    raise AssertionError(f"metadata {meta} is neither checkpoint's")


def test_checkpoint_survives_a_crash_at_every_step(tmp_path, monkeypatch):
    """A crash (an exception from os.replace, Path.rename or
    shutil.rmtree) at each of their calls in save_checkpoint, for a first
    save and for one replacing an earlier checkpoint: the earlier or the
    new checkpoint loads with its own metadata (the earlier one whenever
    the crash came before the commit), and the next save repairs what was
    left and succeeds."""
    real = {"replace": os.replace, "rename": Path.rename,
            "rmtree": shutil.rmtree}
    n_calls = [0]
    crash_at = [None]

    def hook(name):
        def call(*args, **kwargs):
            n_calls[0] += 1
            if n_calls[0] == crash_at[0]:
                raise OSError(f"killed in {name}")
            return real[name](*args, **kwargs)
        return call

    monkeypatch.setattr(os, "replace", hook("replace"))
    monkeypatch.setattr(Path, "rename", hook("rename"))
    monkeypatch.setattr(shutil, "rmtree", hook("rmtree"))
    old, new = _states(1), _states(2)
    outcomes = set()
    for first_save in (True, False):
        k = 1
        while True:
            d = tmp_path / f"{first_save}_{k}"
            if not first_save:
                crash_at[0] = None
                checkpoint.save_checkpoint(d, "last", *old)
            n_calls[0], crash_at[0] = 0, k
            try:
                checkpoint.save_checkpoint(d, "last", *new)
                crashed = False
            except OSError:
                crashed = True
            crash_at[0] = None
            if crashed and first_save and not (d / "last").exists():
                outcomes.add("nothing yet")
            else:
                meta = _assert_loads_a_whole_checkpoint(
                    d / "last", [new] if first_save else [old, new])
                outcomes.add(f"step {meta['step']}")
            checkpoint.save_checkpoint(d, "last", *_states(3))
            _assert_loads_a_whole_checkpoint(d / "last", [_states(3)])
            assert sorted(p.name for p in d.iterdir()) == [
                "last", "last.meta.json"]
            if not crashed:
                break
            k += 1
        assert k >= 4  # every step was a crash point once
    assert outcomes == {"nothing yet", "step 1", "step 2"}


def test_load_auto_resumes_a_save_killed_at_any_step(tmp_path, monkeypatch):
    """`--load auto` (`Trainer.init_state`) after a save that replaced
    `last` was killed at each of its steps: it restores the earlier save
    (step 5) or the new one (step 7), never starts fresh, and the kill
    between moving the earlier save aside and renaming the new one in
    restores step 5."""
    model, _ = build_model(nx=9, ny=9, hidden_dim=8, processor_layers=1,
                           n_timesteps=10, device="cpu")
    states = {}
    for step in (5, 7):
        with torch.no_grad():
            for p in model.parameters():
                p.add_(1.0)
        states[step] = {k: v.clone() for k, v in model.state_dict().items()}
    real_rename = Path.rename
    killed = [None, 0]

    def rename(self, target):
        killed[1] += 1
        if killed[1] == killed[0]:
            raise OSError("killed")
        return real_rename(self, target)

    restored = []
    for k in (1, 2, 3):  # the aside move, the rename in, then no kill
        run = tmp_path / str(k)
        checkpoint.save_checkpoint(run, "last", states[5], None, {"step": 5})
        monkeypatch.setattr(Path, "rename", rename)
        killed[:] = [k, 0]
        try:
            checkpoint.save_checkpoint(run, "last", states[7], None,
                                       {"step": 7})
        except OSError:
            pass
        monkeypatch.setattr(Path, "rename", real_rename)
        trainer = train.Trainer(model, train.TrainFlags(load="auto"),
                                run_dir=run)
        trainer.init_state()
        restored.append(trainer.global_step)
        for name, v in model.state_dict().items():
            assert torch.equal(v, states[trainer.global_step][name])
    assert restored == [5, 5, 7]


def test_train_steps_remat_is_local_to_the_call():
    """`entry.train_steps(remat=True)` gives the losses of the same steps
    without remat and leaves `ModelArgs.remat` as it found it."""
    model, ds = build_model(nx=9, ny=9, hidden_dim=8, processor_layers=1,
                            n_timesteps=30, device="cpu")
    state0 = {k: v.clone() for k, v in model.state_dict().items()}
    losses = {}
    for remat in (False, True):
        model.load_state_dict(state0)
        losses[remat] = train_steps(model, ds, batch_size=2, ar_steps=2,
                                    steps=2, device="cpu", remat=remat)
        assert model.args.remat is False
    assert losses[True] == losses[False]
