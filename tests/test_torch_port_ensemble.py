"""The port's ensembles (`ensemble.py`, the predict CLI's and the test
CLI's `--ensemble_members`) against the JAX package's, on the CPU, with
JAX's noise replayed into the port (`latent_helpers`).

* The scores on the same member arrays (m = 1, 2, 5 members, with and
  without a mask): `crps_ensemble` (each reduction), `rank_histogram`,
  `ensemble_mean_spread` (spread ddof 0) and `spread_skill_ratio`, within
  1e-6 of the largest magnitude (fp32 sums in another order), the rank
  counts exactly; and the port's `score_ensemble` against JAX's
  `evaluate_ensemble` on the same members (JAX's `sample_rollout`
  patched to return them), per sample and averaged with its ssr, the
  same limits.
* `sample_rollout` of a GraphLAM with `--output_std` and of a GraphEFM
  (10x10 dummydata, hidden 16, 1 processor layer, latent_dim 8; batch 2,
  3 members, 2 steps, the members folded sample-major): within 5e-4, the
  rollout limit of the model tests.
* `predict.main --ensemble_members 3` of a GraphEFM, from a converted JAX
  checkpoint, against the JAX CLI (`PRNGKey(seed)`): the same dims with
  a leading `member`, the members within 5e-4 x state_std, in zarr and
  npz.
* `train.main --eval test --ensemble_members 3` of the same checkpoint at
  a batch size that leaves a partial last batch (the JAX trainer pads
  it; the port draws the rows of the real samples only): each ensemble
  score within 1e-4 relative, the rank histogram (and
  `ens_rank_hist.npy`) within 1e-6, the same files written.
* A GraphEFM training run resumed from `last` (`--load auto`, with the
  optimizer) gives the uninterrupted run's next loss bit for bit: its
  noise depends on the seed and the step alone.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import convert_jax_checkpoint
from neural_lam_tpu import ensemble as j_ensemble
from neural_lam_tpu import train as j_train
from neural_lam_tpu.checkpoint import save_checkpoint as j_save_checkpoint
from neural_lam_tpu.config import (
    load_config_and_datastore as j_load_config_and_datastore,
)
from neural_lam_tpu.datastore.zarr_reader import ZarrGroup as JZarrGroup
from neural_lam_tpu.models import MODELS as J_MODELS
from neural_lam_tpu.models.ar_model import ModelArgs as JModelArgs
from neural_lam_tpu.predict import main as j_predict_main
from neural_lam_tpu_torch import ensemble, predict, train
from neural_lam_tpu_torch.config import load_config_and_datastore
from neural_lam_tpu_torch.dataset import WeatherDataset
from neural_lam_tpu_torch.datastore.zarr_reader import ZarrGroup
from neural_lam_tpu_torch.graph.storage import load_or_build_graph
from neural_lam_tpu_torch.models import MODELS
from neural_lam_tpu_torch.models.ar_model import ModelArgs

from .latent_helpers import (  # noqa: F401 (one_torch_thread: autouse)
    eval_draws,
    jax_params_from_port,
    one_torch_thread,
    replay,
    run_compiled,
    split_draws,
)
from .test_torch_port_predict import _dummy

H, D_Z, M, T, B = 16, 8, 3, 2, 2
# model -> (port ModelArgs keywords); both on a 10x10 multiscale graph
MODELS_ = {"output_std": dict(output_std=True), "graph_efm": {}}


def _close(got, want, limit, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    assert np.isfinite(got).all(), what
    assert np.abs(got - want).max() <= limit, (what,
                                               np.abs(got - want).max())


@pytest.mark.parametrize("m", [1, 2, 5])
def test_scores_match_jax(m):
    rng = np.random.default_rng(m)
    ens = rng.standard_normal((2, m, 3, 20, 4)).astype(np.float32)
    target = rng.standard_normal((2, 3, 20, 4)).astype(np.float32)
    mask = rng.random(20) > 0.3
    te, tt, tmask = map(torch.as_tensor, (ens, target, mask))
    je, jt, jmask = map(jnp.asarray, (ens, target, mask))
    for kw in (dict(), dict(average_grid=False), dict(sum_vars=False)):
        for mk in (None, True):
            got = ensemble.crps_ensemble(te, tt, mask=tmask if mk else None,
                                         **kw)
            want = j_ensemble.crps_ensemble(je, jt, mask=jmask if mk
                                            else None, **kw)
            _close(got, want, 1e-6 * float(np.abs(want).max()),
                   f"crps {kw} {mk}")
    for mk in (None, True):
        got = ensemble.rank_histogram(te, tt, mask=tmask if mk else None)
        want = j_ensemble.rank_histogram(je, jt, mask=jmask if mk else None)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert float(got.sum()) == 2 * 3 * 4 * (mask.sum() if mk else 20)
    for a, b in zip(ensemble.ensemble_mean_spread(te),
                    j_ensemble.ensemble_mean_spread(je)):
        _close(a, b, 1e-6 * float(np.abs(b).max()) + 1e-7, "mean/spread")
    var, se = rng.random(3) + 0.1, rng.random(3)
    _close(ensemble.spread_skill_ratio(var, se, m),
           j_ensemble.spread_skill_ratio(var, se, m), 1e-12, "ssr")


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """name -> (jax model, jax params, port model, batch, jax members):
    the 10x10 models with the port's weights on both sides, and JAX's
    sample_rollout of a batch of 2 (3 members, 2 steps) from key 4."""
    root = tmp_path_factory.mktemp("ens")
    cfg = _dummy(root, 10)
    jconfig, jds = j_load_config_and_datastore(cfg)
    config, tds = load_config_and_datastore(cfg)
    graph = load_or_build_graph(tds, "multiscale", device="cpu")
    out = {}
    for name, kw in MODELS_.items():
        model = "graph_efm" if name == "graph_efm" else "graph_lam"
        jm = J_MODELS[model](JModelArgs(hidden_dim=H, processor_layers=1,
                                        latent_dim=D_Z, **kw), jconfig, jds)
        tm = MODELS[model](ModelArgs(hidden_dim=H, processor_layers=1,
                                     latent_dim=D_Z, **kw), config, tds,
                           graph, device="cpu",
                           generator=torch.Generator().manual_seed(1))
        params = jax_params_from_port(jm, tm)
        rng = np.random.default_rng(2)
        n, d = tm.num_grid_nodes, tm.num_state_vars
        batch = (rng.standard_normal((B, 2, n, d)).astype(np.float32),
                 rng.standard_normal((B, T, n, d)).astype(np.float32),
                 rng.standard_normal(
                     (B, T, n, tm.num_forcing_vars * 3)).astype(np.float32),
                 np.zeros((B, T), np.int64))
        jb = [jnp.asarray(x) for x in batch]
        members = np.asarray(run_compiled(
            lambda p, i, f, t: j_ensemble.sample_rollout(
                jm, p, i, f, t, jax.random.PRNGKey(4), n_members=M),
            params, jb[0], jb[2], jb[1]))
        out[name] = (jm, params, tm, batch, members)
    return out


def _draw_shape(tm, rows):
    if getattr(tm, "is_latent", False):
        return (rows, tm.latent_num_nodes, D_Z)
    return (rows, tm.num_grid_nodes, tm.num_state_vars)


@pytest.mark.parametrize("name", sorted(MODELS_))
def test_sample_rollout_matches_jax(models, name, monkeypatch):
    _, _, tm, batch, want = models[name]
    left = replay(monkeypatch, split_draws(jax.random.PRNGKey(4), T,
                                           _draw_shape(tm, B * M)))
    init, target, forcing, _ = map(torch.as_tensor, batch)
    with torch.no_grad():
        got = ensemble.sample_rollout(tm, init, forcing, target,
                                      torch.Generator(), n_members=M)
    assert not left and got.shape == (B, M, T) + target.shape[2:]
    _close(got, want, 5e-4, name)
    # the members of a sample differ, and differ from the other sample's
    assert float((got[:, 0] - got[:, 1]).abs().max()) > 1e-3


@pytest.mark.parametrize("name", sorted(MODELS_))
def test_evaluate_ensemble_matches_jax(models, name, monkeypatch):
    """The scores of the same members, per sample and averaged with ssr."""
    jm, params, tm, batch, members = models[name]
    monkeypatch.setattr(j_ensemble, "sample_rollout",
                        lambda *a, **k: jnp.asarray(members))
    jb = tuple(jnp.asarray(x) for x in batch)
    tb = tuple(torch.as_tensor(x) for x in batch)
    for per_sample in (True, False):
        want = j_ensemble.evaluate_ensemble(jm, params, jb, None, M,
                                            per_sample=per_sample)
        got = ensemble.score_ensemble(torch.tensor(members), tb[1],
                                      tm.interior_mask_bool(),
                                      per_sample=per_sample)
        assert sorted(got) == sorted(want)
        for k, w in want.items():
            g = got[k].numpy() if torch.is_tensor(got[k]) else got[k]
            _close(g, w, 1e-6 * max(float(np.abs(w).max()), 1.0), k)
    assert got["rank_hist"].shape == (T, M + 1)


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """(config, JAX checkpoint, converted checkpoint, port model args) of
    a GraphEFM on a 10x10 dummydata with the port's seeded weights."""
    root = tmp_path_factory.mktemp("efm_cli")
    cfg = _dummy(root, 10)
    jconfig, jds = j_load_config_and_datastore(cfg)
    config, tds = load_config_and_datastore(cfg)
    jm = J_MODELS["graph_efm"](JModelArgs(hidden_dim=H, processor_layers=1,
                                          latent_dim=D_Z), jconfig, jds)
    tm = MODELS["graph_efm"](
        ModelArgs(hidden_dim=H, processor_layers=1, latent_dim=D_Z), config,
        tds, load_or_build_graph(tds, "multiscale", device="cpu"),
        device="cpu", generator=torch.Generator().manual_seed(3))
    j_save_checkpoint(root / "jax", "best", jax_params_from_port(jm, tm),
                      meta={"step": 2})
    ckpt = convert_jax_checkpoint.convert(root / "jax" / "best",
                                          root / "port")
    return cfg, root / "jax" / "best", ckpt, tm


def _flags(cfg):
    return ["--config_path", str(cfg), "--model", "graph_efm", "--graph",
            "multiscale", "--hidden_dim", str(H), "--processor_layers", "1",
            "--latent_dim", str(D_Z)]


def test_predict_cli_ensemble_matches_jax(checkpoint, tmp_path, monkeypatch,
                                          capsys):
    cfg, jckpt, ckpt, tm = checkpoint
    _, tds = load_config_and_datastore(cfg)
    std = tds.get_standardization_dataarray("state")["state_std"]
    common = _flags(cfg) + ["--ar_steps", str(T), "--ensemble_members",
                            str(M), "--seed", "5"]
    shape = (M, tm.latent_num_nodes, D_Z)
    for out in ("f.zarr", "f.npz"):
        j_predict_main(common + ["--load", str(jckpt),
                                 "--out", str(tmp_path / f"jax_{out}")])
        replay(monkeypatch, split_draws(jax.random.PRNGKey(5), T, shape))
        got = predict.main(common + ["--load", str(ckpt), "--device", "cpu",
                                     "--out", str(tmp_path / f"port_{out}")])
        assert got["dims"] == ["member", "time", "grid_index",
                               "state_feature"]
        assert got["shape"] == [M, T, tds.num_grid_points,
                                tds.get_num_data_vars("state")]
    assert "3 members" in capsys.readouterr().out
    t, j = ZarrGroup(tmp_path / "port_f.zarr"), JZarrGroup(
        tmp_path / "jax_f.zarr")
    assert t["state"].dims == j["state"].dims
    pred = t["state"].read_full()
    _close(pred / std, j["state"].read_full() / std, 5e-4, "zarr members")
    np.testing.assert_array_equal(t["time"].read_full(),
                                  j["time"].read_full())
    zt, zj = (np.load(tmp_path / f"{w}_f.npz") for w in ("port", "jax"))
    np.testing.assert_array_equal(zt["state"], pred)
    _close(zt["state"] / std, zj["state"] / std, 5e-4, "npz members")
    assert float(np.abs(pred[0] - pred[1]).max()) > 0


def test_eval_test_ensemble_matches_jax(checkpoint, tmp_path, monkeypatch,
                                        capsys):
    cfg, jckpt, ckpt, tm = checkpoint
    _, tds = load_config_and_datastore(cfg)
    n = len(WeatherDataset(tds, split="test", ar_steps=T))
    assert n % B  # a partial last batch
    argv = _flags(cfg) + [
        "--batch_size", str(B), "--ar_steps_eval", str(T),
        "--val_steps_to_log", "1", "2", "--eval", "test",
        "--ensemble_members", str(M), "--n_example_pred", "0",
        "--save_dir", str(tmp_path / "runs")]
    store = {}
    orig = j_train.Trainer.evaluate_ensemble

    def recorded(self, *a, **k):
        store["ens"] = orig(self, *a, **k)
        return store["ens"]

    monkeypatch.setattr(j_train.Trainer, "evaluate_ensemble", recorded)
    j_train.main(argv + ["--load", str(jckpt), "--run_name", "jax"])
    n_batches = -(-n // B)
    left = replay(monkeypatch, eval_draws(
        0, n_batches, T, (B * M, tm.latent_num_nodes, D_Z)))
    got = train.main(argv + ["--load", str(ckpt), "--run_name", "port",
                             "--device", "cpu"])["ensemble"]
    assert not left
    want = store["ens"]
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        if k == "rank_hist":
            _close(got[k], w, 1e-6, k)
        else:
            _close(got[k], w, 1e-4 * np.abs(np.asarray(w)).max(), k)
    runs = tmp_path / "runs"
    assert sorted(p.name for p in (runs / "port").iterdir()) == sorted(
        p.name for p in (runs / "jax").iterdir())
    _close(np.load(runs / "port" / "ens_rank_hist.npy"),
           np.load(runs / "jax" / "ens_rank_hist.npy"), 1e-6, "rank npy")
    logged = [json.loads(line) for line in
              (runs / "port" / "metrics.jsonl").read_text().splitlines()]
    assert any("ens_crps_mean" in r for r in logged)


def test_load_auto_resume_draws_the_uninterrupted_noise(checkpoint,
                                                        tmp_path):
    """Step 1 of a run, and step 1 of a run resumed from the `last` that
    the first saved after step 0 (`--load auto` with the optimizer), give
    the same loss on the same batch, bit for bit; the same batch at step 0
    gives another (the noise follows the step)."""
    from neural_lam_tpu_torch import entry
    from neural_lam_tpu_torch.train import Trainer, TrainFlags

    cfg, _, _, tm = checkpoint
    _, tds = load_config_and_datastore(cfg)
    state = {k: v.clone() for k, v in tm.state_dict().items()}
    trainer, dm = entry.make_trainer(tm, tds, B, 1, seed=0,
                                     run_dir=tmp_path / "run")
    batches = trainer.train_batches(dm, 0)
    b0, b1 = next(batches), next(batches)
    trainer.train_step(b0)
    trainer.save("last", {"step": trainer.global_step})
    uninterrupted = float(trainer.train_step(b1))

    def fresh(load):
        tm.load_state_dict(state)
        return Trainer(tm, TrainFlags(seed=0, load=load, restore_opt=True),
                       run_dir=tmp_path / "run")

    resumed = fresh("auto")
    resumed.init_state()
    assert resumed.global_step == 1
    assert float(resumed.train_step(b1)) == uninterrupted
    assert float(fresh(None).train_step(b1)) != uninterrupted
    tm.load_state_dict(state)
