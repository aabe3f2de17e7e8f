"""The port's train CLI on several processes against one process, on the
CPU with gloo: the JAX package's tests/test_multihost.py cases, and more.

Each process runs `train.main` on one torch thread, started with
`--num_nodes`, `--node_rank` and `--coordinator_address` at a free port
and waited on with its own timeout. A dummydata datastore of 10x10 grid
points (80 time steps: 44 training samples, 11 validation and 11 test
samples; 40 time steps for the zero-batch case), GraphLAM at hidden 8,
one processor layer, one epoch. The shuffled batch order is seeded and
the shards are strided, so global step k reads the same samples on one
process at batch 8 and on two at batch 4 each. Held (rtol 5e-5, the JAX
test's):

* training, 2 processes x batch 4 against 1 x batch 8: the train loss,
  val_mean_loss and val_loss_unroll1; each rank's gradients of the first
  step, summed and averaged over the ranks, against the single process's
  (within 1e-4 x max abs per parameter: AdamW would hide a gradient
  scaled by a constant from the parameters); the parameters saved after
  the epoch (within 2e-3 relative, the optimizer-trajectory limit); rank 0
  alone wrote `last` and `min_val_loss`; a second launch with `--load
  auto --restore_opt` resumes from rank 0's save on every rank;
* GraphEFM the same way: its noise rows are the global batch's;
* `--eval val` from a checkpoint when one data group's shard of the
  split yields no batch: the merged loss equals one process's;
* `--eval test`: the error maps, the spatial loss maps and the per-lead
  losses of 2 processes equal 1 process's;
* 4 processes as 2 data x 2 space groups (`--spatial_shards 2`, the grid
  scheme): the train and val losses and the first step's gradients of 1
  process at batch 8;
* 2 space ranks under `--spatial_scheme mesh_rs` and `mesh_halo` (the
  JAX package's test_two_process_spatial_halo_matches_single) at batch
  8: the train and val losses and the first step's gradients of 1
  process at batch 8;
* a rank that fails makes every rank fail, with a nonzero exit.
"""

import json
import os
import re
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
CHILD_TIMEOUT_S = 120
# train.main on one torch thread; with --record_grads PREFIX each rank
# writes the gradients of its first step (after their reduction over the
# ranks) to PREFIX{rank}.npz
LAUNCH = """
import sys, numpy as np, torch
torch.set_num_threads(1)
from neural_lam_tpu_torch import train
argv = sys.argv[1:]
if "--record_grads" in argv:
    i = argv.index("--record_grads")
    prefix = argv.pop(i + 1)
    argv.pop(i)
    real_step = train.Trainer.train_step
    def train_step(self, batch):
        loss = real_step(self, batch)
        if self.global_step == 1:
            np.savez(f"{prefix}{self.rank}.npz", **{
                k: p.grad.numpy() for k, p in self.model.named_parameters()
                if p.grad is not None})
        return loss
    train.Trainer.train_step = train_step
train.main(argv)
"""


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def write_config(root: Path, n_timesteps: int) -> Path:
    root.mkdir(parents=True, exist_ok=True)
    (root / "dummy.yaml").write_text(
        f"n_points_1d: 10\nn_timesteps: {n_timesteps}\nroot: dsroot\n")
    cfg = root / "config.yaml"
    cfg.write_text("datastore:\n  kind: dummydata\n"
                   "  config_path: dummy.yaml\n")
    return cfg


def args_of(cfg, save_dir, run_name, batch_size, model="graph_lam"):
    return ["--config_path", str(cfg), "--device", "cpu", "--model", model,
            "--hidden_dim", "8", "--processor_layers", "1", "--latent_dim",
            "4", "--epochs", "1", "--batch_size", str(batch_size),
            "--ar_steps_eval", "2", "--val_steps_to_log", "1", "--seed",
            "42", "--num_workers", "0", "--save_dir", str(save_dir),
            "--run_name", run_name]


def launch(argv_per_rank, cwd):
    """Run one process per argv, each with its own timeout; fail with the
    output of any that fails. Returns the outputs."""
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT)] + [p for p in [os.environ.get("PYTHONPATH")]
                                  if p]))
    procs = [subprocess.Popen([sys.executable, "-c", LAUNCH, *argv],
                              cwd=cwd, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for argv in argv_per_rank]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=CHILD_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            out, _ = p.communicate()
            pytest.fail(f"a process timed out:\n{out[-3000:]}")
        outs.append(out)
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"a process failed:\n{out[-3000:]}"
    return outs


def launch_world(argv, n, cwd, extra=()):
    port = free_port()
    return launch([argv + list(extra) + [
        "--num_nodes", str(n), "--node_rank", str(r),
        "--coordinator_address", f"127.0.0.1:{port}"] for r in range(n)],
        cwd)


def read_metrics(run_dir: Path):
    out = {}
    for line in open(run_dir / "metrics.jsonl"):
        out.update(json.loads(line))
    return out


def params_gap(a: Path, b: Path):
    sa = torch.load(a / "state.pt", map_location="cpu",
                    weights_only=False)["model"]
    sb = torch.load(b / "state.pt", map_location="cpu",
                    weights_only=False)["model"]
    assert sa.keys() == sb.keys()
    return max(float((sa[k] - sb[k]).abs().max())
               / max(float(sa[k].abs().max()), 1e-30) for k in sa)


def assert_grads_match(single: Path, ranks: list):
    """Each rank's first-step gradients (.npz) equal the single
    process's, within 1e-4 x max abs per parameter."""
    want = np.load(single)
    for path in ranks:
        got = np.load(path)
        assert set(got.files) == set(want.files), path
        for k in want.files:
            scale = max(float(np.abs(want[k]).max()), 1e-30)
            gap = float(np.abs(got[k] - want[k]).max())
            assert gap <= 1e-4 * scale, (path.name, k, gap, scale)


@pytest.fixture(scope="module")
def single(tmp_path_factory):
    """One process at batch 8 (GraphLAM and GraphEFM): (root, config)."""
    root = tmp_path_factory.mktemp("single")
    cfg = write_config(root, 80)
    launch([args_of(cfg, root / "m1", "single", 8)
            + ["--record_grads", str(root / "g1_")],
            args_of(cfg, root / "m1", "efm", 8, model="graph_efm")], root)
    return root, cfg


def test_two_process_train_matches_single(single):
    root, cfg = single
    outs = launch_world(args_of(cfg, root / "m2", "multi", 4), 2, root,
                        ["--record_grads", str(root / "g2_")])
    assert any("process 0/2" in o for o in outs)
    assert_grads_match(root / "g1_0.npz",
                       [root / f"g2_{r}.npz" for r in range(2)])
    m1 = read_metrics(root / "m1" / "single")
    m2 = read_metrics(root / "m2" / "multi")
    for key in ("train_loss", "val_mean_loss", "val_loss_unroll1"):
        np.testing.assert_allclose(m2[key], m1[key], rtol=5e-5, err_msg=key)
    assert params_gap(root / "m1" / "single" / "last",
                      root / "m2" / "multi" / "last") <= 2e-3
    assert (root / "m2" / "multi" / "min_val_loss").exists()
    # a second launch resumes from rank 0's save on every rank, and runs
    # its epoch from step 5 on
    outs = launch_world(args_of(cfg, root / "m2", "multi", 4), 2, root,
                        ["--load", "auto", "--restore_opt"])
    assert all("Restored checkpoint" in o and "(step 5)" in o for o in outs)
    assert read_metrics(root / "m2" / "multi")["step"] == 10


def test_two_process_latent_train_matches_single(single):
    root, cfg = single
    launch_world(args_of(cfg, root / "m2", "efm", 4, model="graph_efm"), 2,
                 root)
    m1 = read_metrics(root / "m1" / "efm")
    m2 = read_metrics(root / "m2" / "efm")
    for key in ("train_loss", "val_mean_loss"):
        np.testing.assert_allclose(m2[key], m1[key], rtol=5e-5, err_msg=key)


def test_zero_eval_batch_rank_does_not_deadlock(tmp_path):
    """40 time steps: 5 validation samples, one full batch of 4 (shard 0,
    with the partial one) and none for shard 1, which evaluates a zero
    batch and adds zero sums to the merge."""
    cfg = write_config(tmp_path, 40)
    launch([args_of(cfg, tmp_path / "m1", "single", 4)], tmp_path)
    m1 = read_metrics(tmp_path / "m1" / "single")
    outs = launch_world(args_of(cfg, tmp_path / "m2", "multi", 4), 2,
                        tmp_path, ["--eval", "val", "--load",
                                   str(tmp_path / "m1" / "single" / "last")])
    for out in outs:
        m = re.search(r"'val_mean_loss': ([0-9.eE+-]+)", out)
        assert m, out[-2000:]
        np.testing.assert_allclose(float(m.group(1)), m1["val_mean_loss"],
                                   rtol=5e-5)


def test_two_process_test_epoch_matches_single(single):
    root, cfg = single
    ckpt = str(root / "m1" / "single" / "last")
    extra = ["--eval", "test", "--load", ckpt, "--val_steps_to_log", "1",
             "2", "--n_example_pred", "0"]
    launch([args_of(cfg, root / "e1", "e1", 4) + extra], root)
    launch_world(args_of(cfg, root / "e2", "e2", 4), 2, root, extra)
    d1, d2 = root / "e1" / "e1", root / "e2" / "e2"
    for name in ("test_rmse.csv", "test_mae.csv"):
        np.testing.assert_allclose(np.loadtxt(d2 / name, delimiter=","),
                                   np.loadtxt(d1 / name, delimiter=","),
                                   rtol=5e-5)
    for name in ("mean_spatial_loss.npy", "spatial_loss_t1.npy",
                 "spatial_loss_t2.npy"):
        np.testing.assert_allclose(np.load(d2 / name), np.load(d1 / name),
                                   rtol=5e-5)
    m1, m2 = read_metrics(d1), read_metrics(d2)
    for key in ("test_mean_loss", "test_loss_unroll1", "test_loss_unroll2"):
        np.testing.assert_allclose(m2[key], m1[key], rtol=5e-5)


def test_four_processes_data_and_space(single):
    """2 data x 2 space ranks (the grid scheme within each data group) at
    batch 4 a data group, against one process at batch 8."""
    root, cfg = single
    outs = launch_world(args_of(cfg, root / "m4", "sp", 4), 4, root,
                        ["--spatial_shards", "2", "--record_grads",
                         str(root / "g4_")])
    assert any("2 data x 2 space ranks" in o for o in outs)
    assert_grads_match(root / "g1_0.npz",
                       [root / f"g4_{r}.npz" for r in range(4)])
    m1 = read_metrics(root / "m1" / "single")
    m4 = read_metrics(root / "m4" / "sp")
    for key in ("train_loss", "val_mean_loss", "val_loss_unroll1"):
        np.testing.assert_allclose(m4[key], m1[key], rtol=5e-5, err_msg=key)
    assert params_gap(root / "m1" / "single" / "last",
                      root / "m4" / "sp" / "last") <= 2e-3


@pytest.mark.parametrize("scheme", ["mesh_rs", "mesh_halo"])
def test_two_space_ranks_mesh_node_schemes(scheme, single):
    """1 data x 2 space ranks under a mesh-node-sharded scheme at batch 8,
    against one process at batch 8."""
    root, cfg = single
    outs = launch_world(args_of(cfg, root / scheme, "sp", 8), 2, root,
                        ["--spatial_shards", "2", "--spatial_scheme", scheme,
                         "--record_grads", str(root / f"g_{scheme}_")])
    assert any("1 data x 2 space ranks" in o for o in outs)
    assert_grads_match(root / "g1_0.npz",
                       [root / f"g_{scheme}_{r}.npz" for r in range(2)])
    m1 = read_metrics(root / "m1" / "single")
    ms = read_metrics(root / scheme / "sp")
    for key in ("train_loss", "val_mean_loss", "val_loss_unroll1"):
        np.testing.assert_allclose(ms[key], m1[key], rtol=5e-5, err_msg=key)


def test_a_failed_rank_fails_every_rank(single):
    """Rank 1 fails before training (its config does not exist); rank 0
    fails in its next collective, well inside its own timeout, with a
    nonzero exit: no rank goes on alone."""
    root, cfg = single
    port = free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT)] + [p for p in [os.environ.get("PYTHONPATH")]
                                  if p]))
    procs = []
    for r, c in enumerate((cfg, root / "missing.yaml")):
        procs.append(subprocess.Popen(
            [sys.executable, "-c", LAUNCH,
             *args_of(c, root / "mf", "failed", 4), "--num_nodes", "2",
             "--node_rank", str(r), "--coordinator_address",
             f"127.0.0.1:{port}"], cwd=root, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = [p.communicate(timeout=CHILD_TIMEOUT_S)[0] for p in procs]
    assert [p.returncode != 0 for p in procs] == [True, True], outs
    assert "missing.yaml" in outs[1]
    assert not (root / "mf" / "failed" / "last").exists()
