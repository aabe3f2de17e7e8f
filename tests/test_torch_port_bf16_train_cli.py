"""`train.main --precision bf16` on the MDP fixture, on the CPU: the
trainer CLI's bf16 training is `entry.train_steps`' bf16 training, and its
checkpoint reloads for bf16 evaluation.

The fixture's 12x10 grid lies wholly in MDPDatastore's default 30-point
boundary frame (no interior node: the loss would be NaN), so the frame is
narrowed to 2, as in test_torch_port_bf16_models.py.
"""

import json

import numpy as np
import pytest
import torch
import yaml

from neural_lam_tpu_torch import entry, train
from neural_lam_tpu_torch.checkpoint import load_checkpoint
from neural_lam_tpu_torch.config import load_config_and_datastore
from neural_lam_tpu_torch.datastore.mdp import MDPDatastore
from neural_lam_tpu_torch.graph.storage import load_or_build_graph
from neural_lam_tpu_torch.models import MODELS
from neural_lam_tpu_torch.models.ar_model import ModelArgs

from .mdp_fixture import make_mdp_dataset

H, SEED = 16, 3


@pytest.fixture
def mdp_config(tmp_path, monkeypatch):
    monkeypatch.setattr(MDPDatastore.__init__, "__defaults__", (2,))
    root = tmp_path / "ds"
    root.mkdir()
    ds_cfg = make_mdp_dataset(root)
    cfg = root / "config.yaml"
    cfg.write_text(yaml.safe_dump({"datastore": {
        "kind": "mdp", "config_path": ds_cfg.name}}))
    return cfg


@pytest.mark.parametrize("precision", ["bf16", "bf16-mixed"])
def test_train_cli_bf16_is_train_steps_bf16(mdp_config, tmp_path,
                                            precision):
    """2 bf16 AdamW steps through `train.main --precision bf16` (and
    `bf16-mixed`, the same path) leave the parameters that
    `entry.train_steps` leaves on a bf16 model from the same seed, bit for
    bit, differ from fp32 training's, and the checkpoint scores through
    `--eval test --precision bf16`."""
    common = ["--config_path", str(mdp_config), "--device", "cpu",
              "--graph", "g1level", "--hidden_dim", str(H),
              "--processor_layers", "1", "--batch_size", "2",
              "--ar_steps_eval", "2", "--val_steps_to_log", "1", "2",
              "--seed", str(SEED), "--save_dir", str(tmp_path / "models")]
    for prec in ("32", precision):
        train.main(common + ["--precision", prec, "--max_steps", "2",
                             "--run_name", f"train{prec}"])
    run = tmp_path / "models" / f"train{precision}"
    log = [json.loads(line) for line in
           (run / "metrics.jsonl").read_text().splitlines()]
    assert [r for r in log if np.isfinite(r.get("train_loss", np.nan))]
    state, opt, meta = load_checkpoint(run / "last")
    state32, _, _ = load_checkpoint(tmp_path / "models" / "train32" / "last")
    assert meta["step"] == 2 and opt is not None

    config, ds = load_config_and_datastore(mdp_config)
    model = MODELS["graph_lam"](
        ModelArgs(hidden_dim=H, processor_layers=1,
                  compute_dtype="bfloat16"), config, ds,
        load_or_build_graph(ds, "g1level", torch.device("cpu")),
        device="cpu", generator=torch.Generator().manual_seed(SEED))
    losses = entry.train_steps(model, ds, batch_size=2, ar_steps=1, steps=2,
                               seed=SEED, device="cpu")
    assert all(np.isfinite(losses))
    want = model.state_dict()
    assert set(state) == set(want)
    for k, v in want.items():
        assert v.dtype == torch.float32, k
        assert torch.equal(state[k], v), k
    assert any(not torch.equal(state[k], state32[k]) for k in want)

    res = train.main(common + ["--eval", "test", "--load", str(run / "last"),
                               "--precision", precision, "--run_name",
                               "eval", "--n_example_pred", "0"])
    rmse = np.loadtxt(tmp_path / "models" / "eval" / "test_rmse.csv",
                      delimiter=",", ndmin=2)
    assert np.isfinite(rmse).all() and np.isfinite(res["test_mean_loss"])


def test_train_cli_bf16_resumes_with_restore_opt(mdp_config, tmp_path):
    """`--load ... --restore_opt --precision bf16` resumes a bf16 run: the
    step counter and the AdamW state carry on (one more step taken from
    them), and the parameters move on from the checkpoint's."""
    common = ["--config_path", str(mdp_config), "--device", "cpu",
              "--graph", "g1level", "--hidden_dim", str(H),
              "--processor_layers", "1", "--batch_size", "2",
              "--ar_steps_eval", "2", "--val_steps_to_log", "1", "2",
              "--seed", str(SEED), "--precision", "bf16", "--save_dir",
              str(tmp_path / "models")]
    train.main(common + ["--max_steps", "2", "--run_name", "first"])
    first = tmp_path / "models" / "first" / "last"
    state0, opt0, _ = load_checkpoint(first)
    train.main(common + ["--max_steps", "3", "--load", str(first),
                         "--restore_opt", "--run_name", "resumed"])
    state1, opt1, meta = load_checkpoint(tmp_path / "models" / "resumed"
                                         / "last")
    assert meta["step"] == 3
    steps = {int(s["step"]) for s in opt1["state"].values()}
    assert steps == {3} and {int(s["step"]) for s in
                             opt0["state"].values()} == {2}
    assert all(torch.isfinite(v).all() for v in state1.values())
    assert any(not torch.equal(state0[k], state1[k]) for k in state0)
