"""The port's serving export (`neural_lam_tpu_torch.export`) against its
eager predict step and the JAX package's export.

Each case is the JAX export test's set-up (`tests/test_predict.py`: a
DummyDatastore, a graph under its root, a JAX model's weights saved as an
orbax checkpoint), the checkpoint converted to the port by
`convert_jax_checkpoint.py`. The port's `export.main` writes a `.pt2` and
its sidecar; `load_exported` runs it (also in a fresh process that must
not import the model code). Its output equals the port's eager
`predict_step` (atol 1e-6; it is bit-equal here) and, in fp32, is within
1e-4 of the JAX package's exported artifact and of `jax.jit(predict_step)`
(the models' one-step tolerance); in bf16 it is within 2^-7 of the
output's largest magnitude of JAX's bf16 artifact (the JAX CPU path keeps
some products in fp32 that the port rounds as the accelerator does). The
program names each forward kernel's operator as often as the eager step
calls it. JAX exports every family, so the port exports every family.
"""

import collections
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml
from torch.utils._python_dispatch import TorchDispatchMode

import jax
import jax.numpy as jnp

import convert_jax_checkpoint
from neural_lam_tpu.checkpoint import save_checkpoint
from neural_lam_tpu.config import (
    DatastoreSelection, NeuralLAMConfig, TrainingConfig,
)
from neural_lam_tpu.datastore.dummy import DummyDatastore
from neural_lam_tpu.export import load_exported as j_load_exported
from neural_lam_tpu.export import main as j_export_main
from neural_lam_tpu.graph.build import create_graph
from neural_lam_tpu.models import MODELS
from neural_lam_tpu.models.ar_model import ModelArgs
from neural_lam_tpu_torch import export, predict
from neural_lam_tpu_torch.ops import message_passing as tmp

ROOT = Path(__file__).resolve().parent.parent

# case: (model, hierarchical graph, grid side, batch, flat route, flags)
CASES = {
    "graph_lam-flat": ("graph_lam", False, 10, 16, True, []),
    "graph_lam-flat-bf16": ("graph_lam", False, 10, 16, True,
                            ["--precision", "bf16"]),
    "graph_lam-output_std": ("graph_lam", False, 10, 2, False,
                             ["--output_std"]),
    "hi_lam-batched": ("hi_lam", True, 27, 1, False, []),
    "hi_lam_parallel": ("hi_lam_parallel", True, 27, 2, False, []),
    "graph_efm": ("graph_efm", False, 10, 2, False, ["--latent_dim", "4"]),
    "hi_efm": ("hi_efm", True, 27, 2, False, ["--latent_dim", "4"]),
}

torch.set_num_threads(1)


class OpCounter(TorchDispatchMode):
    """Counts the calls of the kernels' operators (`nlt::*`)."""

    def __init__(self):
        super().__init__()
        self.counts = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.namespace == "nlt":
            self.counts[func._schema.name] += 1
        return func(*args, **(kwargs or {}))


def _setup(tmp_path, name, hier, nx, flags):
    """The JAX export test's set-up for `name` (its `_setup`, with the
    graph and grid of the case): (config path, JAX model, JAX params,
    converted port checkpoint, model flags)."""
    gname = "hier" if hier else "g1"
    root = tmp_path / "ds"
    root.mkdir()
    with open(tmp_path / "dummy.yaml", "w") as f:
        yaml.safe_dump({"n_points_1d": nx, "n_timesteps": 40,
                        "root": str(root)}, f)
    cfg = tmp_path / "config.yaml"
    with open(cfg, "w") as f:
        yaml.safe_dump({"datastore": {
            "kind": "dummydata", "config_path": str(tmp_path / "dummy.yaml")}},
            f)
    ds = DummyDatastore(config_path=tmp_path / "dummy.yaml")
    create_graph(str(ds.root_path / "graph" / gname),
                 ds.get_xy("state", stacked=False),
                 n_max_levels=None if hier else 1, hierarchical=hier)
    config = NeuralLAMConfig(
        datastore=DatastoreSelection(kind="dummydata",
                                     config_path=str(tmp_path / "dummy.yaml")),
        training=TrainingConfig())
    margs = {"output_std": "--output_std" in flags}
    if "--latent_dim" in flags:
        margs["latent_dim"] = 4
    if "bf16" in flags:
        margs["compute_dtype"] = "bfloat16"
    model = MODELS[name](ModelArgs(graph=gname, hidden_dim=8,
                                   processor_layers=1, **margs), config, ds)
    params = model.init_params(jax.random.PRNGKey(0))
    save_checkpoint(tmp_path / "ckpt", "best", params, meta={"step": 7})
    port_ckpt = convert_jax_checkpoint.convert(tmp_path / "ckpt" / "best",
                                               tmp_path / "port")
    model_flags = ["--model", name, "--graph", gname, "--hidden_dim", "8",
                   "--processor_layers", "1", *flags]
    return cfg, model, params, port_ckpt, model_flags


def _inputs(model, B):
    rng = np.random.default_rng(0)
    n, d = model.num_grid_nodes, model.num_state_vars
    d_f = model.grid_dim - 2 * d - model.grid_static_dim
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((B, n, d), (B, n, d), (B, n, d_f)))


def _fresh_process_step(path, inputs, out):
    """Load and run the artifact in a new Python process; returns whether
    that process imported the model code."""
    np.savez(out, *inputs)
    code = (
        "import sys, numpy as np, torch\n"
        "from neural_lam_tpu_torch.export import load_exported\n"
        f"step = load_exported({str(path)!r})\n"
        f"z = np.load({str(out)!r})\n"
        "pred, std = step(*(torch.as_tensor(z[f'arr_{i}']) for i in "
        "range(3)))\n"
        f"np.savez({str(out)!r}, pred=pred.float().numpy(), "
        "std=std.float().numpy())\n"
        "print(any(m.startswith('neural_lam_tpu_torch.models') "
        "for m in sys.modules))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=str(ROOT),
                                  OMP_NUM_THREADS="1"))
    assert res.returncode == 0, res.stderr[-3000:]
    return res.stdout.strip().splitlines()[-1] == "True"


@pytest.mark.parametrize("case", sorted(CASES))
def test_export_matches_eager_and_jax(case, tmp_path, monkeypatch):
    name, hier, nx, B, flat, flags = CASES[case]
    if flat:
        monkeypatch.setattr(tmp, "_FLAT_MIN_VIRT", 1)
    cfg, jmodel, params, port_ckpt, mflags = _setup(tmp_path, name, hier,
                                                    nx, flags)
    out = tmp_path / "model.pt2"
    export.main(["--config_path", str(cfg), *mflags, "--load",
                 str(port_ckpt), "--batch_size", str(B), "--out", str(out),
                 "--device", "cpu"])
    j_out = tmp_path / "model.jaxexp"
    j_export_main(["--config_path", str(cfg), *mflags, "--load",
                   str(tmp_path / "ckpt" / "best"), "--batch_size", str(B),
                   "--out", str(j_out)])
    meta = json.loads(Path(str(out) + ".json").read_text())
    j_meta = json.loads(Path(str(j_out) + ".json").read_text())
    assert meta.keys() == j_meta.keys()
    for k in meta.keys() - {"model", "platforms"}:
        assert meta[k] == j_meta[k], k
    assert meta["platforms"] == ["cpu"]

    inputs = _inputs(jmodel, B)
    step = export.load_exported(out)
    with torch.no_grad():
        pred, std = step(*map(torch.as_tensor, inputs))
    # the eager step of the same checkpoint, its operator calls counted
    args = predict.parse_args(["--config_path", str(cfg), *mflags, "--load",
                               str(port_ckpt), "--out", "x.npz",
                               "--device", "cpu"])
    tmodel, _, _ = predict.prepare(args)
    with torch.no_grad(), OpCounter() as counter:
        e_pred, e_std = tmodel.predict_step(*map(torch.as_tensor, inputs))
    np.testing.assert_allclose(pred.float().numpy(), e_pred.float().numpy(),
                               atol=1e-6, rtol=0)
    graph_ops = collections.Counter(
        n.target._schema.name
        for n in torch.export.load(str(out)).graph.nodes
        if n.op == "call_function"
        and getattr(n.target, "namespace", None) == "nlt")
    assert graph_ops == counter.counts
    if flat:
        assert graph_ops["nlt::edge_layer_flat"] == 1
    else:
        assert not any("flat" in k for k in graph_ops), graph_ops

    j_pred, j_std = j_load_exported(j_out)(*map(jnp.asarray, inputs))
    if "bf16" in flags:
        scale = float(np.abs(np.asarray(j_pred, np.float32)).max())
        np.testing.assert_allclose(pred.float().numpy(),
                                   np.asarray(j_pred, np.float32),
                                   atol=2.0**-7 * scale, rtol=0)
        return
    r_pred, r_std = jax.jit(jmodel.predict_step)(
        params, *map(jnp.asarray, inputs))
    for want in (j_pred, r_pred):
        np.testing.assert_allclose(pred.numpy(), np.asarray(want), atol=1e-4,
                                   rtol=0)
    if "--output_std" in flags:
        assert std.shape == pred.shape
        for want in (j_std, r_std):
            np.testing.assert_allclose(std.numpy(), np.asarray(want),
                                       atol=1e-4, rtol=0)
    else:
        assert std.shape == () and float(std) == 0.0
        assert e_std is None
    if case == "graph_lam-flat":
        imported = _fresh_process_step(out, inputs, tmp_path / "io.npz")
        assert not imported, "load_exported imported the model code"
        z = np.load(tmp_path / "io.npz")
        np.testing.assert_array_equal(z["pred"], pred.numpy())
