"""Checkpoints of the port's own training state.

Counterpart of neural_lam_tpu/checkpoint.py (ref behaviour:
neural_lam/train_model.py:264-270, ar_model.py:698-721): the trainer keeps
`<run_dir>/last` and `<run_dir>/min_val_loss`, each a directory holding the
model's `state_dict` and, optionally, the AdamW state, with the progress
metadata beside it in `<name>.meta.json`. Graphs and statistics are never
stored: they are rebuilt from the datastore. The format is the port's own
(`torch.save` of tensors only, loaded with `weights_only=True`); loading
the JAX package's checkpoints waits for the predict CLI.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import torch

STATE_FILE = "state.pt"


def save_checkpoint(ckpt_dir, name: str, model_state: dict,
                    opt_state: dict | None = None, meta: dict | None = None):
    """Write <ckpt_dir>/<name>/state.pt (+ <name>.meta.json), replacing an
    earlier checkpoint of that name. Tensors are copied to the CPU."""
    path = Path(ckpt_dir).absolute() / name
    tmp = path.with_name(f".{name}.tmp")
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    payload = {"model": _to_cpu(model_state)}
    if opt_state is not None:
        payload["optimizer"] = _to_cpu(opt_state)
    torch.save(payload, tmp / STATE_FILE)
    shutil.rmtree(path, ignore_errors=True)
    tmp.rename(path)
    if meta is not None:
        with open(str(path) + ".meta.json", "w") as f:
            json.dump(meta, f)


def load_checkpoint(ckpt_path, device="cpu"):
    """Read a checkpoint: (model_state, opt_state | None, meta)."""
    path = Path(ckpt_path).absolute()
    payload = torch.load(path / STATE_FILE, map_location=device,
                         weights_only=True)
    meta = {}
    meta_path = Path(str(path) + ".meta.json")
    if meta_path.exists():
        meta = json.loads(meta_path.read_text())
    return payload["model"], payload.get("optimizer"), meta


def _to_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree
