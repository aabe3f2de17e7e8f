"""Checkpoints of the port's own training state.

Counterpart of neural_lam_tpu/checkpoint.py (ref behaviour:
neural_lam/train_model.py:264-270, ar_model.py:698-721): the trainer keeps
`<run_dir>/last` and `<run_dir>/min_val_loss`, each a directory holding the
model's `state_dict` and, optionally, the AdamW state, with the progress
metadata beside it in `<name>.meta.json`. Graphs and statistics are never
stored: they are rebuilt from the datastore. The format is the port's own
(`torch.save` of tensors only, loaded with `weights_only=True`). The JAX
package's orbax checkpoints come in through `convert_jax_checkpoint.py`
at the repository's root (weights only), reference Neural-LAM checkpoints
through `torch_compat.load_torch_checkpoint`.

A save never leaves a run without a loadable checkpoint of its name, which
is what a kill inside a preemption's grace period risks. The new state is
written into `.<name>.tmp/` and its metadata into `<name>.meta.json.tmp`;
then the old directory moves aside to `.<name>.old/`, the new one is
renamed in, the metadata is committed by `os.replace`, and the old
directory is deleted. `load_checkpoint` reads the last save that was
committed (`_committed`): while `.<name>.old/` and an uncommitted
metadata file are both there, that is the old directory with the old
metadata. The next save first finishes or rolls back an interrupted one.
"""

from __future__ import annotations

import json
import os
import shutil
from pathlib import Path

import torch

STATE_FILE = "state.pt"


def _parts(path: Path):
    """(new directory, aside directory, metadata, uncommitted metadata)."""
    return (path.with_name(f".{path.name}.tmp"),
            path.with_name(f".{path.name}.old"),
            Path(f"{path}.meta.json"), Path(f"{path}.meta.json.tmp"))


def _committed(path: Path):
    """(state directory, metadata file) of the last committed save of
    `path`, given what an interrupted save may have left."""
    tmp, old, meta, meta_tmp = _parts(path)
    if old.exists() and (meta_tmp.exists() or not path.exists()):
        # killed between moving the old directory aside and committing the
        # new metadata (or while rolling such a save back)
        return old, meta
    if meta_tmp.exists() and not tmp.exists() and path.exists():
        # a first save killed after its rename, before its commit
        return path, meta_tmp
    return path, meta


def _finish_interrupted(path: Path):
    """Bring what an interrupted save left back to one committed
    checkpoint (each step leaves `_committed` pointing at it)."""
    tmp, old, meta, meta_tmp = _parts(path)
    state, meta_src = _committed(path)
    if state == old:  # roll back to the old checkpoint
        shutil.rmtree(path, ignore_errors=True)
        meta_tmp.unlink(missing_ok=True)
        old.rename(path)
    elif meta_src == meta_tmp:  # roll forward: commit the metadata
        os.replace(meta_tmp, meta)
    meta_tmp.unlink(missing_ok=True)
    shutil.rmtree(old, ignore_errors=True)
    shutil.rmtree(tmp, ignore_errors=True)


def save_checkpoint(ckpt_dir, name: str, model_state: dict,
                    opt_state: dict | None = None, meta: dict | None = None):
    """Write <ckpt_dir>/<name>/state.pt and <name>.meta.json (`meta`, or
    {}), replacing an earlier checkpoint of that name; a kill at any point
    leaves the earlier or the new one loadable with its own metadata (see
    the module doc). Tensors are copied to the CPU."""
    path = Path(ckpt_dir).absolute() / name
    tmp, old, meta_path, meta_tmp = _parts(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    _finish_interrupted(path)
    tmp.mkdir()
    payload = {"model": _to_cpu(model_state)}
    if opt_state is not None:
        payload["optimizer"] = _to_cpu(opt_state)
    torch.save(payload, tmp / STATE_FILE)
    meta_tmp.write_text(json.dumps(meta or {}))
    if path.exists():
        path.rename(old)
    tmp.rename(path)
    os.replace(meta_tmp, meta_path)
    shutil.rmtree(old, ignore_errors=True)


def checkpoint_exists(ckpt_path) -> bool:
    """Whether `ckpt_path` has a committed save that `load_checkpoint`
    reads, also while an interrupted save has moved it aside."""
    state_dir, _ = _committed(Path(ckpt_path).absolute())
    return (state_dir / STATE_FILE).exists()


def load_checkpoint(ckpt_path, device="cpu"):
    """Read a checkpoint's last committed save: (model_state, opt_state |
    None, meta)."""
    state_dir, meta_path = _committed(Path(ckpt_path).absolute())
    payload = torch.load(state_dir / STATE_FILE, map_location=device,
                         weights_only=True)
    meta = {}
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
