"""Reference Neural-LAM checkpoints in and out of the port's state dict.

Counterpart of neural_lam_tpu/torch_compat.py, on the port's state dict
instead of the JAX parameter pytree. The port's keys mirror that pytree
(`<mlp>.layers.{i}.w` stored (in, out), `<mlp>.layers.{i}.b`,
`<mlp>.ln.scale`, `<mlp>.ln.bias`); the reference names its modules after
its own module tree:

  grid_embedder.0.weight ...            (make_mlp Sequential: Linear at 2i,
  g2m_gnn.edge_mlp.0.weight ...          output LayerNorm at 2n-1;
  processor.module_0.edge_mlp...         ref: neural_lam/utils.py:191-214)
  mesh_down_gnns.{p}.{l}.aggr_mlp...    (HiLAM nested ModuleLists)
  processor.module_0.edge_mlp.mlps.{c}  (HiLAMParallel SplitMLPs)

Linear weights are transposed ((out, in) <-> (in, out)). Handles the
legacy `g2m_gnn.grid_mlp.*` -> `encoding_grid_mlp.*` rename the reference
applies on checkpoint load (ref: neural_lam/models/ar_model.py:698-721).
HiLAMParallel's chunked processor (`processor.{p}.edge_mlps.{c}...`,
`.aggr_mlps.{l}...`) maps to the reference's SplitMLPs
(`processor.module_{p}.edge_mlp.mlps.{c}...`, `.aggr_mlp.mlps.{l}...`).
"""

from __future__ import annotations

import re

import numpy as np
import torch

_PARAM = re.compile(r"^(.*)\.(layers\.(\d+)\.(w|b)|ln\.(scale|bias))$")


def param_key_map(state_dict: dict) -> list:
    """(reference key, port key, transpose) for every entry of a port state
    dict (GraphLAM, HiLAM or HiLAMParallel)."""
    n_layers = {}
    for key in state_dict:
        m = _PARAM.match(key)
        if m is None:
            raise KeyError(f"{key}: not an MLP parameter of the port")
        if m.group(3) is not None:
            n_layers[m.group(1)] = max(n_layers.get(m.group(1), 0),
                                       int(m.group(3)) + 1)
    pairs = []
    for key in state_dict:
        prefix, _, layer, wb, ln = _PARAM.match(key).groups()
        ref = re.sub(r"^processor\.(\d+)\.", r"processor.module_\1.",
                     prefix)
        # HiLAMParallel's chunks: the reference's SplitMLP children
        ref = re.sub(r"\.(edge|aggr)_mlps\.(\d+)$", r".\1_mlp.mlps.\2", ref)
        if layer is not None:
            pairs.append((f"{ref}.{2 * int(layer)}."
                          f"{'weight' if wb == 'w' else 'bias'}", key,
                          wb == "w"))
        else:
            pairs.append((f"{ref}.{2 * n_layers[prefix] - 1}."
                          f"{'weight' if ln == 'scale' else 'bias'}", key,
                          False))
    return pairs


def migrate_legacy_keys(state_dict: dict) -> dict:
    """g2m_gnn.grid_mlp.* -> encoding_grid_mlp.* (ref: ar_model.py:706-718)."""
    out = {}
    for k, v in state_dict.items():
        if k.startswith("g2m_gnn.grid_mlp"):
            k = k.replace("g2m_gnn.grid_mlp", "encoding_grid_mlp")
        out[k] = v
    return out


def import_state_dict(template: dict, state_dict: dict) -> dict:
    """The port's state dict (CPU float32 tensors, keys and shapes of
    `template`, e.g. `model.state_dict()`) from a reference state dict
    (tensor- or numpy-valued). Accepts both `processor.module_{i}.` (PyG
    Sequential naming) and `processor.{i}.` (plain ModuleList) prefixes.
    Every port key must be found, and every reference weight or bias used
    (buffers such as statistics and graphs are rebuilt from the
    datastore); KeyError otherwise."""
    state_dict = migrate_legacy_keys(
        {k: np.asarray(v.detach().cpu() if torch.is_tensor(v) else v)
         for k, v in state_dict.items()})
    out, used, missing = {}, set(), []
    for ref_key, key, transpose in param_key_map(template):
        alt = ref_key.replace(".module_", ".")
        src = ref_key if ref_key in state_dict else (
            alt if alt in state_dict else None)
        if src is None:
            missing.append(ref_key)
            continue
        val = np.asarray(state_dict[src], dtype=np.float32)
        if transpose:
            val = val.T
        if tuple(val.shape) != tuple(template[key].shape):
            raise ValueError(f"{src}: shape {val.shape}, the port's {key} "
                             f"has {tuple(template[key].shape)}")
        out[key] = torch.tensor(val)
        used.add(src)
    if missing:
        raise KeyError(f"missing keys in state dict: {missing[:10]}")
    unused = [k for k in state_dict if k not in used
              and (k.endswith(".weight") or k.endswith(".bias"))]
    if unused:
        raise KeyError(f"unused reference keys: {unused[:10]}")
    return out


def export_state_dict(state_dict: dict) -> dict:
    """Inverse of import_state_dict: the port's state dict -> a
    reference-style state dict of numpy arrays."""
    out = {}
    for ref_key, key, transpose in param_key_map(state_dict):
        val = state_dict[key].detach().cpu().numpy()
        out[ref_key] = val.T if transpose else val
    return out


def load_torch_checkpoint(path, template: dict) -> dict:
    """The port's state dict from a reference Lightning `.ckpt` (its
    `state_dict` entry) or a raw state-dict file. A Lightning checkpoint
    pickles more than tensors, so it is unpickled in full: load trusted
    files only."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    state_dict = obj.get("state_dict", obj) if isinstance(obj, dict) else obj
    return import_state_dict(template, state_dict)
