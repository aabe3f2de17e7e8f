"""Load parameters of the JAX package into the port's modules.

The port's modules mirror the JAX package's parameter pytree key for key
(`ops/mlp.py`: layers.{i}.w stored (in, out), layers.{i}.b, ln.scale,
ln.bias), so the conversion is a flattening of nested dicts and lists into
dotted state-dict keys. The caller converts the JAX arrays to numpy first,
e.g. `jax.tree.map(np.asarray, params)`; this module imports no JAX.
"""

from __future__ import annotations

import numpy as np
import torch


def params_from_jax(tree) -> dict[str, torch.Tensor]:
    """State dict (CPU tensors) of a JAX parameter pytree given as nested
    dicts and lists of numpy arrays. Load it with
    `model.load_state_dict(params_from_jax(tree))`; strict loading rejects
    a tree that does not match the model key for key and shape for shape.
    `None` leaves (an MLP without output LayerNorm) have no entry."""
    out: dict[str, torch.Tensor] = {}

    def walk(node, prefix):
        if node is None:
            return
        if isinstance(node, dict):
            items = node.items()
        elif isinstance(node, (list, tuple)):
            items = enumerate(node)
        else:
            out[prefix] = torch.from_numpy(
                np.array(node, dtype=np.float32, copy=True)
            )
            return
        for k, v in items:
            walk(v, f"{prefix}.{k}" if prefix else str(k))

    walk(tree, "")
    return out
