"""Grid-feature embedder (K1): MLP(concatenated features) + LayerNorm.

Counterpart of neural_lam_tpu/ops/pallas_embed.py. The caller packs the
concatenated per-node features into the flat layout once, x_f (N, B*d_in),
and one pass computes per (node, batch element) row

    out = LayerNorm(silu(x @ w0 + b0) @ w1 + b1)          -> (N, B*h)

Unlike the TPU kernel, d_in is not zero-padded to a lane multiple.
The wrapper runs the plain version on a CPU tensor and the CUDA kernel
(`csrc/embed.cu`) on a CUDA tensor. `embed_grid_flat.launches` counts
kernel launches.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build
from .mlp import layer_norm

HID = 64

_P, _I = _build.P, _build.I
_SIGNATURES = {"nlt_embed": [_P] * 3 + [_build.LL, _I, _I, _P]}


def _lib():
    return _build.library("embed", _SIGNATURES)


def embed_grid_flat_plain(x_f, w0, b0, w1, b1, ln_scale, ln_bias,
                          batch_size: int):
    """Plain PyTorch version of `embed_grid_flat`."""
    N = x_f.shape[0]
    x = x_f.view(N, batch_size, -1)
    y = F.silu(x @ w0 + b0) @ w1 + b1
    return layer_norm(y, ln_scale, ln_bias).reshape(N, -1)


def embed_grid_flat(x_f, w0, b0, w1, b1, ln_scale, ln_bias,
                    batch_size: int):
    """Fused flat grid embedder.

    x_f: (N, B*d_in) flat-packed features; w0 (d_in, h), w1 (h, h).
    Returns (N, B*h).

    Replaces pallas_embed.py::_embed_fwd_kernel (via embed_grid_flat).
    Bound by fp32 operations on the card; see csrc/embed.cu.
    """
    if x_f.device.type == "cpu":
        return embed_grid_flat_plain(x_f, w0, b0, w1, b1, ln_scale, ln_bias,
                                     batch_size)
    dev = _build.require_cuda(x_f)
    N, W_in = x_f.shape
    d_in = w0.shape[0]
    _build.expect(W_in == batch_size * d_in, "x_f", (x_f.shape, d_in))
    _build.expect(w0.shape == (d_in, HID) and w1.shape == (HID, HID),
                  "w0/w1", (w0.shape, w1.shape))
    params = torch.cat([w0.reshape(-1), w1.reshape(-1), b0, b1, ln_scale,
                        ln_bias])
    out = torch.empty((N, batch_size * HID), device=dev, dtype=torch.float32)
    f32 = torch.float32
    ptrs = _build.pointers(dev, ("x_f", x_f, f32), ("params", params, f32),
                           ("out", out, f32))
    lib = _lib()
    rc = lib.nlt_embed(*ptrs, N * batch_size, d_in, dev.index,
                       _build.stream_of(dev))
    _build.check(lib, rc, "embed_grid_flat")
    embed_grid_flat.launches += 1
    return out


embed_grid_flat.launches = 0
