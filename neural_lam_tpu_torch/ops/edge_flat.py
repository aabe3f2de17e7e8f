"""Flat-layout edge-MLP tail (K2) and processor edge layer (K3).

Counterpart of neural_lam_tpu/ops/pallas_edge_flat.py. Both functions read
the sender term by index from the node table (`table[senders]`), so one
function covers the JAX package's pre-gathered kernels and its windowed
twins (`edge_layer_flat` and `edge_layer_flat_win`).

Layout: node and edge activations are flat (rows, W) with W = B*h; mask_p
is the (N_virt, K) dense-slot validity of the EdgeSet.

Each wrapper runs its plain PyTorch version (`*_plain`, same module) on a
CPU tensor and its CUDA kernel (`csrc/edge_flat.cu`) on a CUDA tensor;
there is no fallback from one to the other. `<wrapper>.launches` counts
kernel launches.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build
from .mlp import layer_norm

HID = 64  # hidden width the CUDA kernels are written for

_P, _I = _build.P, _build.I
_SIGNATURES = {
    "nlt_edge_tail_sum": [_P] * 7 + [_I] * 4 + [_P],
    "nlt_edge_layer": [_P] * 8 + [_I] * 4 + [_P],
}


def _lib():
    return _build.library("edge_flat", _SIGNATURES)


def _masked_slot_sum(msg, mask_p):
    """(N_virt, K, B, h) messages -> (N_virt, B*h) masked K-slot sums."""
    n_virt = msg.shape[0]
    return (msg * mask_p[:, :, None, None]).sum(dim=1).reshape(n_virt, -1)


def edge_tail_sum_flat_plain(table, senders, ew, rec_rows, mask_p, w2, b2,
                             ln_scale, ln_bias):
    """Plain PyTorch version of `edge_tail_sum_flat`."""
    n_virt, K = mask_p.shape
    h = ew.shape[-1]
    B = table.shape[-1] // h
    g = table.index_select(0, senders).view(n_virt, K, B, h)
    x0 = g + ew.view(n_virt, K, 1, h) + rec_rows.view(n_virt, 1, B, h)
    msg = layer_norm(F.silu(x0) @ w2 + b2, ln_scale, ln_bias)
    return _masked_slot_sum(msg, mask_p)


def edge_tail_sum_flat(table, senders, ew, rec_rows, mask_p, w2, b2,
                       ln_scale, ln_bias):
    """Fused edge-MLP tail with a static edge term (g2m encoder).

    table: (N_send, W) sender transforms x_j @ W_j, one row per node.
    senders: (M,) int32 sender id per edge slot, M = N_virt*K.
    ew: (M, h) static edge term emb @ W_e + b0, shared across batch.
    rec_rows: (N_virt, W) receiver transforms per virtual row.
    Returns virt (N_virt, W): sum_k mask * LN(silu(x0) @ w2 + b2) with
    x0 = table[senders] + ew + rec_rows.

    Replaces pallas_edge_flat.py::_tail_sum_flat_kernel (via
    edge_tail_sum_flat). Bound by fp32 operations on the card (the W2
    product per slot); see csrc/edge_flat.cu.
    """
    if table.device.type == "cpu":
        return edge_tail_sum_flat_plain(table, senders, ew, rec_rows, mask_p,
                                        w2, b2, ln_scale, ln_bias)
    dev = _build.require_cuda(table)
    n_virt, K = mask_p.shape
    W = table.shape[1]
    _build.expect(ew.shape == (n_virt * K, HID), "ew", ew.shape)
    _build.expect(W % HID == 0 and rec_rows.shape == (n_virt, W),
                  "rec_rows", rec_rows.shape)
    _build.expect(senders.shape == (n_virt * K,), "senders", senders.shape)
    _build.expect(w2.shape == (HID, HID), "w2", w2.shape)
    params = torch.cat([w2.reshape(-1), b2, ln_scale, ln_bias])
    virt = torch.empty((n_virt, W), device=dev, dtype=torch.float32)
    f32, i32 = torch.float32, torch.int32
    ptrs = _build.pointers(dev, ("table", table, f32),
                           ("senders", senders, i32), ("ew", ew, f32),
                           ("rec_rows", rec_rows, f32),
                           ("mask_p", mask_p, f32), ("params", params, f32),
                           ("virt", virt, f32))
    lib = _lib()
    rc = lib.nlt_edge_tail_sum(*ptrs, n_virt, K, W // HID, dev.index,
                               _build.stream_of(dev))
    _build.check(lib, rc, "edge_tail_sum_flat")
    edge_tail_sum_flat.launches += 1
    return virt


edge_tail_sum_flat.launches = 0


def edge_layer_flat_plain(edge_rep, table, senders, rec_rows, mask_p, w_e,
                          b0, w2, b2, ln_scale, ln_bias):
    """Plain PyTorch version of `edge_layer_flat`."""
    n_virt, K = mask_p.shape
    M, W = edge_rep.shape
    h = w2.shape[0]
    B = W // h
    e = edge_rep.view(n_virt, K, B, h)
    g = table.index_select(0, senders).view(n_virt, K, B, h)
    x0 = e @ w_e + b0 + g + rec_rows.view(n_virt, 1, B, h)
    msg = layer_norm(F.silu(x0) @ w2 + b2, ln_scale, ln_bias)
    return (e + msg).reshape(M, W), _masked_slot_sum(msg, mask_p)


def edge_layer_flat(edge_rep, table, senders, rec_rows, mask_p, w_e, b0, w2,
                    b2, ln_scale, ln_bias):
    """Fused residual edge layer with evolving edge state (m2m processor).

    edge_rep: (M, W) edge state; table/senders/rec_rows/mask_p as in
    `edge_tail_sum_flat`. Returns (edge_out = edge_rep + msg, virt) with
    msg = LN(silu(edge_rep @ w_e + b0 + table[senders] + rec_rows) @ w2
    + b2). edge_out at padding slots is computed the same way.

    Replaces pallas_edge_flat.py::_layer_flat_kernel (edge_layer_flat) and
    ::_layer_flat_win_kernel (edge_layer_flat_win). Bound by fp32
    operations on the card (W_e and W2 products per slot); see
    csrc/edge_flat.cu.
    """
    if edge_rep.device.type == "cpu":
        return edge_layer_flat_plain(edge_rep, table, senders, rec_rows,
                                     mask_p, w_e, b0, w2, b2, ln_scale,
                                     ln_bias)
    dev = _build.require_cuda(edge_rep)
    n_virt, K = mask_p.shape
    M, W = edge_rep.shape
    _build.expect(M == n_virt * K and W % HID == 0, "edge_rep",
                  edge_rep.shape)
    _build.expect(table.dim() == 2 and table.shape[1] == W, "table",
                  table.shape)
    _build.expect(rec_rows.shape == (n_virt, W), "rec_rows", rec_rows.shape)
    _build.expect(senders.shape == (M,), "senders", senders.shape)
    _build.expect(w_e.shape == (HID, HID) and w2.shape == (HID, HID),
                  "w_e/w2", (w_e.shape, w2.shape))
    params = torch.cat([w2.reshape(-1), b2, ln_scale, ln_bias,
                        w_e.reshape(-1), b0])
    edge_out = torch.empty_like(edge_rep)
    virt = torch.empty((n_virt, W), device=dev, dtype=torch.float32)
    f32, i32 = torch.float32, torch.int32
    ptrs = _build.pointers(dev, ("edge_rep", edge_rep, f32),
                           ("table", table, f32), ("senders", senders, i32),
                           ("rec_rows", rec_rows, f32),
                           ("mask_p", mask_p, f32), ("params", params, f32),
                           ("edge_out", edge_out, f32), ("virt", virt, f32))
    lib = _lib()
    rc = lib.nlt_edge_layer(*ptrs, n_virt, K, W // HID, dev.index,
                            _build.stream_of(dev))
    _build.check(lib, rc, "edge_layer_flat")
    edge_layer_flat.launches += 1
    return edge_out, virt


edge_layer_flat.launches = 0
