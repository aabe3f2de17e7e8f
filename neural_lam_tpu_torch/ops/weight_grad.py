"""Weight gradients as sums of row products: X^T @ D for a list of pairs.

A backward pass whose weight gradients are sums over rows of X (n, 64)
times D (n, d), d <= 64, writes the pairs out and hands them to `xtd_sum`,
which computes all of them in one launch of `csrc/weight_grad.cu`. Two
callers take their weight gradients this way: the decoder backward (B5/B6,
`ops/grid_update.py::grid_update_flat_bwd`, nine pairs) and the processor
edge layer's backward (B3/B4, `ops/edge_flat.py::edge_layer_flat_bwd`, two
pairs: dW2 and dW_e). The JAX kernels they replace
(pallas_grid_update.py::_grid_update_bwd_kernel, ::_grid_update_win_bwd_kernel,
pallas_edge_flat.py::_layer_bwd_kernel, ::_layer_bwd_win_kernel) sum the
same products inside their own bodies.

Each block of the kernel sums `rows_per_block` rows of one pair into a
(64, d) partial matrix; the wrapper sums each pair's partials in a fixed
order (no float atomics), so a run repeats itself bit for bit.
`xtd_sum.launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

HID = 64
MAX_PAIRS = 16  # csrc/weight_grad.cu's kMaxPairs
TILE = 32  # csrc/weight_grad.cu's kTile: rows staged per step
# A multiple of TILE. chip_smoke.py sweeps 1024-8192 at the decoder's
# pairs: 2048 and 6144 were fastest; 2048 runs several waves of blocks,
# so its tail stays short at other row counts too.
ROWS_PER_BLOCK = 2048

_LLP = ctypes.POINTER(_build.LL)
_IP = _build.IP
_SIGNATURES = {"nlt_xtd_sum": [_LLP, _LLP, _LLP, _IP, _IP, _build.I,
                               _build.LL, _build.P, _build.I, _build.P]}


def _lib():
    return _build.library("weight_grad", _SIGNATURES)


def xtd_sum_plain(pairs):
    """Plain PyTorch version of `xtd_sum`."""
    return tuple(x.t() @ d for x, d in pairs)


def _check(pairs, rows_per_block):
    _build.expect(1 <= len(pairs) <= MAX_PAIRS, "number of pairs", len(pairs))
    _build.expect(rows_per_block >= TILE and rows_per_block % TILE == 0,
                  "rows per block", rows_per_block)
    for i, (x, d) in enumerate(pairs):
        _build.expect(x.dim() == 2 and x.shape[1] == HID, f"X[{i}]",
                      tuple(x.shape))
        _build.expect(d.dim() == 2 and d.shape[0] == x.shape[0]
                      and 1 <= d.shape[1] <= HID, f"D[{i}]", tuple(d.shape))
        for name, t in (("X", x), ("D", d)):
            _build.expect(t.data_ptr() % 16 == 0, f"{name}[{i}] alignment",
                          t.data_ptr())


def xtd_sum(pairs, rows_per_block=ROWS_PER_BLOCK):
    """X^T @ D, summed over the rows, for each (X (n, 64), D (n, d)) pair
    with 1 <= d <= 64: a tuple of (64, d) matrices, one launch for all
    pairs on a CUDA device, each block summing `rows_per_block` rows.

    Bound by the bytes of the pairs on the card (each row of X and D read
    once); see csrc/weight_grad.cu."""
    x0 = pairs[0][0]
    if x0.device.type == "cpu":
        return xtd_sum_plain(pairs)
    dev = _build.require_cuda(x0)
    _check(pairs, rows_per_block)
    f32 = torch.float32
    ptrs = _build.pointers(dev, *((f"{n}[{i}]", t, f32)
                                  for i, p in enumerate(pairs)
                                  for n, t in zip("XD", p)))
    first = [0]
    for x, _ in pairs:
        first.append(first[-1] + max(1, -(-x.shape[0] // rows_per_block)))
    n = len(pairs)
    partial = torch.empty((first[-1], HID * HID), device=dev, dtype=f32)
    lib = _lib()
    rc = lib.nlt_xtd_sum(
        (_build.LL * n)(*ptrs[0::2]), (_build.LL * n)(*ptrs[1::2]),
        (_build.LL * n)(*(x.shape[0] for x, _ in pairs)),
        (ctypes.c_int * n)(*(d.shape[1] for _, d in pairs)),
        (ctypes.c_int * (n + 1))(*first), n, rows_per_block,
        partial.data_ptr(), dev.index, _build.stream_of(dev))
    _build.check(lib, rc, "xtd_sum")
    xtd_sum.launches += 1
    return tuple(partial[a:b, :HID * d.shape[1]].sum(dim=0).view(HID, -1)
                 for (_, d), a, b in zip(pairs, first, first[1:]))


xtd_sum.launches = 0
