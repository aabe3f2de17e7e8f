"""Weight gradients as sums of row products: X^T @ D for a list of pairs.

A backward pass whose weight gradients are sums over rows of X (n, h)
times D (n, d) writes the pairs out and hands them to `xtd_sum`, which
computes all of them in two launches of `csrc/weight_grad.cu` (its
library at hidden width h, `_build.WIDTHS`). A D wider than h (the
decoder's o_w1 pair at d_out > h) is taken as column chunks of h, each a
pair of its own (copied contiguous, `column_chunks`), and their results
are joined. Three callers take their weight gradients this way: the
decoder backward (B5/B6, `ops/grid_update.py::grid_update_flat_bwd`, nine
pairs), the processor edge layer's backward (B3/B4,
`ops/edge_flat.py::edge_layer_flat_bwd`, two pairs: dW2 and dW_e) and the
g2m edge tail's (B2, one: dW2). The JAX kernels they replace
(pallas_grid_update.py::_grid_update_bwd_kernel, ::_grid_update_win_bwd_kernel,
pallas_edge_flat.py::_layer_bwd_kernel, ::_layer_bwd_win_kernel) sum the
same products inside their own bodies.

The pairs' rows, end to end, are cut into one even share per block of a
persistent grid (`BLOCKS_PER_SM` blocks on each SM); `segments` cuts each
share at the pair boundaries, and each segment's (h, d) partial matrix is
written apart (`xtd_partials`, the main kernel). `xtd_reduce` (a second,
small kernel) sums each pair's partials in segment order: no float
atomics, so a run repeats itself bit for bit. `xtd_sum.launches` counts
the main kernel's launches, `xtd_reduce.launches` the reduce kernel's.

bf16 (the bf16 training path): a pair's X may be bf16 (B3's dW_e pair
reads the bf16 edge state, B5/B6's enc_w0 pair the bf16 grid embeddings);
the kernel stages it raw and converts it where the product reads it, in
the same launch as the fp32 pairs. D is always fp32. A launch with a bf16
X counts on `xtd_sum.launches_bf16`, and the reduce launch that finishes
it on `xtd_reduce.launches_bf16`.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

MAX_PAIRS = 16  # csrc/weight_grad.cu's kMaxPairs
TILE = 32  # rows per block at least (csrc/weight_grad.cu's kTile at 64)
# Blocks of the persistent grid per SM (capped at what is resident).
BLOCKS_PER_SM = 2

_LLP = ctypes.POINTER(_build.LL)
_IP = _build.IP
_P, _I = _build.P, _build.I
_SIGNATURES = {
    "nlt_xtd_sum": [_LLP, _LLP, _IP, _I, _I, _P, _P, _I, _P, _I, _P],
    "nlt_xtd_reduce": [_P, _IP, _IP, _I, _P, _I, _P],
    "nlt_xtd_sum_occupancy": [_I, _IP, _IP],
}
# (device, width) -> (SMs, blocks per SM)
_OCCUPANCY: dict[tuple, tuple[int, int]] = {}
_SEGMENTS: dict[tuple, tuple] = {}  # (rows, blocks, device) -> tensors


def _lib(h):
    return _build.library("weight_grad", _SIGNATURES, h)


def xtd_sum_plain(pairs):
    """Plain PyTorch version of `xtd_sum` (a bf16 X widened to fp32)."""
    return tuple(x.float().t() @ d for x, d in pairs)


def column_chunks(pairs):
    """The pairs with every D wider than X cut into column chunks of X's
    width h, each a (X, D[:, c0:c0 + h]) pair with that chunk copied
    contiguous (a D no wider than h as it is); and, per pair, how many
    chunks it became."""
    out, counts = [], []
    for x, d in pairs:
        h = x.shape[-1]
        if d.shape[1] <= h:
            out.append((x, d))
            counts.append(1)
            continue
        chunks = [(x, d[:, c0:c0 + h].contiguous())
                  for c0 in range(0, d.shape[1], h)]
        out += chunks
        counts.append(len(chunks))
    return out, counts


def segments(ns, n_blocks):
    """The segment list of `n_blocks` blocks over pairs of ns[p] rows:
    [(block, pair, first row, end row)], rows within the pair, end
    exclusive. The pairs' rows laid end to end are cut into even,
    contiguous shares (block b takes rows b*T//n_blocks up to
    (b+1)*T//n_blocks of the T in all), and each share at the pair
    boundaries; empty segments are left out. In block order, and within a
    block in row order, so each pair's segments are consecutive."""
    total = sum(ns)
    starts = [0]
    for n in ns:
        starts.append(starts[-1] + n)
    out = []
    p = 0
    for b in range(n_blocks):
        lo, hi = b * total // n_blocks, (b + 1) * total // n_blocks
        while lo < hi:
            while starts[p + 1] <= lo:
                p += 1
            end = min(hi, starts[p + 1])
            out.append((b, p, lo - starts[p], end - starts[p]))
            lo = end
    return out


def _occupancy(dev, h):
    """(SMs, resident blocks of the main kernel per SM) of `dev` at width
    h, asked of the library once per device and width."""
    occ = _OCCUPANCY.get((dev.index, h))
    if occ is None:
        lib = _lib(h)
        sms, per_sm = ctypes.c_int(0), ctypes.c_int(0)
        _build.check(lib, lib.nlt_xtd_sum_occupancy(
            dev.index, ctypes.byref(sms), ctypes.byref(per_sm)), "xtd_sum")
        occ = _OCCUPANCY[dev.index, h] = (sms.value, per_sm.value)
    return occ


def n_blocks(ns, dev, h, per_sm=BLOCKS_PER_SM):
    """Blocks of the persistent grid for pairs of ns[p] rows at width h:
    SMs x min(per_sm, resident blocks per SM), and no more than one per
    TILE rows. `xtd_sum` takes BLOCKS_PER_SM; chip_smoke.py sweeps
    `per_sm`."""
    sms, resident = _occupancy(dev, h)
    return max(1, min(sms * min(per_sm, resident), -(-sum(ns) // TILE)))


def _segment_tensors(ns, blocks, dev):
    """(seg (n_seg, 3) int64 on `dev`: pair, first row, end row;
    block_first (blocks + 1) int32 on `dev`; pair_first, the prefix count
    of segments per pair), built once per row counts and grid."""
    key = (tuple(ns), blocks, dev.index)
    got = _SEGMENTS.get(key)
    if got is None:
        segs = segments(ns, blocks)
        block_first = [0] * (blocks + 1)
        for b, _, _, _ in segs:
            block_first[b + 1] += 1
        for i in range(blocks):
            block_first[i + 1] += block_first[i]
        seg = torch.tensor([s[1:] for s in segs] or [[0, 0, 0]],
                           dtype=torch.int64).to(dev)
        got = _SEGMENTS[key] = (
            seg, torch.tensor(block_first, dtype=torch.int32).to(dev),
            _pair_first(segs, len(ns)))
    return got


def _check(pairs, blocks):
    """The pairs' shapes, dtypes and alignment for one launch; returns
    their width h, a built width."""
    _build.expect(1 <= len(pairs) <= MAX_PAIRS, "number of pairs", len(pairs))
    _build.expect(blocks >= 1, "blocks", blocks)
    h = _build.require_width(pairs[0][0].shape[-1], "xtd_sum")
    for i, (x, d) in enumerate(pairs):
        _build.expect(x.dim() == 2 and x.shape[1] == h, f"X[{i}]",
                      tuple(x.shape))
        _build.expect(d.dim() == 2 and d.shape[0] == x.shape[0]
                      and 1 <= d.shape[1] <= h, f"D[{i}]", tuple(d.shape))
        _build.io_dtype(f"X[{i}]", x)
        _build.expect(x.data_ptr() % 16 == 0, f"X[{i}] alignment",
                      x.data_ptr())
        align = 16 if d.shape[1] % 4 == 0 else 4
        _build.expect(d.data_ptr() % align == 0, f"D[{i}] alignment",
                      d.data_ptr())
    return h


def _pair_first(segs, n_pairs):
    """The prefix count of segments per pair."""
    first = [0] * (n_pairs + 1)
    for _, p, _, _ in segs:
        first[p + 1] += 1
    for i in range(n_pairs):
        first[i + 1] += first[i]
    return first


def xtd_partials_plain(pairs, blocks):
    """Plain PyTorch version of `xtd_partials`."""
    h = pairs[0][0].shape[-1]
    segs = segments([x.shape[0] for x, _ in pairs], blocks)
    partial = pairs[0][0].new_zeros((max(1, len(segs)), h * h))
    for s, (_, p, lo, hi) in enumerate(segs):
        x, d = pairs[p]
        partial[s, :h * d.shape[1]] = (
            x[lo:hi].float().t() @ d[lo:hi]).reshape(-1)
    return partial, _pair_first(segs, len(pairs))


def xtd_partials(pairs, blocks):
    """The main kernel over `blocks` blocks (`segments`): (partial (n_seg,
    h*h), whose row s holds segment s's (h, d) partial matrix row-major;
    pair_first, the prefix count of segments per pair). X (n, h), D (n, d)
    with d <= h."""
    if pairs[0][0].device.type == "cpu":
        return xtd_partials_plain(pairs, blocks)
    dev = _build.require_cuda(pairs[0][0])
    h = _check(pairs, blocks)
    f32 = torch.float32
    ptrs = _build.pointers(dev, *((f"{n}[{i}]", t, x.dtype if n == "X"
                                   else f32)
                                  for i, (x, d) in enumerate(pairs)
                                  for n, t in zip("XD", (x, d))))
    xbf = sum(1 << i for i, (x, _) in enumerate(pairs)
              if x.dtype == torch.bfloat16)
    ns = [x.shape[0] for x, _ in pairs]
    seg, block_first, pair_first = _segment_tensors(ns, blocks, dev)
    partial = torch.empty((max(1, pair_first[-1]), h * h), device=dev,
                          dtype=f32)
    if pair_first[-1]:
        n = len(pairs)
        lib = _lib(h)
        rc = lib.nlt_xtd_sum(
            (_build.LL * n)(*ptrs[0::2]), (_build.LL * n)(*ptrs[1::2]),
            (ctypes.c_int * n)(*(d.shape[1] for _, d in pairs)), n, xbf,
            seg.data_ptr(), block_first.data_ptr(), blocks,
            partial.data_ptr(), dev.index, _build.stream_of(dev))
        _build.check(lib, rc, "xtd_sum")
        _build.count_launch(xtd_sum, _launch_dtype(pairs))
    return partial, pair_first


def _launch_dtype(pairs):
    """The instance a launch over `pairs` counts on: bfloat16 when any X
    is bf16."""
    if any(x.dtype == torch.bfloat16 for x, _ in pairs):
        return torch.bfloat16
    return torch.float32


def xtd_reduce_plain(partial, pair_first, widths, h):
    """Plain PyTorch version of `xtd_reduce`."""
    return tuple(partial[a:b, :h * d].sum(dim=0).view(h, d)
                 for a, b, d in zip(pair_first, pair_first[1:], widths))


def xtd_reduce(partial, pair_first, widths, h, dtype=torch.float32):
    """Each pair's (h, d) sum of its segments' partials (rows
    pair_first[p] .. pair_first[p+1]-1 of `partial`, (n_seg, h*h), h the
    pairs' width), in segment order, in one launch on a CUDA tensor,
    counted on the counter of `dtype`, the instance of the `xtd_partials`
    launch it finishes."""
    if partial.device.type == "cpu":
        return xtd_reduce_plain(partial, pair_first, widths, h)
    dev = _build.require_cuda(partial)
    h = _build.require_width(h, "xtd_reduce")
    n = len(widths)
    _build.expect(len(pair_first) == n + 1 and pair_first[0] == 0
                  and partial.shape[0] >= pair_first[-1]
                  and partial.shape[1] == h * h
                  and all(1 <= d <= h for d in widths), "partial",
                  (tuple(partial.shape), pair_first, widths))
    (ptr,) = _build.pointers(dev, ("partial", partial, torch.float32))
    out = torch.empty(h * sum(widths), device=dev, dtype=torch.float32)
    lib = _lib(h)
    rc = lib.nlt_xtd_reduce(ptr, (ctypes.c_int * (n + 1))(*pair_first),
                            (ctypes.c_int * n)(*widths), n, out.data_ptr(),
                            dev.index, _build.stream_of(dev))
    _build.check(lib, rc, "xtd_reduce")
    _build.count_launch(xtd_reduce, dtype)
    return tuple(m.view(h, d)
                 for m, d in zip(out.split([h * d for d in widths]), widths))


def xtd_sum(pairs):
    """X^T @ D, summed over the rows, for each (X (n, h), D (n, d)) pair
    (X fp32 or bf16, D fp32, h a built width, any d >= 1): a tuple of fp32
    (h, d) matrices. On a CUDA device two launches for all pairs
    (`xtd_partials` over `n_blocks` blocks, then `xtd_reduce`), a D wider
    than h taken as column chunks (`column_chunks`), and two more for
    every MAX_PAIRS pairs past the first.

    Bound by the bytes of the pairs on the card (each row of X and D read
    once); see csrc/weight_grad.cu."""
    x0 = pairs[0][0]
    if x0.device.type == "cpu":
        return xtd_sum_plain(pairs)
    dev = _build.require_cuda(x0)
    h = _build.require_width(x0.shape[-1], "xtd_sum")
    chunks, counts = column_chunks(pairs)
    mats = []
    for i in range(0, len(chunks), MAX_PAIRS):
        group = chunks[i:i + MAX_PAIRS]
        blocks = n_blocks([x.shape[0] for x, _ in group], dev, h)
        partial, pair_first = xtd_partials(group, blocks)
        mats += xtd_reduce(partial, pair_first,
                           [d.shape[1] for _, d in group], h,
                           _launch_dtype(group))
    out = []
    for n in counts:
        out.append(mats[0] if n == 1 else torch.cat(mats[:n], dim=1))
        mats = mats[n:]
    return tuple(out)


xtd_sum.launches = 0
xtd_sum.launches_bf16 = 0
xtd_reduce.launches = 0
xtd_reduce.launches_bf16 = 0
