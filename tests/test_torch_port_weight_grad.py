"""`weight_grad.xtd_sum`'s host-side split and its arithmetic, on the CPU.

On a CUDA tensor `xtd_sum` runs csrc/weight_grad.cu in two launches: a
persistent grid whose blocks each take an even, contiguous share of all the
pairs' rows (cut at the pair boundaries into segments by
`weight_grad.segments`) and write one partial matrix per segment, then a
reduce kernel that sums each pair's partials in segment order. The
products run on tensor cores in 3xTF32. These tests hold:

* `segments` covers every row of every pair exactly once, in order, never
  mixes two pairs in one segment, and gives each block an even share
  (within one tile), at the decoder's nine pair sizes and B3/B4's two at
  bench shape, with a 1-row pair and with pairs shorter than a share;
* the plain versions of the two kernels (`xtd_partials_plain`, then
  `xtd_reduce_plain`) compose to `xtd_sum_plain`, and neither wrapper
  builds or launches anything on a CPU tensor;
* a plain emulation of the 3xTF32 split: on a (10^5, 64) x (10^5, 64)
  pair it matches float64 within the kernel's limit on the card (1e-4 +
  1e-4 * max abs, chip_smoke.py phase 4), and one TF32 product does not.
  This one calls no code of the port: it records why the kernel takes
  three products, and chip_smoke.py holds the kernel itself to that limit.
"""

import numpy as np
import pytest
import torch

from neural_lam_tpu_torch.ops import _build, weight_grad

H = 64
# the decoder's nine pairs at bench shape (63,784 grid nodes, 64,000
# virtual rows, K=4, batch 4; `grid_update._PAIRS` order) and B3/B4's two
# at m2m[0] (7,424 virtual rows, K=8, batch 4)
DECODER = [63784 * 4] + [64000 * 4] * 2 + [64000 * 4 * 4] + [64000 * 4] * 5
B3 = [7424 * 8 * 4] * 2


@pytest.mark.parametrize("ns,blocks", [
    (DECODER, 264), (DECODER, 396), (B3, 264), (B3, 132),
    ([1, 5000, 1, 3000], 7),       # 1-row pairs
    ([10, 3, 40, 1, 2], 4),        # pairs shorter than a share
    ([0, 100, 0, 33], 3),          # empty pairs
])
def test_segments_cover_each_row_once_in_even_shares(ns, blocks):
    segs = weight_grad.segments(ns, blocks)
    total = sum(ns)
    # in order: block by block, rows laid end to end, no gap, no overlap
    starts = np.concatenate([[0], np.cumsum(ns)])
    pos = 0
    for b, p, lo, hi in segs:
        assert 0 <= lo < hi <= ns[p], (b, p, lo, hi)  # one pair, non-empty
        assert starts[p] + lo == pos
        pos = starts[p] + hi
    assert pos == total
    assert [s[0] for s in segs] == sorted(s[0] for s in segs)
    # each pair's segments are consecutive in the list
    pairs = [s[1] for s in segs]
    assert pairs == sorted(pairs)
    # even shares: within one tile (here: within one row) of each other
    share = np.zeros(blocks, dtype=np.int64)
    for b, _, lo, hi in segs:
        share[b] += hi - lo
    assert share.sum() == total
    assert share.max() - share.min() <= min(1, weight_grad.TILE)
    # a block holds at most one segment more than the pair starts its
    # share crosses
    per_block = np.bincount([s[0] for s in segs], minlength=blocks)
    assert len(segs) <= blocks + sum(1 for n in ns if n)
    assert per_block.max() <= 1 + sum(1 for n in ns if n)


def _pairs(rng, ns, widths):
    return [(torch.as_tensor(rng.standard_normal((n, H)).astype(np.float32)),
             torch.as_tensor(rng.standard_normal((n, d)).astype(np.float32)))
            for n, d in zip(ns, widths)]


def test_partials_and_reduce_compose_to_xtd_sum(monkeypatch):
    """xtd_partials_plain then xtd_reduce_plain equals xtd_sum_plain (one
    segment per block and pair, each pair's partials summed), with d = 64
    and the decoder's d_out = 17 and a 1-row pair; the wrappers take these
    plain versions on CPU tensors and build and launch nothing."""
    def no_build(*a, **kw):
        raise AssertionError("kernel library requested for a CPU tensor")

    monkeypatch.setattr(_build, "library", no_build)
    rng = np.random.default_rng(0)
    pairs = _pairs(rng, [300, 1, 517, 64], [64, 17, 64, 9])
    widths = [d.shape[1] for _, d in pairs]
    before = (weight_grad.xtd_sum.launches, weight_grad.xtd_reduce.launches)
    partial, first = weight_grad.xtd_partials(pairs, 5)
    want_p = weight_grad.xtd_partials_plain(pairs, 5)
    assert torch.equal(partial, want_p[0]) and first == want_p[1]
    assert first[0] == 0 and first[-1] == partial.shape[0]
    assert partial.shape[1] == H * H
    got = weight_grad.xtd_reduce(partial, first, widths, H)
    want = weight_grad.xtd_sum_plain(pairs)
    for g, w, d in zip(got, want, widths):
        assert g.shape == (H, d)
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-4)
    assert (weight_grad.xtd_sum.launches,
            weight_grad.xtd_reduce.launches) == before


def _tf32(x):
    """Round fp32 to TF32 (10 mantissa bits), to nearest with ties away
    from zero on the magnitude, as `cvt.rna.tf32.f32` does."""
    bits = x.view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def test_3xtf32_split_reaches_fp32_accuracy_where_one_tf32_does_not():
    """X^T D over 10^5 rows, both (10^5, 64) from N(0, 1): with X and D
    split into big = tf32(x) and small = tf32(x - big) and the products
    big*big + big*small + small*big summed in fp32 (the kernel's 3xTF32),
    within 1e-4 + 1e-4 * max abs of float64; with one TF32 product per
    term, far outside it."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((100_000, H)).astype(np.float32)
    d = rng.standard_normal((100_000, H)).astype(np.float32)
    ref = x.astype(np.float64).T @ d.astype(np.float64)
    tol = 1e-4 + 1e-4 * np.abs(ref).max()
    xt, dt = torch.as_tensor(x), torch.as_tensor(d)
    bx, bd = _tf32(xt), _tf32(dt)
    sx, sd = _tf32(xt - bx), _tf32(dt - bd)
    assert bool((bx.view(torch.int32) & 0x1FFF == 0).all())
    # each TF32 x TF32 product is exact in fp32; the sums are fp32
    three = bx.t() @ sd + sx.t() @ bd + bx.t() @ bd
    one = bx.t() @ bd
    err3 = float(np.abs(three.double().numpy() - ref).max())
    err1 = float(np.abs(one.double().numpy() - ref).max())
    assert err3 <= tol, (err3, tol)
    assert err1 > 2 * tol, (err1, tol)
