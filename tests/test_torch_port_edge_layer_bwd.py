"""The processor edge layer's backward in two passes (B3/B4), on the CPU.

On a CUDA tensor `edge_layer_flat_bwd` runs a chain kernel, which writes
X1 = silu(x0) and DY (the LayerNorm input's gradient) to a scratch, and
`weight_grad.xtd_sum`, which sums dW2 = X1^T DY and dW_e = edge^T d_x0.
On a CPU tensor it runs the plain versions of both passes in the same
composition. These tests hold:

* the CPU composition against `edge_layer_flat_bwd_plain` (autograd through
  the plain forward), for all nine outputs, at K = 1, 4 and 8, with and
  without a cotangent on edge_out, with padding slots (mask 0) and padding
  virtual rows (all slots masked), B = 2: max abs diff <= 1e-5 + 1e-5 *
  max abs of the reference, per tensor (fp32 sums of the same products in
  another order);
* the scratch layout the kernel writes: row (v*K + k)*B + b of X1 is
  silu(x0) at slot k of virtual row v and batch element b, and the dW_e
  pair is edge_rep and d_x0 themselves, viewed (M*B, 64);
* that on CPU tensors the chain builds and launches nothing.

The composition against the JAX package's interpret-mode kernel is
`test_torch_port_train.py::test_edge_layer_bwd_matches_jax`.
"""

import numpy as np
import pytest
import torch

from neural_lam_tpu_torch.ops import _build, edge_flat, weight_grad

H = 64


def _rand(rng, *shape, scale=0.3):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _layer_case(K, B=2, n_virt=40, n_send=30, seed=0):
    """Random edge-layer inputs with padding slots and padding virtual
    rows, as tensors: (edge_rep, table, senders, rec_rows, mask_p, w_e, b0,
    w2, b2, ln_scale, ln_bias, d_edge_out, d_virt)."""
    rng = np.random.default_rng(seed + K)
    M, W = n_virt * K, B * H
    mask = (rng.random((n_virt, K)) < 0.7).astype(np.float32)
    mask[:, 0] = 1.0
    mask[-3:] = 0.0  # padding virtual rows
    arrays = (_rand(rng, M, W), _rand(rng, n_send, W),
              rng.integers(0, n_send, M).astype(np.int32),
              _rand(rng, n_virt, W), mask,
              _rand(rng, H, H, scale=0.2), _rand(rng, H, scale=0.2),
              _rand(rng, H, H, scale=0.2), _rand(rng, H, scale=0.2),
              1 + _rand(rng, H, scale=0.1), _rand(rng, H, scale=0.1),
              _rand(rng, M, W, scale=1.0), _rand(rng, n_virt, W, scale=1.0))
    return [torch.as_tensor(a) for a in arrays]


NAMES = ("d_edge", "d_x0", "d_rec", "d_w_e", "d_b0", "d_w2", "d_b2",
         "d_ln_scale", "d_ln_bias")


@pytest.mark.parametrize("with_edge_grad", [True, False],
                         ids=["d_edge_out", "no_d_edge_out"])
@pytest.mark.parametrize("K", [1, 4, 8])
def test_edge_layer_bwd_composition_matches_autograd(K, with_edge_grad):
    """The CPU route of `edge_layer_flat_bwd` (chain plain + xtd_sum_plain
    + assembly) against `edge_layer_flat_bwd_plain`, all nine outputs."""
    args = _layer_case(K)
    if not with_edge_grad:
        args[11] = None
    got = edge_flat.edge_layer_flat_bwd(*args)
    want = edge_flat.edge_layer_flat_bwd_plain(*args)
    assert len(got) == len(want) == len(NAMES)
    for name, g, w in zip(NAMES, got, want):
        assert g.shape == w.shape, (name, g.shape, w.shape)
        tol = 1e-5 + 1e-5 * float(w.abs().max())
        err = float((g - w).abs().max())
        assert err <= tol, f"{name}: max abs diff {err:.3e} > {tol:.3e}"


def test_chain_scratch_has_the_kernel_layout():
    """X1's row (v*K + k)*B + b is silu(x0) of that slot and batch element;
    DY is zero where a padding slot gets no cotangent; the dW_e pair is
    edge_rep and d_x0 viewed (M*B, 64), sharing their storage."""
    K, B, n_virt = 4, 2, 40
    args = _layer_case(K, B=B, n_virt=n_virt)
    args[11] = None  # no d_edge_out: padding slots get no cotangent
    edge_rep, table, senders, rec_rows, mask_p, w_e, b0 = args[:7]
    d_e, d_x0, d_rec, vecs, pairs = edge_flat.edge_layer_bwd_chain_plain(
        *args)
    assert len(vecs) == 4 and len(pairs) == 2
    (x1, dy), (e_rows, d0_rows) = pairs
    M = n_virt * K
    for t in (x1, dy, e_rows, d0_rows):
        assert t.shape == (M * B, H)
    assert e_rows.data_ptr() == edge_rep.data_ptr()
    assert d0_rows.data_ptr() == d_x0.data_ptr()
    assert d_x0.shape == edge_rep.shape
    for v, k, b in ((7, 2, 1), (0, 0, 0), (n_virt - 1, K - 1, B - 1)):
        m, cols = v * K + k, slice(b * H, (b + 1) * H)
        x0 = (edge_rep[m, cols] @ w_e + b0 + table[int(senders[m]), cols]
              + rec_rows[v, cols])
        torch.testing.assert_close(x1[m * B + b],
                                   torch.nn.functional.silu(x0),
                                   rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(e_rows[m * B + b], edge_rep[m, cols],
                                   rtol=0, atol=0)
    pad = (mask_p == 0).reshape(-1).repeat_interleave(B)
    assert pad.any()
    assert bool((dy[pad] == 0).all()) and bool((dy[~pad] != 0).any())


def test_chain_takes_plain_version_on_cpu(monkeypatch):
    """On CPU tensors the chain is its plain version and the whole backward
    builds and launches nothing."""
    def no_build(*a, **kw):
        raise AssertionError("kernel library requested for a CPU tensor")

    monkeypatch.setattr(_build, "library", no_build)
    args = _layer_case(2)
    before = (edge_flat.edge_layer_flat_bwd.launches,
              weight_grad.xtd_sum.launches)
    got = edge_flat.edge_layer_bwd_chain(*args)
    want = edge_flat.edge_layer_bwd_chain_plain(*args)
    for g, w in zip(got[:3] + got[3], want[:3] + want[3]):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    edge_flat.edge_layer_flat_bwd(*args)
    assert (edge_flat.edge_layer_flat_bwd.launches,
            weight_grad.xtd_sum.launches) == before
