"""The g2m edge tail's backward in two passes (B2), on the CPU.

On a CUDA tensor `edge_tail_sum_flat_bwd` runs a chain kernel, which writes
X1 = silu(x0) and DY (the LayerNorm input's gradient) to a scratch, and
`weight_grad.xtd_sum`, which sums dW2 = X1^T DY. On a CPU tensor it runs
the plain versions of both passes in the same composition. These tests
hold:

* the CPU composition (chain plain + `xtd_sum_plain` over `_tail_pairs`)
  against `edge_tail_sum_flat_bwd_plain` (autograd through the plain
  forward) and against autograd through `edge_tail_sum_flat_plain`, for
  all seven outputs, at K = 1, 3 and 8 and B = 1 and 4, with padding
  slots (mask 0) and padding virtual rows (all slots masked): max abs
  diff <= 1e-5 + 1e-5 * max abs of the reference, per tensor (fp32 sums
  of the same products in another order);
* the scratch layout the kernel writes: row (v*K + k)*B + b of X1 is
  silu(x0) at slot k of virtual row v and batch element b, and DY's is
  the LayerNorm input's gradient there (zero at padding slots);
* that on CPU tensors the chain builds and launches nothing.

The composition against the JAX package's interpret-mode kernel is
`test_torch_port_train.py::test_edge_tail_sum_bwd_matches_jax` (K = 8)
and `test_torch_port_kernels.py::test_edge_tail_sum_flat_grads_match_jax`.
"""

import numpy as np
import pytest
import torch

from neural_lam_tpu_torch.ops import _build, edge_flat, weight_grad

H = 64


def _rand(rng, *shape, scale=0.3):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _tail_case(K, B=2, n_virt=40, n_send=30, seed=0):
    """Random edge-tail inputs with padding slots and padding virtual rows,
    as tensors: (table, senders, ew, rec_rows, mask_p, w2, b2, ln_scale,
    ln_bias, d_virt)."""
    rng = np.random.default_rng(seed + 10 * K + B)
    M, W = n_virt * K, B * H
    mask = (rng.random((n_virt, K)) < 0.7).astype(np.float32)
    mask[:, 0] = 1.0
    mask[-3:] = 0.0  # padding virtual rows
    arrays = (_rand(rng, n_send, W),
              rng.integers(0, n_send, M).astype(np.int32),
              _rand(rng, M, H), _rand(rng, n_virt, W), mask,
              _rand(rng, H, H, scale=0.2), _rand(rng, H, scale=0.2),
              1 + _rand(rng, H, scale=0.1), _rand(rng, H, scale=0.1),
              _rand(rng, n_virt, W, scale=1.0))
    return [torch.as_tensor(a) for a in arrays]


NAMES = ("d_x0", "d_ew", "d_rec", "d_w2", "d_b2", "d_ln_scale", "d_ln_bias")


def _assert_close(name, got, want):
    assert got.shape == want.shape, (name, got.shape, want.shape)
    tol = 1e-5 + 1e-5 * float(want.abs().max())
    err = float((got - want).abs().max())
    assert err <= tol, f"{name}: max abs diff {err:.3e} > {tol:.3e}"


@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("K", [1, 3, 8])
def test_edge_tail_bwd_composition_matches_autograd(K, B):
    """Chain plain + xtd_sum_plain over `_tail_pairs`, assembled as the
    CUDA route assembles them, against `edge_tail_sum_flat_bwd_plain` and
    against autograd through `edge_tail_sum_flat_plain` (the table's
    gradient through the gather: d_x0 folded onto the senders)."""
    args = _tail_case(K, B=B)
    d_x0, d_ew, d_rec, (d_b2, d_ls, d_lb), pairs = (
        edge_flat.edge_tail_bwd_chain_plain(*args))
    (d_w2,) = weight_grad.xtd_sum_plain(pairs)
    got = (d_x0, d_ew, d_rec, d_w2, d_b2, d_ls, d_lb)
    for name, g, w in zip(NAMES, got,
                          edge_flat.edge_tail_sum_flat_bwd_plain(*args)):
        _assert_close(name, g, w)
    for name, g, w in zip(NAMES, edge_flat.edge_tail_sum_flat_bwd(*args),
                          got):
        torch.testing.assert_close(g, w, rtol=0, atol=0, msg=name)

    table, senders, ew, rec_rows, mask_p, w2, b2, ls, lb, d_virt = args
    leaves = [t.clone().requires_grad_() for t in (table, ew, rec_rows, w2,
                                                   b2, ls, lb)]
    virt = edge_flat.edge_tail_sum_flat_plain(
        leaves[0], senders, leaves[1], leaves[2], mask_p, *leaves[3:])
    (virt * d_virt).sum().backward()
    d_table = torch.zeros_like(table).index_add_(0, senders.long(), d_x0)
    for name, g, leaf in zip(("d_table",) + NAMES[1:],
                             (d_table, d_ew, d_rec, d_w2, d_b2, d_ls, d_lb),
                             leaves):
        _assert_close(name, g, leaf.grad)


def test_chain_scratch_has_the_kernel_layout():
    """X1's row (v*K + k)*B + b is silu(x0) of that slot and batch element;
    DY's is zero at a padding slot (no cotangent reaches it) and equals the
    LayerNorm backward at a real one."""
    K, B, n_virt = 3, 2, 40
    args = _tail_case(K, B=B, n_virt=n_virt)
    table, senders, ew, rec_rows, mask_p, w2, b2, ls, lb, d_virt = args
    _, _, _, vecs, pairs = edge_flat.edge_tail_bwd_chain_plain(*args)
    assert len(vecs) == 3 and len(pairs) == 1
    ((x1, dy),) = pairs
    M = n_virt * K
    assert x1.shape == dy.shape == (M * B, H)
    for v, k, b in ((7, 2, 1), (0, 0, 0), (n_virt - 4, K - 1, B - 1)):
        m, cols = v * K + k, slice(b * H, (b + 1) * H)
        x0 = ew[m] + table[int(senders[m]), cols] + rec_rows[v, cols]
        x1_want = torch.nn.functional.silu(x0)
        torch.testing.assert_close(x1[m * B + b], x1_want, rtol=1e-5,
                                   atol=1e-6)
        y = (x1_want @ w2 + b2).requires_grad_()
        msg = torch.nn.functional.layer_norm(y, (H,), ls, lb, eps=1e-5)
        (dy_want,) = torch.autograd.grad(msg, y,
                                         mask_p[v, k] * d_virt[v, cols])
        torch.testing.assert_close(dy[m * B + b], dy_want, rtol=1e-4,
                                   atol=1e-5)
    pad = (mask_p == 0).reshape(-1).repeat_interleave(B)
    assert pad.any()
    assert bool((dy[pad] == 0).all()) and bool((dy[~pad] != 0).any())


def test_chain_takes_plain_version_on_cpu(monkeypatch):
    """On CPU tensors the chain is its plain version and the whole backward
    builds and launches nothing."""
    def no_build(*a, **kw):
        raise AssertionError("kernel library requested for a CPU tensor")

    monkeypatch.setattr(_build, "library", no_build)
    args = _tail_case(8)
    before = (edge_flat.edge_tail_sum_flat_bwd.launches,
              weight_grad.xtd_sum.launches, weight_grad.xtd_reduce.launches)
    got = edge_flat.edge_tail_bwd_chain(*args)
    want = edge_flat.edge_tail_bwd_chain_plain(*args)
    for g, w in zip(got[:3] + got[3] + got[4][0], want[:3] + want[3]
                    + want[4][0]):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    edge_flat.edge_tail_sum_flat_bwd(*args)
    assert (edge_flat.edge_tail_sum_flat_bwd.launches,
            weight_grad.xtd_sum.launches,
            weight_grad.xtd_reduce.launches) == before
