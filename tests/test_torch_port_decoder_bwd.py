"""The decoder backward's two passes (B5/B6), on the CPU.

On a CUDA tensor `grid_update_flat_bwd` runs a chain kernel, which writes
the activation/gradient pairs of the nine weight gradients to a scratch,
and `weight_grad.xtd_sum`, which sums X^T @ D over each pair. On a CPU
tensor it runs the plain versions of both passes in the same composition,
with the same assembly code. These tests hold:

* `xtd_sum_plain` against float64 numpy (a row count that is and one
  that is not a multiple of the kernel's 32-row tile, d = 64 and the
  decoder's narrow d_out), and `xtd_sum` on a CPU tensor to its plain
  version; the kernel's tiling is held against the plain version on the
  card, by chip_smoke.py;
* the CPU composition against `grid_update_flat_bwd_plain` (autograd
  through the plain forward), for all 24 outputs, at K = 1, 4 and 8 with
  n_ge < n_virt: max abs diff <= 1e-5 + 1e-5 * max abs of the reference,
  per tensor (fp32 sums of the same products in another order).

The composition against the JAX package's interpret-mode kernel is
`test_torch_port_train.py::test_grid_update_bwd_matches_jax`.
"""

import numpy as np
import pytest
import torch

from neural_lam_tpu_torch.ops import _build, grid_update, weight_grad

H = 64


def _rand(rng, *shape, scale=0.3):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("d", [64, 9])
def test_xtd_sum_plain_matches_float64(d):
    """Each pair's X^T D, two pairs in one call (128 and 127 rows), within
    1e-5 * (1 + max abs) of float64."""
    rng = np.random.default_rng(d)
    pairs = [(_rand(rng, m, H, scale=1.0), _rand(rng, m, d, scale=1.0))
             for m in (128, 127)]
    got = weight_grad.xtd_sum_plain(
        [(torch.as_tensor(x), torch.as_tensor(y)) for x, y in pairs])
    assert len(got) == 2
    for g, (x, y) in zip(got, pairs):
        want = x.astype(np.float64).T @ y.astype(np.float64)
        assert g.shape == (H, d) and g.dtype == torch.float32
        err = float(np.abs(g.numpy() - want).max())
        assert err <= 1e-5 * (1 + np.abs(want).max()), err


def test_xtd_sum_takes_plain_version_on_cpu(monkeypatch):
    """On CPU tensors `xtd_sum` is `xtd_sum_plain`, builds and launches
    nothing; on a tensor of another device it raises."""
    def no_build(*a, **kw):
        raise AssertionError("kernel library requested for a CPU tensor")

    monkeypatch.setattr(_build, "library", no_build)
    rng = np.random.default_rng(0)
    pairs = [(torch.as_tensor(_rand(rng, 50, H)),
              torch.as_tensor(_rand(rng, 50, d))) for d in (64, 17)]
    before = weight_grad.xtd_sum.launches
    for g, w in zip(weight_grad.xtd_sum(pairs),
                    weight_grad.xtd_sum_plain(pairs)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    meta = [(x.to("meta"), d.to("meta")) for x, d in pairs]
    with pytest.raises(ValueError, match="CPU or CUDA"):
        weight_grad.xtd_sum(meta)
    assert weight_grad.xtd_sum.launches == before


def _decoder_case(K, B=2, d_out=9, n_virt=40, n_ge=33, n_send=30, seed=0):
    """Random decoder inputs with padding slots (mask 0) and padding
    virtual rows (n_ge < n_virt), as tensors."""
    rng = np.random.default_rng(seed + K)
    W = B * H
    mask = (rng.random((n_virt, K)) < 0.8).astype(np.float32)
    mask[:, 0] = 1.0

    def mk(*shape):
        return _rand(rng, *shape, scale=0.1)

    pp = {k: mk(H, H) for k in ("w_i", "w2", "enc_w0", "enc_w1", "a_w1",
                                "o_w0")}
    pp.update({k: mk(H) for k in grid_update._VECS})
    for k in ("enc_ls", "e_ls", "a_ls"):
        pp[k] = 1.0 + pp[k]
    pp.update(a_w0=mk(2 * H, H), o_w1=mk(H, d_out), o_b1=mk(d_out))
    args = (_rand(rng, n_send, W),
            rng.integers(0, n_send, n_virt * K).astype(np.int32),
            _rand(rng, n_virt * K, H), _rand(rng, n_ge, W), mask)
    t = [torch.as_tensor(a) for a in args]
    return t + [{k: torch.as_tensor(v) for k, v in pp.items()},
                torch.as_tensor(_rand(rng, n_virt, B * d_out, scale=1.0))]


@pytest.mark.parametrize("K", [1, 4, 8])
def test_grid_update_bwd_composition_matches_autograd(K):
    """The CPU route of `grid_update_flat_bwd` (chain plain + xtd_sum_plain
    + assembly) against `grid_update_flat_bwd_plain`: d_x0, d_ew, d_ge and
    the 21 parameter gradients."""
    args = _decoder_case(K)
    got = grid_update.grid_update_flat_bwd(*args)
    want = grid_update.grid_update_flat_bwd_plain(*args)
    assert list(got[3]) == list(grid_update._KEYS)
    assert sorted(got[3]) == sorted(want[3])
    named = [("d_x0", got[0], want[0]), ("d_ew", got[1], want[1]),
             ("d_ge", got[2], want[2])]
    named += [(k, got[3][k], want[3][k]) for k in grid_update._KEYS]
    assert len(named) == 24
    for name, g, w in named:
        assert g.shape == w.shape, (name, g.shape, w.shape)
        tol = 1e-5 + 1e-5 * float(w.abs().max())
        err = float((g - w).abs().max())
        assert err <= tol, f"{name}: max abs diff {err:.3e} > {tol:.3e}"


def test_chain_scratch_pairs_have_the_kernel_layout():
    """The chain's pairs, as the kernel writes them: node rows v*B + b,
    slot rows (v*K + k)*B + b, ge over its real rows, d_out d_out wide;
    and padding slots get a zero DX2 row."""
    K, B, n_virt, n_ge = 4, 2, 40, 33
    args = _decoder_case(K, B=B, n_virt=n_virt, n_ge=n_ge)
    pairs = grid_update.grid_update_bwd_chain_plain(*args)[4]
    names = [p[0] for p in grid_update._PAIRS]
    shapes = {n: (tuple(x.shape), tuple(d.shape))
              for n, (x, d) in zip(names, pairs)}
    node, slot = (n_virt * B, H), (n_virt * K * B, H)
    assert shapes["enc_w0"] == ((n_ge * B, H), (n_ge * B, H))
    assert shapes["w2"] == (slot, slot)
    assert shapes["o_w1"] == (node, (n_virt * B, 9))
    for n in ("enc_w1", "w_i", "a_wr", "a_wa", "a_w1", "o_w0"):
        assert shapes[n] == (node, node), n
    x1, dx2 = pairs[names.index("w2")]
    mask = args[4]
    pad = (mask == 0).reshape(-1).repeat_interleave(B)
    assert pad.any()
    assert bool((dx2[pad] == 0).all()) and bool((x1[pad] != 0).any())
    # X1 = silu(table[senders] + ew + rec): slot (v, k) of batch b
    table, senders, ew = args[0], args[1], args[2]
    v, k, b = 7, 2, 1
    s = int(senders[v * K + k])
    x1_vkb = x1[(v * K + k) * B + b]
    rec_free = table[s, b * H:(b + 1) * H] + ew[v * K + k]
    gr = pairs[names.index("w_i")][0][v * B + b]
    rec = gr @ args[5]["w_i"]
    torch.testing.assert_close(x1_vkb, torch.nn.functional.silu(
        rec_free + rec), rtol=1e-5, atol=1e-6)
