"""The port stands alone and never runs on the CPU unless asked to.

* No module of `neural_lam_tpu_torch/`, and not `chip_smoke.py`, imports
  JAX, optax or the JAX package; `convert_jax_checkpoint.py` imports JAX
  and orbax but nothing of the JAX package.
* Entry points default to CUDA and raise without it.
* Each kernel wrapper, forward and backward, takes its plain version only
  for CPU tensors, and counts a launch only when it launches its kernel.
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from neural_lam_tpu_torch.ops import _build, edge_flat, embed, grid_update

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "optax", "neural_lam_tpu")


def _port_files():
    files = sorted((ROOT / "neural_lam_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax():
    assert (ROOT / "chip_smoke.py").exists()
    names = {str(p.relative_to(ROOT)) for p in _port_files()}
    for serving in ("predict.py", "torch_compat.py", "datastore/mdp.py",
                    "datastore/npyfilesmeps.py", "datastore/zarr_reader.py",
                    "graph/torch_io.py"):
        assert f"neural_lam_tpu_torch/{serving}" in names, serving
    for evaluation in ("vis.py", "projections.py", "datastore/plot_example.py",
                       "native/__init__.py", "train.py"):
        assert f"neural_lam_tpu_torch/{evaluation}" in names, evaluation
    for tool in ("datastore/create_dataset.py",
                 "datastore/compute_standardization_stats.py"):
        assert f"neural_lam_tpu_torch/{tool}" in names, tool
    bad = []
    for path in _port_files():
        for name in _imports(path):
            if any(name == f or name.startswith(f + ".") for f in FORBIDDEN):
                bad.append(f"{path.relative_to(ROOT)}: {name}")
    assert not bad, bad


def test_convert_script_imports_no_jax_package():
    names = list(_imports(ROOT / "convert_jax_checkpoint.py"))
    assert "jax" in names and "orbax.checkpoint" in names
    bad = [n for n in names
           if n == "neural_lam_tpu" or n.startswith("neural_lam_tpu.")]
    assert not bad, bad


def test_build_model_defaults_to_cuda_and_raises_without_it():
    from neural_lam_tpu_torch.entry import build_model

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_model(nx=9, ny=9, processor_layers=1)


def _calls():
    """(wrapper, args builder) for each kernel wrapper, at a tiny shape."""
    rng = np.random.default_rng(0)
    h, B, n_virt, K, n_send = 64, 2, 4, 2, 5
    W = B * h

    def r(*shape):
        return torch.as_tensor(rng.standard_normal(shape).astype(np.float32))

    senders = torch.as_tensor(rng.integers(0, n_send, n_virt * K),
                              dtype=torch.int32)
    mask = torch.ones(n_virt, K)
    pp = {k: r(h, h) for k in ("w_i", "w2", "enc_w0", "enc_w1", "a_w1",
                               "o_w0")}
    pp.update({k: r(h) for k in grid_update._VECS})
    pp.update(a_w0=r(2 * h, h), o_w1=r(h, 3), o_b1=r(3))
    return [
        (embed.embed_grid_flat,
         lambda: (r(6, B * 7), r(7, h), r(h), r(h, h), r(h), r(h), r(h), B)),
        (edge_flat.edge_tail_sum_flat,
         lambda: (r(n_send, W), senders, r(n_virt * K, h), r(n_virt, W),
                  mask, r(h, h), r(h), r(h), r(h))),
        (edge_flat.edge_layer_flat,
         lambda: (r(n_virt * K, W), r(n_send, W), senders, r(n_virt, W),
                  mask, r(h, h), r(h), r(h, h), r(h), r(h), r(h))),
        (grid_update.grid_update_flat,
         lambda: (r(n_send, W), senders, r(n_virt * K, h), r(3, W), mask,
                  pp)),
    ]


@pytest.mark.parametrize("index", range(4))
def test_wrapper_takes_plain_version_on_cpu(index, monkeypatch):
    """A CPU tensor runs the plain version (identical result), builds and
    launches nothing; a tensor on another non-CUDA device raises."""
    def no_build(*a, **kw):
        raise AssertionError("kernel library requested for a CPU tensor")

    monkeypatch.setattr(_build, "library", no_build)
    wrapper, make_args = _calls()[index]
    plain = getattr(__import__(wrapper.__module__, fromlist=["x"]),
                    wrapper.__name__ + "_plain")
    args = make_args()
    before = wrapper.launches
    got = wrapper(*args)
    want = plain(*args)
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert wrapper.launches == before

    meta_args = [a.to("meta") if isinstance(a, torch.Tensor) else a
                 for a in args]
    with pytest.raises(ValueError, match="CPU or CUDA"):
        wrapper(*meta_args)
    assert wrapper.launches == before


def test_train_entry_points_default_to_cuda_and_raise_without_it(tmp_path):
    """entry.train_steps and the training CLI default to CUDA."""
    from neural_lam_tpu_torch import train
    from neural_lam_tpu_torch.entry import build_model, train_steps

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    model, ds = build_model(nx=9, ny=9, processor_layers=1, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_steps(model, ds, batch_size=2, steps=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(["--config_path", str(tmp_path / "config.yaml")])


def _bwd_calls():
    """(backward wrapper, args) for each kernel wrapper, at a tiny shape:
    the forward's arguments followed by the output cotangents."""
    rng = np.random.default_rng(1)
    out = []
    for wrapper, make_args in _calls():
        args = make_args()
        fwd = getattr(__import__(wrapper.__module__, fromlist=["x"]),
                      wrapper.__name__ + "_plain")(*args)
        cts = [torch.as_tensor(rng.standard_normal(o.shape).astype(
            np.float32)) for o in (fwd if isinstance(fwd, tuple) else (fwd,))]
        bwd = getattr(__import__(wrapper.__module__, fromlist=["x"]),
                      wrapper.__name__ + "_bwd")
        out.append((bwd, tuple(args) + tuple(cts)))
    return out


@pytest.mark.parametrize("index", range(4))
def test_bwd_wrapper_takes_plain_version_on_cpu(index, monkeypatch):
    """A backward wrapper on CPU tensors returns exactly its *_bwd_plain,
    builds and launches nothing; a tensor on another device raises."""
    def no_build(*a, **kw):
        raise AssertionError("kernel library requested for a CPU tensor")

    monkeypatch.setattr(_build, "library", no_build)
    wrapper, args = _bwd_calls()[index]
    plain = getattr(__import__(wrapper.__module__, fromlist=["x"]),
                    wrapper.__name__ + "_plain")
    before = wrapper.launches
    got, want = wrapper(*args), plain(*args)
    if isinstance(got[-1], dict):
        assert sorted(got[-1]) == sorted(want[-1])
        got = got[:-1] + tuple(got[-1][k] for k in sorted(want[-1]))
        want = want[:-1] + tuple(want[-1][k] for k in sorted(want[-1]))
    for g, w in zip(got, want):
        if g is not None or w is not None:
            torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert wrapper.launches == before
    meta_args = [a.to("meta") if isinstance(a, torch.Tensor) else a
                 for a in args]
    with pytest.raises(ValueError, match="CPU or CUDA"):
        wrapper(*meta_args)
    assert wrapper.launches == before


def test_bfloat16_compute_is_not_ported_yet():
    from neural_lam_tpu_torch.entry import build_model

    with pytest.raises(NotImplementedError, match="bfloat16"):
        build_model(nx=9, ny=9, processor_layers=1, device="cpu",
                    compute_dtype="bfloat16")
