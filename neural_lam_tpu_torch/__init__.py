"""neural_lam_tpu_torch — the PyTorch/CUDA port of `neural_lam_tpu`.

Same module layout and names as the JAX package, so each module's
counterpart is found by path (`ops/edge_flat.py` <-> `ops/pallas_edge_flat.py`).
Plain tensor code is PyTorch; every Pallas kernel on the ported path is a
CUDA C++ kernel for Hopper (`csrc/*.cu`), built with nvcc at first use and
bound with ctypes (`ops/_build.py`). On a CPU tensor each kernel wrapper
runs its plain PyTorch version instead; on a CUDA tensor it launches the
kernel or raises.

This package imports nothing of JAX or of `neural_lam_tpu`.
"""

__version__ = "0.1.0"
