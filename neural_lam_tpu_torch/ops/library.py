"""The fused forward kernels as operators of PyTorch's dispatcher.

Each forward launch site of a CUDA kernel (K1-K4, P1-P3) is one operator
of the `nlt` namespace, covering its fp32 and bf16 instances, with three
implementations, registered by the kernel's own module (`define`):

* CPU: the kernel's plain PyTorch version;
* CUDA: the kernel's launch, built at first use; a failed build or launch
  raises, and each launch is counted on its wrapper (`.launches`,
  `.launches_bf16`);
* fake (shape only): the kernel's shape checks for a CUDA tensor, then
  empty outputs of the right shapes and dtypes. It counts nothing.

The wrappers' `torch.autograd.Function`s call these operators in their
forward, so `torch.export` captures the kernels by name (`export.py`)
and an exported program runs them through the dispatcher. The operators
take tensors, ints and bools only (the wrappers keep the sender `fold`),
and return new tensors: an output that a call does not ask for is an
empty tensor. The backward kernels stay direct calls in their
`autograd.Function`s.
"""

from __future__ import annotations

import torch

NAMESPACE = "nlt"
# the operators of K1, K2, K3, K4, P1, P2 and P3
OPS = ("embed_grid_flat", "edge_tail_sum_flat", "edge_layer_flat",
       "grid_update_flat", "edge_tail", "edge_tail_sum", "edge_layer")

_LIB = torch.library.Library(NAMESPACE, "DEF")


def define(name: str, schema: str, *, cpu, cuda, fake):
    """Define the operator `nlt::<name><schema>` with its CPU, CUDA and
    fake implementations; returns it (`torch.ops.nlt.<name>`)."""
    _LIB.define(name + schema)
    _LIB.impl(name, cpu, "CPU")
    _LIB.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=_LIB)
    return getattr(getattr(torch.ops, NAMESPACE), name)


def on_card(t) -> bool:
    """For a fake implementation: whether `t` stands for a CUDA tensor,
    where the kernel's shape checks apply. Raises for any device but the
    CPU and CUDA (a meta tensor reaches the fake implementation
    directly), as the wrappers always have."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"expected a CPU or CUDA tensor, got {t.device}")
    return t.device.type == "cuda"


def load_all():
    """Register every operator of `OPS` (importing the kernels' modules,
    and nothing of the models): what a process that loads an exported
    program needs first."""
    from . import edge, edge_flat, embed, grid_update  # noqa: F401

