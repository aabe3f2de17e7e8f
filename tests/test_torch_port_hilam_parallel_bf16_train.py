"""The port's bf16 HiLAMParallel training path against the JAX package's,
on the CPU: the tests of test_torch_port_bf16_train_models.py (its module
doc gives the reference, the limits and why) on the mixed route, in a
file of their own so that the test workers share the interpret-mode runs.

A 30x30 DummyDatastore gives a two-level hierarchy (81 and 9 mesh nodes,
4 chunks), hidden 64, 2 processor layers, at batch 2 with
`_FLAT_MIN_VIRT` at 100 on both sides: K1-K4 and B1-B6 for the grid
side, K3 and B3/B4 on the m2m[0] and down[0] chunks and in the read-out,
P1 with its messages on the m2m[1] and up[0] chunks (its backward
recomputed through its reference math on fp32 x0, as the JAX VJP does),
P3 in the mesh-init round. The JAX reference's batched-route VJPs take
their cotangents widened (`batched_reference`).
"""

import pytest

from .test_torch_port_hilam_parallel import one_torch_thread  # noqa: F401
from .test_torch_port_bf16_models import build_models
from .test_torch_port_bf16_train_models import (
    check_round_grads,
    run_case,
    test_bf16_training_gradient_matches_jax as check_gradient,
)

# case -> (batch, _FLAT_MIN_VIRT on both sides, rounds recorded: the
# mesh-init and read-out rounds at 2 levels)
CASES = {"hi_lam_parallel-mixed": (2, 100, 2)}


@pytest.fixture(scope="module")
def hlp(tmp_path_factory):
    return build_models(tmp_path_factory, "hi_lam_parallel", 30)


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request, hlp):
    B, min_virt, _ = CASES[request.param]
    jm, params, tm = hlp
    return request.param, run_case(jm, params, tm, B, min_virt)


def test_bf16_training_rounds_match_jax(case):
    """Each interaction-net round's VJP on JAX's recorded inputs and
    cotangents, every round of the step recorded."""
    sends = [w for w, name, *_ in case[1]["rounds"] if name == "send"]
    assert len(sends) == CASES[case[0]][2], sends
    check_round_grads(case[1]["rounds"])


def test_bf16_training_gradient_matches_jax(case):
    """The whole training_loss gradient of a bf16 HiLAMParallel, by
    size."""
    check_gradient(case)
