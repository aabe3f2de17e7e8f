"""The port's bf16 HiLAM training path against the JAX package's, on the
CPU: the HiLAM cases of test_torch_port_bf16_train_models.py (its module
doc gives the reference, the limits and why), one a file, so that the
test workers share the interpret-mode runs.

A 30x30 DummyDatastore gives a two-level hierarchy (81 and 9 mesh nodes),
hidden 64, 2 processor layers. Here, at batch 1, the batched route end to
end (P2 for g2m and m2g, P3 for every mesh round, P1 in fp32 for the
read-out, each backward recomputed on its residuals); at batch 2 with
`_FLAT_MIN_VIRT` at 100, the mixed route, in
test_torch_port_bf16_train_hilam_mixed.py.
"""

import pytest

from .test_torch_port_bf16_models import build_models
from .test_torch_port_bf16_train_models import (
    check_round_grads,
    run_case,
    test_bf16_training_gradient_matches_jax as check_gradient,
)

# case -> (batch, _FLAT_MIN_VIRT on both sides or None, rounds recorded:
# 1 init, 12 processor and 1 read-out round at 2 levels, and on the
# batched route the g2m and m2g rounds, which the flat-grid route runs
# as K2 and K4)
CASES = {"hi_lam-batched": (1, None, 16)}


@pytest.fixture(scope="module")
def hi_lam(tmp_path_factory):
    return build_models(tmp_path_factory, "hi_lam", 30)


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request, hi_lam):
    B, min_virt, _ = CASES[request.param]
    jm, params, tm = hi_lam
    return request.param, run_case(jm, params, tm, B, min_virt)


def test_bf16_training_rounds_match_jax(case):
    """Each interaction-net round's VJP on JAX's recorded inputs and
    cotangents, every round of the step recorded."""
    sends = [w for w, name, *_ in case[1]["rounds"] if name == "send"]
    assert len(sends) == CASES[case[0]][2], sends
    check_round_grads(case[1]["rounds"])


def test_bf16_training_gradient_matches_jax(case):
    """The whole training_loss gradient of a bf16 HiLAM, by size."""
    check_gradient(case)
