"""The port's bf16 HiLAM against the JAX package's, on the CPU: the HiLAM
cases of test_torch_port_bf16_models.py (its module doc gives the
reference, the limits and why), in a file of their own so that the test
workers share the interpret-mode runs.

A 30x30 DummyDatastore gives a two-level hierarchy (81 and 9 mesh nodes),
hidden 64, 2 processor layers: at batch 1 the batched route end to end
(P2 for g2m and m2g, P3 for every mesh round, P1 in fp32 for the
read-out); at batch 2 with `_FLAT_MIN_VIRT` at 100 on both sides, the
mixed route (K1-K4 for the grid side, K3 on m2m[0] and down[0], P3 on
m2m[1] and up[0]).
"""

import pytest

from neural_lam_tpu_torch.ops import message_passing as tmp

from .test_torch_port_bf16_models import (
    build_models,
    check_output,
    check_rounds,
    run_case,
)

# case -> (batch, _FLAT_MIN_VIRT on both sides or None, rounds recorded:
# 1 init, 12 processor and 1 read-out round at 2 levels, and on the
# batched route the g2m and m2g rounds, which the flat-grid route runs
# as K2 and K4)
CASES = {"hi_lam-batched": (1, None, 16), "hi_lam-mixed": (2, 100, 14)}


@pytest.fixture(scope="module")
def hi_lam(tmp_path_factory):
    return build_models(tmp_path_factory, "hi_lam", 30)


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request, hi_lam):
    B, min_virt, _ = CASES[request.param]
    jm, params, tm = hi_lam
    return request.param, run_case(jm, params, tm, B, min_virt)


def test_bf16_rounds_match_jax_on_its_inputs(case):
    """Each interaction-net round of the JAX bf16 predict step, on its
    own inputs, against the port's."""
    assert len(case[1]["rounds"]) == CASES[case[0]][2]
    check_rounds(case[1])


def test_bf16_predict_step_matches_jax(case):
    """One bf16 predict step: the port's bf16 error has JAX's size, and
    it is bf16."""
    check_output(case[1], 0, f"{case[0]} predict step")


def test_bf16_rollout_matches_jax(case):
    """A 3-step bf16 rollout with boundary overwrite, as the step."""
    check_output(case[1], 1, f"{case[0]} 3-step rollout")


def test_bf16_mixed_route_takes_both_kernel_families(hi_lam):
    """At batch 2 with the threshold at 100, the grid side and the large
    sets are flat, the small ones batched."""
    g = hi_lam[2]["bfloat16"].graph
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tmp, "_FLAT_MIN_VIRT", 100)
        flat = {name: [tmp.flat_eligible(es, 2, 64) for es in getattr(g, name)]
                for name in ("m2m", "up", "down")}
        assert hi_lam[2]["bfloat16"]._flat_grid_eligible(2)
    assert flat == {"m2m": [True, False], "up": [False], "down": [True]}
    assert not any(tmp.flat_eligible(es, 1, 64)
                   for name in ("m2m", "up", "down") for es in getattr(g, name))
