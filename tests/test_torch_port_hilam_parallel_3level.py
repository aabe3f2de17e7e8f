"""test_torch_port_hilam_parallel.py's model tests (its module doc gives
the reference and the limits) on the three-level hierarchy of an 81x81
DummyDatastore (729 / 81 / 9 mesh nodes, 7 chunks), one processor layer
(the two-level tests hold two), in a file of their own so that the test
workers share the JAX runs. The mixed route here takes `_FLAT_MIN_VIRT`
150: m2m[0], up[0] and down[0] (192-768 virtual rows) flat, the rest
batched, so that the middle level sums a flat chunk (up[0]) and two
batched ones (m2m[1], down[1]) in one accumulator.
"""

import pytest

from .test_torch_port_hilam_parallel import (  # noqa: F401
    _models,
    one_torch_thread,
    route,
    test_chunks_and_routes,
    test_edge_layout_is_checked,
    test_params_from_jax_loads_strictly,
    test_predict_step_matches_jax,
    test_processor_layer_matches_jax_on_its_inputs,
    test_training_loss_grads_match_jax,
    test_unroll_prediction_matches_jax,
)

GRIDS = {"3-level": 81}


@pytest.fixture(scope="module", params=sorted(GRIDS))
def models(request, tmp_path_factory):
    """(jax_model, jax_params, port_model) on the three-level hierarchy,
    one processor layer."""
    return _models(tmp_path_factory, GRIDS[request.param], layers=1)


@pytest.fixture
def mixed_min_virt():
    """The mixed route's threshold on this hierarchy (module doc)."""
    return 150
