"""The latent families under the mesh-node-sharded schemes over two rank
processes against the JAX package's `spatialize_rs` (the cases of its
`test_latent_sharded_matches`), on the CPU, as
tests/test_torch_port_parallel_rs_models.py holds the others (its
helpers, limits and inputs):

* GraphEFM on a 30x28 grid under mesh_rs and mesh_halo, HiEFM (2 levels)
  on it under mesh_halo, and HiEFM on the 24x12 global grid (an
  icosahedral mesh at 2 refinements in 2 levels, whose polar g2m
  receivers take edges from both ranks' grid blocks) under mesh_rs;
  hidden 64, one processor layer, batch 2, latent width 8. From given
  noise and target: the one-step prediction and the KL within 1e-4 of
  JAX's, the mean square of the prediction plus the mean KL within 1e-5
  relative, its gradients within 5e-4 x max abs per parameter. The
  port's noise is the whole mesh's draw, each rank keeping its owned
  rows; JAX is given the same draw zero-padded to its padded rows, and
  its KL is cut to the mesh's rows, as the port's is.
"""

import pytest

from .latent_helpers import one_torch_thread  # noqa: F401 (autouse)
from .test_torch_port_parallel_rs_models import (
    check_case,
    rank_and_jax_results,
)

CASES = ["graph_efm:rs", "graph_efm:halo", "hi_efm:halo", "hi_efm_global:rs"]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    out = tmp_path_factory.mktemp("latent_ranks")
    return rank_and_jax_results(out, CASES)


@pytest.mark.parametrize("case", CASES)
def test_latent_model_matches_jax_spatialize_rs(case, results):
    check_case(case, *results[:2])
