"""The mesh_halo scheme over two rank processes against the JAX
package's `spatialize_rs(model, make_mesh(n_data=1, n_space=2),
halo=True)`, on the CPU, as tests/test_torch_port_parallel_rs_models.py
holds mesh_rs (its helpers, limits and inputs):

* GraphLAM, HiLAM and HiLAMParallel (2 levels) on a 30x28 grid, hidden
  64, one processor layer, batch 2: the one-step prediction within 1e-4
  of JAX's, the training loss of a 2-step unroll within 1e-5 relative,
  its gradients within 5e-4 x max abs per parameter. Each edge set whose
  senders the other rank owns reads them through the cut-edge halo
  (ppermute rounds of the referenced rows), the g2m partial sums of the
  other rank's rows are pushed to it, and the split sets run their
  interior and frontier rounds on the interior's route;
* a bf16 GraphLAM under mesh_halo: its bf16 error against the fp32
  prediction within 0.9-1.1x of the unsharded bf16 model's.
"""

import pytest

from .latent_helpers import one_torch_thread  # noqa: F401 (autouse)
from .test_torch_port_parallel_rs_models import (
    check_bf16,
    check_case,
    rank_and_jax_results,
)

CASES = ["graph_lam:halo", "hi_lam:halo", "hi_lam_parallel:halo"]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    out = tmp_path_factory.mktemp("halo_ranks")
    return rank_and_jax_results(out, CASES + ["graph_lam_bf16:halo"])


@pytest.mark.parametrize("case", CASES)
def test_halo_model_matches_jax_spatialize_rs(case, results):
    check_case(case, *results[:2])


def test_halo_bf16_error_size(results):
    check_bf16("graph_lam_bf16:halo", results[0])
