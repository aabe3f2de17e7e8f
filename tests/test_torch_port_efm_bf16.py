"""GraphEFM's bf16 path (compute_dtype="bfloat16") against the JAX
package's, on the CPU, with JAX's noise replayed into the port.

The reference is the JAX package with its Pallas kernels in interpret
mode and the accelerator's casts emulated (`jax_reference` of
test_torch_port_bf16_models.py), its programs compiled with XLA's excess
precision off (`strict`, test_torch_port_bf16_train_models.py). GraphEFM
on a 16x16 LAM DummyDatastore, hidden 64, 1 processor layer, latent_dim
32, the port's seeded weights on both sides, on the flat route
(`_FLAT_MIN_VIRT` = 1 on both sides, batch 2): K1-K4 and K2 on the
prior's and posterior's m2m[0] and the posterior's g2m, in their bf16
instances on the card.

bf16 outputs are chaotic (one last-bit difference flips a rounding and
spreads, test_torch_port_bf16_models.py), so both checks hold the size of
the error, as the GraphLAM and HiLAM bf16 tests do (`check_size`): the
port's bf16 error against the JAX fp32 values has the size of JAX's own
bf16 error (mean abs within 0.9-1.1x, max abs within 0.5-1.5x), and the
port's bf16-vs-fp32 gap is at least half of JAX's (a path that stayed
fp32 fails). The heads' softplus, the KL and z = mu + sigma * eps (fp32
eps promotes the bf16 heads, and `latent_map` rounds z again) are where
this model adds rounding sites to GraphLAM's.

* One predict step sampled from the posterior given a target: the output
  and the KL.
* The ELBO's gradient (ar_steps 1) over 3 seeded batches, each parameter
  over its fp32 max abs, all together.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_lam_tpu.config import (
    DatastoreSelection as JDatastoreSelection,
    NeuralLAMConfig as JNeuralLAMConfig,
)
from neural_lam_tpu.datastore.dummy import DummyDatastore as JDummyDatastore
from neural_lam_tpu.graph.build import create_graph as j_create_graph
from neural_lam_tpu.graph.storage import graph_from_bundle as j_graph_from_bundle
from neural_lam_tpu.models import MODELS as J_MODELS
from neural_lam_tpu.models.ar_model import ModelArgs as JModelArgs
from neural_lam_tpu_torch.config import DatastoreSelection, NeuralLAMConfig
from neural_lam_tpu_torch.convert import params_from_jax
from neural_lam_tpu_torch.datastore.dummy import DummyDatastore
from neural_lam_tpu_torch.graph.build import create_graph
from neural_lam_tpu_torch.graph.storage import graph_from_bundle
from neural_lam_tpu_torch.models import MODELS
from neural_lam_tpu_torch.models.ar_model import ModelArgs
from neural_lam_tpu_torch.ops import message_passing as tmp

from .latent_helpers import (  # noqa: F401 (one_torch_thread: autouse)
    jax_params_from_port,
    one_torch_thread,
    replay,
    split_draws,
)
from .test_torch_port_bf16_models import jax_reference
from .test_torch_port_bf16_train_models import check_size, normalized, strict

B, D_Z, N_BATCHES = 2, 32, 3
DTYPES = (None, "bfloat16")


@pytest.fixture(scope="module")
def efm(tmp_path_factory):
    """(JAX models by dtype, JAX params, port models by dtype)."""
    jds = JDummyDatastore(grid_shape=(16, 16), n_timesteps=10)
    tds = DummyDatastore(grid_shape=(16, 16), n_timesteps=10)
    jg = j_graph_from_bundle(j_create_graph(
        str(tmp_path_factory.mktemp("jg")), jds.get_xy("state", stacked=False),
        n_max_levels=None, hierarchical=False))
    tg = graph_from_bundle(create_graph(
        str(tmp_path_factory.mktemp("tg")), tds.get_xy("state", stacked=False),
        n_max_levels=None, hierarchical=False), device="cpu")
    jm = {cd: J_MODELS["graph_efm"](
        JModelArgs(hidden_dim=64, processor_layers=1, latent_dim=D_Z,
                   compute_dtype=cd),
        JNeuralLAMConfig(datastore=JDatastoreSelection("dummydata", "")), jds,
        jg) for cd in DTYPES}
    tm = {cd: MODELS["graph_efm"](
        ModelArgs(hidden_dim=64, processor_layers=1, latent_dim=D_Z,
                  compute_dtype=cd),
        NeuralLAMConfig(datastore=DatastoreSelection("dummydata", "")), tds,
        tg, device="cpu", generator=torch.Generator().manual_seed(4))
        for cd in DTYPES}
    tm["bfloat16"].load_state_dict(tm[None].state_dict())
    return jm, jax_params_from_port(jm[None], tm[None]), tm


def _batch(tm, seed):
    rng = np.random.default_rng(seed)
    n, d = tm.num_grid_nodes, tm.num_state_vars
    return (rng.standard_normal((B, 2, n, d)).astype(np.float32),
            rng.standard_normal((B, 1, n, d)).astype(np.float32),
            rng.standard_normal((B, 1, n, tm.num_forcing_vars * 3))
            .astype(np.float32),
            np.zeros((B, 1), np.int32))


def test_bf16_posterior_step_and_kl_match_jax(efm):
    jm, params, tm = efm
    init, target, forcing, _ = _batch(tm[None], 0)
    eps = np.random.default_rng(1).standard_normal(
        (B, tm[None].latent_num_nodes, D_Z)).astype(np.float32)
    ji = [jnp.asarray(a) for a in (init, target, forcing, eps)]

    def jax_step(model):
        def step(params):
            ctx = {**model.precompute_rollout_ctx(params),
                   "latent_eps": ji[3], "latent_target": ji[1][:, 0]}
            out, _ = model.predict_step(params, ji[0][:, 1], ji[0][:, 0],
                                        ji[2][:, 0], ctx=ctx)
            return out, ctx["_latent_kl"].astype(jnp.float32)
        return [np.asarray(a, np.float32)
                for a in strict(step, params)(params)]

    with jax_reference("off", 1):
        j32 = jax_step(jm[None])
    with jax_reference("interpret", 1):
        assert tmp.flat_eligible(tm["bfloat16"].graph.m2m[0], B, 64)
        j16 = jax_step(jm["bfloat16"])
        got = {}
        for cd in DTYPES:
            t = [torch.as_tensor(a) for a in (init, target, forcing, eps)]
            with torch.no_grad():
                ctx = {**tm[cd].precompute_rollout_ctx(),
                       "latent_eps": t[3], "latent_target": t[1][:, 0]}
                out, _ = tm[cd].predict_step(t[0][:, 1], t[0][:, 0],
                                             t[2][:, 0], ctx)
            got[cd] = [out.float().numpy(),
                       ctx["_latent_kl"].float().numpy()]
    for i, what in enumerate(("posterior step", "KL")):
        check_size(got["bfloat16"][i], j16[i], j32[i], got[None][i],
                   f"GraphEFM bf16 {what}")


def test_bf16_elbo_gradient_matches_jax(efm):
    jm, params, tm = efm
    batches = [_batch(tm[None], 10 + i) for i in range(N_BATCHES)]
    keys = [jax.random.PRNGKey(20 + i) for i in range(N_BATCHES)]
    jbs = [tuple(jnp.asarray(a) for a in b) for b in batches]

    def grads_of(g):
        return {n: v.numpy() for n, v in params_from_jax(
            jax.tree.map(np.asarray, g)).items()}

    out = {}
    with jax_reference("off", 1):
        g = strict(jax.grad(jm[None].training_loss), params, jbs[0], keys[0])
        out["jax", None] = [grads_of(g(params, jb, k))
                            for jb, k in zip(jbs, keys)]
    with jax_reference("interpret", 1) as mp:
        g = strict(jax.grad(jm["bfloat16"].training_loss), params, jbs[0],
                   keys[0])
        out["jax", "bfloat16"] = [grads_of(g(params, jb, k))
                                  for jb, k in zip(jbs, keys)]
        for cd in DTYPES:
            out["port", cd] = []
            for batch, key in zip(batches, keys):
                left = replay(mp, split_draws(
                    key, 1, (B, tm[cd].latent_num_nodes, D_Z)))
                m = tm[cd]
                m.zero_grad(set_to_none=True)
                m.training_loss(tuple(torch.as_tensor(a) for a in batch),
                                generator=torch.Generator()).backward()
                assert not left
                out["port", cd].append({
                    k: p.grad.detach().numpy().copy()
                    for k, p in m.named_parameters()})
    vecs = {k: [] for k in (("port", "bfloat16"), ("jax", "bfloat16"),
                            ("jax", None), ("port", None))}
    for i, j32 in enumerate(out["jax", None]):
        scale = {k: float(np.abs(v).max()) or 1.0 for k, v in j32.items()}
        assert set(out["port", "bfloat16"][i]) == set(scale)
        for k in vecs:
            vecs[k].append(normalized(out[k][i], scale))
    check_size(*(np.concatenate(v) for v in vecs.values()),
               f"GraphEFM bf16 ELBO gradient, {N_BATCHES} batches")
