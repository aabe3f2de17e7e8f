"""JAX's noise replayed into the port, and the port's weights given to
the JAX package, for the latent-model and ensemble parity tests.

JAX's threefry draws cannot be reproduced in torch, and the port does not
try: every normal draw of its latent models and ensembles goes through
`neural_lam_tpu_torch.ensemble.draw_normal`. The parity tests compute the
arrays the JAX package draws by replaying its key schedule in JAX, and
hand them to the port by patching that function:

* `sample_rollout`: `key, sub = split(key)` a step, `normal(sub, ...)`;
* the ELBO's step loop: `key, k_eps = split(key)` a step, the same;
* `predict.py`: `PRNGKey(seed)` into `sample_rollout`;
* the trainer's `evaluate_ensemble`: `PRNGKey(seed + process_index)`,
  then `key, sub = split(key)` a batch into `sample_rollout`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_lam_tpu_torch import ensemble


def split_draws(key, n_steps, shape):
    """The arrays a step loop draws from `key` when each step does
    `key, sub = split(key)` and `normal(sub, shape, float32)`."""
    out = []
    for _ in range(n_steps):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(sub, shape, jnp.float32)))
    return out


def eval_draws(seed, n_batches, n_steps, shape):
    """The arrays the JAX trainer's evaluate_ensemble draws over
    `n_batches` batches of (padded) shape `shape` a step."""
    key = jax.random.PRNGKey(seed)
    out = []
    for _ in range(n_batches):
        key, sub = jax.random.split(key)
        out += split_draws(sub, n_steps, shape)
    return out


def replay(monkeypatch, arrays):
    """Patch the port's draw_normal to return `arrays` in order. A call
    that asks for fewer leading rows than the array has (a partial last
    batch, which the JAX trainer pads and the port does not) gets the
    first rows: the members of a sample are consecutive rows on both
    sides. Returns the list of arrays still to be drawn."""
    queue = list(arrays)

    def draw_normal(shape, generator):
        assert queue, "the port drew more arrays than JAX"
        a = queue.pop(0)
        assert tuple(a.shape[1:]) == tuple(shape[1:]), (a.shape, shape)
        assert a.shape[0] >= shape[0], (a.shape, shape)
        return torch.tensor(a[:shape[0]], device=generator.device)

    monkeypatch.setattr(ensemble, "draw_normal", draw_normal)
    return queue


def jax_params_from_port(jmodel, tmodel):
    """The JAX parameter pytree of `jmodel` holding the port model's
    weights (the inverse of `convert.params_from_jax`). Cheaper on the CPU
    than `init_params`, which compiles a random draw per shape."""
    state = tmodel.state_dict()
    shapes = jax.eval_shape(jmodel.init_params, jax.random.PRNGKey(0))

    def leaf(path, shape):
        key = ".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path)
        value = state[key].detach().cpu().numpy()
        assert value.shape == shape.shape, key
        return jnp.asarray(value)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


# XLA's CPU backend at its lowest optimization level: the reference's
# compile takes ~2.5x less time (the tests' largest cost), and its results
# moved by at most 2e-6 on these models
_FAST_COMPILE = {"xla_backend_optimization_level": 0,
                 "xla_llvm_disable_expensive_passes": True}


def run_compiled(fn, *args):
    """fn(*args) compiled once by XLA at its lowest optimization level."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options=_FAST_COMPILE)(*args)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's side on one thread for a module that imports this
    fixture: the suite's workers share the machine's cores, and these
    small tensors gain little from more (JAX's compiles dominate)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
