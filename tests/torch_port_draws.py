"""The JAX package's sampling draws, replayed for the port's cores, and
the port's own draws made on the CPU for a run on the card.

``cugraph_tpu_torch.algos.sampling`` takes its random numbers from a
``Draws`` object; these classes have the same methods and give, in the
same order, the numbers that ``cugraph_tpu.algos.sampling`` draws from
``jax.random`` for the same ``random_state``, so the tests can compare the
two packages bit for bit.  Shared by the port's sampling, walk and
minibatch tests.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from cugraph_tpu_torch.algos.sampling import Draws


@jax.jit
def _gumbel_tile(key, u_shape_ref):
    u = jax.random.uniform(key, u_shape_ref.shape, minval=1e-20, maxval=1.0)
    return -jnp.log(-jnp.log(u))


class JaxKeyDraws:
    """One hop's draws from one subkey, as the JAX package's samplers use
    it (sampling.py:88-125, 309, 361)."""

    def __init__(self, key):
        self.key = key

    def uniform(self, shape, low=0.0, high=1.0):
        return torch.from_numpy(np.array(jax.random.uniform(
            self.key, shape, minval=low, maxval=high)))

    def gumbel(self, shape):
        return torch.from_numpy(np.array(_gumbel_tile(
            self.key, jnp.zeros(shape, jnp.float32))))

    def seed(self):
        return int(np.asarray(jax.random.key_data(self.key)).reshape(-1)[-1])


class JaxDraws:
    """``split()`` as ``key, sub = jax.random.split(key)``: once per hop
    for the homogeneous samplers, and once per hop and edge type with a
    nonzero fanout, "last" included, for the masked ones
    (sampling.py:1030-1043), which call it in that order on their tile
    route; ``splits`` counts the calls.  ``randint_pair`` as
    ``negative_sampling``'s three-way split per attempt
    (sampling.py:829-851)."""

    def __init__(self, random_state):
        self.key = jax.random.PRNGKey(
            0 if random_state is None else int(random_state))
        self.splits = 0

    def split(self):
        self.key, sub = jax.random.split(self.key)
        self.splits += 1
        return JaxKeyDraws(sub)

    def randint_pair(self, m, high):
        self.key, k1, k2 = jax.random.split(self.key, 3)
        return (np.asarray(jax.random.randint(k1, (m,), 0, high)),
                np.asarray(jax.random.randint(k2, (m,), 0, high)))


def walk_uniforms(random_state, depth, walkers):
    """float32 [depth, W]: the u of each step of the JAX package's walk
    scans (``k, sub = split(k)``; ``uniform(sub, (W,))``)."""
    k = jax.random.PRNGKey(0 if random_state is None else int(random_state))
    rows = []
    for _ in range(depth):
        k, sub = jax.random.split(k)
        rows.append(np.asarray(jax.random.uniform(sub, (walkers,))))
    return torch.from_numpy(np.stack(rows) if rows else
                            np.zeros((0, walkers), np.float32))


class CpuDraws(Draws):
    """The port's draws made by the CPU generator and moved to ``device``,
    so that the card and the CPU see the same numbers (the CUDA generator
    draws another stream)."""

    def __init__(self, random_state, device):
        super().__init__(random_state, "cpu")
        self.target = torch.device(device)

    def uniform(self, shape, low=0.0, high=1.0):
        return super().uniform(shape, low, high).to(self.target)

    def edge_gumbel(self, n):
        return super().edge_gumbel(n).to(self.target)
