"""simvg_tpu_torch.ops.hungarian held against simvg_tpu.ops.hungarian.

The port solves on the host with the JAX solver's algorithm step for step,
in float32 with the same first-index tie rule, so the two packages must
return the SAME assignment, not only one of equal cost: random, rectangular,
invalid-column and tied costs (the adversarial cases of
tests/test_hungarian.py), each batched as the criterion calls it.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from simvg_tpu.ops.hungarian import hungarian_assign as jax_assign
from simvg_tpu_torch.ops.hungarian import hungarian_assign


def _costs(kind, rng):
    if kind == "random":
        return rng.uniform(0, 1, (6, 10, 10)).astype(np.float32), None
    if kind == "rectangular":
        return rng.normal(size=(5, 10, 3)).astype(np.float32), None
    if kind == "invalid_columns":
        valid = rng.uniform(size=(7, 4)) < 0.6
        valid[0] = False  # a sample with no target at all
        return rng.uniform(0, 1, (7, 10, 4)).astype(np.float32), valid
    if kind == "ties":
        cost = np.zeros((3, 4, 4), np.float32)  # all ties
        cost[1, :3, :3] = [[1, 1, 1], [1, 1, 1], [0, 0, 5]]
        cost[2] = np.round(rng.uniform(0, 2, (4, 4)))  # many equal entries
        return cost, None
    if kind == "single":  # the flagship's problem: one query, one target
        return rng.normal(size=(32, 1, 1)).astype(np.float32), None
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["random", "rectangular", "invalid_columns",
                                  "ties", "single"])
def test_assignment_matches_jax(kind):
    cost, valid = _costs(kind, np.random.default_rng(0))
    b, n, m = cost.shape
    if valid is None:
        valid = np.ones((b, m), bool)
    c4r_j, r4c_j = jax.vmap(jax_assign)(jnp.asarray(cost), jnp.asarray(valid))
    before = hungarian_assign.round_trips
    c4r, r4c = hungarian_assign(torch.from_numpy(cost),
                                torch.from_numpy(valid))
    assert hungarian_assign.round_trips == before + 1  # the whole batch
    np.testing.assert_array_equal(c4r.numpy(), np.asarray(c4r_j))
    np.testing.assert_array_equal(r4c.numpy(), np.asarray(r4c_j))
    assert (r4c.numpy()[~valid] == -1).all()


def test_leading_layer_dims_solve_independently():
    rng = np.random.default_rng(1)
    cost = rng.uniform(size=(3, 4, 5, 2)).astype(np.float32)  # [L, B, Q, T]
    c4r, r4c = hungarian_assign(torch.from_numpy(cost))
    for layer in range(3):
        c, r = hungarian_assign(torch.from_numpy(cost[layer]))
        torch.testing.assert_close(c4r[layer], c)
        torch.testing.assert_close(r4c[layer], r)


def test_more_targets_than_queries_raises():
    with pytest.raises(ValueError, match="rows >= cols"):
        hungarian_assign(torch.zeros(2, 3))
