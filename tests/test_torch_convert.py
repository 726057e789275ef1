"""simvg_tpu_torch.convert's copy of the exporter held to the original.

The port keeps a numpy-only copy of ``tools/convert_checkpoint.py``'s
``export_simvg_full`` (and its helpers) so that it imports nothing of the
JAX side.  The copy must map every parameter tree exactly as the original:
same keys, same arrays, bit for bit.
"""

import numpy as np
import jax

from tools.convert_checkpoint import export_simvg_full as original
from util_torch_port import jax_tiny_model, np_batch, to_jax


def _random_tree(seed):
    """A param tree of the tiny model's structure, filled from numpy."""
    shapes = jax.eval_shape(jax_tiny_model().init, jax.random.PRNGKey(0),
                            **to_jax(np_batch()))
    r = np.random.default_rng(seed)
    return jax.tree.map(
        lambda s: r.normal(size=s.shape).astype(np.float32), shapes)


def test_export_copy_matches_the_original_key_for_key():
    from simvg_tpu_torch.convert import export_simvg_full

    tree = _random_tree(0)
    ours, theirs = export_simvg_full(tree), original(tree)
    assert sorted(ours) == sorted(theirs)
    assert len(ours) > 100
    for k in theirs:
        assert ours[k].shape == theirs[k].shape, k
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)


def test_export_names_every_port_parameter():
    from simvg_tpu_torch.convert import export_simvg_full
    from util_torch_port import torch_tiny_model

    sd = export_simvg_full(_random_tree(1))
    model = torch_tiny_model()
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert {k: v.shape for k, v in sd.items()} == shapes
