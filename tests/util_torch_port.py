"""Shared set-up for the tests that hold simvg_tpu_torch against simvg_tpu.

The tiny configuration is the one ``tests/test_converter_e2e.py`` builds
(and ``tests/fixtures/simvg_full_tiny.pth`` was made from): 64 px,
patch 16, D=32, 4 heads, 2 layers.  Inputs are made with numpy from a
fixed seed and handed to both packages.
"""

from __future__ import annotations

import numpy as np
import torch

TINY_BEIT3 = dict(img_size=64, patch_size=16, embed_dim=32, num_heads=4,
                  ffn_dim=64, num_layers=2, vocab_size=80,
                  drop_path_rate=0.0)
TINY_HEAD = dict(num_queries=2, in_channels=32, embed_dim=32,
                 num_decoder_layers=2, num_tgqg_layers=1)


def jax_tiny_model():
    from simvg_tpu.models import SimVGConfig, SimVGModel
    from simvg_tpu.models.beit3 import BEiT3Config
    from simvg_tpu.models.heads.tgqs_head import TGQSHeadConfig

    return SimVGModel(SimVGConfig(beit3=BEiT3Config(**TINY_BEIT3),
                                  head=TGQSHeadConfig(**TINY_HEAD)))


def torch_tiny_model():
    from simvg_tpu_torch.models.beit3 import BEiT3Config
    from simvg_tpu_torch.models.heads.tgqs_head import TGQSHeadConfig
    from simvg_tpu_torch.models.model import SimVGConfig, SimVGModel

    return SimVGModel(SimVGConfig(beit3=BEiT3Config(**TINY_BEIT3),
                                  head=TGQSHeadConfig(**TINY_HEAD))).eval()


def np_batch(b=3, t=6, seed=0):
    """A numpy batch with padded text (lengths t, t-2, 2, ...) and valid
    image extents that leave padded rows and columns on the 4x4 grid."""
    r = np.random.default_rng(seed)
    lengths = [max(2, t - 2 * i) for i in range(b)]
    pad = np.array([[int(j >= n) for j in range(t)] for n in lengths],
                   np.int32)
    shapes = [[64, 64], [48, 64], [64, 33], [40, 40]]
    return dict(
        image=r.normal(size=(b, 64, 64, 3)).astype(np.float32),
        text_ids=r.integers(1, 80, (b, t)).astype(np.int32),
        text_padding_mask=pad,
        img_shape=np.array([shapes[i % 4] for i in range(b)], np.int32),
    )


def to_torch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def to_jax(batch):
    import jax.numpy as jnp

    return {k: jnp.asarray(v) for k, v in batch.items()}


def jax_params_from_port(jax_model, batch, state_dict):
    """A JAX param tree holding a port state dict's weights, through
    ``tools.convert_checkpoint.convert_simvg_full`` into a template of the
    JAX model's shapes (``jax.eval_shape``: no JAX init runs)."""
    import jax

    from tools.convert_checkpoint import convert_simvg_full

    shapes = jax.eval_shape(jax_model.init, jax.random.PRNGKey(0),
                            **to_jax(batch))
    template = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    sd = {k: v.detach().numpy() for k, v in state_dict.items()}
    report = convert_simvg_full(sd, template)
    assert len(report) == len(jax.tree.leaves(template))
    return template
