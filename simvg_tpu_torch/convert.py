"""Weight carry-over from the JAX package.

The port's modules keep the reference's torch state-dict names, so the
JAX package's own exporter (``tools/convert_checkpoint.export_simvg_full``,
numpy only) maps any ``simvg_tpu`` parameter tree onto the port.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def load_jax_params(model: torch.nn.Module, params: Dict) -> torch.nn.Module:
    """Loads a flax param tree (``{"params": {"beit3": ..., "head": ...}}``,
    numpy or JAX arrays) into ``model`` with ``strict=True``."""
    from tools.convert_checkpoint import export_simvg_full

    sd = {k: torch.from_numpy(np.array(v, np.float32))
          for k, v in export_simvg_full(params).items()}
    model.load_state_dict(sd, strict=True)
    return model
