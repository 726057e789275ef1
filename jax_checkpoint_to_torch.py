#!/usr/bin/env python3
"""A checkpoint of the JAX package (an orbax directory written by
``tools/train.py``) as a checkpoint of the PyTorch port.

    python jax_checkpoint_to_torch.py --config CONFIG CKPT_DIR
        --out WORK_DIR [--name NAME] [--cfg-options key=value ...]

It builds the config's JAX model to make the params template (shapes
only: ``jax.eval_shape``, no init runs), restores the params and, when
the directory has them, the EMA params with
``simvg_tpu.utils.checkpoint.load_checkpoint``, maps both to the port's
state-dict names with ``simvg_tpu_torch.convert.export_params`` (the SimVG
family and the composed OneStageModel family), checks them against the
port's model built on the meta device (every name and shape), and writes
``WORK_DIR/NAME`` (default: the checkpoint directory's name) with the
port's ``save_checkpoint``, the epoch, metrics and EMA step carried over.
The port's test CLI then reads it:

    python -m simvg_tpu_torch.tools.test CONFIG WORK_DIR/NAME [--with-ema]

It imports JAX and orbax, so it lives outside ``simvg_tpu_torch/`` and
runs where the JAX package is installed, on the CPU.
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
import sys
from typing import Dict

import numpy as np

REPO = osp.dirname(osp.abspath(__file__))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="JAX checkpoint -> port "
                                "checkpoint")
    p.add_argument("checkpoint", help="orbax checkpoint directory")
    p.add_argument("--config", required=True)
    p.add_argument("--out", required=True, help="work dir to write into")
    p.add_argument("--name", default=None)
    p.add_argument("--cfg-options", nargs="*", default=[],
                   help="dotted overrides key=value")
    return p.parse_args(argv)


def params_template(cfg) -> Dict:
    """Zeros of the config's JAX param tree, from its shapes; the int8
    ``quant`` collection, which checkpoints never hold, left out."""
    import jax
    import jax.numpy as jnp

    from simvg_tpu.models.builder import build_model

    img_size = cfg.get("img_size", 640)
    t = cfg.get("max_token", 20)
    model, _ = build_model(cfg.model, img_size=img_size)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0),
        image=jnp.zeros((1, img_size, img_size, 3)),
        text_ids=jnp.ones((1, t), jnp.int32),
        text_padding_mask=jnp.zeros((1, t), jnp.int32),
        img_shape=jnp.full((1, 2), img_size, jnp.int32)))
    shapes = dict(shapes)
    shapes.pop("quant", None)
    return jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)


def main(argv=None) -> str:
    args = parse_args(argv)
    sys.path.insert(0, REPO)
    import jax

    jax.config.update("jax_platforms", "cpu")
    import torch

    from simvg_tpu.config import Config, parse_cfg_options
    from simvg_tpu.utils.checkpoint import load_checkpoint
    from simvg_tpu_torch.convert import export_params
    from simvg_tpu_torch.models import build_model as port_build
    from simvg_tpu_torch.utils.checkpoint import save_checkpoint

    cfg = Config.fromfile(args.config)
    cfg.merge_from_dict(parse_cfg_options(args.cfg_options))
    ck = load_checkpoint(args.checkpoint,
                         params_template=params_template(cfg),
                         with_ema=True)

    port, _ = port_build(cfg.model, img_size=cfg.get("img_size", 640),
                         device="meta")
    want = {k: tuple(v.shape) for k, v in port.state_dict().items()}

    def to_port(tree):
        sd = {k: torch.from_numpy(np.array(v, np.float32))
              for k, v in export_params(jax.tree.map(np.asarray,
                                                     tree)).items()}
        got = {k: tuple(v.shape) for k, v in sd.items()}
        if got != want:
            bad = sorted(k for k in set(got) | set(want)
                         if got.get(k) != want.get(k))
            raise ValueError(f"the converted tree does not match the port's "
                             f"model at {len(bad)} names: {bad[:8]}")
        return sd

    ema = ck.get("ema_params")
    name = args.name or osp.basename(osp.normpath(args.checkpoint))
    os.makedirs(args.out, exist_ok=True)
    path = save_checkpoint(
        args.out, name, params=to_port(ck["params"]),
        ema_params=None if ema is None else to_port(ema),
        epoch=ck["epoch"], metrics=ck["metrics"], ema_step=ck.get("ema_step"),
        block=True)
    print(f"wrote {path} ({len(want)} tensors"
          f"{', with EMA' if ema is not None else ''})")
    return path


if __name__ == "__main__":
    main()
