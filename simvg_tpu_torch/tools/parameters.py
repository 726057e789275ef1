"""Parameter counts per group and in total (counterpart of
``tools/misc/parameters.py``), with JAX's groups: the encoder (``beit3``,
or the composed family's ``vis_enc``, ``lan_enc``, ``fusion``) and, inside
the head, each sub-block (``head/decoder``, ``head/tgqg``, ...).

    python -m simvg_tpu_torch.tools.parameters [CONFIG]

The model is built on the ``meta`` device (shapes, no weights), so it
counts the flagship without a card.  Without a config it counts the
flagship's model: BEiT3-base/32 at 640 px and a one-query head.
``main(argv)`` returns ``{group: count}``.
"""

from __future__ import annotations

import argparse
from typing import Dict

from simvg_tpu_torch.config import Config
from simvg_tpu_torch.models import build_model

# the port's head module names -> the flax module names JAX groups by
_HEAD_GROUPS = (("transformer.decoder.", "decoder"),
                ("transformer.encoder.", "encoder"),
                ("text_guided_query_generation_transformer.", "tgqg"))


def group_of(name: str) -> str:
    """The JAX group of a port state-dict name."""
    top, rest = name.split(".", 1)
    if top == "head":
        for prefix, group in _HEAD_GROUPS:
            if rest.startswith(prefix):
                return "head/" + group
        return "head/" + rest.split(".", 1)[0]
    if top == "vis_enc" and rest.startswith("beit3."):
        return "beit3"
    return top


def main(argv=None) -> Dict[str, int]:
    p = argparse.ArgumentParser(description="parameter counts per group")
    p.add_argument("config", nargs="?", default=None)
    args = p.parse_args(argv)
    if args.config:
        cfg = Config.fromfile(args.config)
        model_cfg, img_size = cfg.model, cfg.get("img_size", 640)
    else:
        img_size = 640
        model_cfg = {"vis_enc": {"vit_type": "base", "patch_size": 32,
                                 "img_size": img_size},
                     "head": {"num_queries": 1, "in_channels": 768}}
    model, _ = build_model(model_cfg, img_size=img_size, device="meta")
    totals: Dict[str, int] = {}
    for name, p in model.named_parameters():
        totals[group_of(name)] = totals.get(group_of(name), 0) + p.numel()
    width = max(len(k) for k in totals)
    for k in sorted(totals):
        print(f"{k:<{width}}  {totals[k] / 1e6:9.3f}M")
    print("-" * (width + 12))
    print(f"{'total':<{width}}  {sum(totals.values()) / 1e6:9.3f}M")
    return totals


if __name__ == "__main__":
    main()
