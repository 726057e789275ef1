"""Losses (port of ``simvg_tpu/losses``): the set criterion and the SimVG
branch and distillation losses."""

from .criterion import (
    Targets,
    hungarian_match,
    normalize_targets,
    set_criterion,
    simvg_branch_losses,
)

__all__ = ["Targets", "hungarian_match", "normalize_targets", "set_criterion",
           "simvg_branch_losses"]
