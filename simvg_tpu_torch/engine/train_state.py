"""Train state: optimizer with per-module LR groups, LR schedules, EMA (port
of ``simvg_tpu/engine/train_state.py``).

The JAX package builds its optimizer from optax; the port writes the same
update by hand, in place on the model's parameters, with ``torch._foreach_*``
so a step launches a bounded number of kernels:

- three LR groups from the state-dict prefix: ``vis_enc.*`` at lr/10 by
  default, ``lan_enc.*`` and the rest at lr;
- ``freeze_layer``: the grads of encoder layers [0, freeze_layer) are zeroed
  BEFORE the clip and those parameters never move;
- the clip is optax's ``clip_by_global_norm``: g * max_norm / norm when
  norm >= max_norm, with no epsilon (torch's ``clip_grad_norm_`` adds 1e-6);
- Adam with amsgrad is optax's ``scale_by_amsgrad``: nu_max = max(nu_max,
  nu_hat) over the BIAS-CORRECTED nu_hat, update mu_hat / (sqrt(nu_max) +
  eps).  ``torch.optim.Adam(amsgrad=True)`` keeps the max of the
  uncorrected nu and differs from step 2 on;
- ``mu_dtype`` stores the first moment narrower; the arithmetic stays fp32.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import re
from typing import Callable, Dict, List, Optional, Sequence

import torch

Schedule = Callable[[int], float]
GROUPS = ("vis_enc", "lan_enc", "rest")
_ENCODER_LAYER = re.compile(r"\.layers\.(\d+)\.")


def cosine_annealing_lr(base_lr: float, steps_per_epoch: int, t_max: int,
                        eta_min: float = 0.0) -> Schedule:
    """CosineAnnealingLR over epochs; periodic past t_max, as torch's."""

    def schedule(step: int) -> float:
        epoch = step // steps_per_epoch
        return eta_min + 0.5 * (base_lr - eta_min) * (
            1.0 + math.cos(math.pi * epoch / t_max))

    return schedule


def cosine_annealing_warm_restarts(base_lr: float, steps_per_epoch: int,
                                   t_0: int, t_mult: int = 1,
                                   eta_min: float = 0.0) -> Schedule:
    """CosineAnnealingWarmRestarts with a fixed period (t_mult=1)."""
    if t_mult != 1:
        raise ValueError("only t_mult=1 is supported")

    def schedule(step: int) -> float:
        epoch = (step // steps_per_epoch) % t_0
        return eta_min + 0.5 * (base_lr - eta_min) * (
            1.0 + math.cos(math.pi * epoch / t_0))

    return schedule


def multistep_lr_warmup(base_lr: float, steps_per_epoch: int,
                        warmup_epochs: int = 3,
                        decay_steps: Sequence[int] = (25,),
                        decay_ratio: float = 0.1) -> Schedule:
    """The reference's per-epoch factor: epochs 0..warmup-1 ramp
    (e+1)/(warmup+1); after that decay_ratio per decay step passed."""

    def schedule(step: int) -> float:
        epoch = step // steps_per_epoch
        if epoch <= warmup_epochs - 1:
            return base_lr * (epoch + 1.0) / (warmup_epochs + 1.0)
        decay = 1.0
        for s in decay_steps:
            if epoch + 1 >= s:
                decay *= decay_ratio
        return base_lr * decay

    return schedule


def make_lr_schedule(base: float, steps_per_epoch: int, *,
                     scheduler_type: str = "MultiStepLRWarmUp",
                     warmup_epochs: int = 3,
                     decay_steps: Sequence[int] = (25,),
                     decay_ratio: float = 0.1,
                     scheduler_kw: Optional[Dict] = None) -> Schedule:
    """The scheduler registry of the reference."""
    scheduler_kw = scheduler_kw or {}
    if scheduler_type == "MultiStepLRWarmUp":
        return multistep_lr_warmup(base, steps_per_epoch, warmup_epochs,
                                   decay_steps, decay_ratio)
    if scheduler_type == "CosineAnnealingLR":
        return cosine_annealing_lr(base, steps_per_epoch,
                                   scheduler_kw.get("T_max", 30),
                                   scheduler_kw.get("eta_min", 0.0))
    if scheduler_type == "CosineAnnealingLRWarmRestarts":
        return cosine_annealing_warm_restarts(
            base, steps_per_epoch, scheduler_kw.get("T_0", 10),
            scheduler_kw.get("T_mult", 1), scheduler_kw.get("eta_min", 0.0))
    raise ValueError(f"unknown scheduler {scheduler_type!r}")


def group_label(name: str) -> str:
    """The LR group of a parameter, from its state-dict name."""
    top = name.split(".", 1)[0]
    return top if top in ("vis_enc", "lan_enc") else "rest"


def is_frozen(name: str, freeze_layer: int) -> bool:
    """True for the vis_enc encoder layers [0, freeze_layer)."""
    if freeze_layer < 0 or group_label(name) != "vis_enc":
        return False
    m = _ENCODER_LAYER.search(name)
    return m is not None and int(m.group(1)) < freeze_layer


@dataclasses.dataclass
class OptState:
    """Moments in the order of ``model.named_parameters()``; ``count`` is
    the number of updates taken (optax's count)."""

    count: int
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]
    nu_max: Optional[List[torch.Tensor]]


@dataclasses.dataclass
class TrainState:
    step: int
    opt_state: OptState
    ema_params: Optional[List[torch.Tensor]] = None
    ema_step: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """Adam (optionally amsgrad) over three LR groups, with the freeze mask
    and the global-norm clip in front: optax's chain."""

    schedules: Dict[str, Schedule]
    amsgrad: bool = True
    b1: float = 0.9
    b2: float = 0.98
    eps: float = 1e-9
    grad_norm_clip: float = 0.15
    freeze_layer: int = -1
    mu_dtype: Optional[torch.dtype] = None

    def init(self, params: Sequence[torch.Tensor]) -> OptState:
        zeros = lambda dt=None: [torch.zeros_like(p, dtype=dt)  # noqa: E731
                                 for p in params]
        return OptState(count=0, mu=zeros(self.mu_dtype), nu=zeros(),
                        nu_max=zeros() if self.amsgrad else None)

    def apply(self, names: Sequence[str], params: Sequence[torch.Tensor],
              grads: List[torch.Tensor], state: OptState) -> OptState:
        """Updates ``params`` in place from ``grads`` (which it clobbers)
        and returns the new state."""
        frozen = [is_frozen(n, self.freeze_layer) for n in names]
        if any(frozen):
            for g, f in zip(grads, frozen):
                if f:
                    g.zero_()
        if self.grad_norm_clip and self.grad_norm_clip > 0:
            norm = global_norm(grads)
            scale = torch.where(norm < self.grad_norm_clip, 1.0,
                                self.grad_norm_clip / norm)
            torch._foreach_mul_(grads, scale)

        count = state.count + 1
        bc1 = 1.0 - self.b1 ** count
        bc2 = 1.0 - self.b2 ** count
        for group in GROUPS:
            idx = [i for i, n in enumerate(names)
                   if group_label(n) == group and not frozen[i]]
            if not idx:
                continue
            lr = self.schedules[group](state.count)
            self._adam([params[i] for i in idx], [grads[i] for i in idx],
                       [state.mu[i] for i in idx], [state.nu[i] for i in idx],
                       None if state.nu_max is None
                       else [state.nu_max[i] for i in idx], bc1, bc2, lr)
        state.count = count
        return state

    @torch.no_grad()
    def _adam(self, p, g, mu_store, nu, nu_max, bc1, bc2, lr):
        if self.mu_dtype is None:
            mu = mu_store
            torch._foreach_mul_(mu, self.b1)
        else:  # optax's b1 * mu is a weak-typed product in the stored
            # dtype: b1 is rounded to it, and so is the product
            b1 = torch.tensor(self.b1, dtype=self.mu_dtype).item()
            mu = [m.float() for m in torch._foreach_mul(mu_store, b1)]
        torch._foreach_add_(mu, g, alpha=1.0 - self.b1)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_addcmul_(nu, g, g, value=1.0 - self.b2)
        mu_hat = torch._foreach_div(mu, bc1)
        nu_hat = torch._foreach_div(nu, bc2)
        if nu_max is not None:
            torch._foreach_maximum_(nu_max, nu_hat)
            nu_hat = nu_max
        denom = torch._foreach_sqrt(nu_hat)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(mu_hat, denom)
        torch._foreach_add_(p, upd, alpha=-lr)
        if self.mu_dtype is not None:
            for dst, src in zip(mu_store, mu):
                dst.copy_(src)


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm)."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


def create_optimizer(
    lr: float,
    steps_per_epoch: int,
    *,
    lr_vis_enc: Optional[float] = None,
    lr_lan_enc: Optional[float] = None,
    betas=(0.9, 0.98),
    eps: float = 1e-9,
    grad_norm_clip: float = 0.15,
    warmup_epochs: int = 3,
    decay_steps: Sequence[int] = (25,),
    decay_ratio: float = 0.1,
    freeze_layer: int = -1,
    optimizer_type: str = "Adam",
    scheduler_type: str = "MultiStepLRWarmUp",
    scheduler_kw: Optional[Dict] = None,
    amsgrad: bool = True,
    mu_dtype: Optional[str] = None,
) -> Optimizer:
    """The Adam optimizer of ``simvg_tpu.engine.train_state.
    create_optimizer``, with its arguments; every shipped config's.  AdamW,
    SGD and RMSProp are not ported yet."""
    if optimizer_type != "Adam":
        raise NotImplementedError(f"optimizer {optimizer_type!r} is not "
                                  "ported")
    bases = {"vis_enc": lr / 10.0 if lr_vis_enc is None else lr_vis_enc,
             "lan_enc": lr if lr_lan_enc is None else lr_lan_enc,
             "rest": lr}
    schedules = {g: make_lr_schedule(
        base, steps_per_epoch, scheduler_type=scheduler_type,
        warmup_epochs=warmup_epochs, decay_steps=decay_steps,
        decay_ratio=decay_ratio, scheduler_kw=scheduler_kw)
        for g, base in bases.items()}
    return Optimizer(
        schedules=schedules, amsgrad=amsgrad, b1=betas[0], b2=betas[1],
        eps=eps, grad_norm_clip=grad_norm_clip, freeze_layer=freeze_layer,
        mu_dtype=getattr(torch, mu_dtype) if mu_dtype else None)


def create_train_state(model: torch.nn.Module, optimizer: Optimizer,
                       ema: bool = False) -> TrainState:
    params = [p.detach() for p in model.parameters()]
    return TrainState(
        step=0, opt_state=optimizer.init(params),
        ema_params=[p.clone() for p in params] if ema else None,
        ema_step=0 if ema else None)


@torch.no_grad()
def ema_update(ema_params: List[torch.Tensor], params: Sequence[torch.Tensor],
               ema_step: int, alpha: float = 0.999) -> int:
    """shadow = d * shadow + (1 - d) * param, d = min(alpha, (step + 1) /
    (step + 10)), in place; returns the next ema_step."""
    decay = min(alpha, (ema_step + 1.0) / (ema_step + 10.0))
    torch._foreach_mul_(ema_params, decay)
    torch._foreach_add_(ema_params, list(params), alpha=1.0 - decay)
    return ema_step + 1


@contextlib.contextmanager
def swapped_params(model: torch.nn.Module, tensors: Sequence[torch.Tensor]):
    """Runs the body with ``tensors`` (in ``model.parameters()`` order, e.g.
    the EMA shadow) in the model's parameters, and puts the model's own
    back after it."""
    params = list(model.parameters())
    with torch.no_grad():
        saved = [p.detach().clone() for p in params]
        torch._foreach_copy_(params, list(tensors))
    try:
        yield model
    finally:
        with torch.no_grad():
            torch._foreach_copy_(params, saved)
