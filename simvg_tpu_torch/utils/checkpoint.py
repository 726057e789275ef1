"""Checkpoint save and load with the reference's three load modes (port of
``simvg_tpu/utils/checkpoint.py``).

Layout, as the JAX package writes it: ``<work_dir>/<name>/`` holds one item
each for ``params``, ``opt_state`` and ``ema_params`` (here a ``torch.save``
of host tensors keyed by the port's state-dict names) and ``meta.json``
(epoch, step, ema_step, metrics, the item list).  The optimizer item holds
optax's ``count`` and the Adam moments ``mu``, ``nu`` (and ``nu_max`` with
amsgrad), each keyed by parameter name.

A save copies every tensor to the host first, then writes on a background
thread, as orbax's asynchronous saves do: the items go to
``<name>.tmpN``, ``meta.json`` last, then the old checkpoint is removed and
the new one renamed into place.  A directory without ``meta.json`` is never
a checkpoint, so a kill at any point leaves the previous one loadable.
``wait_for_checkpoints`` joins the writes and raises what they raised.

Load modes (``tools/train.py``): ``--resume-from`` restores everything and
the counters, ``--load-from`` the weights (and EMA), ``--finetune-from``
the weights non-strictly, logging missing and unexpected keys.
"""

from __future__ import annotations

import json
import os
import os.path as osp
import shutil
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Sequence

import torch

from simvg_tpu_torch.engine.train_state import OptState

_lock = threading.Lock()
_writer: Optional[ThreadPoolExecutor] = None
_pending: List[Future] = []
_save_seq = 0


def _to_host(tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Host copies that later in-place updates cannot reach (a CPU tensor
    is cloned, a CUDA one copied)."""
    return {k: v.detach().to("cpu", copy=True) for k, v in tensors.items()}


def opt_state_to_dict(names: Sequence[str], opt: OptState) -> Dict[str, Any]:
    """An ``OptState`` (moments in parameter order) keyed by name."""
    out: Dict[str, Any] = {"count": opt.count,
                           "mu": dict(zip(names, opt.mu)),
                           "nu": dict(zip(names, opt.nu))}
    if opt.nu_max is not None:
        out["nu_max"] = dict(zip(names, opt.nu_max))
    return out


@torch.no_grad()
def load_opt_state(names: Sequence[str], saved: Dict[str, Any],
                   opt: OptState) -> OptState:
    """Copies a saved optimizer item into ``opt``'s tensors in place."""
    for key in ("mu", "nu", "nu_max"):
        dst = getattr(opt, key)
        if dst is None:
            continue
        if key not in saved:
            raise KeyError(f"checkpoint optimizer state has no {key!r}")
        for name, t in zip(names, dst):
            t.copy_(saved[key][name])
    opt.count = int(saved["count"])
    return opt


def wait_for_checkpoints() -> None:
    """Blocks until every pending save has committed; raises a save's
    error."""
    while True:
        with _lock:
            if not _pending:
                return
            fut = _pending.pop(0)
        fut.result()


def _write_items(tmp: str, items: Dict[str, Dict]) -> None:
    os.makedirs(tmp)
    for key, tree in items.items():
        torch.save(tree, osp.join(tmp, key))


def _commit(tmp: str, path: str, meta: Dict) -> None:
    """meta.json last, then the swap: the previous checkpoint is removed
    only once the new one is complete."""
    with open(osp.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
    if osp.exists(path):
        shutil.rmtree(path)
    os.rename(tmp, path)


def _save(tmp: str, path: str, items: Dict, meta: Dict) -> None:
    _write_items(tmp, items)
    _commit(tmp, path, meta)


def save_checkpoint(
    work_dir: str,
    name: str,
    *,
    params: Dict[str, torch.Tensor],
    opt_state: Optional[Dict[str, Any]] = None,
    ema_params: Optional[Dict[str, torch.Tensor]] = None,
    epoch: int = 0,
    step: Optional[int] = None,
    metrics: Optional[Dict[str, float]] = None,
    ema_step: Optional[int] = None,
    block: bool = False,
) -> str:
    """Saves ``<work_dir>/<name>``: ``params`` (a state dict),
    ``opt_state`` (``opt_state_to_dict``) and ``ema_params`` (by name).
    Returns the path; the write finishes on a thread unless ``block``."""
    global _writer, _save_seq
    path = osp.abspath(osp.join(work_dir, name))
    wait_for_checkpoints()  # one save and swap at a time
    items: Dict[str, Any] = {"params": _to_host(params)}
    if opt_state is not None:
        items["opt_state"] = {
            k: (_to_host(v) if isinstance(v, dict) else v)
            for k, v in opt_state.items()}
    if ema_params is not None:
        items["ema_params"] = _to_host(ema_params)
    with _lock:
        _save_seq += 1
        tmp = f"{path}.tmp{_save_seq}"
    if osp.exists(tmp):
        shutil.rmtree(tmp)
    meta = {"epoch": epoch, "step": step, "metrics": metrics or {},
            # the EMA warm-up counter: without it a resume restarts the
            # decay min(alpha, (t+1)/(t+10)) at t=0
            "ema_step": ema_step, "items": sorted(items)}
    if block:
        _save(tmp, path, items, meta)
        return path
    with _lock:
        if _writer is None:
            _writer = ThreadPoolExecutor(1, thread_name_prefix="checkpoint")
        _pending.append(_writer.submit(_save, tmp, path, items, meta))
    return path


def load_checkpoint(path: str, *, with_opt: bool = False,
                    with_ema: bool = False) -> Dict[str, Any]:
    """Returns {"params", ["opt_state"], ["ema_params"], "epoch", "step",
    "metrics", "ema_step"}, every tensor on the host."""
    path = osp.abspath(path)
    wait_for_checkpoints()  # the path may still be being written
    if not osp.isfile(osp.join(path, "meta.json")):
        raise FileNotFoundError(f"{path} is not a checkpoint (no "
                                "meta.json)")
    with open(osp.join(path, "meta.json")) as f:
        meta = json.load(f)

    def item(key):
        return torch.load(osp.join(path, key), map_location="cpu",
                          weights_only=True)

    out: Dict[str, Any] = {"params": item("params")}
    if with_opt and osp.isfile(osp.join(path, "opt_state")):
        out["opt_state"] = item("opt_state")
    if with_ema and osp.isfile(osp.join(path, "ema_params")):
        out["ema_params"] = item("ema_params")
    out["epoch"] = meta.get("epoch", 0)
    out["step"] = meta.get("step")
    out["metrics"] = meta.get("metrics", {})
    out["ema_step"] = meta.get("ema_step")
    return out


def latest_checkpoint(work_dir: str) -> Optional[str]:
    p = osp.join(work_dir, "latest")
    # meta.json is written last; a dir without it is a partial save
    return p if osp.isfile(osp.join(p, "meta.json")) else None
