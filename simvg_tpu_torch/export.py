"""Ahead-of-time serving export on ``torch.export`` (port of
``simvg_tpu/export.py``): the serving forward and its weights in one file
that a serving site loads and calls without the model code, the config or
a checkpoint.

    prog = export_serving(model, sample_batch, polymorphic_batch=True)
    save_exported("model.pt2", prog)
    # serving site:
    import simvg_tpu_torch.ops.fused_attention  # registers the K1 operator
    prog = load_exported("model.pt2")
    preds = prog.call(batch)  # {"decoder": {...}, "token": {...}}

The serving function is the eval step's body (``engine.eval.eval_forward``:
the forward, the on-device normalisation of ``normalize_on_device``
configs, both branches decoded), so exported predictions are those of the
eval step on the same device.  The attention forward K1 stays in the graph
as one ``simvg::attention_fwd`` node a call (a custom operator, see
``ops/fused_attention.py``), which launches the Hopper kernel when the
program runs on the card; ``attention_op_count`` counts the nodes.  An
``int8_static`` model exports with its int8 products as ``aten._int_mm``
nodes (``int_mm_op_count``) and its quant tensors baked in, or, with the
weights as an argument, in that argument (``serving_state``).

What differs from JAX's ``jax.export``:

- the program runs on the device it was exported on (its weights live
  there); there is no cross-platform lowering, and ``platforms=`` raises;
- the operator is resolved when the file is loaded: ``load_exported``
  imports its module, and any other serving site must import
  ``simvg_tpu_torch.ops.fused_attention`` before ``torch.export.load``.
"""

from __future__ import annotations

import json
from typing import Dict, Optional

import torch

from simvg_tpu_torch.engine.eval import eval_forward
from simvg_tpu_torch.ops.quant import quant_layers

# The exported calling convention: one dict with exactly these keys (the
# loader's device batch minus host-only fields).
SERVING_INPUTS = ("image", "text_ids", "text_padding_mask", "img_shape")
_META_FILE = "simvg_serving.json"


class _Serving(torch.nn.Module):
    """forward(batch) -> preds, the weights baked in."""

    def __init__(self, model: torch.nn.Module, device_norm=None):
        super().__init__()
        self.model = model
        self.device_norm = device_norm

    def forward(self, batch):
        return eval_forward(self.model, batch, self.device_norm)


class _WeightsAsArgument(torch.nn.Module):
    """forward(params, batch) -> preds: the model's parameters (and the
    quant tensors of an int8_static model, ``serving_state``) come in as
    the first argument, by name, and the program holds none."""

    def __init__(self, model: torch.nn.Module, device_norm=None):
        super().__init__()
        # not a submodule: its own parameters stay out of the program
        self.__dict__["model"] = model
        self.device_norm = device_norm

    def forward(self, params, batch):
        model = self.__dict__["model"]

        def call(image, text_ids, text_padding_mask, img_shape=None):
            return torch.func.functional_call(
                model, params, (image, text_ids, text_padding_mask),
                {"img_shape": img_shape})

        return eval_forward(call, batch, self.device_norm)


def serving_state(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The ``params`` argument of a program exported with
    ``bake_weights=False``: the state dict and, for an ``int8_static``
    model, its quant tensors (``w_q``, ``s_w``, ``act_scale``), which stay
    out of state dicts but travel with the weights they were quantized
    from."""
    state = dict(model.state_dict())
    state.update(model.named_buffers())
    return {k: v.detach() for k, v in state.items()}


def make_serving_fn(model: torch.nn.Module,
                    device_norm: Optional[dict] = None) -> torch.nn.Module:
    """The serving forward over ``model``'s own weights: ``fn(batch) ->
    preds``.  ``device_norm``: the config's ``img_norm_cfg`` when the
    pipeline uses ``normalize_on_device=True`` (uint8 images in)."""
    return _Serving(model.eval(), device_norm)


def serving_specs(sample_batch: Dict, polymorphic_batch: bool = False):
    """(example batch of the SERVING_INPUTS, dynamic shapes): with
    ``polymorphic_batch`` the leading axis of every input is the one
    symbolic dimension ``b`` (a batch of 1 is traced twice over)."""
    batch = {k: torch.as_tensor(sample_batch[k]) for k in SERVING_INPUTS}
    if not polymorphic_batch:
        return batch, None
    if batch["image"].shape[0] == 1:
        # torch.export specialises a dimension it sees at size 1
        batch = {k: torch.cat([v, v]) for k, v in batch.items()}
    b = torch.export.Dim("b", min=1, max=4096)
    return batch, {k: {0: b} for k in SERVING_INPUTS}


class ServingProgram:
    """An exported serving forward and what a server needs to know of it
    (``meta``: ``weights_as_argument``, ``polymorphic_batch``, ``inputs``
    as [shape, dtype] of the example batch, ``img_size``, ``device``).
    ``call(batch)``, or ``call(params, batch)`` for a program exported
    with ``bake_weights=False``."""

    def __init__(self, program, meta: Dict):
        self.program = program
        self.meta = meta
        self._module = program.module()

    def call(self, *args):
        if len(args) != (2 if self.meta["weights_as_argument"] else 1):
            raise TypeError(
                "call(params, batch) for a program exported with "
                "bake_weights=False, call(batch) otherwise")
        got = {k: str(v.dtype).replace("torch.", "")
               for k, v in args[-1].items()}
        want = {k: v[1] for k, v in self.meta["inputs"].items()}
        if got != want:
            raise TypeError(f"the batch's dtypes {got} are not the "
                            f"program's {want}")
        with torch.no_grad():
            return self._module(*args)


def export_serving(model: torch.nn.Module, sample_batch: Dict, *,
                   polymorphic_batch: bool = False,
                   device_norm: Optional[dict] = None,
                   bake_weights: bool = True,
                   platforms=None) -> ServingProgram:
    """``torch.export`` of the serving forward at ``sample_batch``'s shapes
    and device.  ``bake_weights=True``: the weights are in the program,
    ``call(batch)``; ``False``: they are its first argument,
    ``call(params, batch)`` with ``params`` the ``serving_state`` of a
    model of the same config, for a site that swaps checkpoints under one
    program.  An ``int8_static`` model's program holds ``_int_mm`` nodes
    (``int_mm_op_count``) and ``"quantized"`` in its meta."""
    if platforms is not None:
        raise ValueError(
            "platforms= has no counterpart in torch.export: a program runs "
            "on the device it was exported on; export on that device")
    model.eval()
    batch, dynamic = serving_specs(sample_batch, polymorphic_batch)
    if bake_weights:
        fn, args = _Serving(model, device_norm), (batch,)
        shapes = None if dynamic is None else (dynamic,)
    else:
        params = serving_state(model)
        fn, args = _WeightsAsArgument(model, device_norm), (params, batch)
        shapes = None if dynamic is None else (
            {k: None for k in params}, dynamic)
    with torch.no_grad():
        program = torch.export.export(fn, args, dynamic_shapes=shapes,
                                      strict=False)
    _drop_metadata_asserts(program)
    meta = {"weights_as_argument": not bake_weights,
            "quantized": bool(quant_layers(model, "static")),
            "polymorphic_batch": polymorphic_batch,
            "inputs": {k: [list(v.shape), str(v.dtype).replace("torch.", "")]
                       for k, v in batch.items()},
            "img_size": int(batch["image"].shape[1]),
            "device": str(batch["image"].device)}
    return ServingProgram(program, meta)


def _drop_metadata_asserts(program) -> None:
    """Takes out the ``aten._assert_tensor_metadata`` nodes that
    ``torch.export`` puts before every dtype conversion (377 of the tiny
    model's 1210 operator nodes): they re-check dtypes that the graph itself
    fixes, and each costs a dispatcher call on the host, which made the
    program slower than eager.  The program still guards its inputs'
    shapes, and ``ServingProgram.call`` checks the batch's dtypes."""
    graph = program.graph_module.graph
    target = torch.ops.aten._assert_tensor_metadata.default
    for node in list(graph.nodes):
        if node.op == "call_function" and node.target == target:
            graph.erase_node(node)
    graph.lint()
    program.graph_module.recompile()


def _op_count(program, target) -> int:
    program = getattr(program, "program", program)
    return sum(1 for node in program.graph.nodes
               if node.op == "call_function" and node.target == target)


def attention_op_count(program) -> int:
    """The ``simvg::attention_fwd`` (K1) nodes of an exported program's
    graph (a ServingProgram or a torch ExportedProgram)."""
    return _op_count(program, torch.ops.simvg.attention_fwd.default)


def int_mm_op_count(program) -> int:
    """The ``aten._int_mm`` nodes (the int8 products of an ``int8`` or
    ``int8_static`` model) of an exported program's graph."""
    return _op_count(program, torch.ops.aten._int_mm.default)


def save_exported(path: str, prog: ServingProgram) -> None:
    """Writes the program and its meta to one file (``torch.export.save``)."""
    torch.export.save(prog.program, path,
                      extra_files={_META_FILE: json.dumps(prog.meta)})


def load_exported(path: str) -> ServingProgram:
    """Inverse of ``save_exported``; registers the K1 operator first."""
    import simvg_tpu_torch.ops.fused_attention  # noqa: F401

    extra = {_META_FILE: ""}
    program = torch.export.load(path, extra_files=extra)
    return ServingProgram(program, json.loads(extra[_META_FILE]))
