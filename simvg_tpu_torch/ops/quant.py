"""int8 w8a8 serving quantization (port of ``simvg_tpu/ops/quant.py``).

``Int8Linear`` is a drop-in for ``models/layers.py::Linear`` with the same
``weight`` [out, in] and ``bias`` parameters, so every checkpoint loads
into it with ``strict=True``; quantization happens at serving time:

- weights: symmetric per-output-channel int8 (scale = max|w| / 127);
- activations: symmetric per-tensor int8 (scale from the live batch's max
  in ``dynamic``, from calibration in ``static``);
- int8 x int8 -> int32 with ``torch._int_mm`` (cuBLASLt on the card),
  rescaled by ``s_x * s_w`` in float32, the float32 bias added, then cast
  to the compute dtype: the JAX layer's order of operations.

Its four modes (``BEiT3Config.quant``: ``int8``, ``int8_calib``,
``int8_static``, ``int8_qat``):

- ``dynamic``: weights and activations quantized inside every forward;
- ``calib``: the float forward, recording the running max |x| in the
  ``act_amax`` buffer;
- ``static``: pre-quantized ``w_q``/``s_w`` and a calibrated ``act_scale``,
  set by ``attach_static_quant``;
- ``qat``: fake-quantized weights and activations with a straight-through
  gradient, the training mode whose checkpoints serve under ``static``.

Scales are the global tensor's, as JAX takes them inside a ``jit`` over a
mesh: on a data-parallel layout each rank holds a shard of the batch, and
the activation max is all-reduced (MAX) over the data group; under tensor
parallelism a row-parallel layer holds a shard of its input features, and
its activation max and its per-output-channel weight max are all-reduced
over the model group too (``set_groups``, called by
``parallel/mesh.py::shard_model``).  The layer then multiplies its local
int8 shards (``int_mm``), dequantizes the int32 sums with those common
scales and hands the result to DTensor: a column-parallel layer's output
features, a row-parallel layer's int32 sums all-reduced first (exactly, as
JAX adds them; QAT's float partial sums go to DTensor as the float
layer's do).  Without a process group no collective runs.

The quant tensors (``w_q`` [out, in] int8, ``s_w`` [out] f32,
``act_scale`` and ``act_amax`` [] f32) are non-persistent buffers: like
JAX's "quant" collection they stay out of ``state_dict()`` and of every
checkpoint.  A collection is a flat dict ``{"<module>.<leaf>": tensor}``
under the port's module names; ``save_quant_collection`` and
``load_quant_collection`` read and write JAX's ``.npz`` artifact (flax
paths, ``w_q`` as [in, out]) through ``simvg_tpu_torch.convert``.
"""

from __future__ import annotations

import logging
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from simvg_tpu_torch.convert import quant_key_to_jax, quant_keys_from_jax
from simvg_tpu_torch.models.layers import Linear

MODES = {"int8": "dynamic", "int8_calib": "calib", "int8_static": "static",
         "int8_qat": "qat"}
# torch's CUDA _int_mm (cuBLASLt) takes M > 16 rows and K, N multiples of 8
_CUDA_MIN_ROWS = 17


def _div127(t: torch.Tensor) -> torch.Tensor:
    """t / 127 as a true division, JAX's: torch divides a CUDA tensor by a
    Python number as a multiplication by its reciprocal, which can land one
    bit away; a divisor on the tensor's device is divided by."""
    return t / t.new_full((), 127.0)


def _plain(t: torch.Tensor) -> torch.Tensor:
    """A quant buffer as a plain tensor: tensor parallelism
    (``parallelize_module``) makes every buffer of a parallel layer a
    replicated DTensor, whose local tensor is the whole buffer."""
    return t.to_local() if isinstance(t, DTensor) else t


def _group_max(amax: torch.Tensor, groups: Sequence) -> torch.Tensor:
    """``amax`` all-reduced (MAX) over each process group of ``groups``,
    the ranks that hold the rest of the global tensor; in place, under no
    gradient (a max of |x| feeds only rounding)."""
    for group in groups:
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    return amax


def quantize_symmetric(w: torch.Tensor, dim: Optional[int] = None,
                       groups: Sequence = ()):
    """Symmetric int8 quantization: (int8 values, float32 scale), the scale
    max|w| / 127 floored at 1e-8, taken over ``dim`` (None: the whole
    tensor; the scale then has ``dim`` reduced away) and over the shards of
    ``w`` that the process groups ``groups`` hold, values rounded half to
    even and clipped to +-127."""
    w32 = w.float()
    a = w32.abs()
    amax = a.amax() if dim is None else a.amax(dim=dim, keepdim=True)
    if groups:
        amax = _group_max(amax.detach().clone(), groups)
    scale = torch.clamp(_div127(amax), min=1e-8)
    q = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
    return q, (scale if dim is None else scale.squeeze(dim))


def fake_quant(v: torch.Tensor, dim: Optional[int] = None,
               groups: Sequence = ()) -> torch.Tensor:
    """``v`` rounded to its int8 grid in the forward, the identity in the
    backward (JAX's ``v + stop_gradient(deq - v)``), in float32; the grid's
    scale is the global tensor's (``quantize_symmetric``'s ``groups``)."""
    v32 = v.float()
    with torch.no_grad():
        q, s = quantize_symmetric(v32, dim, groups)
        deq = q.float() * (s if dim is None else s.unsqueeze(dim))
        residual = deq - v32
    return v32 + residual


def int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [M, K] int8 @ b [K, N] int8 -> [M, N] int32, exact.  On the card
    it launches ``torch._int_mm`` (``int_mm.launches`` counts the
    launches) and raises on K or N not a multiple of 8; an M of 16 or
    fewer rows, which cuBLASLt refuses, is padded with zero rows that are
    cut off again (they change no other row)."""
    if not a.is_cuda:
        return torch._int_mm(a, b)
    m, k = a.shape
    if k % 8 or b.shape[1] % 8:
        raise ValueError(f"int_mm on the card needs K and N multiples of 8, "
                         f"got K={k}, N={b.shape[1]}")
    if m < _CUDA_MIN_ROWS:
        a = torch.cat([a, a.new_zeros(_CUDA_MIN_ROWS - m, k)])
    out = torch._int_mm(a, b)
    int_mm.launches += 1
    return out[:m]


int_mm.launches = 0  # _int_mm launches on the card; chip_smoke.py reads it


class Int8Linear(Linear):
    """``Linear`` with w8a8 int8 products in ``mode`` ("dynamic", "calib",
    "static" or "qat"); the parameters are ``Linear``'s."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype = torch.float32, mode: str = "dynamic"):
        super().__init__(in_features, out_features, dtype)
        if mode not in MODES.values():
            raise ValueError(f"unknown int8 mode {mode!r}")
        self.mode = mode
        # the process groups over which the activation max and the
        # per-channel weight max are taken (set_groups); none: this rank's
        # tensors are the whole ones
        self.act_groups: tuple = ()
        self.weight_groups: tuple = ()
        if mode == "static":
            self.register_buffer("w_q", torch.zeros(
                out_features, in_features, dtype=torch.int8),
                persistent=False)
            self.register_buffer("s_w", torch.ones(out_features),
                                 persistent=False)
            self.register_buffer("act_scale", torch.ones(()),
                                 persistent=False)
            self.attached = False  # set by attach_static_quant
        elif mode == "calib":
            self.register_buffer("act_amax", torch.zeros(()),
                                 persistent=False)

    def _float(self, x: torch.Tensor, w: torch.Tensor,
               wrap=None) -> torch.Tensor:
        """x @ w^T in the compute dtype, the bias added in float32 (to the
        product that ``wrap`` returns, see ``_local``)."""
        dt = self.compute_dtype
        y = F.linear(x.to(dt), w.to(dt)).float()
        return ((wrap(y) if wrap else y) + self.bias).to(dt)

    def _int8(self, x_q, s_x, w_q, s_w, group=None,
              wrap=None) -> torch.Tensor:
        """The int8 product dequantized with the scales ``s_x * s_w``; a
        row-parallel layer's int32 partial sums are first added over
        ``group``."""
        y = int_mm(x_q.reshape(-1, x_q.shape[-1]), w_q.t())
        if group is not None:
            # exactly, as JAX's int32 dot_general adds them: a float sum
            # of dequantized parts lands an activation on the other side
            # of a rounding boundary of the next layer's grid now and then
            dist.all_reduce(y, group=group)
        y = (y.float() * (s_x * s_w)).reshape(*x_q.shape[:-1], -1)
        y = wrap(y, summed=True) if wrap else y
        return (y + self.bias).to(self.compute_dtype)

    def _static_x(self, x):
        s_x = torch.clamp(_div127(_plain(self.act_scale)), min=1e-8)
        return torch.clamp(torch.round(x.float() / s_x), -127,
                           127).to(torch.int8), s_x

    def _check_attached(self):
        if not self.attached:
            raise RuntimeError("an int8_static layer without its quant "
                               "tensors: call attach_static_quant")

    def _local(self, x: torch.Tensor):
        """The operands on this rank: (x, the weight, the static ``w_q``
        and ``s_w`` or None, the group that sums the int32 products, the
        wrap of the float product).  A plain weight: the layer's own
        tensors, no group, no wrap.  Under tensor parallelism
        (``parallel/mesh.py``) the weight is a DTensor sharded on its
        output features (column-parallel, ``x`` whole) or on its input
        features (row-parallel, ``x`` sharded on its features): the local
        shards and the slices of ``w_q``/``s_w`` that match them, a
        row-parallel layer's model group, and a wrap that hands the
        product to DTensor (output features sharded; a row-parallel
        layer's sums reduced when ``summed``, else partial, as the float
        layer's) so that the bias is added there."""
        w = self.weight
        static = self.mode == "static"
        w_q, s_w = ((_plain(self.w_q), _plain(self.s_w)) if static
                    else (None, None))
        if not isinstance(w, DTensor):
            return x, w, w_q, s_w, None, None
        mesh, rank, n = w.device_mesh, w.device_mesh.get_local_rank(), \
            w.device_mesh.size()
        row = w.placements[0] == Shard(1)
        if isinstance(x, DTensor):
            # a whole x (column-parallel) gets from this rank the part of
            # its gradient that this rank's output features give: a
            # partial sum over the model group
            x = x.to_local(grad_placements=[Partial()]
                           if x.placements[0].is_replicate() else None)
        if static:
            w_q = w_q.chunk(n, 1 if row else 0)[rank].contiguous()
            s_w = s_w if row else s_w.chunk(n)[rank]

        def wrap(y, summed=False):
            out = (Replicate() if summed else Partial()) if row \
                else Shard(-1)
            return DTensor.from_local(y, mesh, [out], run_check=False)

        return x, w.to_local(), w_q, s_w, mesh.get_group() if row \
            else None, wrap

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, w, w_q, s_w, group, wrap = self._local(x)
        if x.numel() == 0:
            # a zero-length segment: the max has no identity and the
            # output is empty anyway
            return self._float(x, w, wrap)
        if self.mode == "calib":
            self._record(x)
            return self._float(x, w, wrap)
        if self.mode == "qat":
            return self._float(fake_quant(x, None, self.act_groups),
                               fake_quant(w, 1, self.weight_groups), wrap)
        if self.mode == "static":
            self._check_attached()
            x_q, s_x = self._static_x(x)
        else:
            w_q, s_w = quantize_symmetric(w, 1, self.weight_groups)
            x_q, s_x = quantize_symmetric(x, None, self.act_groups)
        return self._int8(x_q, s_x, w_q, s_w, group, wrap)

    @torch.no_grad()
    def _record(self, x):
        """calib: the running max |x| of the global activation."""
        amax = _group_max(x.float().abs().amax(), self.act_groups)
        act_amax = _plain(self.act_amax)
        act_amax.copy_(torch.maximum(act_amax, amax))


def set_groups(model: torch.nn.Module, data_group=None, model_group=None,
               row_parallel=lambda name: False) -> None:
    """Gives ``model``'s ``Int8Linear`` layers the process groups that hold
    the rest of their global tensors: ``data_group`` shards the batch, and
    ``model_group`` the input features of the layers that
    ``row_parallel(name)`` names (their activations and their weights'
    rows).  None: no such group."""
    for name, m in quant_layers(model).items():
        row = model_group is not None and row_parallel(name)
        m.act_groups = tuple(g for g in (data_group,
                                         model_group if row else None)
                             if g is not None)
        m.weight_groups = (model_group,) if row else ()


def quant_layers(model: torch.nn.Module, mode: Optional[str] = None
                 ) -> Dict[str, Int8Linear]:
    """The model's ``Int8Linear`` modules by name (those in ``mode``)."""
    return {n: m for n, m in model.named_modules()
            if isinstance(m, Int8Linear) and mode in (None, m.mode)}


@torch.no_grad()
def reset_calibration(model: torch.nn.Module) -> None:
    """Zeroes the running max of every calibration layer, as JAX starts its
    calibration from a zero "quant" collection.  A model built on the meta
    device and moved with ``to_empty`` holds uninitialised memory there."""
    for m in quant_layers(model, "calib").values():
        m.act_amax.zero_()


def calibration_amax(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The running max |x| that a calibration model's layers recorded,
    ``{"<module>.act_amax": tensor}``."""
    return {f"{n}.act_amax": _plain(m.act_amax).detach().clone()
            for n, m in quant_layers(model, "calib").items()}


@torch.no_grad()
def build_quant_collection(model: torch.nn.Module,
                           act_amax: Optional[Dict] = None,
                           margin: float = 1.0) -> Dict[str, torch.Tensor]:
    """The collection of an ``int8_static`` model: ``w_q``/``s_w`` quantized
    from the weights of ``model``'s ``Int8Linear`` layers (in any mode:
    they name the quantized layers), ``act_scale`` = max(amax x margin,
    1e-8) from ``act_amax`` (``calibration_amax``), 1.0 where it has none."""
    act_amax = act_amax or {}
    out = {}
    for name, m in quant_layers(model).items():
        # a sharded weight (tensor parallelism, FSDP) whole
        w = m.weight.full_tensor() if isinstance(m.weight, DTensor) \
            else m.weight
        out[f"{name}.w_q"], out[f"{name}.s_w"] = quantize_symmetric(w, 1)
        a = act_amax.get(f"{name}.act_amax")
        out[f"{name}.act_scale"] = (
            torch.ones((), device=m.weight.device) if a is None
            else torch.clamp(torch.as_tensor(a, dtype=torch.float32,
                                             device=m.weight.device)
                             * margin, min=1e-8))
    return out


def requantize_weights(model: torch.nn.Module,
                       qcol: Dict[str, torch.Tensor]
                       ) -> Dict[str, torch.Tensor]:
    """``w_q``/``s_w`` quantized from ``model``'s current weights (the ones
    being served, for example the EMA weights), with the ``act_scale``
    entries of ``qcol``; raises when ``qcol`` lacks one (a layout
    mismatch must fail loudly: a silent 1.0 saturates)."""
    fresh = build_quant_collection(model)
    missing = [k for k in fresh if k.endswith(".act_scale")
               and k not in qcol]
    if missing:
        raise ValueError(
            f"calibration artifact has no act_scale for {missing[:3]}"
            f"{'...' if len(missing) > 3 else ''}: was it calibrated with "
            "a different model layout (names, num_layers)?")
    for k in fresh:
        if k.endswith(".act_scale"):
            fresh[k] = torch.as_tensor(qcol[k], dtype=torch.float32).to(
                fresh[k].device)
    return fresh


@torch.no_grad()
def set_quant_collection(model: torch.nn.Module,
                         qcol: Dict[str, torch.Tensor]) -> None:
    """Copies a collection into the ``int8_static`` layers' buffers."""
    for name, m in quant_layers(model, "static").items():
        for leaf in ("w_q", "s_w", "act_scale"):
            _plain(getattr(m, leaf)).copy_(qcol[f"{name}.{leaf}"])
        m.attached = True


def attach_static_quant(model: torch.nn.Module,
                        quant_npz: Optional[str] = None) -> torch.nn.Module:
    """Gives ``model``'s ``int8_static`` layers their quant tensors, in
    place: with ``quant_npz`` (``tools/quantize_serving.py``'s artifact)
    its ``act_scale`` entries, with ``w_q``/``s_w`` re-quantized from the
    weights the model holds now; without it, activation scales of 1.0,
    which saturate post-LN activations (a loud warning says so).  A model
    without static layers is returned as it is, unless ``quant_npz`` was
    given: then it raises."""
    static = quant_layers(model, "static")
    if quant_npz is not None:
        if not static:
            raise SystemExit(
                "--quant-collection given but the model has no quant "
                "layers; set model.vis_enc.quant=int8_static")
        qcol = load_quant_collection(quant_npz, only=("act_scale",))
        set_quant_collection(model, requantize_weights(model, qcol))
    elif static:
        logging.getLogger("simvg_tpu_torch").warning(
            "int8_static without --quant-collection: activation scales "
            "default to 1.0, which saturates post-LN activations and "
            "destroys accuracy. Calibrate with "
            "python -m simvg_tpu_torch.tools.quantize_serving and pass the "
            ".npz.")
        set_quant_collection(model, build_quant_collection(model))
    return model


def save_quant_collection(path: str, qcol: Dict[str, torch.Tensor]) -> None:
    """Writes a collection as JAX's ``.npz`` artifact: keys are the flax
    paths ('/'-joined), ``w_q`` is stored [in, out]."""
    out = {}
    for key, v in qcol.items():
        a = v.detach().cpu().numpy()
        out[quant_key_to_jax(key)] = a.T.copy() if key.endswith(".w_q") \
            else a
    np.savez(path, **out)


def load_quant_collection(path: str, only: Optional[Sequence[str]] = None
                          ) -> Dict[str, torch.Tensor]:
    """Inverse of ``save_quant_collection``, and the reader of the JAX
    tool's artifacts, including a stacked one (calibrated under
    ``scan_layers=True``: ``layers/...`` with a leading layer axis), which
    is split into its layers.  ``only`` keeps the named leaf kinds (for
    example ``("act_scale",)``)."""
    out = {}
    with np.load(path) as z:
        for key in z.files:
            if only is not None and key.split("/")[-1] not in only:
                continue
            for name, a in quant_keys_from_jax(key, z[key]):
                if name.endswith(".w_q"):
                    a = a.T
                out[name] = torch.from_numpy(np.array(a, order="C"))
    return out
