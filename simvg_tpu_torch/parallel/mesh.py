"""Process groups, the device mesh and the parameter layout (port of
``simvg_tpu/parallel/mesh.py``).

JAX lays one ``Mesh(("data", "model"))`` over its devices and lets pjit
place every leaf by ``param_partition_spec``.  The port keeps the mesh and
the spec and places the leaves with PyTorch's own machinery:

- **data**: one process per card, each on its shard of the global batch
  (``samples_per_gpu`` x dp samples a step).  ``DistributedDataParallel``
  averages the gradients; the criterion's batch statistics are summed over
  the axis first (``Sharded.batch_sum``), so the loss is JAX's global-batch
  loss (``losses/criterion.py``).
- **model**: tensor parallelism by DTensor ``parallelize_module``:
  column-parallel q/k/v and fc1, row-parallel out_proj and fc2, with the
  encoder's sub-LayerNorms between them on the gathered features.  With
  ``seq_parallel`` the residual stream between the blocks is sharded over
  the sequence on this axis (``SeqShard``), odd segment lengths included.
- **fsdp**: FSDP2 ``fully_shard`` on each encoder layer and at the root,
  sharding every leaf of at least ``fsdp_min_size`` elements over "data"
  on the dim the spec picks (ZeRO-3: params, grads, and, through the train
  state's local shards, the optimizer moments and the EMA); smaller leaves
  stay replicated and their gradients are averaged by the train step.

``init_distributed`` reads torchrun's environment (or the JAX launcher's
``COORDINATOR_ADDRESS``/``NUM_PROCESSES``/``PROCESS_ID``); NCCL serves the
card and gloo the CPU.  A run without ``--distributed`` builds no mesh and
stays on one device, where fsdp and the model axis shard nothing.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import re
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)
from torch.distributed.tensor.parallel import (ColwiseParallel,
                                               PrepareModuleInput,
                                               RowwiseParallel,
                                               parallelize_module)

# FSDP/ZeRO: leaves smaller than this stay replicated (biases, LayerNorm
# scales: gathering them costs more latency than their bytes save)
FSDP_MIN_SIZE = 1 << 16

# tensor-parallel rules by state-dict name (JAX's by flax path,
# ``fc1_A/kernel`` ...): column-parallel up-projections shard the output
# features, torch's dim 0; row-parallel down-projections the input
# features, torch's dim 1
_COL_PARALLEL = re.compile(
    r"(self_attn\.[qkv]_proj\.[AB]|ffn\.[AB]\.fc1)\.weight$")
_ROW_PARALLEL = re.compile(
    r"(self_attn\.out_proj\.[AB]|ffn\.[AB]\.fc2)\.weight$")
# leaves whose torch layout is flax's: embedding tables, the CLS and mask
# tokens; every other 2-D weight is a transposed Dense kernel
_SAME_LAYOUT = re.compile(
    r"(text_embed|embed_positions\.[AB]|query_embed)\.weight$"
    r"|(cls_token|mask_token)$")

Spec = Tuple[Optional[str], ...]


def init_distributed(device: str = "cuda",
                     timeout: Optional[datetime.timedelta] = None) -> int:
    """Joins the process group that the launcher's environment describes
    and returns this process's local rank.

    torchrun sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``
    and ``MASTER_PORT``; the JAX launcher's contract (``tools/
    dist_train.sh``: ``COORDINATOR_ADDRESS=host:port``, ``NUM_PROCESSES``,
    ``PROCESS_ID``) is read where torchrun's is absent.  NCCL on ``cuda``
    (after ``torch.cuda.set_device(LOCAL_RANK)``), gloo on ``cpu``.
    Raises when neither environment is there.  A process that has joined
    a group already (with its own timeout, say) keeps it."""
    env = os.environ
    if dist.is_initialized():
        return int(env.get("LOCAL_RANK", 0))
    if "RANK" in env or "COORDINATOR_ADDRESS" not in env:
        missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR",
                               "MASTER_PORT") if k not in env]
        if missing:
            raise RuntimeError(
                f"--distributed needs a launcher's environment; {missing} "
                "unset (run under torchrun, or set COORDINATOR_ADDRESS, "
                "NUM_PROCESSES and PROCESS_ID)")
        addr = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
        rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
    else:
        addr = env["COORDINATOR_ADDRESS"]
        rank, world = int(env["PROCESS_ID"]), int(env["NUM_PROCESSES"])
    local_rank = int(env.get("LOCAL_RANK", 0))
    if device == "cuda":
        torch.cuda.set_device(local_rank)
        backend = "nccl"
    elif device == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"unsupported device {device!r}")
    kw = {} if timeout is None else {"timeout": timeout}
    dist.init_process_group(backend, init_method=f"tcp://{addr}",
                            rank=rank, world_size=world, **kw)
    return local_rank


def create_mesh(model_parallel: int = 1,
                device_type: str = "cuda") -> DeviceMesh:
    """The ("data", "model") mesh over every rank of the process group:
    world / model_parallel by model_parallel."""
    world = dist.get_world_size()
    if world % model_parallel:
        raise ValueError(f"create_mesh: {world} ranks not divisible by "
                         f"model_parallel={model_parallel}")
    return init_device_mesh(device_type,
                            (world // model_parallel, model_parallel),
                            mesh_dim_names=("data", "model"))


def _flax_view(name: str, shape: Sequence[int]):
    """(the JAX leaf's ndim, its element count, its two trailing dims'
    sizes, the torch dims they are) for the torch leaf ``name``: a Dense
    kernel [in, out] is torch's [out, in]; a conv kernel HWIO torch's OIHW
    (and the head's 1x1 ``input_proj``, a Dense kernel in JAX, torch's
    [out, in, 1, 1]); the packed ``in_proj_weight`` [3D, D] is three
    [D, D] kernels; embeddings and tokens keep their layout."""
    n = 1
    for s in shape:
        n *= s
    if len(shape) == 4:
        return 4, n, (shape[1], shape[0]), (1, 0)
    if len(shape) < 2 or _SAME_LAYOUT.search(name):
        return len(shape), n, tuple(shape[-2:]), tuple(range(len(shape))[-2:])
    if name.endswith("in_proj_weight"):
        return 2, n // 3, (shape[1], shape[0] // 3), (1, 0)
    return 2, n, (shape[1], shape[0]), (1, 0)


def param_partition_spec(name: str, shape: Sequence[int],
                         mesh_shape: Dict[str, int], fsdp: bool = False,
                         fsdp_min_size: int = FSDP_MIN_SIZE) -> Spec:
    """The mesh axis of each dim of the torch leaf ``name`` (None:
    replicated), JAX's ``param_partition_spec`` in torch layout.

    "model" goes on the output features (dim 0) of the column-parallel
    weights and the input features (dim 1) of the row-parallel ones, when
    the model axis is larger than 1.  With ``fsdp`` and a data axis larger
    than 1, a leaf whose JAX counterpart has two or more dims and at least
    ``fsdp_min_size`` elements gets "data" on the largest of that leaf's
    two trailing dims that is still free and that dp divides, the first in
    flax's order on a tie (JAX's stable sort); the torch dim is the one
    that flax dim became (``_flax_view``).  A 64010-row vocab falls
    through to D; a leaf no dim of which dp divides stays replicated."""
    shape = tuple(int(s) for s in shape)
    spec: List[Optional[str]] = [None] * len(shape)
    if mesh_shape.get("model", 1) > 1 and len(shape) == 2:
        if _COL_PARALLEL.search(name):
            spec[0] = "model"
        elif _ROW_PARALLEL.search(name):
            spec[1] = "model"
    dp = mesh_shape.get("data", 1)
    if fsdp and dp > 1:
        d = fsdp_dim(name, shape, dp, fsdp_min_size, spec)
        if d is not None:
            spec[d] = "data"
    return tuple(spec)


def fsdp_dim(name: str, shape: Sequence[int], dp: int, fsdp_min_size: int,
             spec: Sequence[Optional[str]]) -> Optional[int]:
    """The torch dim that FSDP shards over a data axis of ``dp`` (JAX's
    rule, ``param_partition_spec``), None for a leaf it leaves
    replicated; ``spec``: the dims the model axis took already."""
    ndim, size, sizes, dims = _flax_view(name, tuple(shape))
    if ndim < 2 or size < fsdp_min_size:
        return None
    for i in sorted(range(2), key=lambda i: -sizes[i]):
        if spec[dims[i]] is None and sizes[i] % dp == 0:
            return dims[i]
    return None


def local(t: torch.Tensor) -> torch.Tensor:
    """This rank's shard of ``t`` (``t`` itself when it is no DTensor);
    in-place updates of the result update ``t``."""
    return t.to_local() if isinstance(t, DTensor) else t


def full_tensor(shard: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """The whole tensor of which ``shard`` is this rank's part, laid out as
    the parameter ``like`` (a collective when ``like`` is a DTensor)."""
    if not isinstance(like, DTensor):
        return shard
    return DTensor.from_local(shard, like.device_mesh, like.placements,
                              run_check=False, shape=like.shape,
                              stride=like.stride()).full_tensor()


def shard_of(full: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """This rank's part of ``full`` in the layout of the parameter
    ``like`` (scattered from rank 0 when ``like`` is a DTensor)."""
    full = full.to(device=like.device, dtype=like.dtype)
    if not isinstance(like, DTensor):
        return full
    return distribute_tensor(full, like.device_mesh,
                             like.placements).to_local()


def _norm_groups(p: torch.Tensor) -> Tuple[dist.ProcessGroup, ...]:
    """The groups over which a shard's square sum adds up to the whole
    tensor's: one for each mesh dim that shards ``p``."""
    if not isinstance(p, DTensor):
        return ()
    return tuple(p.device_mesh.get_group(i)
                 for i, pl in enumerate(p.placements) if pl.is_shard())


@dataclasses.dataclass
class Sharded:
    """A model laid out on a mesh, and what its train step needs to know
    of the layout.

    module: what the train step calls (the model, or its DDP wrapper).
    mesh: the ("data", "model") mesh.
    synced: the parameters no wrapper reduces, whose gradients the step
        averages over "data" itself (``sync_grads``): with FSDP the
        replicated small leaves, with tensor parallelism and no FSDP all.
    seq_summed: under sequence parallelism the parameters that act on the
        sequence shards (the encoder's LayerNorms between the blocks):
        each model rank's gradient covers its tokens only, and the step
        sums them over "model".
    """

    module: nn.Module
    mesh: DeviceMesh
    synced: List[nn.Parameter]
    seq_summed: List[nn.Parameter] = dataclasses.field(default_factory=list)

    @property
    def dp(self) -> int:
        return self.mesh["data"].size()

    @property
    def dp_rank(self) -> int:
        return self.mesh["data"].get_local_rank()

    def batch_sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the data axis (a new tensor on the mesh's
        device, no gradient)."""
        out = t.detach().to(self.mesh.device_type, copy=True)
        if self.dp > 1:
            dist.all_reduce(out, group=self.mesh["data"].get_group())
        return out

    def sync_grads(self, params: Sequence[torch.Tensor]) -> None:
        """After the backward: lays each DTensor gradient of ``params`` out
        as its parameter (DTensor may return a replicated parameter's
        gradient sharded), then averages the gradients of ``synced`` over
        the data axis, one all-reduce for all of them."""
        for p in params:
            if isinstance(p.grad, DTensor) and p.grad.placements != \
                    p.placements:
                p.grad = p.grad.redistribute(p.device_mesh, p.placements)
        _all_reduce(self.seq_summed, self.mesh["model"])
        _all_reduce(self.synced, self.mesh["data"], average=True)

    @staticmethod
    def norm_groups(params: Sequence[torch.Tensor]):
        """For each parameter, the groups over which its shards' square
        sums add up (``train_state.global_norm``)."""
        return [_norm_groups(p) for p in params]


def _all_reduce(params: Sequence[torch.Tensor], mesh: DeviceMesh,
                average: bool = False) -> None:
    """Sums (or averages) the local gradients of ``params`` over the 1-D
    ``mesh``, in one all-reduce."""
    grads = [local(p.grad) for p in params if p.grad is not None]
    if mesh.size() == 1 or not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=mesh.get_group())
    if average:
        flat /= mesh.size()
    torch._foreach_copy_(grads, [x.view_as(g) for g, x in zip(
        grads, flat.split([g.numel() for g in grads]))])


class _ColwiseBySpec(ColwiseParallel):
    """Column-parallel ``Linear`` laid out as JAX lays it: the weight
    sharded on its output features, the bias replicated (JAX's rule
    places kernels only)."""

    def _partition_linear_fn(self, name, module, device_mesh):
        for pname, placement in (("weight", Shard(0)),
                                 ("bias", Replicate())):
            param = getattr(module, pname)
            module.register_parameter(pname, nn.Parameter(
                distribute_tensor(param, device_mesh, [placement]),
                requires_grad=param.requires_grad))


def _tp_plan(model: nn.Module, seq_parallel: bool) -> Dict[str, object]:
    """The parallelize_module plan of every encoder layer: q/k/v and fc1
    column-parallel, out_proj and fc2 row-parallel, and the sub-LayerNorm
    between them (``inner_attn_ln``, ``ffn_layernorm``: a LayerNorm over
    the sharded features) on the features gathered first.  With
    ``seq_parallel`` the row-parallel products reduce-scatter over the
    sequence in place of the all-reduce."""
    out = Shard(1) if seq_parallel else Replicate()
    gather = PrepareModuleInput(input_layouts=Shard(-1),
                                desired_input_layouts=Replicate(),
                                use_local_output=True)
    plan: Dict[str, object] = {}
    for name, _ in model.named_modules():
        if _COL_PARALLEL.search(name + ".weight"):
            plan[name] = _ColwiseBySpec()
        elif _ROW_PARALLEL.search(name + ".weight"):
            plan[name] = RowwiseParallel(input_layouts=Replicate(),
                                         output_layouts=out)
        elif re.search(r"\.self_attn\.inner_attn_ln\.[AB]$", name) or \
                re.search(r"\.ffn\.[AB]\.ffn_layernorm$", name):
            plan[name] = gather
    return plan


def shard_model(model: nn.Module, mesh: DeviceMesh, *, fsdp: bool = False,
                fsdp_min_size: int = FSDP_MIN_SIZE) -> Sharded:
    """Lays ``model`` out on ``mesh`` by ``param_partition_spec``, in place:

    - model axis > 1: tensor parallelism (``_tp_plan``), and the encoder's
      sequence parallelism when its config sets ``seq_parallel``;
    - ``fsdp``: FSDP2 ``fully_shard`` on each encoder layer, then the root,
      each leaf on its spec's "data" dim, leaves without one replicated (at
      dp=1, where JAX's spec shards nothing, the leaves it would shard at
      any larger dp take FSDP2's path as one shard);
    - otherwise, with a model axis of 1: ``DistributedDataParallel``.

    Every world size takes its path, 1 included.  Returns the ``Sharded``
    the train step takes."""
    from simvg_tpu_torch.models.beit3 import BEiT3Encoder, EncoderLayer

    mp, dp = mesh["model"].size(), mesh["data"].size()
    encoders = [m for m in model.modules() if isinstance(m, BEiT3Encoder)]
    seq_summed: List[nn.Parameter] = []
    if mp > 1:
        seq = any(enc.cfg.seq_parallel for enc in encoders)
        parallelize_module(model, mesh["model"], _tp_plan(model, seq))
        for enc in (e for e in encoders if e.cfg.seq_parallel):
            enc.seq_mesh = mesh["model"]
            for layer in enc.encoder.layers:
                seq_summed += list(layer.self_attn_layer_norm.parameters())
                seq_summed += list(layer.final_layer_norm.parameters())
            seq_summed += list(enc.encoder.layer_norm.parameters())
    if fsdp:
        from torch.distributed.fsdp import fully_shard

        # the leaves param_partition_spec shards over "data", by the same
        # rule at every dp: a 1-rank group takes FSDP2's path too
        placement: Dict[int, Shard] = {}
        replicated = set()
        for name, p in model.named_parameters():
            tp = param_partition_spec(name, p.shape, {"model": mp})
            d = fsdp_dim(name, p.shape, dp, fsdp_min_size, tp)
            if d is None:
                replicated.add(p)
            else:
                placement[id(p)] = Shard(d)

        def kw():  # resharded after every forward, the root's too, so
            # that model.parameters() are the shards outside a step
            return dict(mesh=mesh["data"], ignored_params=replicated,
                        reshard_after_forward=True,
                        shard_placement_fn=lambda p: placement[id(p)])

        for layer in [m for m in model.modules()
                      if isinstance(m, EncoderLayer)]:
            fully_shard(layer, **kw())
        fully_shard(model, **kw())
        return Sharded(model, mesh, [p for p in model.parameters()
                                     if p in replicated], seq_summed)
    if mp > 1:
        return Sharded(model, mesh, list(model.parameters()), seq_summed)
    device = next(model.parameters()).device
    # find_unused_parameters: no forward uses the BEiT-3 mask token
    ddp = nn.parallel.DistributedDataParallel(
        model, device_ids=[device.index] if device.type == "cuda" else None,
        process_group=mesh["data"].get_group(), find_unused_parameters=True)
    return Sharded(ddp, mesh, [])


class SeqShard:
    """Sequence parallelism of one encoder forward: the (vision, text)
    residual stream sharded over the sequence on the model axis between
    the blocks, as JAX's ``_seq_shard`` constrains it, at any segment
    length (a length the axis does not divide gives uneven shards,
    ``torch.chunk``'s, which DTensor's reduce-scatter yields too).

    ``shard`` takes a rank's part of whole segments; ``gather`` puts the
    whole segments back together before a block's column-parallel
    products (its backward keeps the rank's part of the gradient, which
    the column-parallel products have already all-reduced).  An empty
    segment (a single-modality encode) passes through both as it is."""

    def __init__(self, mesh: DeviceMesh, lengths: Tuple[int, int]):
        self.mesh = mesh
        self.lengths = lengths

    def shard(self, xs):
        return tuple(DTensor.from_local(x, self.mesh, [Replicate()],
                                        run_check=False)
                     .redistribute(self.mesh, [Shard(1)]).to_local()
                     if n else x for x, n in zip(xs, self.lengths))

    def gather(self, xs):
        out = []
        for x, n in zip(xs, self.lengths):
            if not n:
                out.append(x)
                continue
            shape = (x.shape[0], n) + tuple(x.shape[2:])
            stride = torch.empty(shape, device="meta").stride()
            out.append(DTensor.from_local(
                x, self.mesh, [Shard(1)], run_check=False, shape=shape,
                stride=stride).redistribute(self.mesh, [Replicate()])
                .to_local())
        return tuple(out)
