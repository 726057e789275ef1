"""The port's parameter layout (``simvg_tpu_torch.parallel.mesh``) held to
JAX's ``param_partition_spec`` (``simvg_tpu/parallel/mesh.py``), and the
process-group entry.

- Every leaf of the tiny config, on the 4x2 and 8x1 meshes of the virtual
  CPU devices, with fsdp off and on and ``fsdp_min_size`` 0 and the
  default: the port's spec on the torch leaf equals JAX's on the flax leaf
  moved to torch layout by ``export_simvg_full`` itself (a marker array
  along each sharded dim shows where the dim lands: transposed Dense
  kernels, the HWIO conv, the packed ``in_proj_weight``).
- The rules of tests/test_fsdp.py in torch layout: the largest divisible
  dim, ties to flax's first dim, TP composed with FSDP, the odd vocab
  falling through to D, the patch conv choosing among its (I, O) dims and
  never kH/kW, small and 1-D leaves replicated.
- ``init_distributed`` raises without a launcher's environment and reads
  torchrun's or the JAX launcher's; a 1-rank FSDP2 layout, the card's,
  trains as the unwrapped model does.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
from simvg_tpu.parallel import create_mesh as jax_create_mesh
from simvg_tpu.parallel.mesh import param_partition_spec as jax_spec
from simvg_tpu_torch.convert import _flatten, export_simvg_full
from simvg_tpu_torch.parallel import init_distributed, param_partition_spec
from util_torch_port import free_port, jax_tiny_model, np_batch, to_jax


@pytest.fixture(scope="module")
def tiny_params():
    shapes = jax.eval_shape(jax_tiny_model().init, jax.random.PRNGKey(0),
                            **to_jax(np_batch()))
    return jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)


def _nest(flat):
    out = {}
    for path, v in flat.items():
        node = out
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def _jax_specs_in_torch_layout(params, mesh, fsdp, min_size):
    """torch name -> JAX's spec moved to torch layout: for each mesh axis,
    every flax leaf gets a marker (its index along the dim that axis
    shards, 0 elsewhere), and the exported torch tensor varies along the
    dim that axis lands on."""
    flat = _flatten(params["params"])
    specs = {p: tuple(jax_spec(p, v, mesh, fsdp, min_size))
             for p, v in flat.items()}
    out = {}
    for axis in ("data", "model"):
        marked = {}
        for path, v in flat.items():
            spec = specs[path] + (None,) * (v.ndim - len(specs[path]))
            m = np.zeros(v.shape, np.float32)
            if axis in spec:
                d = spec.index(axis)
                shape = [1] * v.ndim
                shape[d] = v.shape[d]
                m = m + np.arange(1, v.shape[d] + 1).reshape(shape)
            marked[path] = m
        for name, t in export_simvg_full({"params": _nest(marked)}).items():
            spec = out.setdefault(name, [None] * t.ndim)
            for d in range(t.ndim):
                if t.shape[d] > 1 and np.any(np.diff(t, axis=d) != 0):
                    spec[d] = axis
    return {k: tuple(v) for k, v in out.items()}


@pytest.mark.parametrize("model_parallel", [2, 1])
@pytest.mark.parametrize("fsdp,min_size", [(False, 1 << 16), (True, 0),
                                           (True, 1 << 16)])
def test_spec_equals_jax_on_every_leaf(tiny_params, model_parallel, fsdp,
                                       min_size):
    mesh = jax_create_mesh(8, model_parallel=model_parallel)
    want = _jax_specs_in_torch_layout(tiny_params, mesh, fsdp, min_size)
    shapes = {k: v.shape for k, v in export_simvg_full(tiny_params).items()}
    assert sorted(want) == sorted(shapes)
    mesh_shape = dict(mesh.shape)
    sharded = 0
    for name, shape in shapes.items():
        got = param_partition_spec(name, shape, mesh_shape, fsdp, min_size)
        assert got == want[name], (name, shape, got, want[name])
        sharded += any(got)
    # the cases that shard here do: TP on the 4x2 mesh, FSDP at min size 0
    if model_parallel > 1 or (fsdp and not min_size):
        assert sharded >= 16, sharded


DP4 = {"data": 4, "model": 2}


@pytest.mark.parametrize("name,shape,mesh,min_size,want", [
    # a Dense kernel [in=64, out=32]: its largest dim, torch's dim 1
    ("head.mlp.layers.0.weight", (32, 64), DP4, 0, (None, "data")),
    # column-parallel fc1 ("model" on its outputs) with FSDP on its inputs
    ("vis_enc.beit3.encoder.layers.0.ffn.A.fc1.weight", (64, 32), DP4, 0,
     ("model", "data")),
    # row-parallel out_proj: "model" on its inputs, FSDP on its outputs
    ("vis_enc.beit3.encoder.layers.3.self_attn.out_proj.B.weight", (32, 32),
     DP4, 0, ("data", "model")),
    # a tie [32, 32]: flax's first dim (in), torch's dim 1
    ("head.input_text_proj.weight", (32, 32), {"data": 4, "model": 1}, 0,
     (None, "data")),
    # the odd vocab: 65 rows over dp=4 fall through to D
    ("vis_enc.beit3.text_embed.weight", (65, 32), DP4, 0, (None, "data")),
    # the flagship's 64010-row vocab at dp=8
    ("vis_enc.beit3.text_embed.weight", (64010, 768),
     {"data": 8, "model": 1}, 1 << 16, (None, "data")),
    # the patch conv OIHW [32, 3, 32, 32]: JAX chooses among (I, O) =
    # (3, 32) of HWIO, O here, torch's dim 0; never kH or kW
    ("vis_enc.beit3.vision_embed.proj.weight", (32, 3, 32, 32), DP4, 0,
     ("data", None, None, None)),
    # the packed q/k/v of a head attention: three [32, 32] kernels, a tie
    ("head.transformer.decoder.layers.0.attentions.0.attn.in_proj_weight",
     (96, 32), {"data": 4, "model": 1}, 0, (None, "data")),
    # ... whose JAX leaves (1024 elements each) stay below 2048
    ("head.transformer.decoder.layers.0.attentions.0.attn.in_proj_weight",
     (96, 32), {"data": 4, "model": 1}, 2048, (None, None)),
    # small leaves at the default threshold, and 1-D leaves always
    ("head.mlp.layers.0.weight", (32, 64), DP4, 1 << 16, (None, None)),
    ("vis_enc.beit3.encoder.layers.0.ffn.A.fc1.bias", (1 << 20,), DP4, 0,
     (None,)),
    # the CLS token [1, 1, D] keeps flax's layout
    ("vis_enc.beit3.vision_embed.cls_token", (1, 1, 32), DP4, 0,
     (None, None, "data")),
])
def test_spec_rules_in_torch_layout(name, shape, mesh, min_size, want):
    assert param_partition_spec(name, shape, mesh, True, min_size) == want


def test_init_distributed_needs_a_launcher(monkeypatch):
    for key in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
                "COORDINATOR_ADDRESS"):
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(RuntimeError, match="launcher"):
        init_distributed("cpu")
    assert not dist.is_initialized()


@pytest.mark.parametrize("launcher", ["torchrun", "jax"])
def test_init_distributed_reads_the_launchers(monkeypatch, launcher):
    port = free_port()
    for key in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
                "COORDINATOR_ADDRESS", "LOCAL_RANK"):
        monkeypatch.delenv(key, raising=False)
    if launcher == "torchrun":
        env = dict(RANK="0", WORLD_SIZE="1", MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port))
    else:
        env = dict(COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                   NUM_PROCESSES="1", PROCESS_ID="0")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    try:
        assert init_distributed("cpu") == 0
        assert dist.get_backend() == "gloo"
        assert (dist.get_rank(), dist.get_world_size()) == (0, 1)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_one_rank_fsdp_takes_fsdp2s_path(monkeypatch):
    """At dp=1 JAX's spec shards nothing, but a 1-rank ``--distributed``
    run still lays the leaves it would shard at a larger dp out as FSDP2
    shards (the path a card runs alone), and two train steps there equal
    two steps of the unwrapped model."""
    from torch.distributed.tensor import DTensor

    from simvg_tpu_torch.engine import (create_optimizer, create_train_state,
                                        make_train_step)
    from simvg_tpu_torch.parallel import create_mesh, shard_model
    from test_torch_train import BLW, _batch, _models

    for key in ("COORDINATOR_ADDRESS", "LOCAL_RANK"):
        monkeypatch.delenv(key, raising=False)
    for k, v in dict(RANK="0", WORLD_SIZE="1", MASTER_ADDR="127.0.0.1",
                     MASTER_PORT=str(free_port())).items():
        monkeypatch.setenv(k, v)
    batch = {k: torch.from_numpy(v)
             for k, v in _batch("refcoco", b=2).items()}
    runs = []
    init_distributed("cpu")
    try:
        for layout in (False, True):
            model = _models("refcoco")[1]
            torch.manual_seed(0)
            for p in model.parameters():
                torch.nn.init.normal_(p, std=0.05)
            sharded = (shard_model(model, create_mesh(1, "cpu"), fsdp=True,
                                   fsdp_min_size=1024) if layout else None)
            opt = create_optimizer(1e-3, 1000)
            state = create_train_state(model, opt)
            step = make_train_step(model, opt, branch_loss_weight=BLW,
                                   sharded=sharded)
            for _ in range(2):
                state, scalars = step(state, batch, 1)
            runs.append((model, scalars))
        (plain, s1), (fsdp, s2) = runs
        assert sum(isinstance(p, DTensor) for p in fsdp.parameters()) >= 20
        for k, v in s1.items():
            assert float(s2[k]) == pytest.approx(float(v), rel=1e-6), k
        for (n, a), b in zip(plain.named_parameters(), fsdp.parameters()):
            b = b.full_tensor() if isinstance(b, DTensor) else b
            torch.testing.assert_close(b.detach(), a.detach(), rtol=1e-5,
                                       atol=1e-6, msg=n)
    finally:
        dist.destroy_process_group()


def test_data_ranks_draw_their_own_masks(monkeypatch):
    """Each data-parallel rank folds its rank into the step's generator
    seed: rank 0 draws the single-device run's drop-path masks, rank 1
    others, and the same rank the same again."""
    import dataclasses

    from simvg_tpu_torch.engine import (create_optimizer, create_train_state,
                                        make_train_step)
    from simvg_tpu_torch.models import beit3
    from test_torch_train import BLW, _batch, _models

    @dataclasses.dataclass
    class OneRank:  # the train step's view of a layout, without a group
        module: torch.nn.Module
        dp_rank: int
        dp: int = 1

        def batch_sum(self, t):
            return t.detach().clone()

        def sync_grads(self, params):
            pass

        @staticmethod
        def norm_groups(params):
            return [() for _ in params]

    drawn = []
    real = beit3.keep_mask

    def recording(shape, keep, generator, device):
        mask = real(shape, keep, generator, device)
        drawn[-1].append(mask.clone())
        return mask

    monkeypatch.setattr(beit3, "keep_mask", recording)
    batch = {k: torch.from_numpy(v)
             for k, v in _batch("refcoco", b=8).items()}
    for rank in (None, 0, 1, 1):
        model = _models("refcoco")[1]
        for layer in model.vis_enc["beit3"].encoder.layers:
            layer.drop_path.rate = 0.5
        opt = create_optimizer(1e-3, 1000)
        step = make_train_step(
            model, opt, branch_loss_weight=BLW,
            sharded=None if rank is None else OneRank(model, rank))
        drawn.append([])
        step(create_train_state(model, opt), batch, 1)
    single, r0, r1, r1_again = (torch.cat([m.flatten() for m in d])
                                for d in drawn)
    assert torch.equal(single, r0) and torch.equal(r1, r1_again)
    assert not torch.equal(r0, r1)
