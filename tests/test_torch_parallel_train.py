"""simvg_tpu_torch's data, FSDP, tensor and sequence parallelism held
against simvg_tpu's global-batch train step, in 2-process gloo runs on the
CPU (``tests/_torch_parallel_worker.py``), as tests/test_fsdp.py and
tests/test_seq_parallel.py hold JAX's on its virtual mesh.

The tiny config of tests/test_torch_train.py (32 px, patch 16: a vision
segment of 5 tokens, odd; D=32, 4 heads, 2 layers; no random draw), one
global batch of 4 and the same weights go through JAX
``make_train_step(dp_size=dp)`` and, for two steps, through the port laid
out four ways on 2 ranks: DDP (dp=2, each rank 2 samples), FSDP2 with
remat (dp=2, ``fsdp_min_size`` 2048, so that both sharded and replicated
leaves occur), tensor parallelism (model=2) and tensor plus sequence
parallelism; and on 4 ranks all three at once (data 2 x model 2, as
tests/test_fsdp.py's ``test_fsdp_composes_with_tp_scan``).  Every
loss term and ``grad_norm`` agree at rtol 1e-4 (the clip's norm is the
whole gradient's), and the parameters and EMA after the steps at rtol 2e-4
/ atol 2e-5 (tests/test_fsdp.py's bounds), left out, as in
tests/test_torch_train.py, the elements whose JAX gradient is below 1e-6:
Adam moves those by up to +-lr from summation-order noise in either
package (the port's single-process gradient picks them: it is JAX's to
1e-5 of each tensor's max, tests/test_torch_train.py).
"""

import json
import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simvg_tpu.engine import create_optimizer as jax_create_optimizer
from simvg_tpu.engine import create_train_state as jax_create_train_state
from simvg_tpu.engine import make_train_step as jax_make_train_step
from simvg_tpu_torch.convert import export_simvg_full
from simvg_tpu_torch.engine.train import train_losses
from simvg_tpu_torch.models import init_random_weights
from simvg_tpu_torch.parallel import param_partition_spec
from test_torch_train import BLW, TINY_BEIT3, TINY_HEAD, _batch, _models
from util_torch_port import cheap_jit, jax_params_from_port, run_ranks
from util_torch_port import one_torch_thread  # noqa: F401

OPT = dict(lr=1e-3, steps_per_epoch=1000)
MIN_SIZE = 2048
# layout -> the data-parallel size of its mesh
DP = {"ddp": 2, "fsdp": 2, "tp": 1, "tp_sp": 1, "fsdp_tp_sp": 2}


def _live(tm, batch, dp):
    """name -> the elements whose first-step gradient (one process, the
    whole batch) is at least 1e-6 in magnitude."""
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    losses, _ = train_losses(tm, tb, tb["image"], branch_loss_weight=BLW,
                             dp_size=dp)
    tm.zero_grad()
    losses["loss_total"].backward()
    return {n: np.zeros(p.shape, bool) if p.grad is None
            else p.grad.abs().numpy() >= 1e-6
            for n, p in tm.named_parameters()}


def _jax_run(jm, params, batch, dp):
    """Two JAX steps on the global batch; the scalars and the parameters
    and EMA after them, by exported name."""
    tx = jax_create_optimizer(**OPT)
    state = jax_create_train_state(params, tx, ema=True)
    step = cheap_jit(jax_make_train_step(jm, tx, branch_loss_weight=BLW,
                                         ema_alpha=0.99, dp_size=dp))
    scalars = []
    for _ in range(2):
        state, s = step(state, batch, jax.random.PRNGKey(1))
        scalars.append({k: float(v) for k, v in s.items()})
    return dict(scalars=scalars,
                params=export_simvg_full(jax.tree.map(np.asarray,
                                                      state.params)),
                ema=export_simvg_full(jax.tree.map(np.asarray,
                                                   state.ema_params)))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("parallel_train")
    jm, tm = _models("refcoco")
    init_random_weights(tm, 0)
    batch = _batch("refcoco", b=4)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    params = jax_params_from_port(jm, {k: batch[k] for k in (
        "image", "text_ids", "text_padding_mask", "img_shape")},
        tm.state_dict())
    sd = export_simvg_full(params)
    np.savez(d / "inputs.npz", **{f"sd/{k}": v for k, v in sd.items()},
             **{f"batch/{k}": v for k, v in batch.items()})
    with open(d / "config.json", "w") as f:
        json.dump({"beit3": TINY_BEIT3, "head": dict(TINY_HEAD,
                                                     num_queries=1),
                   "optimizer": OPT, "blw": BLW,
                   "fsdp_min_size": MIN_SIZE}, f)
    run_ranks(2, ["tests/_torch_parallel_worker.py", "train", str(d)])
    run_ranks(4, ["tests/_torch_parallel_worker.py", "train", str(d),
                  "fsdp_tp_sp"])
    ref = {dp: dict(_jax_run(jm, params, jb, dp), live=_live(tm, batch, dp))
           for dp in (1, 2)}
    return d, ref


@pytest.mark.parametrize("layout", list(DP))
def test_parallel_train_steps_match_jax_global_batch(runs, layout):
    d, ref = runs
    want = ref[DP[layout]]
    got = np.load(d / f"{layout}.npz")
    scalars = json.loads(str(got["scalars"]))
    for step, (st, sj) in enumerate(zip(scalars, want["scalars"])):
        for k, v in sj.items():
            np.testing.assert_allclose(st[k], v, rtol=1e-4, atol=1e-6,
                                       err_msg=f"{layout} step {step} {k}")
    for name, pj in want["params"].items():
        live = want["live"][name]
        for kind, ref_tree in (("param", want["params"]),
                               ("ema", want["ema"])):
            np.testing.assert_allclose(got[f"{kind}/{name}"][live],
                                       ref_tree[name][live], rtol=2e-4,
                                       atol=2e-5,
                                       err_msg=f"{layout} {kind} {name}")


def test_fsdp_holds_a_dp_th_of_every_large_leaf(runs):
    """ZeRO-3: each rank holds half of every leaf that the spec shards
    (JAX's rule: two or more dims, >= fsdp_min_size elements) in its
    params, grads, the three amsgrad moments and the EMA; the other leaves
    stay whole."""
    d, _ = runs
    with open(d / "zero.json") as f:
        zero = json.load(f)
    sharded = 0
    for name, c in zero.items():
        big = "data" in param_partition_spec(
            name, c["shape"], {"data": 2, "model": 1}, True, MIN_SIZE)
        want = c["numel"] // 2 if big else c["numel"]
        for kind in ("param", "grad", "mu", "nu", "nu_max", "ema"):
            if kind == "grad" and name.endswith("mask_token"):
                assert c[kind] is None, c  # no forward uses it
                continue
            assert c[kind] == want, (name, kind, c)
        sharded += big
    assert sharded >= 10, sharded


def test_sequence_parallel_shards_an_odd_segment(runs):
    """The residual stream reaches each layer as this rank's part of the
    5-token vision segment (3 and 2 tokens) and the 6-token text one, and
    the forward is within 1e-5 of the unsharded one."""
    d, _ = runs
    for rank, vision in ((0, 3), (1, 2)):
        with open(osp.join(d, f"sp_rank{rank}.json")) as f:
            sp = json.load(f)
        assert sp["layer_input_lengths"] == [[vision, 3]] * 2, sp
        assert sp["max_abs_err"] <= 1e-5, sp
