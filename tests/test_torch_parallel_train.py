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

int8: the same two steps with ``quant="int8_qat"`` under DDP (dp=2) and
under FSDP2 with tensor and sequence parallelism (data 2 x model 2), on a
batch whose second half (the second data shard) is scaled x4, so that the
two shards' activation maxima differ:
JAX takes each fake-quant scale over the global batch inside its ``jit``,
which is what the one-device ``make_train_step(dp_size=dp)`` computes, and
the port's ranks all-reduce their maxima (``ops/quant.py``).  The bounds
are the ones above.  And eval forwards of the tiny encoder of
``util_torch_port`` (64 px: 17 vision tokens) on 2 ranks, held against
JAX's encoder on the global batch: dynamic int8 under DDP on the scaled
batch; dynamic int8 and int8_static (one calibration's collection, read by
both packages) under tensor parallelism; token pruning after layer 0
(keep 5 of 16 patches) under tensor parallelism, without and with sequence
parallelism.  int8 features at ``util_torch_port.assert_int8_close``'s
bounds (tests/test_torch_quant.py's), pruned ones at atol 1e-5
(tests/test_torch_prune.py's), the kept indices equal.
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
from util_torch_port import (TINY_BEIT3 as ENC_BEIT3, assert_int8_close,
                             cheap_jit, in_background, jax_params_from_port,
                             np_batch, run_ranks)
from util_torch_port import one_torch_thread  # noqa: F401

OPT = dict(lr=1e-3, steps_per_epoch=1000)
MIN_SIZE = 2048
# layout -> the data-parallel size of its mesh; an "_int8_qat" layout runs
# the worker's layout of that name with quant="int8_qat" on the scaled batch
DP = {"ddp": 2, "fsdp": 2, "tp": 1, "tp_sp": 1, "fsdp_tp_sp": 2,
      "ddp_int8_qat": 2, "fsdp_tp_sp_int8_qat": 2}
QAT = "int8_qat"
SCALE = 4.0  # the second half of the batch, x4: its own activation max


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


def _write_inputs(d, sd, batch, beit3):
    np.savez(d / "inputs.npz", **{f"sd/{k}": v for k, v in sd.items()},
             **{f"batch/{k}": v for k, v in batch.items()})
    with open(d / "config.json", "w") as f:
        json.dump({"beit3": beit3, "head": dict(TINY_HEAD,
                                                num_queries=1),
                   "optimizer": OPT, "blw": BLW,
                   "fsdp_min_size": MIN_SIZE}, f)


def _qat_models():
    """The tiny models of _models("refcoco") with quant="int8_qat"."""
    from simvg_tpu.models import SimVGConfig, SimVGModel
    from simvg_tpu.models.beit3 import BEiT3Config
    from simvg_tpu.models.heads.tgqs_head import TGQSHeadConfig
    from simvg_tpu_torch.models.beit3 import BEiT3Config as TBEiT3Config
    from simvg_tpu_torch.models.heads.tgqs_head import (
        TGQSHeadConfig as THeadConfig)
    from simvg_tpu_torch.models.model import (SimVGConfig as TConfig,
                                              SimVGModel as TModel)

    head = dict(TINY_HEAD, num_queries=1)
    return (SimVGModel(SimVGConfig(beit3=BEiT3Config(**TINY_BEIT3,
                                                     quant=QAT),
                                   head=TGQSHeadConfig(**head))),
            TModel(TConfig(beit3=TBEiT3Config(**TINY_BEIT3, quant=QAT),
                           head=THeadConfig(**head))))


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
    _write_inputs(d, sd, batch, TINY_BEIT3)
    # int8_qat on a batch whose shards have different activation maxima
    dq = d / QAT
    dq.mkdir()
    qbatch = dict(batch, image=batch["image"].copy())
    qbatch["image"][2:] *= SCALE
    _write_inputs(dq, sd, qbatch, dict(TINY_BEIT3, quant=QAT))
    worker = ["tests/_torch_parallel_worker.py", "train", str(d)]
    # the gloo ranks run while the JAX references are computed here
    ranks = in_background(lambda: (
        run_ranks(2, worker + ["ddp", "fsdp", "tp", "tp_sp", "sp",
                               f"{QAT}/ddp"]),
        run_ranks(4, worker + ["fsdp_tp_sp", f"{QAT}/fsdp_tp_sp"])))
    jq, tq = _qat_models()
    tq.load_state_dict(tm.state_dict(), strict=True)
    qjb = {k: jnp.asarray(v) for k, v in qbatch.items()}
    # the three JAX programs compile side by side (XLA leaves the GIL)
    runs = {(None, 1): in_background(_jax_run, jm, params, jb, 1),
            (None, 2): in_background(_jax_run, jm, params, jb, 2),
            (QAT, 2): in_background(_jax_run, jq, params, qjb, 2)}
    ref = {key: dict(run(), live=_live(tq if key[0] else tm,
                                       qbatch if key[0] else batch, key[1]))
           for key, run in runs.items()}
    ranks()
    return d, ref


@pytest.mark.parametrize("layout", list(DP))
def test_parallel_train_steps_match_jax_global_batch(runs, layout):
    d, ref = runs
    quant = QAT if layout.endswith(QAT) else None
    want = ref[(quant, DP[layout])]
    got = np.load(d / quant / f"{layout[:-len(QAT) - 1]}.npz" if quant
                  else d / f"{layout}.npz")
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


# the eval cases: (encoder arguments beyond ENC_BEIT3, model_parallel)
PRUNE = dict(token_prune_keep=5, token_prune_layer=0, token_prune_force=True)
EVAL_CASES = {
    "ddp_int8": (dict(quant="int8"), 1),
    "tp_int8": (dict(quant="int8"), 2),
    "tp_int8_static": (dict(quant="int8_static"), 2),
    "tp_prune": (PRUNE, 2),
    "tp_sp_prune": (dict(PRUNE, seq_parallel=True), 2),
}


@pytest.fixture(scope="module")
def evals(tmp_path_factory):
    """The port's 2-rank eval forwards of every case (one process group),
    and JAX's encoder on the global batch."""
    from simvg_tpu.models.beit3 import BEiT3Config as JaxBEiT3Config
    from simvg_tpu.models.beit3 import BEiT3Encoder as JaxEncoder
    from simvg_tpu.ops.quant import load_quant_collection
    from simvg_tpu_torch.models.beit3 import BEiT3Config, BEiT3Encoder
    from simvg_tpu_torch.ops import quant as q

    d = tmp_path_factory.mktemp("parallel_eval")
    batch = np_batch(b=4, seed=6)
    batch["image"][2:] *= SCALE
    args = [batch[k] for k in ("image", "text_ids", "text_padding_mask")]
    params = {"params": _jax_encoder_params(JaxEncoder(JaxBEiT3Config(
        **ENC_BEIT3)), args)}
    sd = {k[len("vis_enc.beit3."):]: v for k, v in export_simvg_full(
        {"params": {"beit3": params["params"]}}).items()}
    enc = BEiT3Encoder(BEiT3Config(**ENC_BEIT3))
    enc.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()},
                        strict=True)
    # int8_static's collection: a calibration of the same weights
    calib = BEiT3Encoder(BEiT3Config(**ENC_BEIT3, quant="int8_calib"))
    calib.load_state_dict(enc.state_dict(), strict=True)
    with torch.no_grad():
        calib.eval()(*map(torch.from_numpy, args))
    npz = str(d / "q.npz")
    q.save_quant_collection(npz, q.build_quant_collection(
        calib, q.calibration_amax(calib)))
    cases = {name: dict(beit3=dict(ENC_BEIT3, **kw), mp=mp,
                        quant_npz=npz if kw.get("quant") == "int8_static"
                        else None)
             for name, (kw, mp) in EVAL_CASES.items()}
    np.savez(d / "eval_inputs.npz", **{f"sd/{k}": v for k, v in sd.items()},
             **{f"batch/{k}": v for k, v in batch.items()})
    with open(d / "eval.json", "w") as f:
        json.dump(cases, f)
    ranks = in_background(run_ranks, 2, ["tests/_torch_parallel_worker.py",
                                         "eval", str(d)])
    ref, by_kw = {}, {}
    for name, (kw, _) in EVAL_CASES.items():
        kw = {k: v for k, v in kw.items() if k != "seq_parallel"}
        key = json.dumps(kw, sort_keys=True)  # one JAX run a config
        if key not in by_kw:
            variables = dict(params)
            if kw.get("quant") == "int8_static":
                variables["quant"] = load_quant_collection(npz)
            by_kw[key] = JaxEncoder(JaxBEiT3Config(**ENC_BEIT3, **kw)).apply(
                variables, *map(jnp.asarray, args),
                return_prune_idx="token_prune_keep" in kw)
        ref[name] = by_kw[key]
    ranks()
    return d, ref


def _jax_encoder_params(jax_enc, args, seed=2):
    """Random weights in the JAX encoder's tree, drawn with numpy on its
    shapes (``jax.eval_shape``: no JAX init runs): LayerNorm scales near
    1, every other leaf of std 0.05."""
    shapes = jax.eval_shape(jax_enc.init, jax.random.PRNGKey(0),
                            *map(jnp.asarray, args))["params"]
    r = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, s: ((1.0 if path[-1].key == "scale" else 0.0)
                         + 0.05 * r.normal(size=s.shape)).astype(s.dtype),
        shapes)


@pytest.mark.parametrize("case", list(EVAL_CASES))
def test_parallel_eval_matches_jax_global_batch(evals, case):
    d, ref = evals
    got = np.load(d / f"eval_{case}.npz")
    want = ref[case]
    keys = ("img_feat", "text_feat", "cls_feat", "prune_idx")
    if "prune" in case:
        np.testing.assert_array_equal(got["prune_idx"], np.asarray(want[3]))
    for k, w in zip(keys[:3], want[:3]):
        if "int8" in case:
            assert_int8_close(got[k], w, err_msg=f"{case} {k}")
        else:
            np.testing.assert_allclose(got[k], np.asarray(w), atol=1e-5,
                                       rtol=0, err_msg=f"{case} {k}")
