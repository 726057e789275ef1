"""The BEiT-3 task heads of simvg_tpu_torch and the encoder's single-modality
and ``attn_bias`` modes, held against simvg_tpu's on the CPU in float32
(``simvg_tpu_torch/models/beit3_heads.py``, ``models/beit3.py``).

tests/test_beit3_heads.py's tiny configuration (32 px, patch 16, D=32, 4
heads, 2 layers, vocab 60) with ``attn_impl="pallas"``: on the CPU JAX
takes its XLA path and the port its kernels' plain versions.  Each module
runs on JAX's ``init``, carried into the port by ``convert.load_jax_params``
(``export_beit3_heads``), on inputs made with numpy from a seed (JAX's
``init`` and gradients through ``util_torch_port.cheap_jit``).  The
encoder's outputs within 2e-5 (tests/test_checkpoint_convert.py's
encoder tolerance), each head's within 1e-5 of their max, the gradients of
one loss within 1e-5 of each tensor's max, ``greedy_generate``'s ids
JAX's.  JAX's forwards run op by op (at these sizes a compile costs more
than the run).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from simvg_tpu.models import beit3 as jb
from simvg_tpu.models import beit3_heads as jh
from simvg_tpu_torch.convert import export_params, load_jax_params
from simvg_tpu_torch.models import beit3 as tb
from simvg_tpu_torch.models import beit3_heads as th
from util_torch_port import cheap_jit, one_torch_thread  # noqa: F401

CFG = dict(img_size=32, patch_size=16, embed_dim=32, num_heads=4,
           ffn_dim=64, num_layers=2, vocab_size=60, drop_path_rate=0.0,
           attn_impl="pallas")
ENC_TOL = 2e-5
HEAD_TOL = 1e-5


def _data(b=2, t=6, seed=0):
    r = np.random.default_rng(seed)
    img = r.normal(size=(b, 32, 32, 3)).astype(np.float32)
    ids = r.integers(2, 60, (b, t)).astype(np.int32)
    mask = np.zeros((b, t), np.int32)
    mask[:, t - 2:] = 1
    mask[0, t - 3] = 1  # ragged padding
    return img, ids, mask


def _close(got, want, tol, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float64)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(np.asarray(got, np.float64) - want).max())
    assert err <= tol * scale, (what, err, scale)


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


@pytest.mark.parametrize("mode", ["vision", "text", "joint_bias"])
def test_encoder_modes_match_jax(encoders, mode):
    """Vision-only, text-only and a joint encode under captioning's
    additive mask: the absent outputs are None, the rest JAX's."""
    enc, params, port = encoders
    img, ids, mask = _data()
    kw = {"vision": dict(images=img),
          "text": dict(text_ids=ids, text_padding_mask=mask),
          "joint_bias": dict(images=img, text_ids=ids,
                             text_padding_mask=mask)}[mode]
    jkw = {k: jnp.asarray(v) for k, v in kw.items()}
    tkw = {k: torch.from_numpy(v) for k, v in kw.items()}
    if mode == "joint_bias":
        split = jb.BEiT3Config(**CFG).seq_vision
        jkw["attn_bias"] = jh.captioning_uni_mask(split, ids.shape[1])
        tkw["attn_bias"] = th.captioning_uni_mask(split, ids.shape[1])
        np.testing.assert_array_equal(jkw["attn_bias"],
                                      tkw["attn_bias"].numpy())
    want = enc.apply(params, **jkw)
    with torch.no_grad():
        got = port(**tkw)
    for name, w, g in zip(("img", "text", "cls"), want, got):
        assert (w is None) == (g is None), (mode, name)
        if w is not None:
            _close(g, w, ENC_TOL, f"{mode} {name}")


def test_text_only_positions_start_at_two(encoders):
    """With no vision segment the text table is still read from row 2:
    a text-only encode differs when row 0 or 1 changes not at all."""
    _, _, port = encoders
    _, ids, mask = _data()
    with torch.no_grad():
        before = port(text_ids=torch.from_numpy(ids))[1]
        table = port.encoder.embed_positions.B.weight
        saved = table[:2].clone()
        table[:2] += 1.0
        after = port(text_ids=torch.from_numpy(ids))[1]
        table[:2] = saved
    torch.testing.assert_close(before, after, rtol=0, atol=0)


def test_prune_refuses_attn_bias_and_text_only():
    cfg = tb.BEiT3Config(**CFG, token_prune_keep=3, token_prune_layer=0,
                         token_prune_force=True)
    port = tb.BEiT3Encoder(cfg).eval()
    img, ids, mask = _t(*_data())
    bias = th.captioning_uni_mask(cfg.seq_vision, ids.shape[1])
    with pytest.raises(ValueError, match="attn_bias"):
        port(img, ids, mask, attn_bias=bias)
    with pytest.raises(ValueError, match="vision input"):
        port(text_ids=ids, text_padding_mask=mask)
    with pytest.raises(ValueError, match="images, text_ids or both"):
        port()


def _heads():
    """name -> (JAX module, port module, numpy inputs by keyword)."""
    img, ids, mask = _data()
    img_b = _data(seed=1)[0]
    jc, tc = jb.BEiT3Config(**CFG), tb.BEiT3Config(**CFG)
    return {
        "classification": (jh.BEiT3ForImageClassification(jc, 10),
                           th.BEiT3ForImageClassification(tc, 10),
                           dict(image=img)),
        "vqa": (jh.BEiT3ForVisualQuestionAnswering(jc, 13),
                th.BEiT3ForVisualQuestionAnswering(tc, 13),
                dict(image=img, question_ids=ids, padding_mask=mask)),
        "reasoning": (jh.BEiT3ForVisualReasoning(jc),
                      th.BEiT3ForVisualReasoning(tc),
                      dict(image_a=img, image_b=img_b, text_ids=ids,
                           padding_mask=mask)),
        "retrieval": (jh.BEiT3ForRetrieval(jc), th.BEiT3ForRetrieval(tc),
                      dict(image=img, text_ids=ids, padding_mask=mask)),
        "captioning": (jh.BEiT3ForCaptioning(jc), th.BEiT3ForCaptioning(tc),
                       dict(image=img, text_ids=ids, padding_mask=mask)),
    }


HEADS = ("classification", "vqa", "reasoning", "retrieval", "captioning")


@pytest.fixture(scope="module")
def heads():
    """name -> (JAX module, its params, the port's module, inputs)."""
    out = {}
    for name, (jm, tm, kw) in _heads().items():
        params = cheap_jit(jm.init)(
            jax.random.PRNGKey(1), **{k: jnp.asarray(v) for k, v in kw.items()})
        load_jax_params(tm, jax.tree.map(np.asarray, params))
        out[name] = (jm, params, tm.eval(), kw)
    return out


@pytest.fixture(scope="module")
def encoders(heads):
    """The JAX encoder on the retrieval head's ``init`` (joint, so every
    encoder parameter exists) and the port's encoder with its weights."""
    _, params, tm, _ = heads["retrieval"]
    return (jb.BEiT3Encoder(jb.BEiT3Config(**CFG)),
            {"params": params["params"]["beit3"]}, tm.beit3)


def _outputs(out):
    return [o for o in (out if isinstance(out, tuple) else (out,))
            if o is not None]


@pytest.mark.parametrize("name", HEADS)
def test_head_matches_jax(heads, name):
    jm, params, tm, kw = heads[name]
    want = jm.apply(params, **{k: jnp.asarray(v) for k, v in kw.items()})
    with torch.no_grad():
        got = tm(**{k: torch.from_numpy(v) for k, v in kw.items()})
    want, got = _outputs(want), _outputs(got)
    assert len(want) == len(got)
    for w, g in zip(want, got):
        assert tuple(g.shape) == tuple(np.shape(w)), name
        _close(g, w, HEAD_TOL, name)


def test_retrieval_single_modality_calls_equal_joint_call(heads):
    _, _, tm, kw = heads["retrieval"]
    img, ids, mask = _t(kw["image"], kw["text_ids"], kw["padding_mask"])
    with torch.no_grad():
        v, t, scale = tm(image=img, text_ids=ids, padding_mask=mask)
        v1, t1, _ = tm(image=img)
        v2, t2, _ = tm(text_ids=ids, padding_mask=mask)
    assert t1 is None and v2 is None
    torch.testing.assert_close(v1, v, rtol=0, atol=0)
    torch.testing.assert_close(t2, t, rtol=0, atol=0)
    torch.testing.assert_close(torch.linalg.norm(v, dim=-1),
                               torch.ones(v.shape[0]))
    assert abs(scale.item() - np.log(1 / 0.07)) < 1e-6


def test_captioning_is_causal(heads):
    """Changing a later caption token changes no earlier position."""
    _, _, tm, kw = heads["captioning"]
    img, ids, _ = _t(kw["image"], kw["text_ids"], kw["padding_mask"])
    mask = torch.zeros_like(ids)
    ids2 = ids.clone()
    ids2[:, 4] = (ids2[:, 4] + 7) % 58 + 2
    with torch.no_grad():
        a, b = tm(img, ids, mask), tm(img, ids2, mask)
    torch.testing.assert_close(a[:, :4], b[:, :4], rtol=0, atol=1e-6)
    assert not torch.allclose(a[:, 4:], b[:, 4:], atol=1e-5)


def test_greedy_generate_matches_jax(heads):
    jm, params, tm, kw = heads["captioning"]
    want = jh.BEiT3ForCaptioning.greedy_generate(
        jm, params, jnp.asarray(kw["image"]), bos_id=0, eos_id=2,
        max_len=6)
    got = tm.greedy_generate(torch.from_numpy(kw["image"]), bos_id=0,
                             eos_id=2, max_len=6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _loss_jax(jm, kw):
    def loss(p):
        out = _outputs(jm.apply(p, **{k: jnp.asarray(v)
                                      for k, v in kw.items()}))
        return sum(jnp.sum(o * jnp.cos(jnp.arange(o.size).reshape(o.shape)))
                   for o in out)
    return loss


@pytest.mark.parametrize("name", ("classification", "vqa", "retrieval"))
def test_head_gradients_match_jax(heads, name):
    """One loss (a fixed cosine-weighted sum of the outputs) through the
    head: every parameter's gradient within 1e-5 of its max."""
    jm, params, tm, kw = heads[name]
    # compiled with LLVM's cheap passes: a quarter of the op-by-op time
    grad = cheap_jit(jax.grad(_loss_jax(jm, kw)))
    want = export_params(jax.tree.map(np.asarray, grad(params)))
    tm.zero_grad()
    out = _outputs(tm(**{k: torch.from_numpy(v) for k, v in kw.items()}))
    sum((o * torch.cos(torch.arange(o.numel(), dtype=torch.float32)
                       ).reshape(o.shape)).sum() for o in out).backward()
    params = dict(tm.named_parameters())
    assert set(params) == set(want)
    for k, p in params.items():
        # a parameter off the path (the text table of a vision-only
        # encode) has no gradient here and JAX's zeros
        g = torch.zeros(p.shape) if p.grad is None else p.grad
        _close(g, want[k], HEAD_TOL, k)
