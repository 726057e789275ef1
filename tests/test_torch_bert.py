"""The ALBERTA language encoder (``BERTLanguageEncoder``) and
``convert.convert_hf_bert`` of simvg_tpu_torch, on the CPU in float32.

- the encoder within 1e-5 of JAX's on JAX's ``init`` (carried across by
  ``convert.export_composed``), word ids with zero padding, from which both
  derive the mask;
- ``convert_hf_bert`` gives the arrays of
  ``tools/convert_checkpoint.py::convert_hf_bert`` (after ``export_composed``)
  on one numpy HF-layout state dict, and raises as it does when the layer
  counts differ;
- with ``transformers`` present, the encoder on a tiny random
  ``RobertaModel``'s or ``BertModel``'s weights gives its
  ``last_hidden_state`` within 1e-5 (roberta's padded rows excepted: HF
  pins their position ids to the padding index);
- ``pretrained_state_dict`` takes an HF state dict under ``roberta.``,
  ``bert.`` or no prefix into a OneStageModel's ``lan_enc``, and
  ``load_pretrained_into_model`` loads one from a ``.pth``.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_onestage import ONESTAGE, _batch, _jax
from test_torch_zoo import jax_run

from simvg_tpu_torch.convert import (convert_hf_bert, export_composed,
                                     export_params, load_pretrained_into_model,
                                     pretrained_state_dict)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
from convert_checkpoint import convert_hf_bert as jax_convert_hf_bert  # noqa: E402,E501
from util_torch_port import one_torch_thread  # noqa: F401

# roberta's layout at tiny widths: position ids from padding_idx + 1 = 2
TINY = dict(vocab_size=60, hidden_size=32, num_layers=2, num_heads=4,
            max_positions=24, position_offset=2)


def _ids(pad_id=0, seed=0):
    """Word ids of 8 tokens, 8, 6 and 3 of them real."""
    ids = np.random.default_rng(seed).integers(2, 60, (3, 8)).astype(np.int32)
    for i, n in enumerate((8, 6, 3)):
        ids[i, n:] = pad_id
    return ids


def _port_encoder(sd=None, **kw):
    from simvg_tpu_torch.models.lan_encs import BERTLanguageEncoder

    enc = BERTLanguageEncoder(**dict(TINY, **kw))
    if sd is not None:
        enc.load_state_dict({k[len("lan_enc."):]: torch.tensor(np.asarray(v))
                             for k, v in sd.items()}, strict=True)
    return enc.eval()


def _hf_state_dict(layers=2, prefix="roberta.", seed=0):
    """Random float32 arrays in HF BertModel's layout at TINY's widths."""
    rng = np.random.default_rng(seed)
    d = TINY["hidden_size"]
    shapes = {"embeddings.word_embeddings.weight": (TINY["vocab_size"], d),
              "embeddings.position_embeddings.weight":
                  (TINY["max_positions"], d),
              "embeddings.token_type_embeddings.weight": (1, d),
              "embeddings.LayerNorm.weight": (d,),
              "embeddings.LayerNorm.bias": (d,)}
    for i in range(layers):
        for name, (o, n) in (("attention.self.query", (d, d)),
                             ("attention.self.key", (d, d)),
                             ("attention.self.value", (d, d)),
                             ("attention.output.dense", (d, d)),
                             ("intermediate.dense", (4 * d, d)),
                             ("output.dense", (d, 4 * d))):
            shapes[f"encoder.layer.{i}.{name}.weight"] = (o, n)
            shapes[f"encoder.layer.{i}.{name}.bias"] = (o,)
        for name in ("attention.output.LayerNorm", "output.LayerNorm"):
            shapes[f"encoder.layer.{i}.{name}.weight"] = (d,)
            shapes[f"encoder.layer.{i}.{name}.bias"] = (d,)
    return {prefix + k: rng.normal(0, 0.1, s).astype(np.float32)
            for k, s in shapes.items()}


def _jax_tree(**kw):
    """Zeros on the JAX encoder's parameter shapes, under ``lan_enc``."""
    from simvg_tpu.models.lan_encs import BERTLanguageEncoder

    shapes = jax.eval_shape(BERTLanguageEncoder(**dict(TINY, **kw)).init,
                            jax.random.PRNGKey(0), jnp.ones((1, 4), jnp.int32))
    return {"params": {"lan_enc": jax.tree.map(
        lambda a: np.zeros(a.shape, np.float32), shapes["params"])}}


def test_encoder_matches_jax():
    from simvg_tpu.models.lan_encs import BERTLanguageEncoder

    ids = _ids()
    jm = BERTLanguageEncoder(**TINY)

    def init_apply(key, ids):
        params = jm.init(key, ids)
        return params["params"], jm.apply(params, ids)

    params, want = jax_run(init_apply, jax.random.PRNGKey(0), jnp.asarray(ids))
    enc = _port_encoder(export_composed({"params": {"lan_enc": params}}))
    with torch.no_grad():
        got = enc(torch.from_numpy(ids))
    assert np.array_equal(got["text_mask"].numpy(), want["text_mask"])
    w = want["text_feat"]
    np.testing.assert_allclose(got["text_feat"].numpy(), w, rtol=0,
                               atol=1e-5 * np.abs(w).max())
    assert enc.out_channels == TINY["hidden_size"]


def test_convert_hf_bert_matches_the_jax_converter():
    sd = _hf_state_dict()
    params = _jax_tree()
    jax_convert_hf_bert(sd, params, out_prefix="lan_enc")
    want = export_composed(params)
    target = _port_encoder().state_dict()
    got = convert_hf_bert(sd, {"lan_enc." + k: v for k, v in target.items()})
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.array_equal(got[k].numpy(), want[k]), k


def test_layer_count_mismatch_raises():
    sd = _hf_state_dict(layers=2)
    with pytest.raises(ValueError, match="2 layers, encoder expects 3"):
        jax_convert_hf_bert(sd, _jax_tree(num_layers=3), out_prefix="lan_enc")
    target = {"lan_enc." + k: v for k, v in
              _port_encoder(num_layers=3).state_dict().items()}
    with pytest.raises(ValueError, match="2 layers, encoder expects 3"):
        convert_hf_bert(sd, target)


@pytest.mark.parametrize("family", ["roberta", "bert"])
def test_hf_model_matches_encoder(family):
    transformers = pytest.importorskip("transformers")
    kw = dict(vocab_size=60, hidden_size=32, num_hidden_layers=2,
              num_attention_heads=4, intermediate_size=128,
              max_position_embeddings=24, hidden_dropout_prob=0.0,
              attention_probs_dropout_prob=0.0, hidden_act="gelu")
    torch.manual_seed(0)
    if family == "roberta":
        hf = transformers.RobertaModel(transformers.RobertaConfig(
            pad_token_id=1, **kw), add_pooling_layer=False)
        ids, offset = _ids(pad_id=1), 2
    else:
        hf = transformers.BertModel(transformers.BertConfig(
            pad_token_id=0, **kw), add_pooling_layer=False)
        ids, offset = _ids(pad_id=0), 0
    pad = torch.from_numpy(ids == (1 if family == "roberta" else 0))
    sd = {family + "." + k: v for k, v in hf.state_dict().items()}
    enc = _port_encoder(position_offset=offset)
    mapped = convert_hf_bert(sd, {"lan_enc." + k: v for k, v in
                                  enc.state_dict().items()})
    enc = _port_encoder(mapped, position_offset=offset)
    with torch.no_grad():
        want = hf.eval()(input_ids=torch.from_numpy(ids).long(),
                         attention_mask=(~pad).long()).last_hidden_state
        got = enc(torch.from_numpy(ids), pad)["text_feat"]
    rows = ~pad if family == "roberta" else torch.ones_like(pad)
    np.testing.assert_allclose(got[rows].numpy(), want[rows].numpy(),
                               rtol=0, atol=1e-5 * want.abs().max().item())


def _albert_onestage():
    from simvg_tpu_torch.config import Config

    return dict(Config.fromfile(ONESTAGE).model,
                lan_enc=dict(type="ALBERTA", **TINY))


@pytest.mark.parametrize("prefix", ["roberta.", "bert.", ""])
def test_pretrained_state_dict_takes_hf_checkpoints(prefix):
    """Into the tiny OneStageModel with an ALBERTA lan_enc, whose state
    dict names JAX's ``init`` (``jax.eval_shape``) names: every HF tensor
    lands in ``lan_enc``, none is left unused."""
    from simvg_tpu.models.builder import build_model as jax_build
    from simvg_tpu_torch.models import build_model

    model_cfg = _albert_onestage()
    jm, _ = jax_build(model_cfg, img_size=64)
    shapes = export_params(jax.tree.map(
        lambda a: np.zeros(a.shape, np.float32),
        jax.eval_shape(jm.init, jax.random.PRNGKey(0), **_jax(_batch()))))
    model, _ = build_model(model_cfg, img_size=64, device="meta")
    target = model.state_dict()
    assert {k: tuple(v.shape) for k, v in target.items()} == \
        {k: v.shape for k, v in shapes.items()}
    sd = {k: torch.from_numpy(v) for k, v in _hf_state_dict(
        prefix=prefix).items()}
    mapped, unused = pretrained_state_dict(sd, target)
    assert not unused
    want = convert_hf_bert(sd, target)
    assert sorted(mapped) == sorted(want) == sorted(
        k for k in target if k.startswith("lan_enc."))
    for k in want:
        assert torch.equal(mapped[k], want[k]), k


def test_load_pretrained_into_model_from_a_pth(tmp_path):
    from simvg_tpu_torch.models import build_model

    path = str(tmp_path / "tiny_roberta.pth")
    sd = {k: torch.from_numpy(v) for k, v in _hf_state_dict().items()}
    torch.save(sd, path)
    model, _ = build_model(_albert_onestage(), img_size=64, device="cpu")
    loaded = load_pretrained_into_model(model, path)
    assert loaded == sorted(k for k in model.state_dict()
                            if k.startswith("lan_enc."))
    assert torch.equal(model.lan_enc.word_embeddings.weight,
                       sd["roberta.embeddings.word_embeddings.weight"])
    assert torch.equal(model.lan_enc.fc2_1.weight,
                       sd["roberta.encoder.layer.1.output.dense.weight"])
