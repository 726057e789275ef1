"""The SeqTR/MDETR legacy transformers of simvg_tpu_torch held against
simvg_tpu's on the CPU in float32 (``simvg_tpu_torch/models/
legacy_layers.py``).

tests/test_legacy_layers.py's tiny widths (D=32, 4 heads, FFN 64) on JAX's
``init``, carried into the port by ``convert.load_jax_params``
(``export_legacy``), on inputs made with numpy from a seed: the outputs
within 1e-5 of their max, ``generate``'s ids JAX's, a padded feature map
through both (the padding mask reaches attention as a key mask).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from simvg_tpu.models import legacy_layers as jl
from simvg_tpu_torch.convert import load_jax_params
from simvg_tpu_torch.models import legacy_layers as tl
from simvg_tpu_torch.models.layers import set_generator
from util_torch_port import cheap_jit, one_torch_thread  # noqa: F401

TOL = 1e-5
WIDTHS = dict(d_model=32, num_heads=4, ffn_dim=64)


def _close(got, want, what=""):
    want = np.asarray(want, np.float64)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got.detach().numpy().astype(np.float64) - want).max())
    assert err <= TOL * scale, (what, err, scale)


def _feature_map(b=2, h=4, w=5, c=16, seed=0):
    """A feature map and its padding mask: sample 1 has its last two
    columns and last row padded."""
    r = np.random.default_rng(seed)
    x = r.normal(size=(b, h, w, c)).astype(np.float32)
    mask = np.zeros((b, h, w), bool)
    mask[1, :, w - 2:] = True
    mask[1, h - 1, :] = True
    return x, mask


def test_causal_mask_is_jax():
    np.testing.assert_array_equal(tl.causal_mask(5).numpy(),
                                  np.asarray(jl.causal_mask(5)))


@pytest.fixture(scope="module")
def autoregressive():
    jm = jl.AutoRegressiveTransformer(**WIDTHS, num_encoder_layers=2,
                                      num_decoder_layers=2, vocab_size=20,
                                      max_seq_len=5, dropout=0.1)
    x, _ = _feature_map()
    seq = np.random.default_rng(1).integers(0, 20, (2, 5)).astype(np.int32)
    params = cheap_jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x),
                                jnp.asarray(seq))
    tm = tl.AutoRegressiveTransformer(16, **WIDTHS, num_encoder_layers=2,
                                      num_decoder_layers=2, vocab_size=20,
                                      max_seq_len=5, dropout=0.1)
    load_jax_params(tm, jax.tree.map(np.asarray, params))
    return jm, params, tm.eval(), seq


@pytest.mark.parametrize("padded", [False, True])
def test_autoregressive_matches_jax(autoregressive, padded):
    jm, params, tm, seq = autoregressive
    x, mask = _feature_map()
    xm = mask if padded else None
    want = jm.apply(params, jnp.asarray(x), jnp.asarray(seq),
                    None if xm is None else jnp.asarray(xm))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(seq),
                 None if xm is None else torch.from_numpy(xm))
    assert tuple(got.shape) == (2, 5, 20)
    _close(got, want, f"padded={padded}")
    if padded:  # the mask changes the answer: it reaches attention
        with torch.no_grad():
            unpadded = tm(torch.from_numpy(x), torch.from_numpy(seq))
        assert not torch.allclose(got, unpadded, atol=1e-4)


def test_autoregressive_generate_matches_jax(autoregressive):
    jm, params, tm, _ = autoregressive
    x, _ = _feature_map()
    want = jl.AutoRegressiveTransformer.generate(jm, params, jnp.asarray(x),
                                                 start_id=0, steps=4)
    got = tm.generate(torch.from_numpy(x), start_id=0, steps=4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="max_seq_len"):
        tm.generate(torch.from_numpy(x), start_id=0, steps=5)


def test_autoregressive_is_causal(autoregressive):
    _, _, tm, seq = autoregressive
    x, _ = _feature_map()
    seq2 = seq.copy()
    seq2[:, 3] = (seq2[:, 3] + 5) % 20
    with torch.no_grad():
        a = tm(torch.from_numpy(x), torch.from_numpy(seq))
        b = tm(torch.from_numpy(x), torch.from_numpy(seq2))
    torch.testing.assert_close(a[:, :3], b[:, :3], rtol=0, atol=1e-6)
    assert not torch.allclose(a[:, 3:], b[:, 3:], atol=1e-5)


def test_encoder_layer_padding_mask_plumbed():
    """Padded keys' content leaves the unpadded positions alone
    (tests/test_legacy_layers.py's check, on the port's layer)."""
    r = np.random.default_rng(1)
    layer = tl.EncoderLayer1D(32, 4, 64, dropout=0.0).eval()
    x = torch.from_numpy(r.normal(size=(1, 8, 32)).astype(np.float32))
    pos = torch.from_numpy(r.normal(size=(1, 8, 32)).astype(np.float32))
    mask = torch.zeros(1, 8, dtype=torch.bool)
    mask[:, 5:] = True
    x2 = x.clone()
    x2[:, 5:] += 10.0
    with torch.no_grad():
        a, b = layer(x, pos, mask), layer(x2, pos, mask)
    torch.testing.assert_close(a[:, :5], b[:, :5], rtol=0, atol=1e-6)


def test_dropout_draws_from_the_generator(autoregressive):
    """In train mode the same generator state gives the same output and
    another state another one."""
    _, _, tm, seq = autoregressive
    x, _ = _feature_map()
    outs = []
    try:
        tm.train()
        for s in (3, 3, 4):
            set_generator(tm, torch.Generator().manual_seed(s))
            with torch.no_grad():
                outs.append(tm(torch.from_numpy(x), torch.from_numpy(seq)))
    finally:
        set_generator(tm, None)
        tm.eval()
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)
    assert not torch.allclose(outs[0], outs[2], atol=1e-4)


def test_mdetr_matches_jax():
    jm = jl.MDETRTransformer(**WIDTHS, num_encoder_layers=2,
                             num_decoder_layers=2, num_queries=3,
                             text_dim=24)
    x, mask = _feature_map()
    r = np.random.default_rng(2)
    text = r.normal(size=(2, 5, 24)).astype(np.float32)
    tmask = np.zeros((2, 5), bool)
    tmask[0, 3:] = True
    args = (x, mask, text, tmask)
    params = cheap_jit(jm.init)(jax.random.PRNGKey(0),
                                *map(jnp.asarray, args))
    want = jm.apply(params, *map(jnp.asarray, args))
    tm = tl.MDETRTransformer(16, **WIDTHS, num_encoder_layers=2,
                             num_decoder_layers=2, num_queries=3,
                             text_dim=24)
    load_jax_params(tm, jax.tree.map(np.asarray, params))
    with torch.no_grad():
        got = tm.eval()(*map(torch.from_numpy, args))
    assert tuple(got.shape) == (2, 2, 3, 32)
    _close(got, want, "mdetr")
