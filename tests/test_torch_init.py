"""The port's random init (``init_random_weights``) against JAX ``model.init``,
and the CLIs' TF32 setting, on the CPU.

- init: on ``configs/smoke/tiny_synth.py``, and on it with the DETR encoder
  (``only_decoder=False``), every parameter's mean and std lie
  within sampling error (6 standard errors) of the matching tensor of JAX
  ``model.init`` after ``export_simvg_full``; constant tensors (LayerNorm
  scales, biases, ``mask_token``) are equal exactly; the draw is made on a
  CPU generator, so one seed gives the same tensors whatever device the
  model was built on;
- TF32: after the CLIs' device setup both TF32 flags are off.
"""

import os.path as osp

import numpy as np
import pytest
import torch

from simvg_tpu_torch.config import Config
from simvg_tpu_torch.convert import export_simvg_full
from simvg_tpu_torch.models import build_model, init_random_weights
from simvg_tpu_torch.tools import test as test_cli
from simvg_tpu_torch.tools import train as train_cli
from util_torch_port import cheap_jit, one_torch_thread  # noqa: F401

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
TINY = osp.join(REPO, "configs", "smoke", "tiny_synth.py")
N_SE = 6.0  # standard errors of the sampling allowed for mean and std


# head settings of the two trees held to JAX: the config's, and the DETR
# encoder over the image memory (only_decoder=False, 2 layers)
HEADS = {"tiny_synth": {},
         "encoder": {"only_decoder": False, "num_encoder_layers": 2}}


@pytest.fixture(scope="module", params=sorted(HEADS))
def jax_init_sd(request):
    import jax
    import jax.numpy as jnp

    from simvg_tpu.config import Config as JaxConfig
    from simvg_tpu.models.builder import build_model as jax_build

    cfg = JaxConfig.fromfile(TINY)
    cfg.model.head.update(HEADS[request.param])
    model, _ = jax_build(cfg.model, img_size=cfg.img_size, dtype=jnp.float32)
    t = cfg.max_token
    params = cheap_jit(model.init)(
        jax.random.PRNGKey(0),
        image=jnp.zeros((1, cfg.img_size, cfg.img_size, 3), jnp.float32),
        text_ids=jnp.ones((1, t), jnp.int32),
        text_padding_mask=jnp.zeros((1, t), jnp.int32),
        img_shape=jnp.full((1, 2), cfg.img_size, jnp.int32))
    return request.param, export_simvg_full(jax.tree.map(np.asarray, params))


def _built(device="cpu", **head):
    cfg = Config.fromfile(TINY)
    cfg.model.head.update(head)
    model, _ = build_model(cfg.model, img_size=cfg.img_size, device=device)
    return model.to_empty(device="cpu") if device == "meta" else model


def _port(seed=0, device="cpu", **head):
    return init_random_weights(_built(device, **head), seed)


def test_init_statistics_match_jax_model_init(jax_init_sd):
    heads, jax_init_sd = jax_init_sd
    sd = {k: v.numpy().astype(np.float64)
          for k, v in _port(**HEADS[heads]).state_dict().items()}
    assert set(sd) == set(jax_init_sd)
    bad = []
    for k, want in jax_init_sd.items():
        want = np.asarray(want, np.float64)
        got = sd[k]
        assert got.shape == want.shape, k
        if want.std() == 0.0:  # a constant: zeros or ones
            if not np.array_equal(got, want):
                bad.append((k, "constant", got.mean(), want.mean()))
            continue
        sigma = want.std()
        n1, n2 = got.size, want.size
        mean_tol = N_SE * sigma * np.sqrt(1 / n1 + 1 / n2)
        std_tol = N_SE * sigma * np.sqrt(1 / (2 * n1) + 1 / (2 * n2))
        if abs(got.mean() - want.mean()) > mean_tol or \
                abs(got.std() - want.std()) > std_tol:
            bad.append((k, got.mean(), got.std(), want.mean(), want.std()))
    assert not bad, bad


def test_mask_token_is_zero_and_query_embed_is_unit_normal():
    model = _port(seed=1)
    enc = model.vis_enc["beit3"]
    assert torch.count_nonzero(enc.vision_embed.mask_token) == 0
    q = model.head.query_embed.weight
    assert 0.7 < q.std().item() < 1.3, q.std()


def test_one_seed_gives_the_same_weights_whatever_the_build_device():
    a = _port(seed=5).state_dict()
    b = _port(seed=5, device="meta").state_dict()
    c = init_random_weights(_port(seed=6),
                            torch.Generator().manual_seed(5)).state_dict()
    for k in a:
        assert torch.equal(a[k], b[k]), k
        assert torch.equal(a[k], c[k]), k


def test_the_draw_comes_from_a_cpu_generator(monkeypatch):
    seen = []
    normal = torch.Tensor.normal_

    def spy_normal(t, *args, generator=None, **kw):
        seen.append((t.device.type, generator.device.type))
        return normal(t, *args, generator=generator, **kw)

    model = _built("meta")
    monkeypatch.setattr(torch.Tensor, "normal_", spy_normal)
    init_random_weights(model, 2)
    monkeypatch.undo()
    assert seen and set(seen) == {("cpu", "cpu")}


@pytest.mark.parametrize("cli", ["resolve_device", "train", "test"])
def test_clis_turn_tf32_off(tmp_path, cli):
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        if cli == "resolve_device":
            assert train_cli.resolve_device("cpu").type == "cpu"
        else:
            # the device setup runs before the config is read
            argv = [str(tmp_path / "missing.py"), "--device", "cpu"]
            if cli == "test":
                argv.insert(1, str(tmp_path / "ck"))
            main = train_cli.main if cli == "train" else test_cli.main
            with pytest.raises((FileNotFoundError, OSError)):
                main(argv)
        assert torch.backends.cuda.matmul.allow_tf32 is False
        assert torch.backends.cudnn.allow_tf32 is False
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
