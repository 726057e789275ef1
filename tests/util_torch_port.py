"""Shared set-up for the tests that hold simvg_tpu_torch against simvg_tpu.

The tiny configuration is the one ``tests/test_converter_e2e.py`` builds
(and ``tests/fixtures/simvg_full_tiny.pth`` was made from): 64 px,
patch 16, D=32, 4 heads, 2 layers.  Inputs are made with numpy from a
fixed seed and handed to both packages.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

TINY_BEIT3 = dict(img_size=64, patch_size=16, embed_dim=32, num_heads=4,
                  ffn_dim=64, num_layers=2, vocab_size=80,
                  drop_path_rate=0.0)
TINY_HEAD = dict(num_queries=2, in_channels=32, embed_dim=32,
                 num_decoder_layers=2, num_tgqg_layers=1)


# int8 outputs against JAX: a float32 difference of ~1e-6 upstream (another
# summation order) can move an activation across a k + 0.5 boundary of its
# int8 grid, which moves that value one step, s_x * s_w * |w_q| in the
# product (~1e-3 at these weights) and more after the layers above it.
# Such flips are rare: the most elements may differ by INT8_MAX_ATOL, the
# mean by INT8_MEAN_ATOL, a tenth of the int8 model's own drift from float32
INT8_MAX_ATOL = 5e-3
INT8_MEAN_ATOL = 2e-4


def assert_int8_close(got, want, err_msg=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    diff = np.abs(got - want)
    assert diff.max() <= INT8_MAX_ATOL, (err_msg, diff.max())
    assert diff.mean() <= INT8_MEAN_ATOL, (err_msg, diff.mean())


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Runs a module's tests on one torch CPU thread and gives the thread
    count back after it.  The suite runs six test processes on the machine's
    cores; one torch thread each leaves the cores to the processes rather
    than to torch threads that wait for one another (a test module that
    imports this fixture takes it)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# XLA with LLVM's cheap passes only: the JAX references of these tests
# compile in a half to a third of the time and compute the same values up
# to float32 rounding
CHEAP_COMPILE = {"xla_backend_optimization_level": 0,
                 "xla_llvm_disable_expensive_passes": True}


def cheap_jit(fn, **kw):
    """``jax.jit(fn)`` compiled with CHEAP_COMPILE."""
    import jax

    return jax.jit(fn, compiler_options=CHEAP_COMPILE, **kw)


def jax_tiny_model(**head):
    """The tiny JAX model; ``head`` overrides TINY_HEAD's settings."""
    from simvg_tpu.models import SimVGConfig, SimVGModel
    from simvg_tpu.models.beit3 import BEiT3Config
    from simvg_tpu.models.heads.tgqs_head import TGQSHeadConfig

    return SimVGModel(SimVGConfig(beit3=BEiT3Config(**TINY_BEIT3),
                                  head=TGQSHeadConfig(**TINY_HEAD, **head)))


def torch_tiny_model(**head):
    """The port's tiny model in eval mode; ``head`` as jax_tiny_model's."""
    from simvg_tpu_torch.models.beit3 import BEiT3Config
    from simvg_tpu_torch.models.heads.tgqs_head import TGQSHeadConfig
    from simvg_tpu_torch.models.model import SimVGConfig, SimVGModel

    return SimVGModel(SimVGConfig(
        beit3=BEiT3Config(**TINY_BEIT3),
        head=TGQSHeadConfig(**TINY_HEAD, **head))).eval()


def np_batch(b=3, t=6, seed=0):
    """A numpy batch with padded text (lengths t, t-2, 2, ...) and valid
    image extents that leave padded rows and columns on the 4x4 grid."""
    r = np.random.default_rng(seed)
    lengths = [max(2, t - 2 * i) for i in range(b)]
    pad = np.array([[int(j >= n) for j in range(t)] for n in lengths],
                   np.int32)
    shapes = [[64, 64], [48, 64], [64, 33], [40, 40]]
    return dict(
        image=r.normal(size=(b, 64, 64, 3)).astype(np.float32),
        text_ids=r.integers(1, 80, (b, t)).astype(np.int32),
        text_padding_mask=pad,
        img_shape=np.array([shapes[i % 4] for i in range(b)], np.int32),
    )


def to_torch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def to_jax(batch):
    import jax.numpy as jnp

    return {k: jnp.asarray(v) for k, v in batch.items()}


def jax_params_from_port(jax_model, batch, state_dict):
    """A JAX param tree holding a port state dict's weights, through
    ``tools.convert_checkpoint.convert_simvg_full`` into a template of the
    JAX model's shapes (``jax.eval_shape``: no JAX init runs)."""
    import jax

    from tools.convert_checkpoint import convert_simvg_full

    shapes = jax.eval_shape(jax_model.init, jax.random.PRNGKey(0),
                            **to_jax(batch))
    template = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    sd = {k: v.detach().numpy() for k, v in state_dict.items()}
    report = convert_simvg_full(sd, template)
    assert len(report) == len(jax.tree.leaves(template))
    return template


def free_port() -> int:
    """A TCP port on localhost that is free now."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(n, argv, timeout=240, env=None):
    """Runs ``argv`` (after the interpreter) as ``n`` ranks of one gloo
    group, with torchrun's environment, from the repo root; kills them all
    when one fails or the time runs out, and raises with its output.
    Returns each rank's (stdout, stderr)."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    port = free_port()
    procs = []
    try:
        for rank in range(n):
            e = dict(os.environ, **(env or {}), RANK=str(rank),
                     LOCAL_RANK=str(rank), WORLD_SIZE=str(n),
                     MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                     PYTHONPATH=repo, OMP_NUM_THREADS="1")
            procs.append(subprocess.Popen(
                [sys.executable, *argv], cwd=repo, env=e, text=True,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE))
        outs = [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (p, (_, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank}:\n{err[-4000:]}"
    return outs
