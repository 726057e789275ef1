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


def in_background(fn, *args, **kw):
    """Runs ``fn(*args, **kw)`` on a thread of its own; returns a function
    that waits for it and gives its result, or raises its exception.  A
    test's gloo spawns (``run_ranks``) wait on their subprocesses there
    while the test computes its JAX reference."""
    import threading

    box = {}

    def run():
        try:
            box["out"] = fn(*args, **kw)
        except BaseException as e:  # noqa: BLE001 -- handed to the waiter
            box["err"] = e

    thread = threading.Thread(target=run, daemon=True)
    thread.start()

    def wait():
        thread.join()
        if "err" in box:
            raise box["err"]
        return box["out"]

    return wait


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


def _png_filter(kinds, lines, bpp):
    """The PNG filters ``kinds`` (0-4, one a row) of unfiltered scanlines
    ``lines`` (uint8 [n, rowbytes]), all at once: each byte's predictor
    comes from the unfiltered bytes left of it and above it."""
    x = lines.astype(np.int16)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    pred = np.stack([np.zeros_like(x), a, b, (a + b) >> 1, paeth])
    chosen = pred[np.asarray(kinds), np.arange(len(x))]
    return ((x - chosen) & 0xFF).astype(np.uint8)


def png_chunk(kind: bytes, payload: bytes, crc=None) -> bytes:
    import struct
    import zlib

    crc = zlib.crc32(kind + payload) if crc is None else crc
    return struct.pack(">I", len(payload)) + kind + payload \
        + struct.pack(">I", crc & 0xFFFFFFFF)


# PNG streams at the edges of the card's unfilter kernel (csrc/png.cu: a
# warp a group of 32 rows, 16 warp slots on a cluster's SMs, lane 31 handing
# its row on through a ring of 128 units whose reader reports every 16):
# (name, colour type, bit depth, height, width, filter types, Adam7).
# Heights around a row group and around the slots' 512 rows, widths of 1 and
# 2 units at every bytes-per-pixel (1, 2, 3, 4, 6, 8), unit counts past 8,
# a report and half and all of the ring, and images of a single filter type.
PNG_BOUNDARY_CASES = (
    [(f"rows{h}", 2, 8, h, 17, (0, 1, 2, 3, 4), False)
     for h in (31, 32, 33, 32 * 16 - 1, 32 * 16 + 1)]
    + [(f"bpp{bpp}_units{w}", ct, bd, 33, w, (0, 1, 2, 3, 4), False)
       for ct, bd, bpp in ((0, 8, 1), (4, 8, 2), (2, 8, 3), (6, 8, 4),
                           (2, 16, 6), (6, 16, 8)) for w in (1, 2)]
    + [(f"units{w}", 0, 8, 40, w, (0, 1, 2, 3, 4), False)
       for w in (9, 17, 65, 129)]
    + [(f"only{f}{'_adam7' if i else ''}", 2, 8, 37, 29, (f,), i)
       for f in (1, 2, 3, 4) for i in (False, True)])


def png_boundary_stream(case, seed=0):
    """The PNG stream of one of PNG_BOUNDARY_CASES, its samples from
    ``seed``."""
    _, ct, bd, h, w, filters, interlace = case
    ch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ct]
    samples = np.random.default_rng(seed).integers(0, 1 << bd, (h, w, ch))
    return write_png(samples, bd, ct, filters, interlace)


def write_png(samples, bit_depth=8, color_type=2, filters=(0,),
              interlace=False, chunks_before=b"", chunks_after=b""):
    """A PNG stream of ``samples`` (uint [h, w, channels] in the colour
    type's channel order, values below 2**bit_depth), written with zlib and
    struct: row i of each pass takes filter ``filters[i % len(filters)]``;
    ``chunks_before`` (PLTE, tRNS, eXIf, ...) go before IDAT."""
    import struct
    import zlib

    samples = np.asarray(samples)
    h, w, ch = samples.shape
    bpp = max(1, ch * bit_depth // 8)
    passes = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
              (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2)) \
        if interlace else ((0, 0, 1, 1),)
    raw = bytearray()
    i = 0
    for x0, y0, dx, dy in passes:
        sub = samples[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        flat = sub.reshape(len(sub), -1)
        if bit_depth == 16:
            lines = flat.astype(">u2").view(np.uint8)
        elif bit_depth == 8:
            lines = flat.astype(np.uint8)
        else:
            bits = ((flat[..., None] >> np.arange(bit_depth - 1, -1, -1))
                    & 1).astype(np.uint8).reshape(len(flat), -1)
            lines = np.packbits(bits, axis=1)
        kinds = [filters[(i + k) % len(filters)] for k in range(len(lines))]
        i += len(lines)
        raw += np.concatenate([np.asarray(kinds, np.uint8)[:, None],
                               _png_filter(kinds, lines, bpp)], 1).tobytes()
    ihdr = struct.pack(">IIBBBBB", w, h, bit_depth, color_type, 0, 0,
                       int(interlace))
    return (b"\x89PNG\r\n\x1a\n" + png_chunk(b"IHDR", ihdr) + chunks_before
            + png_chunk(b"IDAT", zlib.compress(bytes(raw)))
            + chunks_after + png_chunk(b"IEND", b""))
