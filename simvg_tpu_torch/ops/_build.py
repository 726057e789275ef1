"""Builds the port's CUDA sources into shared libraries at first use.

Each ``csrc/<name>.cu`` has a plain C interface.  ``jpeg.cu`` also links
the toolkit's nvJPEG, found beside ``nvcc`` (``<toolkit>/lib64``, recorded
as the library's run path).  It is compiled with ``nvcc`` for ``sm_90a``
into ``BUILD_DIR`` and loaded with ``ctypes``: no PyTorch headers, so a
build takes seconds.  The library's file name carries a hash of the
source, the shared ``csrc/*.cuh`` headers and the flags, so an edited
source is rebuilt and a stale library is never loaded.  A failed build
raises; nothing falls back.

``BUILD_DIR`` is ``simvg_tpu_torch/_build/`` in a source checkout (the
package beside the repository's ``pyproject.toml``, writable), and the
per-user cache ``$XDG_CACHE_HOME/simvg_tpu_torch/build`` (default
``~/.cache``) for an installed package, whose directory may be read-only;
``SIMVG_TPU_TORCH_BUILD_DIR`` overrides both.  The sources ship with the
package (``pyproject.toml``'s package data), so an installed package
builds its kernels too.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Sequence

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR_ENV = "SIMVG_TPU_TORCH_BUILD_DIR"


def default_build_dir(package_dir: Path = PACKAGE_DIR) -> Path:
    """Where the libraries go: ``$SIMVG_TPU_TORCH_BUILD_DIR`` when set;
    ``<package>/_build`` in a writable source checkout; else the per-user
    cache directory."""
    override = os.environ.get(BUILD_DIR_ENV)
    if override:
        return Path(override).expanduser()
    if ((package_dir.parent / "pyproject.toml").is_file()
            and os.access(package_dir, os.W_OK)):
        return package_dir / "_build"
    cache = os.environ.get("XDG_CACHE_HOME") or os.path.join(
        os.path.expanduser("~"), ".cache")
    return Path(cache) / "simvg_tpu_torch" / "build"


BUILD_DIR = default_build_dir()
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas=-v",  # registers, shared memory and spills go to the log
)

# extra nvcc arguments of one source: the libraries it links
LINK_LIBS = {"jpeg": ("-lnvjpeg",)}

_lock = threading.Lock()
_loaded: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the port's kernels")


def build(name: str) -> Path:
    """Compiles ``csrc/<name>.cu`` unless an up-to-date build exists; the
    library's name carries a hash of the source, the headers and the
    flags."""
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    headers = b"".join(h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh")))
    nvcc = _nvcc()
    flags = list(NVCC_FLAGS)
    if name in LINK_LIBS:
        libdir = os.path.join(os.path.dirname(os.path.dirname(
            os.path.realpath(nvcc))), "lib64")
        flags += [f"-L{libdir}", "-Xlinker", f"-rpath={libdir}",
                  *LINK_LIBS[name]]
    key = hashlib.sha256(src + headers
                         + " ".join(flags).encode()).hexdigest()
    out = BUILD_DIR / f"lib{name}-{key[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc, *flags, "-o", tmp, str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    out.with_suffix(".log").write_text(
        " ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def build_all(names: Sequence[str]) -> Dict[str, Path]:
    """Builds every named source at once, one ``nvcc`` process each."""
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        return dict(zip(names, pool.map(build, names)))


def load(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu``, compiled on first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = _loaded[name] = ctypes.CDLL(str(build(name)))
        return lib
