"""An installed port can build its kernels (ROADMAP F10).

The wheel is built offline from a copy of the sources (``pip wheel --no-deps
--no-build-isolation``, so the tree stays clean) and must hold the CUDA
sources under ``simvg_tpu_torch/csrc/``.  Unpacked as an installed package,
with its directory read-only, ``ops/_build.BUILD_DIR`` must resolve to a
writable per-user cache directory; in the source checkout it stays
``simvg_tpu_torch/_build/``, and ``SIMVG_TPU_TORCH_BUILD_DIR`` overrides both.
"""

import glob
import os
import os.path as osp
import shutil
import stat
import subprocess
import sys
import zipfile

import pytest

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
SOURCES = ("pyproject.toml", "README.md", "simvg_tpu", "simvg_tpu_torch")
CSRC = sorted(osp.basename(p) for p in glob.glob(
    osp.join(REPO, "simvg_tpu_torch", "csrc", "*.cu*")))


@pytest.fixture(scope="module")
def wheel(tmp_path_factory):
    src = tmp_path_factory.mktemp("src")
    ignore = shutil.ignore_patterns("__pycache__", "_build", "*.pyc")
    for name in SOURCES:
        path = osp.join(REPO, name)
        if osp.isdir(path):
            shutil.copytree(path, src / name, ignore=ignore)
        else:
            shutil.copy(path, src / name)
    out = tmp_path_factory.mktemp("wheel")
    proc = subprocess.run(
        [sys.executable, "-m", "pip", "wheel", "--no-deps",
         "--no-build-isolation", "--no-index", "--no-cache-dir", "-q",
         "-w", str(out), str(src)],
        capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stderr[-2000:]
    (path,) = glob.glob(str(out / "*.whl"))
    return path


def test_wheel_holds_the_cuda_sources(wheel):
    assert {"attention_fwd.cu", "attention_bwd.cu", "jpeg.cu",
            "attention_common.cuh"} <= set(CSRC)
    with zipfile.ZipFile(wheel) as z:
        names = z.namelist()
    got = sorted(osp.basename(n) for n in names
                 if n.startswith("simvg_tpu_torch/csrc/"))
    assert got == CSRC, got
    assert not [n for n in names if "/_build/" in n]


def _build_dir(site, env):
    code = ("from simvg_tpu_torch.ops import _build; "
            "print(_build.BUILD_DIR); print(_build.CSRC_DIR)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(site),
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return proc.stdout.split()


def test_build_dir_of_an_installed_package_is_writable(wheel, tmp_path):
    site = tmp_path / "site"
    with zipfile.ZipFile(wheel) as z:
        z.extractall(site)
    pkg = site / "simvg_tpu_torch"
    for d, _, files in os.walk(pkg):
        for f in files:
            os.chmod(osp.join(d, f), stat.S_IRUSR | stat.S_IRGRP)
        os.chmod(d, stat.S_IRUSR | stat.S_IXUSR | stat.S_IRGRP
                 | stat.S_IXGRP)
    try:
        env = {k: v for k, v in os.environ.items()
               if k != "SIMVG_TPU_TORCH_BUILD_DIR"}
        env.update(PYTHONPATH=str(site), HOME=str(tmp_path / "home"),
                   XDG_CACHE_HOME=str(tmp_path / "cache"))
        build_dir, csrc = _build_dir(site, env)
        assert build_dir == str(tmp_path / "cache" / "simvg_tpu_torch"
                                / "build")
        assert csrc == str(pkg / "csrc")
        assert sorted(os.listdir(csrc)) == CSRC
        os.makedirs(build_dir)
        probe = osp.join(build_dir, "probe")
        with open(probe, "w") as f:
            f.write("x")
        assert os.access(build_dir, os.W_OK) and osp.isfile(probe)

        del env["XDG_CACHE_HOME"]
        assert _build_dir(site, env)[0] == str(
            tmp_path / "home" / ".cache" / "simvg_tpu_torch" / "build")
        env["SIMVG_TPU_TORCH_BUILD_DIR"] = str(tmp_path / "mine")
        assert _build_dir(site, env)[0] == str(tmp_path / "mine")
    finally:
        for d, _, _ in os.walk(pkg):
            os.chmod(d, stat.S_IRWXU)


def test_build_dir_of_the_source_checkout(monkeypatch, tmp_path):
    from simvg_tpu_torch.ops import _build

    monkeypatch.delenv("SIMVG_TPU_TORCH_BUILD_DIR", raising=False)
    assert _build.default_build_dir() == _build.PACKAGE_DIR / "_build"
    assert str(_build.PACKAGE_DIR) == osp.join(REPO, "simvg_tpu_torch")
    monkeypatch.setenv("SIMVG_TPU_TORCH_BUILD_DIR", str(tmp_path))
    assert _build.default_build_dir() == tmp_path
