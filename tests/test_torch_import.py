"""Rules of the fast3r_torch package that hold without a GPU.

* ``import fast3r_torch`` (and every submodule) pulls in neither jax nor
  fast3r_tpu: the GPU machine that runs the port has no JAX; nor cv2,
  which that machine lacks too (this one has it, so only the check
  catches a stray import).
* The package calls no library attention, compiler or cuDNN switch: the
  hand-written kernels are the path.
* ``chip_smoke.py`` fails without a CUDA device, and outside the repository,
  before printing any result.
"""

import os
import pathlib
import re
import shutil
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
PKG = REPO / "fast3r_torch"


def _run(code_or_args, cwd, env_extra=None):
    env = dict(os.environ, **(env_extra or {}))
    args = ([sys.executable, "-c", code_or_args]
            if isinstance(code_or_args, str) else
            [sys.executable, *code_or_args])
    return subprocess.run(args, cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=240)


def test_import_leaves_jax_out():
    mods = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts)
        for p in PKG.rglob("*.py") if p.name != "__init__.py")
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "import fast3r_torch\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'fast3r_tpu',\n"
            "                                    'cv2'))\n"
            "print('BAD', bad)\n")
    res = _run(code, REPO)
    assert res.returncode == 0, res.stderr
    assert "BAD []" in res.stdout, res.stdout


def test_data_pipeline_leaves_torch_out():
    """The training loader's spawn workers import the CLI module (their
    main), the datasets and the loader, build a dataset and load a sample:
    none of it imports torch (the package's names load on first use), so
    the workers start in a fraction of a second."""
    code = ("import sys\n"
            "import fast3r_torch.cli.train, fast3r_torch.data.datamodule\n"
            "from fast3r_torch.data.dsl import build_dataset\n"
            "from fast3r_torch.data.loader import collate_views\n"
            "ds = build_dataset('DummyMultiview(num_scenes=2, num_views=2, "
            "resolution=[(64, 48)], seed=777)')\n"
            "ds.set_epoch(0)\n"
            "collate_views([ds[(0, 0)]])\n"
            "print('TORCH', 'torch' in sys.modules)\n"
            "import fast3r_torch\n"
            "print('LAZY', fast3r_torch.inference.__module__,\n"
            "      'torch' in sys.modules)\n")
    res = _run(code, REPO)
    assert res.returncode == 0, res.stderr
    assert "TORCH False" in res.stdout, res.stdout
    assert "LAZY fast3r_torch.inference True" in res.stdout, res.stdout


def test_package_imports_no_cv2():
    """The card's machine has no OpenCV: no port module imports cv2 (the
    import check above also holds cv2 out of ``sys.modules``)."""
    pat = re.compile(r"^\s*(import|from)\s+cv2\b")
    hits = [f"{p.relative_to(REPO)}:{i}"
            for p in PKG.rglob("*.py")
            for i, line in enumerate(p.read_text().splitlines(), 1)
            if pat.match(line)]
    assert not hits, hits


def test_package_imports_no_jax():
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|fast3r_tpu)\b")
    hits = [f"{p.relative_to(REPO)}:{i}"
            for p in PKG.rglob("*.py")
            for i, line in enumerate(p.read_text().splitlines(), 1)
            if pat.match(line)]
    assert not hits, hits


@pytest.mark.parametrize("needle", ["scaled_dot_product_attention",
                                    "torch.compile", "cudnn"])
def test_package_source_avoids(needle):
    hits = [str(p.relative_to(REPO)) for p in PKG.rglob("*.py")
            if needle in p.read_text()]
    assert not hits, hits


def test_chip_smoke_fails_without_cuda():
    res = _run(["chip_smoke.py"], REPO, {"CUDA_VISIBLE_DEVICES": ""})
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_chip_smoke_fails_outside_repo(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {"PYTHONPATH": ""}
    res = _run(["chip_smoke.py"], tmp_path, env)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
