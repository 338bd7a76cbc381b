"""The port stands alone: no module of ml_function_tpu_torch, and not
chip_smoke.py, imports JAX or the JAX package; CPU runs never launch a
kernel; a CUDA input either launches the kernel or raises; and chip_smoke.py
refuses to run, printing no result, where there is no CUDA device."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import ml_function_tpu_torch
from ml_function_tpu_torch.features.synthetic import make_criteo_like
from ml_function_tpu_torch.models import get_model
from ml_function_tpu_torch.ops.kernels import cin as tcin

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
PORT = Path(ml_function_tpu_torch.__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "ml_function_tpu")


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    return env


def _forbidden(name):
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_every_port_module_imports_without_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import ml_function_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        f"bad = [m for m in sys.modules if any(m == f or m.startswith(f + '.') "
        f"for f in {FORBIDDEN!r})]\n"
        "print(len(names), bad)\n"
        "sys.exit(1 if bad or len(names) < 15 else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], env=_env(), cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.parametrize("path", sorted(
    [str(p.relative_to(REPO)) for p in PORT.rglob("*.py")] + ["chip_smoke.py"]))
def test_no_source_names_jax(path):
    tree = ast.parse((REPO / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        assert not any(_forbidden(n) for n in names), (path, names)


def test_cpu_forward_launches_no_kernel():
    fs, data = make_criteo_like(n_rows=256, n_dense=2, n_sparse=4,
                                vocab_size=20, embed_dim=4)
    model = get_model("xdeepfm", fs, device="cpu", cin_hidden=(128,),
                      hidden=(8,))
    tcin.cin_fwd_launches = 0
    with torch.no_grad():
        logits, _, _ = model(data)     # B 256, O 128: the fused-layer route
    assert logits.shape == (256,) and torch.isfinite(logits).all()
    assert tcin.cin_fwd_launches == 0


def test_non_cpu_inputs_never_fall_back():
    """Inputs that are not all on the CPU go to the kernel's checks, never to
    the plain version (``meta`` tensors stand in for the card here)."""
    xk = torch.zeros(2, 256, 3, device="meta")
    x0 = torch.zeros(2, 256, 3, device="meta")
    w1 = torch.zeros(3, 3 * 128, device="meta")
    before = tcin.cin_fwd_launches
    with pytest.raises(ValueError, match="CUDA"):
        tcin.cin_layer_t(xk, x0, w1)
    with pytest.raises(ValueError, match="CUDA"):
        tcin.cin_layer_t(xk, torch.zeros(2, 256, 3), torch.zeros(3, 384))
    with pytest.raises(NotImplementedError, match="training slice"):
        tcin.cin_layer_t(xk, x0, w1.requires_grad_())
    assert tcin.cin_fwd_launches == before


def test_kernel_builds_from_the_repo_sources_only():
    from ml_function_tpu_torch.ops.kernels import _build
    assert {p.stem for p in _build.CSRC.glob("*.cu")} == {"cin_fwd"}
    so = _build.library_path("cin_fwd")
    assert so.parent == _build.BUILD and so.name.startswith("libcin_fwd-")
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    ignored = (REPO / ".gitignore").read_text().split()
    assert "build/" in ignored, "the build directory must be git-ignored"


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                         env=_env(), cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    assert "no CUDA device" in out.stderr
    assert out.stdout.strip() == ""
