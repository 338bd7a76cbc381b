"""The port stands alone: no module of ml_function_tpu_torch, and not
chip_smoke.py, imports JAX or the JAX package; CPU runs, forward and
training, never launch a kernel; a CUDA input either launches the kernel or
raises, in training too; every kernel builds from the repository's sources
(a change to a shared header builds anew); and chip_smoke.py
refuses to run, printing no result, where there is no CUDA device."""

import ast
import os
import shutil
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


def test_sources_checked_cover_the_last_modules():
    """The sources that ``test_no_source_names_jax`` reads include the
    sequence-parallel and pipeline modules and graph pretraining."""
    names = {str(p.relative_to(PORT)) for p in PORT.rglob("*.py")}
    want = {f"parallel/{m}.py" for m in ("comm", "longseq", "seq_parallel", "pipeline")}
    want |= {f"embedding_pretrain/{m}.py" for m in (
        "__init__", "alias", "api", "evaluate", "graph", "line", "native_walks", "sdne",
        "walks", "word2vec")}
    assert want <= names, sorted(want - names)


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


def test_cpu_train_step_launches_no_kernel():
    from ml_function_tpu_torch.train.loop import make_train_step
    from ml_function_tpu_torch.train.optimizers import make_optimizer
    fs, data = make_criteo_like(n_rows=256, n_dense=2, n_sparse=4,
                                vocab_size=20, embed_dim=4)
    model = get_model("xdeepfm", fs, device="cpu", cin_hidden=(128,),
                      hidden=(8,))
    step = make_train_step(model, make_optimizer("adam", 1e-3).init(model))
    tcin.cin_fwd_launches = tcin.cin_bwd_launches = 0
    out = step(data)
    assert torch.isfinite(out["loss"]) and model.cin.w0.grad is not None
    assert tcin.cin_fwd_launches == tcin.cin_bwd_launches == 0


def test_training_entry_points_default_to_the_card():
    """get_model (and so fit, which trains the model where it is) and the
    learning-curve tool run on the card unless asked for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is the card")
    from ml_function_tpu_torch.tools import learning_curve
    fs, _ = make_criteo_like(n_rows=8, n_dense=1, n_sparse=2, vocab_size=5)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        get_model("xdeepfm", fs)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        learning_curve.main(["--vocab", "5"])


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
    with pytest.raises(ValueError, match="CUDA"):   # training as well
        tcin.cin_layer_t(xk, x0, w1.requires_grad_())
    assert tcin.cin_fwd_launches == before


def test_cpu_autoint_launches_no_kernel(monkeypatch):
    """The field-attention route on the CPU, forward and training, runs the
    plain versions."""
    from ml_function_tpu_torch.ops.kernels import field_attention as tfa
    from ml_function_tpu_torch.train.loop import make_train_step
    from ml_function_tpu_torch.train.optimizers import make_optimizer
    monkeypatch.setenv("ML_FUNCTION_TPU_FIELD_ATTN", "1")
    fs, data = make_criteo_like(n_rows=64, n_dense=2, n_sparse=4,
                                vocab_size=20, embed_dim=4)
    model = get_model("autoint", fs, device="cpu")
    tfa.field_attn_fwd_launches = tfa.field_attn_bwd_launches = 0
    out = make_train_step(model, make_optimizer("adam", 1e-3).init(model))(data)
    assert torch.isfinite(out["loss"]) and model.mha0.q.grad is not None
    assert tfa.field_attn_fwd_launches == tfa.field_attn_bwd_launches == 0


def test_field_attention_non_cpu_inputs_never_fall_back():
    from ml_function_tpu_torch.ops.kernels import field_attention as tfa
    q = torch.zeros(4, 3, 2, 8, device="meta")
    bias = torch.zeros(4, 3, device="meta")
    before = tfa.field_attn_fwd_launches, tfa.field_attn_bwd_launches
    with pytest.raises(ValueError, match="CUDA"):
        tfa.field_attention(q, q, q, bias, 0.5)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.field_attention(q, q, q, torch.zeros(4, 3), 0.5)
    with pytest.raises(ValueError, match="CUDA"):   # training as well
        tfa.field_attention(q.requires_grad_(), q, q, bias, 0.5)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.field_attention_backward(q, q, q, bias, q, 0.5)
    assert (tfa.field_attn_fwd_launches, tfa.field_attn_bwd_launches) == before


def test_gru_and_merge_scatter_non_cpu_inputs_never_fall_back():
    from ml_function_tpu_torch.ops.kernels import embedding_grad as teg
    from ml_function_tpu_torch.ops.kernels import gru as tgru
    xw = torch.zeros(4, 3, 12, device="meta")
    wh = torch.zeros(4, 12, device="meta")
    bl, h0 = torch.ones(4, 3, device="meta"), torch.zeros(4, 4, device="meta")
    before = tgru.gru_fwd_launches, tgru.gru_bwd_launches, teg.merge_scatter_launches
    with pytest.raises(ValueError, match="CUDA"):
        tgru.gru_sequence(xw, wh, bl, bl, h0)
    with pytest.raises(ValueError, match="CUDA"):
        tgru.gru_sequence(xw, torch.zeros(4, 12), bl, bl, h0)
    with pytest.raises(ValueError, match="CUDA"):   # training as well
        tgru.gru_sequence(xw, wh.requires_grad_(), bl, bl, h0)
    with pytest.raises(ValueError, match="CUDA"):
        tgru.gru_sequence_backward(xw, wh, bl, bl, h0, xw[..., :4], xw[..., :4])
    ids = torch.zeros(6, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        teg.dense_grad_from_updates(ids, torch.zeros(6, 4, device="meta"), 10)
    with pytest.raises(ValueError, match="CUDA"):   # the backward of a lookup
        teg.fused_gather(torch.zeros(10, 4, device="meta", requires_grad=True),
                         ids).sum().backward()
    assert (tgru.gru_fwd_launches, tgru.gru_bwd_launches,
            teg.merge_scatter_launches) == before


def test_flash_attention_non_cpu_inputs_never_fall_back():
    from ml_function_tpu_torch.ops.kernels import flash_attention as tfl
    q = torch.zeros(2, 2, 5, 8, device="meta")
    bias = torch.zeros(2, 5, device="meta")
    lse = torch.zeros(2, 2, 5, device="meta")
    counts = lambda: (tfl.flash_fwd_launches, tfl.flash_bwd_dq_launches,  # noqa: E731
                      tfl.flash_bwd_dkv_launches)
    before = counts()
    with pytest.raises(ValueError, match="CUDA"):
        tfl.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="CUDA"):
        tfl.flash_attention(q, q, q, torch.ones(2, 5, dtype=torch.bool))
    with pytest.raises(ValueError, match="CUDA"):   # training as well
        tfl.flash_attention(q.requires_grad_(), q, q)
    for fn in (tfl.flash_attention_backward_dq, tfl.flash_attention_backward_dkv):
        with pytest.raises(ValueError, match="CUDA"):
            fn(q, q, q, bias, lse, q, lse, 0.5)
    assert counts() == before


def test_cpu_sim_launches_no_kernel(monkeypatch):
    """SIM on the CPU with every kernel route on (hard search over a
    512-step stream, so the flash route; the (AU)GRU kernel route; the
    merge-scatter flag), a train step: the plain versions, no launch."""
    import numpy as np
    from ml_function_tpu_torch.features.schema import SeqSpec
    from ml_function_tpu_torch.features.synthetic import make_behavior_data
    from ml_function_tpu_torch.ops import embedding
    from ml_function_tpu_torch.ops.kernels import embedding_grad as teg
    from ml_function_tpu_torch.ops.kernels import flash_attention as tfl
    from ml_function_tpu_torch.ops.kernels import gru as tgru
    from ml_function_tpu_torch.train.loop import make_train_step
    from ml_function_tpu_torch.train.optimizers import make_optimizer
    monkeypatch.setattr(embedding, "_USE_MERGE_SCATTER", True)
    fs, data = make_behavior_data(n_rows=8, n_items=30, n_cates=6, seq_len=8, embed_dim=4)
    fs = fs.replace(seq=fs.seq + (SeqSpec("hist_long", 31, 512, vocab_name="item", dim=4),))
    data["seq"]["hist_long"] = np.random.default_rng(0).integers(0, 31, (8, 512)).astype(np.int32)
    model = get_model("sim", fs, device="cpu", search="hard", hidden=(8,),
                      long_behavior=("hist_long",))
    model.dien.gru1.kernel = model.dien.gru2.kernel = "pallas"
    tfl.flash_fwd_launches = tfl.flash_bwd_dq_launches = tfl.flash_bwd_dkv_launches = 0
    tgru.gru_fwd_launches = tgru.gru_bwd_launches = teg.merge_scatter_launches = 0
    out = make_train_step(model, make_optimizer("adam", 1e-3).init(model))(data)
    assert torch.isfinite(out["loss"]) and model.mha.q.grad is not None
    assert (tfl.flash_fwd_launches, tfl.flash_bwd_dq_launches, tfl.flash_bwd_dkv_launches,
            tgru.gru_fwd_launches, tgru.gru_bwd_launches, teg.merge_scatter_launches) == (0,) * 6


def test_kernel_builds_from_the_repo_sources_only(tmp_path, monkeypatch):
    from ml_function_tpu_torch.ops.kernels import _build
    names = {"cin_fwd", "cin_bwd", "field_attn_fwd", "field_attn_bwd", "gru_fwd",
             "gru_bwd", "merge_scatter", "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"}
    assert {p.stem for p in _build.CSRC.glob("*.cu")} == names
    for name in names:
        so = _build.library_path(name)
        assert so.parent == _build.BUILD and so.name.startswith(f"lib{name}-")
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    # the hash covers the shared header: an edited copy builds anew
    before = _build.library_path("field_attn_fwd")
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, copy)
    monkeypatch.setattr(_build, "CSRC", copy)
    assert _build.library_path("field_attn_fwd").name == before.name
    (copy / "field_attn.cuh").write_text((copy / "field_attn.cuh").read_text() + "\n")
    assert _build.library_path("field_attn_fwd").name != before.name
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
