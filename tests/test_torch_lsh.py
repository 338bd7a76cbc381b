"""Reformer LSH attention in the port: ``ops.threefry`` (the numpy copy of
``jax.random``'s PRNGKey, fold_in, bits and normal that draws the bucket
rotations), ``LSHSelfAttention``, and BST(attention='lsh') and
SIM(esu_attention='lsh'), against the JAX package on the CPU with the JAX
weights carried across by the bridge.

The rotations: the key words and the random bits are JAX's exactly; the
normals sit at most ``ROTATION_ULPS`` (3) ulps from ``jax.random.normal``'s,
whose f32 erfinv runs XLA's own log1p (measured: 3 at (2000, 3), 0 to 3 at
the shapes here), and the buckets of the tests' keys are equal.

Bars, with ``ML_FUNCTION_TPU_F32_MATMUL=1``: outputs, logits and losses
within 1e-6 (relative to the largest), gradients within 1e-5·max|g|
(a gradient through the sort's gathers, the chunk windows and the
LayerNorm sums more terms than a forward); on the bf16 path 1e-4 and one
bf16 step of max|g|. The max|g| of a target attention's MLP (SIM's
``attn`` and its DIEN core's ``dien.attn``) is its block's: the softmax
over steps does not see a shift of every score, so those gradients are
residues of sums that cancel (``tests/test_torch_sequence_tier.py``),
and with f32 matmuls they are held at 1e-4 of it (SIM's ``dien.attn`` head
bias reads 1.1e-5). SIM's ``dien.mlp`` is never read (``ROADMAP.md`` R6):
exactly zero gradient in JAX, none in the port. BST's 41 positions take 3
chunks of 16 (48 padded), SIM's top 24 two.
"""

import contextlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ml_function_tpu.features.synthetic import make_behavior_data as jax_make
from ml_function_tpu.models import get_model as jax_get_model
from ml_function_tpu.ops.attention import LSHSelfAttention as JLSH
from ml_function_tpu.train import loop as jloop
from ml_function_tpu_torch.bridge import params_from_numpy
from ml_function_tpu_torch.features.synthetic import make_behavior_data
from ml_function_tpu_torch.models import get_model
from ml_function_tpu_torch.ops import threefry
from ml_function_tpu_torch.ops.attention import LSHSelfAttention, TransformerBlock
from ml_function_tpu_torch.serving import export_model, load_scorer
from ml_function_tpu_torch.train import loop as tloop

torch.set_num_threads(1)

ROTATION_ULPS = 3
# (hd, N_BUCKETS // 2): this file's modules, BST and SIM here (kd 8, 2
# heads) and at the board's width in chip_smoke (kd 16, 2 heads)
ROTATION_SHAPES = ((4, 4), (8, 4))
DATA_KW = dict(n_rows=16, n_items=30, n_cates=6, seq_len=40, embed_dim=4, seed=2)
MODELS = {"bst": {"attention": "lsh", "hidden": (16, 8)},
          "sim": {"esu_attention": "lsh", "hidden": (16, 8), "top_k": 24}}
MODEL_CASES = [(m, f32) for m in MODELS for f32 in (True, False)]
# (L, n_hashes) at the callers' settings (chunks of 16): 40 keys take 3
# chunks (8 of them padding), 48 three whole ones, 13 one chunk of 13
LSH_CASES = {
    "chunks": (40, 1),
    "hashes": (40, 3),
    "whole_chunks": (48, 1),
    "one_chunk_hashes": (13, 2),
}


@contextlib.contextmanager
def _f32(on: bool):
    saved = os.environ.get("ML_FUNCTION_TPU_F32_MATMUL")
    os.environ["ML_FUNCTION_TPU_F32_MATMUL"] = "1" if on else "0"
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop("ML_FUNCTION_TPU_F32_MATMUL")
        else:
            os.environ["ML_FUNCTION_TPU_F32_MATMUL"] = saved


def _close(got, want, rtol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


def _ulps(a, b):
    return int(np.abs(a.view(np.int32).astype(np.int64)
                      - b.view(np.int32).astype(np.int64)).max())


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(tree):
    return {".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path):
            np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


# ---- the rotations --------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 11, 2 ** 32 - 1])
def test_keys_and_bits_are_jax_bits(seed):
    base = jax.random.PRNGKey(seed)
    assert threefry.prng_key(seed) == tuple(int(w) for w in np.asarray(base))
    for r in range(3):
        key = jax.random.fold_in(base, r)
        ours = threefry.fold_in(threefry.prng_key(seed), r)
        assert ours == tuple(int(w) for w in np.asarray(key))
        for shape in ROTATION_SHAPES + ((7, 5, 3),):
            np.testing.assert_array_equal(
                threefry.random_bits(ours, shape),
                np.asarray(jax.random.bits(key, shape, jnp.uint32)))


def test_rotations_are_jax_normals_within_ulps():
    """Every rotation the tests and chip_smoke draw: within ROTATION_ULPS
    of ``jax.random.normal``, and the buckets of random keys equal."""
    rng = np.random.default_rng(0)
    worst = 0
    for seed in (0, 11):
        for r in range(3):
            key = jax.random.fold_in(jax.random.PRNGKey(seed), r)
            ours = threefry.fold_in(threefry.prng_key(seed), r)
            for shape in ROTATION_SHAPES:
                want = np.asarray(jax.random.normal(key, shape, jnp.float32))
                got = threefry.normal(ours, shape)
                worst = max(worst, _ulps(got, want))
                qk = rng.normal(size=(64, shape[0])).astype(np.float32)
                bw, bg = (np.argmax(np.concatenate([qk @ w, -(qk @ w)], -1), -1)
                          for w in (want, got))
                np.testing.assert_array_equal(bg, bw)
    assert worst <= ROTATION_ULPS, worst


def test_threefry_rejects_seeds_out_of_range():
    for seed in (-1, 2 ** 32):
        with pytest.raises(ValueError, match="seed"):
            threefry.prng_key(seed)
    with pytest.raises(ValueError, match="data"):
        threefry.fold_in((0, 0), 2 ** 32)


# ---- LSHSelfAttention -----------------------------------------------------


def _lsh_inputs(b=3, l=13, d=8, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, l, d)).astype(np.float32)
    mask = np.ones((b, l), bool)
    mask[1, 9:] = False
    mask[2, 3:] = False
    return x, mask


@pytest.mark.parametrize("case", sorted(LSH_CASES))
def test_lsh_attention_matches_jax(case):
    """Output, bucket ids of every round, and the gradients of sum(sin(out))
    to the input and every parameter, with padded keys."""
    l, n_hashes = LSH_CASES[case]
    x, mask = _lsh_inputs(l=l)
    jm = JLSH(dim=8, num_heads=2, n_hashes=n_hashes)
    params = _np(jm.init(jax.random.PRNGKey(0)))
    with _f32(True):
        want = np.asarray(jm(params, jnp.asarray(x), jnp.asarray(mask)))
        loss = lambda p, xx: jnp.sum(jnp.sin(jm(p, xx, jnp.asarray(mask))))
        jg, jgx = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))
        tm = LSHSelfAttention(8, 2, n_hashes=n_hashes)
        params_from_numpy(tm, params)
        tx = torch.from_numpy(x).requires_grad_()
        got = tm(tx, torch.from_numpy(mask))
        torch.sin(got).sum().backward()
        qk = jnp.asarray(x) @ params["qk"]
        qk_f = np.asarray(qk).reshape(3, l, 2, 4).transpose(0, 2, 1, 3).reshape(6, l, 4)
        base = jax.random.PRNGKey(LSHSelfAttention.SEED)
        for r in range(n_hashes):
            jb = np.asarray(jm._buckets(jnp.asarray(qk_f), jax.random.fold_in(base, r)))
            np.testing.assert_array_equal(tm.buckets(torch.from_numpy(qk_f), r).numpy(), jb)
    _close(got.detach().numpy(), want, 1e-6)
    _close(tx.grad.numpy(), np.asarray(jgx), 1e-5)
    jg = _flat(jg)
    for n, p in tm.named_parameters():
        _close(p.grad.numpy(), jg[n], 1e-5)


@pytest.mark.parametrize("l", [12, 16])
def test_one_chunk_is_shared_qk_full_attention(l):
    """L ≤ CHUNK (16): exactly shared-QK full attention with the self
    penalty (the chunk attends to itself twice, which leaves the softmax
    average as it is), as ``tests/test_lsh_attention.py`` pins for JAX."""
    x, mask = _lsh_inputs(l=l)
    tm = LSHSelfAttention(8, 2)
    jm = JLSH(dim=8, num_heads=2)
    params = _np(jm.init(jax.random.PRNGKey(0)))
    params_from_numpy(tm, params)
    with _f32(True), torch.no_grad():
        tx, tmask = torch.from_numpy(x), torch.from_numpy(mask)
        got = tm(tx, tmask)
        qk = (tx @ tm.qk).reshape(3, l, 2, 4)
        v = (tx @ tm.v).reshape(3, l, 2, 4)
        logits = torch.einsum("bqhd,bkhd->bhqk", qk, qk) / 2.0
        logits = torch.where(tmask[:, None, None, :], logits, -1e9)
        logits = logits + torch.eye(l) * tm.SELF_PENALTY
        out = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(logits, -1), v).reshape(3, l, 8)
        want = tm.ln((out @ tm.o) * tmask[..., None] + tx)
        jax_out = np.asarray(jm(params, jnp.asarray(x), jnp.asarray(mask)))
    _close(got.numpy(), want.numpy(), 1e-5)
    _close(got.numpy(), jax_out, 1e-6)


def test_lsh_rotation_is_a_buffer_not_a_parameter():
    """The rotations move with the module and stay out of the state dict,
    the parameter tree and the optimizer, as in the reference."""
    tm = LSHSelfAttention(8, 2, n_hashes=2)
    assert sorted(n for n, _ in tm.named_parameters()) == [
        "ln.bias", "ln.scale", "o", "qk", "v"]
    assert "rotation0" not in tm.state_dict()
    assert tm.rotation1.shape == (4, 4)
    block = TransformerBlock(8, 2, attention="lsh")
    assert isinstance(block.mha, LSHSelfAttention) and block.mha.CHUNK == JLSH.chunk_size
    with pytest.raises(ValueError, match="attention"):
        TransformerBlock(8, 2, attention="bogus")


# ---- BST and SIM with LSH -------------------------------------------------


@pytest.fixture(scope="module")
def jax_side():
    fs, data = jax_make(**DATA_KW)
    out = {}
    for name, f32 in MODEL_CASES:
        with _f32(f32):
            jm = jax_get_model(name, fs, **MODELS[name])
            params, state = jm.init(jax.random.PRNGKey(0))
            fn = jax.jit(jax.value_and_grad(
                lambda p: jloop.loss_fn(jm, p, state, data, None), has_aux=True))
            (total, (logits, _, aux, _)), grads = fn(params)
        out[name, f32] = dict(params=_np(params), logits=np.asarray(logits),
                              aux={k: float(v) for k, v in aux.items()},
                              total=float(total), grads=_flat(grads))
    return out


def _port_model(name, params):
    fs, _ = make_behavior_data(**DATA_KW)
    tm = get_model(name, fs, device="cpu", **MODELS[name])
    params_from_numpy(tm, params)
    return tm


def _bf16(x):
    return torch.tensor(np.asarray(x, np.float32)).bfloat16().float().numpy()


@pytest.mark.parametrize("name,f32", MODEL_CASES,
                         ids=[f"{m}-{'f32' if f else 'bf16'}" for m, f in MODEL_CASES])
def test_lsh_models_match_jax(jax_side, name, f32):
    """BST's blocks and SIM's exact search unit on LSH attention: logits,
    aux terms, the total loss and every step-1 gradient."""
    side = jax_side[name, f32]
    tm = _port_model(name, side["params"])
    _, tdata = make_behavior_data(**DATA_KW)
    lsh = [m for m in tm.modules() if isinstance(m, LSHSelfAttention)]
    assert len(lsh) == 1
    with _f32(f32):
        total, (logits, _, aux, _) = tloop.loss_fn(tm, tloop.to_device(tdata, "cpu"))
        total.backward()
    bar = 1e-6 if f32 else 1e-4
    _close(logits.detach().numpy(), side["logits"], bar)
    for k, v in aux.items():
        _close(v.item(), side["aux"][k], bar)
    _close(total.item(), side["total"], bar)
    grads = side["grads"]
    assert {n for n, _ in tm.named_parameters()} == set(grads)

    def block(n):
        head = n.split(".mlp.")[0]
        return head if head.split(".")[-1] == "attn" else n

    block_max = {}
    for n, g in grads.items():
        block_max[block(n)] = max(block_max.get(block(n), 0.0), float(np.abs(g).max()))
    for n, p in tm.named_parameters():
        want = grads[n]
        if p.grad is None:
            assert n.startswith("dien.mlp.") and not want.any(), n
            continue
        got, scale = p.grad.numpy(), block_max[block(n)]
        err = np.abs(got - want)
        if f32:
            bar = 1e-4 if block(n) != n else 1e-5
            ok = err <= bar * scale + 1e-5 * np.abs(want)
        else:
            ok = err <= 2.0 ** -8 * scale + 1e-3 * np.abs(want)
            if np.array_equal(_bf16(got), got) and np.array_equal(_bf16(want), want):
                _, e = np.frexp(np.maximum(np.abs(got), np.abs(want)))
                ok |= err <= np.ldexp(1.0, e - 8)
        assert ok.all(), f"{n}: max |err| {err.max()} (max|g| {scale})"


def test_bst_lsh_export_scores_in_the_port(jax_side, tmp_path):
    """BST(attention='lsh') through ``export_model`` → ``load_scorer``: the
    JAX model's scores (the rotation is drawn anew from the seed, not
    exported)."""
    side = jax_side["bst", True]
    tm = _port_model("bst", side["params"])
    fs, tdata = make_behavior_data(**DATA_KW)
    path = export_model(str(tmp_path / "m"), "bst", fs, tm,
                        hyperparams={"attention": "lsh", "hidden": [16, 8]})
    scorer = load_scorer(path, batch_size=6, device="cpu")
    with _f32(True):
        got = scorer.predict_proba({k: tdata[k] for k in ("dense", "sparse", "seq")})
    want = 1.0 / (1.0 + np.exp(-side["logits"].astype(np.float64)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
