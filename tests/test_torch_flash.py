"""Flash attention: the port (ml_function_tpu_torch) against the JAX package
on the CPU.

On the CPU the port's ``flash_attention`` runs its plain versions, forward
and backward; the JAX one runs the Pallas kernels in interpret mode, as
tests/test_flash_attention.py does, at that file's three shapes and at
Lk 1,100, which the JAX side pads to 1,536 (three key blocks of 512), with
and without the causal mask. Both are f32 throughout and differ only in
the order of f32 sums and in the reference's padding: the forward is held
to 1e-5 absolute (outputs are O(1)), dQ, dK and dV of sum(sin(o)) to
``jax.grad`` within 1e-4·max|g| of each tensor.

Every row of these cases has a valid key (key 0 is never masked), so the
one place the two packages part is left out here and pinned on its own
(``ROADMAP.md`` R1): a query whose keys are all masked gets mean(V) over the
Lk real keys in the port, the dense route's value, while the JAX flash
kernel, which gives its padded keys the masked bias too, averages over
Lk_pad keys of which the padding is zero and returns (Lk/Lk_pad)·mean(V).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ml_function_tpu.ops.kernels.flash_attention import \
    flash_attention as jax_flash_attention
from ml_function_tpu_torch.ops.kernels import flash_attention as tfl

torch.set_num_threads(1)

B, H = 2, 2
# (Lq, Lk, Dh, causal): tests/test_flash_attention.py's shapes, then Lk 1,100
SHAPES = [(64, 96, 16, False), (128, 128, 16, True), (100, 200, 8, False),
          (130, 1100, 16, False), (130, 1100, 16, True)]


def _inputs(shape, seed=0):
    lq, lk, dh, _ = shape
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, H, lq, dh)).astype(np.float32)
    k = rng.normal(size=(B, H, lk, dh)).astype(np.float32)
    v = rng.normal(size=(B, H, lk, dh)).astype(np.float32)
    mask = rng.uniform(size=(B, lk)) > 0.2
    mask[:, 0] = True
    return q, k, v, mask


@pytest.fixture(scope="module")
def jax_side():
    """JAX's interpret-mode kernels at each shape: the output, and dQ, dK,
    dV of sum(sin(o))."""
    out = {}
    for shape in SHAPES:
        causal = shape[3]
        q, k, v, mask = (jnp.asarray(a) for a in _inputs(shape))
        o = jax_flash_attention(q, k, v, mask, causal=causal)
        grads = jax.grad(lambda q, k, v: jnp.sum(jnp.sin(jax_flash_attention(
            q, k, v, mask, causal=causal))), argnums=(0, 1, 2))(q, k, v)
        out[shape] = (np.asarray(o), [np.asarray(g) for g in grads])
    return out


@pytest.mark.parametrize("shape", SHAPES)
def test_flash_forward_matches_jax(jax_side, shape):
    q, k, v, mask = (torch.from_numpy(a) for a in _inputs(shape))
    tfl.flash_fwd_launches = 0
    got = tfl.flash_attention(q, k, v, mask, causal=shape[3])
    assert got.shape == q.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), jax_side[shape][0], rtol=0, atol=1e-5)
    assert tfl.flash_fwd_launches == 0


@pytest.mark.parametrize("shape", SHAPES)
def test_flash_gradients_match_jax(jax_side, shape):
    """Through the autograd Function, whose CPU backward is
    ``flash_attention_backward_reference``; the mask gets no gradient and
    no kernel launches."""
    leaves = [torch.from_numpy(a).requires_grad_() for a in _inputs(shape)[:3]]
    mask = torch.from_numpy(_inputs(shape)[3])
    tfl.flash_bwd_dq_launches = tfl.flash_bwd_dkv_launches = 0
    torch.sin(tfl.flash_attention(*leaves, mask, causal=shape[3])).sum().backward()
    assert tfl.flash_bwd_dq_launches == tfl.flash_bwd_dkv_launches == 0
    for leaf, want in zip(leaves, jax_side[shape][1]):
        np.testing.assert_allclose(leaf.grad.numpy(), want, rtol=0,
                                   atol=1e-4 * float(np.abs(want).max()))


@pytest.mark.parametrize("causal", [False, True])
def test_backward_reference_formulas_are_the_gradient(causal):
    """In f64 the written-out formulas, with lse and δ, equal autograd of
    the plain forward, masked keys and a ragged Lq ≠ Lk included."""
    q, k, v, mask = (torch.from_numpy(a).double() if a.dtype != bool
                     else torch.from_numpy(a) for a in _inputs((7, 11, 5, causal), seed=3))
    bias = torch.where(mask, 0.0, tfl.NEG_INF).double()
    do = torch.from_numpy(np.random.default_rng(4).normal(size=q.shape))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o, lse = tfl.flash_attention_reference(*leaves, bias, 0.4, causal)
    o.backward(do)
    delta = (do * o.detach()).sum(dim=-1)
    got = tfl.flash_attention_backward_reference(q, k, v, bias, lse.detach(), do, delta,
                                                 0.4, causal)
    for g, leaf in zip(got, leaves):
        np.testing.assert_allclose(g.numpy(), leaf.grad.numpy(), rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("causal", [False, True])
def test_plain_versions_in_chunks_equal_one_chunk(causal, monkeypatch):
    """The plain versions cut the query rows into chunks so that the
    (B, H, rows, Lk) logits stay small at SIM's 16,384 keys: cut into
    chunks of 2 rows or taken whole, they give the same numbers."""
    q, k, v, mask = (torch.from_numpy(a) for a in _inputs((9, 40, 8, causal), seed=6))
    bias = torch.where(mask, 0.0, tfl.NEG_INF)
    do = torch.from_numpy(np.random.default_rng(7).normal(size=q.shape).astype(np.float32))

    def both():
        o, lse = tfl.flash_attention_reference(q, k, v, bias, 0.3, causal)
        delta = (do * o).sum(dim=-1)
        return (o, lse, *tfl.flash_attention_backward_reference(
            q, k, v, bias, lse, do, delta, 0.3, causal))

    whole = both()
    monkeypatch.setattr(tfl, "PLAIN_CHUNK", 2 * B * H * 40)
    assert len(tfl._row_chunks(B * H, 9, 40)) == 5
    for got, want in zip(both(), whole):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)


def test_fully_masked_row_is_the_mean_of_v():
    """R1: batch row 1 has every key masked. The port gives mean(V) over the
    Lk = 40 real keys in every query row, as the dense route does; the JAX
    flash kernel pads Lk to 512 and gives (40/512)·mean(V). The other batch
    row agrees with the JAX kernel."""
    q, k, v, mask = (torch.from_numpy(a) for a in _inputs((6, 40, 8, False), seed=5))
    mask[1] = False
    got = tfl.flash_attention(q, k, v, mask)
    mean_v = v[1].mean(dim=1, keepdim=True).expand(-1, 6, -1)
    np.testing.assert_allclose(got[1].numpy(), mean_v.numpy(), rtol=0, atol=1e-6)
    jax_out = np.asarray(jax_flash_attention(*(jnp.asarray(t.numpy()) for t in (q, k, v, mask))))
    np.testing.assert_allclose(jax_out[1], (40 / 512) * mean_v.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[0].numpy(), jax_out[0], rtol=0, atol=1e-5)


def test_no_mask_and_default_scale_match_jax():
    """mask None keeps every key; the scale defaults to 1/√Dh; Lq 1."""
    q, k, v, _ = _inputs((1, 300, 4, False), seed=8)
    got = tfl.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)))
    want = jax_flash_attention(*(jnp.asarray(a) for a in (q, k, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 mantissa bits), to nearest even, on its int32
    view."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0xFFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.view(torch.float32)


def _split_tf32_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The kernels' product: a = hi + lo, b = hi + lo with hi = tf32(x) and
    lo = tf32(x − hi), and lo·hi + hi·lo + hi·hi summed in f32. A product of
    two TF32 values is exact in f32, so f32 matmuls of the parts emulate the
    tensor cores up to the order of the f32 sums."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


@pytest.mark.parametrize("dh", [8, 64])
def test_split_tf32_products_are_f32_accurate(dh):
    """The precision argument of the tensor-core flash kernels, on the CPU:
    q·kᵀ·scale and P·V by split TF32, on standard-normal inputs, within
    2e-6 of max|f64| (the kernels' card bar against f64 is 1e-5 for o, dk
    and dv; this leaves room for the exponential and the online softmax).
    One-pass TF32 is printed beside it, not asserted. (The kernels round hi
    on its bits and leave lo to the tensor cores' truncation;
    tests/test_torch_flash_mma.py models exactly that.)"""
    rng = np.random.default_rng(dh)
    q = torch.from_numpy(rng.standard_normal((64, dh)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((512, dh)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((512, dh)).astype(np.float32))
    scale = dh ** -0.5
    s64 = (q.double() @ k.double().T) * scale
    p64 = torch.softmax(s64, dim=-1)
    o64 = p64 @ v.double()
    p = p64.float()

    def rel(got, want):
        return ((got.double() - want).abs().max() / want.abs().max()).item()

    split = {"logits": rel(_split_tf32_matmul(q, k.T) * scale, s64),
             "p_v": rel(_split_tf32_matmul(p, v), p.double() @ v.double())}
    one_pass = {"logits": rel((_tf32(q) @ _tf32(k).T) * scale, s64),
                "p_v": rel(_tf32(p) @ _tf32(v), p.double() @ v.double())}
    print(f"Dh {dh}: split TF32 {split}, one-pass TF32 {one_pass}, "
          f"o {rel(_split_tf32_matmul(p, v), o64)}")
    assert max(split.values()) < 2e-6


# (kind, Lq, Lk, Dh, taken): each kernel's grid has 65,535 rows of blocks at
# most, 128 query rows a block in the forward and dQ, 128 key rows in dK/dV
# (64 at a padded Dh of 64)
GRID_CASES = [("fwd", 8_000_000, 8, 8, True), ("dq", 8_000_000, 8, 8, True),
              ("fwd", 8_400_000, 8, 8, False), ("dkv", 8, 8_000_000, 32, True),
              ("dkv", 8, 8_000_000, 64, False), ("dkv", 8, 4_000_000, 64, True)]


@pytest.mark.parametrize("kind, lq, lk, dh, taken", GRID_CASES)
def test_grid_limit_is_each_kernels_own(kind, lq, lk, dh, taken, monkeypatch):
    """The wrappers refuse a shape by the grid of the kernel they launch,
    not by the narrowest block of the three (meta tensors: no memory)."""
    monkeypatch.setattr(tfl, "check_cuda_inputs", lambda *a, **k: None)
    meta = dict(device="meta", dtype=torch.float32)
    t = {"q": torch.empty(1, 1, lq, dh, **meta), "k": torch.empty(1, 1, lk, dh, **meta),
         "v": torch.empty(1, 1, lk, dh, **meta), "bias": torch.empty(1, lk, **meta)}
    if kind != "fwd":
        t.update(lse=torch.empty(1, 1, lq, **meta), do=torch.empty(1, 1, lq, dh, **meta),
                 delta=torch.empty(1, 1, lq, **meta))
    if taken:
        assert tfl._shape("test", kind, **t) == (1, 1, lq, lk, dh)
    else:
        with pytest.raises(ValueError, match="grid"):
            tfl._shape("test", kind, **t)
