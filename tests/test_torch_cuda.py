"""Tests of the port that need the CUDA card; here they skip.

This file imports nothing of JAX, so it also runs on a machine with the card
and without JAX, where tests/conftest.py (which imports JAX) and the
repository's pytest options are left out:

    python3 -m pytest --noconftest -o addopts="" -q tests/test_torch_cuda.py

The kernel is held against its plain version with rtol 1e-3 and
atol 1e-3·max|ref|: the rounding sites are the same, only the f32 summation
order differs.
"""

import numpy as np
import pytest
import torch

from ml_function_tpu_torch.features.synthetic import make_criteo_like
from ml_function_tpu_torch.models import get_model
from ml_function_tpu_torch.ops.kernels import cin as tcin

torch.set_num_threads(1)

RTOL = 1e-3


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want):
    want = want.detach().cpu().numpy()
    np.testing.assert_allclose(got.detach().cpu().numpy(), want, rtol=RTOL,
                               atol=RTOL * float(np.abs(want).max()))


@pytest.mark.parametrize("d,b,h,f,o", [
    (4, 200, 5, 5, 100),    # ragged B and O
    (3, 77, 37, 3, 130),    # odd H, O past one 128-wide tile
    (2, 256, 1, 1, 8),      # one field, one row of w1
    (8, 256, 26, 26, 128),  # the first CIN layer of xDeepFM at B 256
])
def test_cin_kernel_matches_plain_version(card, d, b, h, f, o):
    gen = torch.Generator(device=card).manual_seed(0)
    xk = torch.randn(d, b, h, device=card, generator=gen)
    x0 = torch.randn(d, b, f, device=card, generator=gen)
    w1 = torch.randn(h, f * o, device=card, generator=gen) * 0.1
    before = tcin.cin_fwd_launches
    got = tcin.cin_layer_t(xk, x0, w1)
    torch.cuda.synchronize()
    assert tcin.cin_fwd_launches == before + 1
    _close(got, tcin.cin_layer_t_reference(xk, x0, w1))


def test_cin_kernel_refuses_what_it_does_not_take(card):
    xk = torch.zeros(2, 256, 3, device=card)
    x0 = torch.zeros(2, 256, 3, device=card)
    w1 = torch.zeros(3, 3 * 128, device=card)
    with pytest.raises(ValueError, match="contiguous"):
        tcin.cin_layer_t(xk.transpose(0, 1), x0, w1)
    with pytest.raises(ValueError, match="float32"):
        tcin.cin_layer_t(xk.double(), x0, w1)
    with pytest.raises(ValueError, match="shapes"):
        tcin.cin_layer_t(xk, x0[:, :100].contiguous(), w1)
    with pytest.raises(NotImplementedError, match="training slice"):
        tcin.cin_layer_t(xk, x0, w1.clone().requires_grad_())


def test_model_on_the_card_matches_the_cpu(card):
    fs, data = make_criteo_like(n_rows=256, n_dense=4, n_sparse=6,
                                vocab_size=50, embed_dim=4, seed=1)
    kw = dict(cin_hidden=(128, 128), hidden=(16, 8))
    on_cpu = get_model("xdeepfm", fs, device="cpu",
                       generator=torch.Generator().manual_seed(0), **kw)
    on_card = get_model("xdeepfm", fs,
                        generator=torch.Generator().manual_seed(0), **kw)
    assert on_card.embedding.table.device.type == "cuda"
    before = tcin.cin_fwd_launches
    with torch.inference_mode():
        want, _, want_aux = on_cpu(data)
        got, _, got_aux = on_card(data)
    assert tcin.cin_fwd_launches == before + 2
    _close(got, want)
    _close(got_aux["emb_l2"], want_aux["emb_l2"])
