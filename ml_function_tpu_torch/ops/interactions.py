"""Feature-interaction blocks of the port: FM, pair products, PNN's outer
product, the DCN cross networks, the linear unit, CIN and AFM's attention.

Counterpart of ``ml_function_tpu/ops/interactions.py``. All take field
embeddings ``e`` of shape (B, F, D). The FM sums and the pair products are
f32; ``OuterProduct``, the cross networks and AFM's ``Dense`` layers round
their matmul inputs to bf16 (``bf16_matmul``), as the reference does.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from .base import bf16_matmul, glorot_uniform
from .core import Dense
from .kernels.cin import cin_layer_t, supports

CIN_KERNEL_MODES = ("auto", "pallas", "off")


def fm_interaction(e: torch.Tensor) -> torch.Tensor:
    """Second-order FM term (B, F, D) → (B,), by the O(F·D) identity
    0.5 · Σ_d [(Σ_f e)² − Σ_f e²]."""
    s = e.sum(dim=1)
    sq = e.square().sum(dim=1)
    return 0.5 * (s.square() - sq).sum(dim=-1)


def fm_interaction_vector(e: torch.Tensor) -> torch.Tensor:
    """NFM's bi-interaction vector (B, F, D) → (B, D): the FM term before
    its sum over D."""
    s = e.sum(dim=1)
    sq = e.square().sum(dim=1)
    return 0.5 * (s.square() - sq)


def triu_pairs(e: torch.Tensor) -> torch.Tensor:
    """(2, P): (i, j) of every field pair i < j of (B, F, …) ``e`` in
    row-major order (``np.triu_indices`` with k = 1), on e's device."""
    n = e.shape[1]
    return torch.triu_indices(n, n, offset=1, device=e.device)


def pairwise_products(e: torch.Tensor) -> torch.Tensor:
    """All F·(F−1)/2 elementwise pair products: (B, F, D) → (B, P, D)."""
    iu, ju = triu_pairs(e)
    return e[:, iu, :] * e[:, ju, :]


def pairwise_inner_products(e: torch.Tensor) -> torch.Tensor:
    """Pairwise inner products (B, F, D) → (B, P): the f32 Gram product read
    at the upper triangle (PNN's inner signal)."""
    g = torch.einsum("bfd,bgd->bfg", e, e)
    iu, ju = triu_pairs(e)
    return g[:, iu, ju]


class OuterProduct(nn.Module):
    """PNN's outer product with sum reduction: p = Σ_f e_f, signal =
    vec(p·pᵀ) · ``kernel`` ((D², out), glorot)."""

    def __init__(self, dim: int, out_dim: int = 1):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(dim * dim, out_dim))

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.kernel.copy_(glorot_uniform(self.kernel.shape, generator))

    def forward(self, e: torch.Tensor) -> torch.Tensor:
        p = e.sum(dim=1)
        outer = torch.einsum("bi,bj->bij", p, p).reshape(p.shape[0], -1)
        return bf16_matmul(outer, self.kernel)


class _CrossLayer(nn.Module):
    """One cross layer's ``w`` ((dim, 1) for v1, (dim, dim) for v2, glorot)
    and ``b`` (dim,)."""

    def __init__(self, dim: int, width: int):
        super().__init__()
        self.w = nn.Parameter(torch.empty(dim, width))
        self.b = nn.Parameter(torch.empty(dim))

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.w.copy_(glorot_uniform(self.w.shape, generator))
        self.b.zero_()


class _CrossStack(nn.Module):
    def __init__(self, dim: int, depth: int, width: int):
        super().__init__()
        self.depth = depth
        for i in range(depth):
            self.add_module(f"layer{i}", _CrossLayer(dim, width))


class CrossNet(_CrossStack):
    """DCN-v1 cross network: x_{k+1} = x0 ⊙ (x_k·w_k) + b_k + x_k over
    ``layer{i}`` with ``w`` (dim, 1)."""

    def __init__(self, dim: int, depth: int = 3):
        super().__init__(dim, depth, 1)

    def forward(self, x0: torch.Tensor) -> torch.Tensor:
        x = x0
        for i in range(self.depth):
            layer = getattr(self, f"layer{i}")
            x = x0 * bf16_matmul(x, layer.w) + layer.b + x
        return x


class CrossNetMix(_CrossStack):
    """DCN-v2 full-matrix cross layers: x_{k+1} = x0 ⊙ (x_k·W_k + b_k) +
    x_k, ``w`` (dim, dim)."""

    def __init__(self, dim: int, depth: int = 3):
        super().__init__(dim, depth, dim)

    def forward(self, x0: torch.Tensor) -> torch.Tensor:
        x = x0
        for i in range(self.depth):
            layer = getattr(self, f"layer{i}")
            x = x0 * (bf16_matmul(x, layer.w) + layer.b) + x
        return x


class LinearUnit(nn.Module):
    """Explicit w·x + b over the dense features: (B, in_dim) → (B,)."""

    def __init__(self, in_dim: int):
        super().__init__()
        self.dense = Dense(in_dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.dense(x)[:, 0]


class CIN(nn.Module):
    """Compressed Interaction Network (xDeepFM).

    Layer k: X^{k+1}[b,o,d] = Σ_{h,f} W[h·F+f, o] · X^k[b,h,d] · X^0[b,f,d],
    with ``w{k}`` of shape (H·F, O) as in the reference. Each layer's output
    is sum-pooled over D; the pooled features are concatenated and, with
    ``out_logit``, projected to a logit by ``head``.

    ``kernel``: 'auto' takes the fused layer (``kernels/cin.py``: the CUDA
    kernel on the card, its plain version on the CPU) when ``supports()``
    holds for every layer at the runtime batch, the einsum route otherwise;
    'pallas' forces the fused layer (the name is the reference's, and travels
    in exported hyperparameters); 'off' forces the einsum route.
    """

    def __init__(self, n_fields: int, dim: int,
                 hidden: Sequence[int] = (128, 128), out_logit: bool = True,
                 kernel: str = "auto"):
        super().__init__()
        if kernel not in CIN_KERNEL_MODES:
            raise ValueError(f"CIN kernel must be one of {CIN_KERNEL_MODES}, "
                             f"got {kernel!r}")
        self.n_fields, self.dim = n_fields, dim
        self.hidden, self.out_logit, self.kernel = tuple(hidden), out_logit, kernel
        h_prev = n_fields
        for i, h in enumerate(self.hidden):
            self.register_parameter(
                f"w{i}", nn.Parameter(torch.empty(h_prev * n_fields, h)))
            h_prev = h
        if out_logit:
            self.head = Dense(sum(self.hidden), 1)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for i in range(len(self.hidden)):
            w = getattr(self, f"w{i}")
            w.copy_(glorot_uniform(w.shape, generator))

    def features(self, e: torch.Tensor) -> torch.Tensor:
        """(B, F, D) → (B, Σ hidden) pooled interaction features."""
        b, f, d = e.shape
        if self.kernel == "pallas" or (
                self.kernel == "auto"
                and all(supports(b, f, h, d) for h in self.hidden)):
            # one entry transpose to (D, B, F); each layer's (D, B, O) output
            # is the next layer's input, and pooling sums over D in place
            e_t = e.permute(2, 0, 1).float().contiguous()
            xk_t = e_t
            pooled = []
            h_prev = f
            for i, h in enumerate(self.hidden):
                w1 = getattr(self, f"w{i}").reshape(h_prev, f * h)
                xk_t = cin_layer_t(xk_t, e_t, w1)
                pooled.append(xk_t.sum(dim=0))
                h_prev = h
            return torch.cat(pooled, dim=-1)
        x0 = e
        xk = e
        pooled = []
        for i in range(len(self.hidden)):
            # Z (B, H·F, D) in f32, then rounded to bf16 for the compression
            z = torch.einsum("bhd,bfd->bhfd", xk, x0).reshape(b, -1, d)
            w = getattr(self, f"w{i}")
            nxt = torch.matmul(z.bfloat16().float().transpose(1, 2),
                               w.bfloat16().float()).transpose(1, 2)
            xk = nxt
            pooled.append(nxt.sum(dim=-1))
        return torch.cat(pooled, dim=-1)

    def forward(self, e: torch.Tensor) -> torch.Tensor:
        feats = self.features(e)
        if not self.out_logit:
            return feats
        return self.head(feats)[:, 0]


class AFMAttention(nn.Module):
    """Attentional FM pooling: ``score1`` (relu) and ``score2`` score each
    pair product, a softmax over the P pairs weights them, and ``proj``
    maps the pooled (B, D) vector to a logit term."""

    def __init__(self, dim: int, attn_dim: int = 16):
        super().__init__()
        self.score1 = Dense(dim, attn_dim)
        self.score2 = Dense(attn_dim, 1, use_bias=False)
        self.proj = Dense(dim, 1, use_bias=False)

    def forward(self, pair_products: torch.Tensor) -> torch.Tensor:
        """(B, P, D) → (B,)."""
        h = torch.relu(self.score1(pair_products))
        a = torch.softmax(self.score2(h), dim=1)              # (B, P, 1)
        pooled = (a * pair_products).sum(dim=1)                # (B, D)
        return self.proj(pooled)[:, 0]
