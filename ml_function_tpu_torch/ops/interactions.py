"""Feature-interaction blocks of the port: FM, the linear unit and CIN.

Counterpart of ``ml_function_tpu/ops/interactions.py``. All take field
embeddings ``e`` of shape (B, F, D).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from .base import glorot_uniform
from .core import Dense
from .kernels.cin import cin_layer_t, supports

CIN_KERNEL_MODES = ("auto", "pallas", "off")


def fm_interaction(e: torch.Tensor) -> torch.Tensor:
    """Second-order FM term (B, F, D) → (B,), by the O(F·D) identity
    0.5 · Σ_d [(Σ_f e)² − Σ_f e²]."""
    s = e.sum(dim=1)
    sq = e.square().sum(dim=1)
    return 0.5 * (s.square() - sq).sum(dim=-1)


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
