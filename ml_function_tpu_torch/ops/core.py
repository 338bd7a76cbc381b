"""Core dense blocks: Dense, LayerNorm, BatchNorm, Activation, MLP, and the
score heads (ScoreHead, MergeScoreHead, intra_view_pool, Align).

Counterpart of ``ml_function_tpu/ops/core.py``. Parameter layouts are those
of the JAX pytree (``Dense.w`` is (in, out)), and module names are its keys,
so ``params/mlp/layer0/dense/w`` is the state-dict key ``mlp.layer0.dense.w``.
BatchNorm keeps its running statistics as buffers and updates them in place
in training mode, where the reference threads an explicit state. Under a
sharded context whose data axis is above 1 it takes the global batch's
moments, as the reference's do under pjit: sums all-reduced over the data
group, with a backward that crosses ranks (``parallel/comm.all_reduce_sum``),
so every rank's running buffers stay equal.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import context as pctx
from ..parallel.comm import all_reduce_sum
from .base import bf16_matmul, glorot_uniform

ACTIVATIONS = ("relu", "prelu", "dice", "sigmoid", "tanh", "gelu",
               "identity", "linear", None)


class Dense(nn.Module):
    """w·x + b with bf16-rounded matmul inputs; ``w`` is (in, out)."""

    def __init__(self, in_dim: int, out_dim: int, use_bias: bool = True):
        super().__init__()
        self.in_dim, self.out_dim = in_dim, out_dim
        self.w = nn.Parameter(torch.empty(in_dim, out_dim))
        if use_bias:
            self.b = nn.Parameter(torch.empty(out_dim))
        else:
            self.register_parameter("b", None)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.w.copy_(glorot_uniform((self.in_dim, self.out_dim), generator))
        if self.b is not None:
            self.b.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = bf16_matmul(x, self.w)
        return y if self.b is None else y + self.b


class LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.scale.fill_(1.0)
        self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mu = x.mean(dim=-1, keepdim=True)
        var = (x - mu).square().mean(dim=-1, keepdim=True)
        return (x - mu) * torch.rsqrt(var + self.eps) * self.scale + self.bias


def _global_moments(x: torch.Tensor, axes, mesh):
    """Mean and biased variance over the leading axes of every data rank's
    ``x`` (equal shards), differentiable across ranks."""
    n = x.numel() // x.shape[-1] * mesh.data
    mean = all_reduce_sum(x.sum(dim=axes), mesh.data_group) / n
    var = all_reduce_sum((x - mean).square().sum(dim=axes), mesh.data_group) / n
    return mean, var


class BatchNorm(nn.Module):
    """BatchNorm over the leading axes; running ``mean``/``var`` buffers
    are updated in place when ``train`` is true."""

    def __init__(self, dim: int, momentum: float = 0.99, eps: float = 1e-3):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.register_buffer("mean", torch.zeros(dim))
        self.register_buffer("var", torch.ones(dim))

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.scale.fill_(1.0)
        self.bias.zero_()
        self.mean.zero_()
        self.var.fill_(1.0)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if train:
            axes = tuple(range(x.dim() - 1))
            mesh = pctx.active_mesh()
            if mesh is not None and mesh.data > 1:
                mean, var = _global_moments(x, axes, mesh)
            else:
                mean = x.mean(dim=axes)
                var = x.var(dim=axes, unbiased=False)
            with torch.no_grad():
                m = self.momentum
                self.mean.mul_(m).add_((1 - m) * mean)
                self.var.mul_(m).add_((1 - m) * var)
        else:
            mean, var = self.mean, self.var
        return (x - mean) * torch.rsqrt(var + self.eps) * self.scale + self.bias


class Activation(nn.Module):
    """relu | prelu | dice | sigmoid | tanh | gelu | identity. PReLU and
    Dice carry a learned per-feature ``alpha``."""

    def __init__(self, kind: Optional[str], dim: int = 0):
        super().__init__()
        if kind not in ACTIVATIONS:
            raise ValueError(f"unknown activation {kind!r}")
        self.kind = kind
        if kind in ("prelu", "dice"):
            self.alpha = nn.Parameter(torch.full((dim,), 0.25))

    def reset_parameters(self, generator: torch.Generator) -> None:
        if self.kind in ("prelu", "dice"):
            self.alpha.fill_(0.25)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = self.kind
        if k == "relu":
            return torch.relu(x)
        if k == "prelu":
            return torch.where(x > 0, x, self.alpha * x)
        if k == "dice":
            mu = x.mean(dim=-1, keepdim=True)
            var = x.var(dim=-1, unbiased=False, keepdim=True)
            p = torch.sigmoid((x - mu) * torch.rsqrt(var + 1e-8))
            return p * x + (1.0 - p) * self.alpha * x
        if k == "sigmoid":
            return torch.sigmoid(x)
        if k == "tanh":
            return torch.tanh(x)
        if k == "gelu":
            return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default
        return x


class _MLPLayer(nn.Module):
    def __init__(self, din: int, dout: int, activation: str,
                 norm: Optional[str]):
        super().__init__()
        self.dense = Dense(din, dout)
        self.act = Activation(activation, dout)
        if norm == "layer":
            self.norm = LayerNorm(dout)
        elif norm == "batch":
            self.norm = BatchNorm(dout)


class MLP(nn.Module):
    """Residual MLP tower (reference ``MLP``): ``res_every`` adds a skip
    every N layers (0 disables), ``norm`` is None | 'layer' | 'batch',
    ``out_dim`` adds a final linear ``head``."""

    def __init__(self, in_dim: int, hidden: Sequence[int],
                 activation: str = "relu", res_every: int = 0,
                 norm: Optional[str] = None, out_dim: Optional[int] = None):
        super().__init__()
        if norm not in (None, "layer", "batch"):
            raise ValueError(f"unknown norm {norm!r}")
        self.in_dim, self.hidden = in_dim, tuple(hidden)
        self.res_every, self.norm, self.out_dim = res_every, norm, out_dim
        for i, (din, dout) in enumerate(self._layers()):
            self.add_module(f"layer{i}", _MLPLayer(din, dout, activation, norm))
        if res_every:
            for i, (_, dout) in enumerate(self._layers()):
                if (i + 1) % res_every == 0:
                    src = i - res_every
                    src_dim = in_dim if src < 0 else self.hidden[src]
                    if src_dim != dout:
                        self.add_module(f"res{i}", Dense(src_dim, dout,
                                                         use_bias=False))
        if out_dim is not None:
            self.head = Dense(self.hidden[-1] if self.hidden else in_dim,
                              out_dim)

    def _layers(self) -> Sequence[Tuple[int, int]]:
        dims = (self.in_dim,) + self.hidden
        return [(dims[i], dims[i + 1]) for i in range(len(self.hidden))]

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        outs = [x]
        h = x
        for i in range(len(self.hidden)):
            layer = getattr(self, f"layer{i}")
            h = layer.dense(h)
            if self.norm == "layer":
                h = layer.norm(h)
            elif self.norm == "batch":
                h = layer.norm(h, train)
            h = layer.act(h)
            if self.res_every and (i + 1) % self.res_every == 0:
                skip = outs[i - self.res_every + 1]
                proj = getattr(self, f"res{i}", None)
                h = h + (skip if proj is None else proj(skip))
            outs.append(h)
        if self.out_dim is not None:
            h = self.head(h)
        return h


def flatten_concat(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """Flatten each input to (B, -1) and concatenate."""
    flat = [x.reshape(x.shape[0], -1) for x in xs]
    return flat[0] if len(flat) == 1 else torch.cat(flat, dim=-1)


class ScoreHead(nn.Module):
    """One logit as the sum of (B,)-shaped contributions, plus a scalar
    ``bias`` (reference ``ScoreHead``, no parameter without ``use_bias``)."""

    def __init__(self, use_bias: bool = True):
        super().__init__()
        self.use_bias = use_bias
        if use_bias:
            self.bias = nn.Parameter(torch.zeros(()))

    def reset_parameters(self, generator: torch.Generator) -> None:
        if self.use_bias:
            self.bias.zero_()

    def forward(self, contributions: Sequence[torch.Tensor]) -> torch.Tensor:
        total = sum(c.reshape(c.shape[0]) for c in contributions)
        return total + self.bias if self.use_bias else total


class MergeScoreHead(nn.Module):
    """Flatten and concatenate the inputs, then one ``Dense(in_dim, 1)``
    ``head``: a single logit, where the reference's source emits a 2-way
    softmax (the same model class)."""

    def __init__(self, in_dim: int):
        super().__init__()
        self.head = Dense(in_dim, 1)

    def forward(self, xs: Sequence[torch.Tensor]) -> torch.Tensor:
        return self.head(flatten_concat(list(xs)))[:, 0]


def intra_view_pool(x: torch.Tensor) -> torch.Tensor:
    """The mean over axis 1, kept as an axis of 1."""
    return x.mean(dim=1, keepdim=True)


class Align(nn.Module):
    """Project each input to ``out_dim`` by its own ``proj{i}`` Dense; an
    input already that wide passes as it is (and has no ``proj{i}``)."""

    def __init__(self, in_dims: Sequence[int], out_dim: int):
        super().__init__()
        self.in_dims, self.out_dim = tuple(in_dims), out_dim
        for i, d in enumerate(self.in_dims):
            if d != out_dim:
                self.add_module(f"proj{i}", Dense(d, out_dim))

    def forward(self, xs: Sequence[torch.Tensor]) -> list:
        return [x if d == self.out_dim else getattr(self, f"proj{i}")(x)
                for i, (x, d) in enumerate(zip(xs, self.in_dims))]
