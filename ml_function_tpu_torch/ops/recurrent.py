"""Recurrent cells of the port: GRU, AUGRU, LSTM and BiLSTM.

Counterpart of ``GRU``, ``AUGRU``, ``LSTM`` and ``BiLSTM`` in
``ml_function_tpu/ops/recurrent.py``.
The input projections of every step are hoisted into one (B·L, D)·(D, 3H)
product; the recurrence then runs on the small h·wh product and the gates.
Gate convention (DIEN paper, not ``torch.nn.GRU``'s): u is the update gate,

    u = σ(xu + h·wh_u),  r = σ(xr + h·wh_r),  n = tanh(xn + r·(h·wh_n))
    h' = (1 − u)·h + u·n

with the bias only in the projections (no recurrent bias). AUGRU scales the
update gate by the attention score after the sigmoid, u = a·σ(·). Padded
steps (mask false) carry h. Parameters are the JAX pytree's: ``wx`` (D, 3H),
``wh`` (H, 3H), ``b`` (3H,).

Routes, by the reference's ``kernel`` field (default 'scan'):
- 'scan': a Python loop of the reference's ``_step`` with the port's
  ``bf16_matmul``, differentiated by autograd (as ``lax.scan`` is by JAX);
- 'pallas': the fused recurrence ``kernels/gru.gru_sequence`` (the CUDA
  kernels on the card, their plain versions on the CPU), returning
  ``(seq, seq[:, -1])``.

The port's ``AUGRU`` carries the ``kernel`` field too (the reference's
always builds a scan GRU), so that DIEN's second recurrence can take the
kernel route.

``LSTM`` (DSIN's session interaction, through ``BiLSTM``) is a step loop of
the reference's body, not ``torch.nn.LSTM``: gates i, f, g, o from one
(H, 4H) product, the forget gate's pre-activation +1.0, both products
through ``bf16_matmul``, and masked steps holding h and c. ``wx`` (D, 4H),
``wh`` (H, 4H), ``b`` (4H,).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from .base import bf16_matmul, glorot_uniform
from .kernels.gru import gru_sequence

KERNELS = ("scan", "pallas")


def _check_kernel(kernel: str) -> None:
    if kernel not in KERNELS:
        raise ValueError(f"GRU kernel must be one of {KERNELS}, got {kernel!r}")


class GRU(nn.Module):
    """GRU over (B, L, D) with a (B, L) mask → ((B, L, H) seq, (B, H) last)."""

    def __init__(self, in_dim: int, hidden: int, kernel: str = "scan"):
        super().__init__()
        self.in_dim, self.hidden = in_dim, hidden
        _check_kernel(kernel)
        self.kernel = kernel
        self.wx = nn.Parameter(torch.empty(in_dim, 3 * hidden))
        self.wh = nn.Parameter(torch.empty(hidden, 3 * hidden))
        self.b = nn.Parameter(torch.empty(3 * hidden))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """glorot ``wx``, orthogonal ``wh``, zero ``b``, as the reference."""
        self.wx.copy_(glorot_uniform(self.wx.shape, generator))
        wh = torch.empty(self.wh.shape, device=generator.device)
        self.wh.copy_(nn.init.orthogonal_(wh, generator=generator))
        self.b.zero_()

    def _step(self, h, xw, m, a=None):
        hh = bf16_matmul(h, self.wh)
        xu, xr, xn = xw.chunk(3, dim=-1)
        hu, hr, hn = hh.chunk(3, dim=-1)
        u = torch.sigmoid(xu + hu)
        r = torch.sigmoid(xr + hr)
        n = torch.tanh(xn + r * hn)
        if a is not None:
            u = a[:, None] * u     # AUGRU: attention scales the update gate
        h_new = (1.0 - u) * h + u * n
        return torch.where(m[:, None], h_new, h)

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                att_scores: Optional[torch.Tensor] = None,
                h0: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        _check_kernel(self.kernel)    # also a value set after construction
        b, l, _ = x.shape
        xw = (bf16_matmul(x.reshape(b * l, -1), self.wx) + self.b).reshape(b, l, -1)
        if h0 is None:
            h0 = x.new_zeros((b, self.hidden))
        if self.kernel == "pallas":
            att = (att_scores.contiguous() if att_scores is not None
                   else x.new_ones((b, l)))
            seq = gru_sequence(xw, self.wh, mask.float(), att, h0.contiguous())
            return seq, seq[:, -1]
        h, out, mask = h0, [], mask.bool()
        for t in range(l):
            a = None if att_scores is None else att_scores[:, t]
            h = self._step(h, xw[:, t], mask[:, t], a)
            out.append(h)
        return torch.stack(out, dim=1), h


class AUGRU(GRU):
    """Attention-gated GRU (DIEN's interest evolution): ``att_scores`` is
    required."""

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                att_scores: torch.Tensor, h0: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        return super().forward(x, mask, att_scores=att_scores, h0=h0)


class LSTM(nn.Module):
    """LSTM over (B, L, D) with a (B, L) mask → ((B, L, H) seq, (B, H) last
    h). ``reverse=True`` walks every position from the last to the first,
    padded ones included, as ``lax.scan(reverse=True)`` does; the sequence
    keeps the input's order."""

    def __init__(self, in_dim: int, hidden: int):
        super().__init__()
        self.in_dim, self.hidden = in_dim, hidden
        self.wx = nn.Parameter(torch.empty(in_dim, 4 * hidden))
        self.wh = nn.Parameter(torch.empty(hidden, 4 * hidden))
        self.b = nn.Parameter(torch.empty(4 * hidden))

    reset_parameters = GRU.reset_parameters

    def forward(self, x: torch.Tensor, mask: torch.Tensor, reverse: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        b, l, _ = x.shape
        xw = (bf16_matmul(x.reshape(b * l, -1), self.wx) + self.b).reshape(b, l, -1)
        h = c = x.new_zeros((b, self.hidden))
        mask = mask.bool()
        out = [None] * l
        for t in (range(l - 1, -1, -1) if reverse else range(l)):
            gates = xw[:, t] + bf16_matmul(h, self.wh)
            i, f, g, o = gates.chunk(4, dim=-1)
            i, f, o = torch.sigmoid(i), torch.sigmoid(f + 1.0), torch.sigmoid(o)
            c_new = f * c + i * torch.tanh(g)
            h_new = o * torch.tanh(c_new)
            m = mask[:, t, None]
            h, c = torch.where(m, h_new, h), torch.where(m, c_new, c)
            out[t] = h
        return torch.stack(out, dim=1), h


class BiLSTM(nn.Module):
    """Forward and reverse LSTMs (``fwd``, ``bwd``), their sequences
    concatenated → (B, L, 2H)."""

    def __init__(self, in_dim: int, hidden: int):
        super().__init__()
        self.fwd = LSTM(in_dim, hidden)
        self.bwd = LSTM(in_dim, hidden)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        f_seq, _ = self.fwd(x, mask)
        b_seq, _ = self.bwd(x, mask, reverse=True)
        return torch.cat([f_seq, b_seq], dim=-1)
