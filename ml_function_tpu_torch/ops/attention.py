"""Attention of the port: field and sequence self-attention, transformer
blocks, target attention and positional encodings.

Counterpart of ``MultiHeadAttention``, ``TransformerBlock``,
``TargetAttention``, ``attention_mask_bias``, ``sincos_position_encoding``
and ``SessionPositionBias`` in ``ml_function_tpu/ops/attention.py``; LSH
attention comes with the long-sequence tier's LSH item.
Parameter names are the JAX pytree's keys (``q``, ``k``, ``v``, ``o``,
``ln``), so ``params/mha0/q`` is the state-dict key ``mha0.q``.
"""

from __future__ import annotations

import math
import os
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from .base import bf16_matmul, glorot_uniform
from .core import MLP, Dense, LayerNorm
from .kernels.field_attention import MAX_HEAD_DIM, MAX_SCORES, field_attention
from .kernels.flash_attention import flash_attention

NEG_INF = -1e9


def attention_mask_bias(mask: torch.Tensor) -> torch.Tensor:
    """(…, L) bool → (…, 1, L) additive bias (0 keep / −1e9 drop)."""
    return torch.where(mask[..., None, :], 0.0, NEG_INF)


class MultiHeadAttention(nn.Module):
    """softmax(QKᵀ/√d)V with fused projections, then the output projection,
    the residual and LayerNorm (``use_res``/``use_ln``).

    Its routes are the reference's, in the same order:
    - flash attention (``kernels/flash_attention.py``) when ``flash`` is
      'always', or 'auto' with a key length of at least ``flash_min_len``
      and no ``extra_bias``, in the (B, H, L, Dh) layout;
    - the field-attention kernel (``kernels/field_attention.py``), opt-in by
      ``ML_FUNCTION_TPU_FIELD_ATTN=1`` read at call time, for lq·lk ≤ 4096,
      head dim ≤ 64, no ``extra_bias`` and not causal;
    - the small-L multiply-reduce route under the same size gate;
    - the einsum route.
    """

    def __init__(self, dim: int, num_heads: int = 2,
                 head_dim: Optional[int] = None, use_res: bool = True,
                 use_ln: bool = True, causal: bool = False,
                 flash: str = "auto", flash_min_len: int = 512):
        super().__init__()
        self.dim, self.num_heads = dim, num_heads
        self.hd = head_dim or max(dim // num_heads, 1)
        self.use_res, self.use_ln, self.causal = use_res, use_ln, causal
        self.flash, self.flash_min_len = flash, flash_min_len
        proj = num_heads * self.hd
        for name, shape in (("q", (dim, proj)), ("k", (dim, proj)),
                            ("v", (dim, proj)), ("o", (proj, dim))):
            self.register_parameter(name, nn.Parameter(torch.empty(shape)))
        if use_ln:
            self.ln = LayerNorm(dim)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for name in ("q", "k", "v", "o"):
            w = getattr(self, name)
            w.copy_(glorot_uniform(w.shape, generator))

    def forward(self, x: torch.Tensor, kv: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None,
                extra_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x: (B, Lq, D); kv: (B, Lk, D) (defaults to x); mask: (B, Lk)
        valid-key mask; extra_bias: (B, Lq, Lk) additive."""
        kv = x if kv is None else kv
        b, lq, _ = x.shape
        lk = kv.shape[1]
        h, hd = self.num_heads, self.hd
        q = bf16_matmul(x, self.q).reshape(b, lq, h, hd)
        k = bf16_matmul(kv, self.k).reshape(b, lk, h, hd)
        v = bf16_matmul(kv, self.v).reshape(b, lk, h, hd)
        small = lq * lk <= MAX_SCORES and hd <= MAX_HEAD_DIM
        if self.flash == "always" or (self.flash == "auto" and lk >= self.flash_min_len
                                      and extra_bias is None):
            out = flash_attention(q.transpose(1, 2).contiguous(),
                                  k.transpose(1, 2).contiguous(),
                                  v.transpose(1, 2).contiguous(), mask=mask,
                                  causal=self.causal, scale=1.0 / math.sqrt(hd))
            out = out.transpose(1, 2)                           # (B, lq, H, hd)
        elif (small and os.environ.get("ML_FUNCTION_TPU_FIELD_ATTN") == "1"
                and extra_bias is None and not self.causal):
            bias = (torch.zeros((b, lk), dtype=torch.float32, device=x.device)
                    if mask is None else torch.where(mask, 0.0, NEG_INF))
            out = field_attention(q, k, v, bias, 1.0 / math.sqrt(hd))
        elif small:
            # the reference's multiply-reduce: logits in (B, lq, lk, H)
            lg = (q[:, :, None] * k[:, None, :]).sum(dim=-1) / math.sqrt(hd)
            if mask is not None:
                lg = lg + torch.where(mask, 0.0, NEG_INF)[:, None, :, None]
            if extra_bias is not None:
                lg = lg + extra_bias[..., None]
            if self.causal:
                tril = torch.ones((lq, lk), dtype=torch.bool, device=x.device).tril()
                lg = torch.where(tril[None, :, :, None], lg, NEG_INF)
            a = torch.softmax(lg, dim=2)
            out = (a[..., None] * v[:, None]).sum(dim=2)      # (B, lq, H, hd)
        else:
            logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
            if mask is not None:
                logits = logits + torch.where(mask, 0.0, NEG_INF)[:, None, None, :]
            if extra_bias is not None:
                logits = logits + extra_bias[:, None, :, :]
            if self.causal:
                tril = torch.ones((lq, lk), dtype=torch.bool, device=x.device).tril()
                logits = torch.where(tril[None, None], logits, NEG_INF)
            a = torch.softmax(logits, dim=-1)
            out = torch.einsum("bhqk,bkhd->bqhd", a, v)
        out = bf16_matmul(out.reshape(b, lq, h * hd), self.o)
        if self.use_res:
            out = out + x
        if self.use_ln:
            out = self.ln(out)
        return out


class TransformerBlock(nn.Module):
    """Multi-head self-attention (``mha``, with its residual and LayerNorm),
    then a position-wise ReLU FFN (``ffn``, ``ffn_out``) with a residual and
    LayerNorm (``ln``). ``attention='lsh'`` (Reformer attention) raises; the
    reference's causal and extra-bias options have no caller (BST uses
    neither) and are left out."""

    def __init__(self, dim: int, num_heads: int = 2,
                 ffn_hidden: Tuple[int, ...] = (32,), attention: str = "softmax"):
        super().__init__()
        if attention == "lsh":
            raise NotImplementedError(
                "TransformerBlock(attention='lsh') (LSHSelfAttention) comes "
                "with the LSH item of the long-sequence tier")
        self.mha = MultiHeadAttention(dim, num_heads)
        self.ffn = MLP(dim, ffn_hidden, activation="relu")
        self.ffn_out = Dense(ffn_hidden[-1], dim)
        self.ln = LayerNorm(dim)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        h = self.mha(x, mask=mask)
        return self.ln(h + self.ffn_out(self.ffn(h)))


class TargetAttention(nn.Module):
    """DIN's activation unit: score_t = MLP([c, s_t, c − s_t, c ⊙ s_t]) for
    the candidate c (B, D) and each step s_t of a (B, L, D) sequence; padded
    steps get ``NEG_INF`` before the softmax over steps (so a row with every
    step padded gets uniform weights), or 0 after a sigmoid without
    ``softmax_norm``. Its ``mlp`` is ``MLP(4·dim, hidden[:-1] or (36,),
    activation, out_dim=1)``."""

    def __init__(self, dim: int, hidden=(36, 1), activation: str = "sigmoid",
                 softmax_norm: bool = True):
        super().__init__()
        self.dim, self.softmax_norm = dim, softmax_norm
        self.mlp = MLP(4 * dim, tuple(hidden[:-1]) or (36,),
                       activation=activation, out_dim=1)

    def scores(self, cand: torch.Tensor, seq: torch.Tensor,
               mask: torch.Tensor) -> torch.Tensor:
        """cand (B, D), seq (B, L, D), mask (B, L) → (B, L) weights."""
        c = cand[:, None, :].expand_as(seq)
        s = self.mlp(torch.cat([c, seq, c - seq, c * seq], dim=-1))[..., 0]
        s = torch.where(mask, s, NEG_INF)
        if self.softmax_norm:
            return torch.softmax(s, dim=-1)
        return torch.where(mask, torch.sigmoid(s), 0.0)

    def forward(self, cand: torch.Tensor, seq: torch.Tensor,
                mask: torch.Tensor, return_seq: bool = False) -> torch.Tensor:
        """The weighted sum (B, D), or the weighted sequence (B, L, D) with
        ``return_seq``."""
        w = self.scores(cand, seq, mask)
        if return_seq:
            return seq * w[..., None]
        return torch.einsum("bl,bld->bd", w, seq)


def sincos_position_encoding(length: int, dim: int) -> torch.Tensor:
    """(L, D) sin/cos encodings, computed in numpy as the reference does:
    sin at even columns, cos at odd ones, angle pos / 10000^(2·(i//2)/D)."""
    pos = np.arange(length)[:, None]
    i = np.arange(dim)[None, :]
    angle = pos / np.power(10000.0, (2 * (i // 2)) / dim)
    enc = np.zeros((length, dim), np.float32)
    enc[:, 0::2] = np.sin(angle[:, 0::2])
    enc[:, 1::2] = np.cos(angle[:, 1::2])
    return torch.from_numpy(enc)


class SessionPositionBias(nn.Module):
    """DSIN's learned bias over (session, position, dim): x (B, S, Ls, D)
    plus ``sess`` (S, 1, 1), ``pos`` (1, Ls, 1) and ``unit`` (1, 1, D), all
    starting at zero."""

    def __init__(self, session_num: int, session_len: int, dim: int):
        super().__init__()
        self.sess = nn.Parameter(torch.zeros(session_num, 1, 1))
        self.pos = nn.Parameter(torch.zeros(1, session_len, 1))
        self.unit = nn.Parameter(torch.zeros(1, 1, dim))

    def reset_parameters(self, generator: torch.Generator) -> None:
        for p in (self.sess, self.pos, self.unit):
            p.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.sess[None] + self.pos[None] + self.unit[None]
