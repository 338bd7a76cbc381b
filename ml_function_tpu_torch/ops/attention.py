"""Attention of the port: field and sequence self-attention, transformer
blocks, target attention and positional encodings.

Counterpart of ``MultiHeadAttention``, ``TransformerBlock``,
``LSHSelfAttention``, ``TargetAttention``, ``attention_mask_bias``,
``sincos_position_encoding`` and ``SessionPositionBias`` in
``ml_function_tpu/ops/attention.py``.
Parameter names are the JAX pytree's keys (``q``, ``k``, ``v``, ``o``,
``ln``; LSH's ``qk``), so ``params/mha0/q`` is the state-dict key ``mha0.q``.
"""

from __future__ import annotations

import math
import os
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from . import threefry
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
    LayerNorm (``ln``). ``attention='lsh'`` makes ``mha`` an
    ``LSHSelfAttention`` with the reference's chunks of 16; the reference's
    causal, extra-bias and chunk-size options have no caller (BST uses none)
    and are left out."""

    def __init__(self, dim: int, num_heads: int = 2,
                 ffn_hidden: Tuple[int, ...] = (32,), attention: str = "softmax"):
        super().__init__()
        if attention == "lsh":
            self.mha = LSHSelfAttention(dim, num_heads)
        elif attention == "softmax":
            self.mha = MultiHeadAttention(dim, num_heads)
        else:
            raise ValueError(f"attention must be 'softmax' or 'lsh', got {attention!r}")
        self.ffn = MLP(dim, ffn_hidden, activation="relu")
        self.ffn_out = Dense(ffn_hidden[-1], dim)
        self.ln = LayerNorm(dim)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        h = self.mha(x, mask=mask)
        return self.ln(h + self.ffn_out(self.ffn(h)))


class LSHSelfAttention(nn.Module):
    """Reformer's shared-QK attention over hash buckets, at the settings its
    callers (BST's blocks, SIM's search unit) build it with: head dim
    dim // num_heads, ``N_BUCKETS`` buckets, chunks of ``CHUNK``, the
    rotations drawn from ``SEED``, the residual and LayerNorm. Each round
    draws a random rotation R (not a parameter: ``threefry.normal`` of
    ``fold_in(PRNGKey(SEED), round)``, the reference's draw), buckets each
    key by argmax([qk·R, −qk·R]) (invalid keys into a virtual last bucket),
    sorts the keys stably by (bucket, position), and lets each chunk of
    ``CHUNK`` sorted keys attend to itself and the chunk before it (the
    first to the last), a key to itself only at a −1e5 penalty. The softmax
    is shifted by its max explicitly (at that penalty exp(logits −
    logsumexp) would lose mass in f32); ``n_hashes`` rounds are combined by
    their log-sum-exp. Then the output projection ``o``, the mask, the
    residual and LayerNorm (``ln``). With L ≤ ``CHUNK`` it is exactly
    shared-QK full attention. The reference's causal, head-dim, residual
    and LayerNorm options have no caller and are left out."""

    N_BUCKETS = 8
    CHUNK = 16
    SEED = 0
    SELF_PENALTY = -1e5

    def __init__(self, dim: int, num_heads: int = 2, n_hashes: int = 1):
        super().__init__()
        self.num_heads, self.n_hashes = num_heads, n_hashes
        self.hd = max(dim // num_heads, 1)
        proj = num_heads * self.hd
        for name, shape in (("qk", (dim, proj)), ("v", (dim, proj)), ("o", (proj, dim))):
            self.register_parameter(name, nn.Parameter(torch.empty(shape)))
        self.ln = LayerNorm(dim)
        base = threefry.prng_key(self.SEED)
        for r in range(n_hashes):
            self.register_buffer(f"rotation{r}", torch.from_numpy(threefry.normal(
                threefry.fold_in(base, r), (self.hd, self.N_BUCKETS // 2))), persistent=False)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for name in ("qk", "v", "o"):
            w = getattr(self, name)
            w.copy_(glorot_uniform(w.shape, generator))

    def buckets(self, qk: torch.Tensor, r: int = 0) -> torch.Tensor:
        """Round r's bucket of each key: qk (N, L, hd) → (N, L) int64."""
        proj = qk @ getattr(self, f"rotation{r}")
        return torch.cat([proj, -proj], dim=-1).argmax(dim=-1)

    def _one_round(self, qk, v, valid, r):
        """qk, v (N, L, hd), valid (N, L) → (out (N, L, hd), lse (N, L))."""
        n, l, hd = qk.shape
        c = min(self.CHUNK, l)
        lp = -(-l // c) * c
        buckets = torch.where(valid, self.buckets(qk, r), self.N_BUCKETS)
        pos = torch.arange(l, device=qk.device)
        s_idx = torch.argsort(buckets * l + pos, dim=-1)
        sqk = torch.gather(qk, 1, s_idx[..., None].expand(n, l, hd))
        sv = torch.gather(v, 1, s_idx[..., None].expand(n, l, hd))
        spos, svalid = s_idx, torch.gather(valid, 1, s_idx)
        if lp != l:     # inert keys to a whole number of chunks
            sqk = F.pad(sqk, (0, 0, 0, lp - l))
            sv = F.pad(sv, (0, 0, 0, lp - l))
            spos = F.pad(spos, (0, lp - l), value=l)
            svalid = F.pad(svalid, (0, lp - l), value=False)
        nc = lp // c

        def window(t):   # this chunk ++ the previous one (the first: the last)
            t = t.reshape(n, nc, c, *t.shape[2:])
            return torch.cat([t, torch.roll(t, 1, dims=1)], dim=2)

        cq = sqk.reshape(n, nc, c, hd)
        ck, cv, kpos, kval = window(sqk), window(sv), window(spos), window(svalid)
        qpos = spos.reshape(n, nc, c)
        logits = torch.einsum("ngqd,ngkd->ngqk", cq, ck) / math.sqrt(hd)
        logits = torch.where(kval[:, :, None, :], logits, NEG_INF)
        logits = torch.where(kpos[:, :, None, :] == qpos[..., None],
                             logits + self.SELF_PENALTY, logits)
        mx = logits.amax(dim=-1, keepdim=True)
        e = torch.exp(logits - mx)
        se = e.sum(dim=-1, keepdim=True)
        lse = (mx + torch.log(se))[..., 0].reshape(n, lp)[:, :l]
        out = torch.einsum("ngqk,ngkd->ngqd", e / se, cv).reshape(n, lp, hd)[:, :l]
        inv = torch.argsort(s_idx, dim=-1)       # back to time order
        return (torch.gather(out, 1, inv[..., None].expand(n, l, hd)),
                torch.gather(lse, 1, inv))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        """x (B, L, D), mask (B, L) valid → (B, L, D)."""
        b, l, _ = x.shape
        h, hd = self.num_heads, self.hd
        valid = (torch.ones((b, l), dtype=torch.bool, device=x.device)
                 if mask is None else mask.bool())

        def fold(t):
            return t.reshape(b, l, h, hd).transpose(1, 2).reshape(b * h, l, hd)

        qk, v = fold(bf16_matmul(x, self.qk)), fold(bf16_matmul(x, self.v))
        val = valid.repeat_interleave(h, dim=0)
        rounds = [self._one_round(qk, v, val, r) for r in range(self.n_hashes)]
        if self.n_hashes == 1:
            out = rounds[0][0]
        else:           # each round weighted by its softmax mass
            w = torch.softmax(torch.stack([s for _, s in rounds]), dim=0)[..., None]
            out = (w * torch.stack([o for o, _ in rounds])).sum(dim=0)
        out = out.reshape(b, h, l, hd).transpose(1, 2).reshape(b, l, h * hd)
        return self.ln(bf16_matmul(out, self.o) * valid[..., None] + x)


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
