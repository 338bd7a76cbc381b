"""The extended feature-interaction family of the port: CCPM, FGCNN, FLEN,
ONN, FAT-DeepFFM, FiGNN, MLR and OENN.

Counterpart of ``ml_function_tpu/models/interaction_ext.py``. Submodules
and parameters carry the JAX pytree's keys (``conv0``, ``rec0``, ``ffm``,
``se1``, ``mha``, ``wmsg``, ``cell``, ``order2``, …) in its layouts (CCPM's
``conv{i}`` (width, in, out), FGCNN's (height, 1, in, out)), so the bridge
copies JAX weights as they are.

FiGNN's field self-attention is ``MultiHeadAttention``, so under
``ML_FUNCTION_TPU_FIELD_ATTN=1`` it takes the field-attention kernels
(F ≤ 64 fields); its propagation calls ``GRU._step`` over the B·F nodes
itself. CCPM's and FGCNN's convolutions are ``torch.nn.functional``
convolutions with the reference's SAME padding (the lower side padded
``(k − 1) // 2``), as the reference's are XLA convolutions outside any
Pallas kernel: with cuDNN's TF32 allowed (``torch.backends.cudnn.allow_tf32``,
PyTorch's default) they compute in TF32 on the card. The others are tensor
operations and ``bf16_matmul`` towers.

MLR reads neither its embedding's ``linear`` table nor its ``dense_linear``
unit, which the reference creates all the same (``ROADMAP.md`` R6).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..features.schema import FeatureSet
from ..ops.attention import NEG_INF, MultiHeadAttention
from ..ops.base import bf16_matmul, glorot_uniform, normal_init
from ..ops.core import MLP, Dense, flatten_concat
from ..ops.embedding import FusedEmbedding, gather_rows
from ..ops.interactions import pairwise_inner_products, triu_pairs
from ..ops.recurrent import GRU
from .base import Model, embed_inputs, stateless
from .interaction import _bias, _dims, _ffm_parts, _first_order, _maybe_dense_linear
from .longseq import top_k_indices


def _same_pad(k: int) -> Tuple[int, int]:
    """SAME padding of a width-k window at stride 1: (low, high)."""
    return (k - 1) // 2, (k - 1) - (k - 1) // 2


def _p_max_pool(x: torch.Tensor, k: int) -> torch.Tensor:
    """CCPM's flexible p-max pooling: (B, W, C) → (B, k, C), each channel's
    k largest responses (the lower index first among equal ones, as
    ``lax.top_k``) kept in their original order."""
    b, w, c = x.shape
    xt = x.transpose(1, 2)                                         # (B, C, W)
    idx = top_k_indices(xt.reshape(b * c, w), k).reshape(b, c, k)
    idx = torch.sort(idx, dim=-1).values
    return torch.gather(xt, 2, idx).transpose(1, 2)


def CCPM(fs: FeatureSet,
         channels: Tuple[int, ...] = (4, 4),
         widths: Tuple[int, ...] = (3, 3),
         hidden: Tuple[int, ...] = (128, 64)) -> Model:
    """Convolutional Click Prediction Model: the (B, F, D) field embeddings
    as a length-F sequence of D channels through ``conv{i}`` (width
    ``widths[i]``, ``channels[i]`` maps, SAME padding), tanh and p-max
    pooling to the paper's level sizes (the last keeps 3); the last maps
    flattened (with dense) into ``mlp``, + the first-order terms and
    ``bias``."""
    f, d, nd = _dims(fs)
    n = len(channels)
    sizes, cur = [], f
    for i in range(1, n + 1):
        p = f if i == n else int(np.ceil((1 - (i / n) ** (n - i)) * f))
        cur = 3 if i == n else max(3, min(cur, p))
        sizes.append(cur)
    in_ch = [d] + list(channels[:-1])
    shapes = [(widths[i], in_ch[i], channels[i]) for i in range(n)]
    parts = {"embedding": FusedEmbedding(fs),
             "mlp": MLP(sizes[-1] * channels[-1] + nd, hidden, activation="relu",
                        out_dim=1),
             "bias": _bias(), **_maybe_dense_linear(fs)}
    inits = {}
    for i, shape in enumerate(shapes):
        parts[f"conv{i}"] = nn.Parameter(torch.empty(shape))
        inits[f"conv{i}"] = lambda g, shape=shape: glorot_uniform(shape, g)

    def fwd(m, batch, train):
        inp = embed_inputs(m.embedding, batch)
        x = inp["emb"]                                             # (B, W, C)
        for i in range(n):
            w = getattr(m, f"conv{i}")                             # (k, in, out)
            xc = F.pad(x.transpose(1, 2), _same_pad(w.shape[0]))
            x = torch.tanh(F.conv1d(xc, w.permute(2, 1, 0)).transpose(1, 2))
            x = _p_max_pool(x, min(sizes[i], x.shape[1]))
        h = x.reshape(x.shape[0], -1)
        if nd:
            h = torch.cat([h, inp["dense"]], dim=-1)
        logit = _first_order(m, inp) + m.mlp(h, train)[:, 0] + m.bias
        return logit, {"emb_l2": inp["l2"]}

    return stateless("CCPM", fs, parts, fwd, inits)


def FGCNN(fs: FeatureSet,
          channels: Tuple[int, ...] = (6, 8),
          kernel_heights: Tuple[int, ...] = (7, 7),
          pool_sizes: Tuple[int, ...] = (2, 2),
          new_maps: Tuple[int, ...] = (3, 3),
          hidden: Tuple[int, ...] = (128, 64)) -> Model:
    """Feature Generation by CNN: the (F × D) embedding image through
    ``conv{i}`` ((h, 1) kernels along the fields, SAME padding), tanh and a
    VALID max pool of (p, 1) a level; each level's recombination ``rec{i}``
    mixes its (fields × channels) into ``new_maps[i]`` generated fields
    (tanh), shared across the embedding dims. The original and generated
    fields, flattened and as pairwise inner products (with dense), feed
    ``mlp``, + the first-order terms and ``bias``."""
    f, d, nd = _dims(fs)
    n = len(channels)
    in_ch = [1] + list(channels[:-1])
    cur, pools, rec_in = f, [], []
    for i in range(n):
        pools.append(min(pool_sizes[i], cur))
        cur = max(1, cur // pools[i])
        rec_in.append(cur * channels[i])
    ft = f + sum(new_maps)
    parts = {"embedding": FusedEmbedding(fs),
             "mlp": MLP(ft * d + ft * (ft - 1) // 2 + nd, hidden, activation="relu",
                        out_dim=1),
             "bias": _bias(), **_maybe_dense_linear(fs)}
    inits = {}
    for i in range(n):
        shape = (kernel_heights[i], 1, in_ch[i], channels[i])
        parts[f"conv{i}"] = nn.Parameter(torch.empty(shape))
        inits[f"conv{i}"] = lambda g, shape=shape: glorot_uniform(shape, g)
        parts[f"rec{i}"] = Dense(rec_in[i], new_maps[i])

    def fwd(m, batch, train):
        inp = embed_inputs(m.embedding, batch)
        e = inp["emb"]                                             # (B, F, D)
        x = e[:, None]                                             # NCHW: (B, 1, F, D)
        gen = []
        for i in range(n):
            w = getattr(m, f"conv{i}")                             # (h, 1, in, out)
            x = F.pad(x, (0, 0) + _same_pad(w.shape[0]))
            x = torch.tanh(F.conv2d(x, w.permute(3, 2, 0, 1)))
            x = F.max_pool2d(x, (pools[i], 1))
            b, ci, fi, dd = x.shape
            flat = x.permute(0, 3, 2, 1).reshape(b, dd, fi * ci)  # fields-major
            gen.append(torch.tanh(getattr(m, f"rec{i}")(flat)).transpose(1, 2))
        fields = torch.cat([e] + gen, dim=1)                       # (B, F', D)
        parts = [fields.reshape(fields.shape[0], -1), pairwise_inner_products(fields)]
        if nd:
            parts.append(inp["dense"])
        deep = m.mlp(torch.cat(parts, dim=-1), train)
        logit = _first_order(m, inp) + deep[:, 0] + m.bias
        return logit, {"emb_l2": inp["l2"]}

    return stateless("FGCNN", fs, parts, fwd, inits)


def FLEN(fs: FeatureSet,
         groups: Optional[Tuple[Tuple[str, ...], ...]] = None,
         hidden: Tuple[int, ...] = (128, 64)) -> Model:
    """Field-leveraged embedding network: the fields in groups (default:
    three contiguous thirds); the FM module sums each group's
    bi-interaction vector, the MF module takes the Hadamard product of each
    pair of group sums; [``mlp`` over the flattened embeddings (with dense),
    FM, MF…] → ``head``, + the first-order terms and ``bias``."""
    f, d, nd = _dims(fs)
    if groups is None:
        names = [s.name for s in fs.sparse]
        k = max(1, len(names) // 3)
        groups = (tuple(names[:k]), tuple(names[k:2 * k]), tuple(names[2 * k:]))
    idx_groups = [[fs.sparse_index(n) for n in g] for g in groups if g]
    n_groups = len(idx_groups)
    n_pairs = n_groups * (n_groups - 1) // 2
    parts = {"embedding": FusedEmbedding(fs),
             "mlp": MLP(f * d + nd, hidden, activation="relu"),
             "head": Dense(hidden[-1] + d + n_pairs * d, 1),
             "bias": _bias(), **_maybe_dense_linear(fs)}
    for i, g in enumerate(idx_groups):      # each group's fields, a buffer
        parts[f"group{i}"] = torch.tensor(g, dtype=torch.long)

    def fwd(m, batch, train):
        inp = embed_inputs(m.embedding, batch)
        e = inp["emb"]
        members = [e.index_select(1, getattr(m, f"group{i}")) for i in range(n_groups)]
        sums = [x.sum(dim=1) for x in members]                     # (B, D) each
        sqs = [x.square().sum(dim=1) for x in members]
        fm_vec = 0.5 * sum(s.square() - q for s, q in zip(sums, sqs))
        mf = [sums[i] * sums[j] for i in range(n_groups) for j in range(i + 1, n_groups)]
        deep = m.mlp(flatten_concat([e] + ([inp["dense"]] if nd else [])), train)
        z = torch.cat([deep, fm_vec] + mf, dim=-1)
        logit = _first_order(m, inp) + m.head(z)[:, 0] + m.bias
        return logit, {"emb_l2": inp["l2"]}

    return stateless("FLEN", fs, parts, fwd)


def ONN(fs: FeatureSet, ffm_dim: int = 4,
        hidden: Tuple[int, ...] = (128, 64)) -> Model:
    """Operation-aware NN (NFFM): a copy embedding per feature for the
    tower and a field-aware block per (feature, other field) in the
    (V, F·K) ``ffm`` table; pair (i, j) gives ⟨v_{i→fj}, v_{j→fi}⟩; [the
    flattened copy embeddings, the pair dots, dense] → ``mlp``, + the
    first-order terms and ``bias``. ``emb_l2`` adds the ``ffm`` rows'."""
    f, d, nd = _dims(fs)
    k = ffm_dim
    ffm, inits = _ffm_parts(fs, k)
    parts = {"embedding": FusedEmbedding(fs), **ffm,
             "mlp": MLP(f * d + f * (f - 1) // 2 + nd, hidden, activation="relu",
                        out_dim=1),
             "bias": _bias(), **_maybe_dense_linear(fs)}

    def fwd(m, batch, train):
        inp = embed_inputs(m.embedding, batch)
        gids = m.embedding.global_sparse_ids(batch["sparse"])
        rows = gather_rows(m.ffm, gids, tape_key="ffm")            # (B, F, F·K)
        e = rows.reshape(rows.shape[0], f, f, k)
        t = (e * e.transpose(1, 2)).sum(dim=-1)                    # (B, F, F)
        iu, ju = triu_pairs(e)
        parts = [flatten_concat([inp["emb"]]), t[:, iu, ju]]
        if nd:
            parts.append(inp["dense"])
        deep = m.mlp(torch.cat(parts, dim=-1), train)
        logit = _first_order(m, inp) + deep[:, 0] + m.bias
        return logit, {"emb_l2": inp["l2"] + m.embedding.l2_from_sparse(rows)}

    return stateless("ONN", fs, parts, fwd, inits)


def FATDeepFFM(fs: FeatureSet, ffm_dim: int = 4, reduction: int = 2,
               hidden: Tuple[int, ...] = (128, 64)) -> Model:
    """FAT-DeepFFM: a CENet field attention (each field's F·K ``ffm`` row
    squeezed by its mean, ``se1`` ReLU, ``se2`` sigmoid) rescales the
    field-aware rows before the pairwise Hadamard products, which (with
    dense) feed ``mlp``, + the first-order terms and ``bias``. ``emb_l2``
    adds the rescaled rows'."""
    f, d, nd = _dims(fs)
    k = ffm_dim
    mid = max(1, f // reduction)
    ffm, inits = _ffm_parts(fs, k)
    parts = {"embedding": FusedEmbedding(fs), **ffm,
             "se1": Dense(f, mid), "se2": Dense(mid, f),
             "mlp": MLP(f * (f - 1) // 2 * k + nd, hidden, activation="relu",
                        out_dim=1),
             "bias": _bias(), **_maybe_dense_linear(fs)}

    def fwd(m, batch, train):
        inp = embed_inputs(m.embedding, batch)
        gids = m.embedding.global_sparse_ids(batch["sparse"])
        rows = gather_rows(m.ffm, gids, tape_key="ffm")            # (B, F, F·K)
        a = torch.sigmoid(m.se2(torch.relu(m.se1(rows.mean(dim=-1)))))
        rows = rows * a[..., None]
        e = rows.reshape(rows.shape[0], f, f, k)
        iu, ju = triu_pairs(e)
        had = e * e.transpose(1, 2)                                # (B, F, F, K)
        parts = [had[:, iu, ju, :].reshape(rows.shape[0], -1)]
        if nd:
            parts.append(inp["dense"])
        deep = m.mlp(torch.cat(parts, dim=-1), train)
        logit = _first_order(m, inp) + deep[:, 0] + m.bias
        return logit, {"emb_l2": inp["l2"] + m.embedding.l2_from_sparse(rows)}

    return stateless("FATDeepFFM", fs, parts, fwd, inits)


def FiGNN(fs: FeatureSet, steps: int = 2, num_heads: int = 2) -> Model:
    """Fi-GNN: the field embeddings refined by self-attention (``mha``),
    a complete graph over the fields weighted by their Gram softmax (no
    self loops), ``steps`` rounds of messages through ``wmsg`` and a shared
    GRU cell (``cell``) with a residual to the refined embeddings; the
    readout Σ_f σ(``attn``(h_f))·``score``(h_f), + the first-order terms
    and ``bias``."""
    f, d, nd = _dims(fs)
    parts = {"embedding": FusedEmbedding(fs), "mha": MultiHeadAttention(d, num_heads),
             "wmsg": nn.Parameter(torch.empty(d, d)), "cell": GRU(d, d),
             "score": Dense(d, 1), "attn": Dense(d, 1),
             "bias": _bias(), **_maybe_dense_linear(fs)}
    inits = {"wmsg": lambda g: glorot_uniform((d, d), g)}

    def fwd(m, batch, train):
        inp = embed_inputs(m.embedding, batch)
        e = m.mha(inp["emb"])                                      # (B, F, D)
        b = e.shape[0]
        logits = torch.einsum("bfd,bgd->bfg", e, e) / math.sqrt(d)
        eye = torch.eye(f, dtype=torch.bool, device=e.device)
        adj = torch.softmax(torch.where(eye, NEG_INF, logits), dim=-1)
        h, every = e, torch.ones(b * f, dtype=torch.bool, device=e.device)
        for _ in range(steps):
            msg = torch.einsum("bfg,bgd->bfd", adj, bf16_matmul(h, m.wmsg))
            xw = bf16_matmul(msg.reshape(b * f, d), m.cell.wx) + m.cell.b
            h = m.cell._step(h.reshape(b * f, d), xw, every).reshape(b, f, d) + e
        readout = (torch.sigmoid(m.attn(h)[..., 0]) * m.score(h)[..., 0]).sum(dim=-1)
        return readout + _first_order(m, inp) + m.bias, {"emb_l2": inp["l2"]}

    return stateless("FiGNN", fs, parts, fwd, inits)


def MLR(fs: FeatureSet, regions: int = 4) -> Model:
    """Mixed logistic regression (PS-PLM): p = Σ_m softmax(``u``·x)_m ·
    σ(``w``·x)_m over x = [flattened embeddings, dense], clipped to
    [1e-6, 1 − 1e-6] and returned as the logit log p − log(1 − p)."""
    f, d, nd = _dims(fs)
    x_dim = f * d + nd
    parts = {"embedding": FusedEmbedding(fs), "u": Dense(x_dim, regions),
             "w": Dense(x_dim, regions), **_maybe_dense_linear(fs)}

    def fwd(m, batch, train):
        inp = embed_inputs(m.embedding, batch)
        x = flatten_concat([inp["emb"]] + ([inp["dense"]] if nd else []))
        prob = (torch.softmax(m.u(x), dim=-1) * torch.sigmoid(m.w(x))).sum(dim=-1)
        prob = torch.clamp(prob, 1e-6, 1 - 1e-6)
        return torch.log(prob) - torch.log1p(-prob), {"emb_l2": inp["l2"]}

    return stateless("MLR", fs, parts, fwd)


def OENN(fs: FeatureSet, max_order: int = 3,
         hidden: Tuple[int, ...] = (128, 64)) -> Model:
    """Order-aware embedding NN: each feature keeps a table per interaction
    order k (``order2``, ``order3``, (V, D) each) besides the first-order
    one, and order k's signal is the sum over every k-combination of its
    Hadamard product, in closed form from the power sums s_p = Σ_f e_f^p:
    (s₁² − s₂)/2 and (s₁³ − 3s₁s₂ + 2s₃)/6; [flattened embeddings, the
    order vectors, dense] → ``mlp``, + the first-order terms and ``bias``."""
    if not 2 <= max_order <= 3:
        raise ValueError("max_order must be 2 or 3")
    f, d, nd = _dims(fs)
    orders = range(2, max_order + 1)
    parts = {"embedding": FusedEmbedding(fs),
             "mlp": MLP(f * d + (max_order - 1) * d + nd, hidden, activation="relu",
                        out_dim=1),
             "bias": _bias(), **_maybe_dense_linear(fs)}
    shape = (fs.total_vocab, d)
    inits = {}
    for k in orders:
        parts[f"order{k}"] = nn.Parameter(torch.empty(shape))
        inits[f"order{k}"] = lambda g: normal_init(shape, g, stddev=0.05)

    def fwd(m, batch, train):
        inp = embed_inputs(m.embedding, batch)
        gids = m.embedding.global_sparse_ids(batch["sparse"])
        parts = [inp["emb"].reshape(inp["emb"].shape[0], -1)]
        l2 = inp["l2"]
        for k in orders:
            e = gather_rows(getattr(m, f"order{k}"), gids, tape_key=f"order{k}")
            s1, s2 = e.sum(dim=1), e.square().sum(dim=1)
            if k == 2:
                parts.append(0.5 * (s1.square() - s2))
            else:
                s3 = (e * e * e).sum(dim=1)
                parts.append((s1 * s1 * s1 - 3.0 * s1 * s2 + 2.0 * s3) / 6.0)
            l2 = l2 + m.embedding.l2_from_sparse(e)
        if nd:
            parts.append(inp["dense"])
        deep = m.mlp(torch.cat(parts, dim=-1), train)
        logit = _first_order(m, inp) + deep[:, 0] + m.bias
        return logit, {"emb_l2": l2}

    return stateless("OENN", fs, parts, fwd, inits)
