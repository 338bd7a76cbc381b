"""Feature-interaction models of the port: LR, FM, FFM, FwFM, PNN,
DeepCross, Wide&Deep, DeepFM, DCN (v1 and v2), NFM, xDeepFM, AFM, FiBiNET,
DLRM, AutoInt and FNN (with ``fnn_from_fm``).

Counterpart of ``ml_function_tpu/models/interaction.py``. Only xDeepFM (the
CIN kernels) and AutoInt (the field-attention kernels, under their flag) run
kernels of their own; the others' pair products are f32 tensor operations
and their towers ``bf16_matmul``s, as in the reference.

Some parameters are never read, as in the reference, and are kept because
the parameter trees must match key for key: the ``linear`` table of PNN,
DeepCross, DCN and AutoInt, whose lookups take the cross rows alone, and
PNN's ``outer.kernel``, whose forward concatenates vec(p·pᵀ) itself. Their
gradients are zero (``ROADMAP.md`` R6).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..features.schema import FeatureSet
from ..ops.attention import MultiHeadAttention
from ..ops.base import normal_init, zeros
from ..ops.core import MLP, Dense, flatten_concat
from ..ops.embedding import FusedEmbedding, gather_rows
from ..ops.interactions import (CIN, AFMAttention, CrossNet, CrossNetMix,
                                LinearUnit, OuterProduct, fm_interaction,
                                fm_interaction_vector, pairwise_inner_products,
                                pairwise_products, triu_pairs)
from .base import Model, embed_inputs, stateless


def _dims(fs: FeatureSet):
    return len(fs.sparse), fs.embed_dim, len(fs.dense)


def _first_order(m: Model, inp) -> torch.Tensor:
    """Linear sparse terms + the optional dense linear unit: (B,)."""
    lo = inp["linear"].sum(dim=1)
    if inp["dense"] is not None and inp["dense"].shape[-1] > 0:
        lo = lo + m.dense_linear(inp["dense"])
    return lo


def _maybe_dense_linear(fs: FeatureSet):
    return {"dense_linear": LinearUnit(len(fs.dense))} if len(fs.dense) else {}


def _bias() -> nn.Parameter:
    return nn.Parameter(zeros(()))


def _ffm_parts(fs: FeatureSet, k: int):
    """The (V, F·K) field-aware ``ffm`` table (a block of K a field an id
    meets) and its normal(0.05) init: FFM's, ONN's and FAT-DeepFFM's."""
    shape = (fs.total_vocab, len(fs.sparse) * k)
    return ({"ffm": nn.Parameter(torch.empty(shape))},
            {"ffm": lambda g: normal_init(shape, g, stddev=0.05)})


def _deep_input(inp, nd: int) -> torch.Tensor:
    """[flattened field embeddings ∥ dense features]: (B, F·D + Nd)."""
    return flatten_concat([inp["emb"]] + ([inp["dense"]] if nd else []))


def LR(fs: FeatureSet) -> Model:
    """Logistic regression: the (V, 1) ``embedding.linear`` weights, the
    dense linear unit and ``bias``; the store holds no cross table and the
    model no ``emb_l2``."""
    parts = {"embedding": FusedEmbedding(fs, with_table=False),
             "bias": _bias(), **_maybe_dense_linear(fs)}

    def fwd(m, batch, train):
        inp = {"linear": m.embedding.sparse_linear(batch["sparse"]),
               "dense": batch.get("dense")}
        return _first_order(m, inp) + m.bias, {}

    return stateless("LR", fs, parts, fwd)


def FM(fs: FeatureSet) -> Model:
    """Factorization machine: first-order + FM second-order + ``bias``."""
    parts = {"embedding": FusedEmbedding(fs), "bias": _bias(),
             **_maybe_dense_linear(fs)}

    def fwd(m, batch, train):
        inp = embed_inputs(m.embedding, batch)
        logit = _first_order(m, inp) + fm_interaction(inp["emb"]) + m.bias
        return logit, {"emb_l2": inp["l2"]}

    return stateless("FM", fs, parts, fwd)


def FFM(fs: FeatureSet, ffm_dim: int = 4) -> Model:
    """Field-aware FM: every id has F blocks of ``ffm_dim``, one per field
    it meets, in one (V, F·K) ``ffm`` table (normal(0.05)); pair (i, j) is
    v_{i, field j} · v_{j, field i}, summed over the strict upper triangle.
    The store holds ``linear`` alone; ``emb_l2`` is taken over the gathered
    ``ffm`` rows with each field's coefficient."""
    f, _, _ = _dims(fs)
    k = ffm_dim
    ffm, inits = _ffm_parts(fs, k)
    parts = {"embedding": FusedEmbedding(fs, with_table=False), **ffm,
             "bias": _bias(), **_maybe_dense_linear(fs)}

    def fwd(m, batch, train):
        gids = m.embedding.global_sparse_ids(batch["sparse"])
        lin = gather_rows(m.embedding.linear, gids, tape_key="linear")[..., 0]
        rows = gather_rows(m.ffm, gids, tape_key="ffm")             # (B, F, F·K)
        e = rows.reshape(rows.shape[0], f, f, k)                   # e[b,i,j] = v_{i,fj}
        t = (e * e.transpose(1, 2)).sum(dim=-1)                    # v_{i,fj}·v_{j,fi}
        diag = torch.diagonal(t, dim1=1, dim2=2).sum(dim=-1)
        second = 0.5 * (t.sum(dim=(1, 2)) - diag)
        inp = {"dense": batch.get("dense"), "linear": lin}
        logit = _first_order(m, inp) + second + m.bias
        return logit, {"emb_l2": m.embedding.l2_from_sparse(rows)}

    return stateless("FFM", fs, parts, fwd, inits)


def FwFM(fs: FeatureSet, hidden: Optional[Tuple[int, ...]] = None) -> Model:
    """Field-weighted FM: first-order + Σ_{i<j} r_ij ⟨v_i, v_j⟩ with the
    learned (F, F) ``field_r`` (normal(0.1)) over the f32 Gram product;
    ``hidden`` adds a DeepFwFM tower (``mlp``) over the flattened
    embeddings."""
    f, d, nd = _dims(fs)
    parts = {"embedding": FusedEmbedding(fs),
             "field_r": nn.Parameter(torch.empty(f, f)),
             "bias": _bias(), **_maybe_dense_linear(fs)}
    if hidden:
        parts["mlp"] = MLP(f * d + nd, hidden, activation="relu", out_dim=1)
    inits = {"field_r": lambda g: normal_init((f, f), g, stddev=0.1)}

    def fwd(m, batch, train):
        inp = embed_inputs(m.embedding, batch)
        e = inp["emb"]
        gram = torch.einsum("bid,bjd->bij", e, e)
        triu = torch.ones(f, f, device=e.device).triu(1)
        second = (gram * (m.field_r * triu)).sum(dim=(1, 2))
        logit = _first_order(m, inp) + second + m.bias
        if hidden:
            logit = logit + m.mlp(_deep_input(inp, nd), train)[:, 0]
        return logit, {"emb_l2": inp["l2"]}

    return stateless("FwFM", fs, parts, fwd, inits)


def PNN(fs: FeatureSet, hidden: Tuple[int, ...] = (128, 64),
        use_inner: bool = True, use_outer: bool = True) -> Model:
    """Product-based NN: [flattened embeddings ∥ dense ∥ inner products ∥
    vec(p·pᵀ) with p = Σ_f e_f] → ``mlp`` → logit. ``outer.kernel`` and the
    ``linear`` table are kept and never read (R6)."""
    f, d, nd = _dims(fs)
    n_pairs = f * (f - 1) // 2
    in_dim = f * d + nd + (n_pairs if use_inner else 0) + (d * d if use_outer else 0)
    parts = {"embedding": FusedEmbedding(fs),
             "mlp": MLP(in_dim, hidden, activation="relu", out_dim=1)}
    if use_outer:
        parts["outer"] = OuterProduct(d, d * d)

    def fwd(m, batch, train):
        inp = embed_inputs(m.embedding, batch, with_linear=False)
        e = inp["emb"]
        parts = [_deep_input(inp, nd)]
        if use_inner:
            parts.append(pairwise_inner_products(e))
        if use_outer:
            p = e.sum(dim=1)
            parts.append(torch.einsum("bi,bj->bij", p, p).reshape(e.shape[0], -1))
        logit = m.mlp(torch.cat(parts, dim=-1), train)
        return logit[:, 0], {"emb_l2": inp["l2"]}

    return stateless("PNN", fs, parts, fwd)


def DeepCross(fs: FeatureSet, hidden: Tuple[int, ...] = (256, 128, 64),
              res_every: int = 2) -> Model:
    """Deep Crossing: a residual ``mlp`` (a skip every ``res_every``
    layers) over [flattened embeddings ∥ dense] → logit."""
    f, d, nd = _dims(fs)
    parts = {"embedding": FusedEmbedding(fs),
             "mlp": MLP(f * d + nd, hidden, activation="relu",
                        res_every=res_every, out_dim=1)}

    def fwd(m, batch, train):
        inp = embed_inputs(m.embedding, batch, with_linear=False)
        logit = m.mlp(_deep_input(inp, nd), train)
        return logit[:, 0], {"emb_l2": inp["l2"]}

    return stateless("DeepCross", fs, parts, fwd)


def WideDeep(fs: FeatureSet, hidden: Tuple[int, ...] = (256, 128, 64)) -> Model:
    """Wide & Deep: the first-order (wide) terms + the ``mlp`` (deep) +
    ``bias``, one logit."""
    f, d, nd = _dims(fs)
    parts = {"embedding": FusedEmbedding(fs),
             "mlp": MLP(f * d + nd, hidden, activation="relu", out_dim=1),
             "bias": _bias(), **_maybe_dense_linear(fs)}

    def fwd(m, batch, train):
        inp = embed_inputs(m.embedding, batch)
        deep = m.mlp(_deep_input(inp, nd), train)
        logit = _first_order(m, inp) + deep[:, 0] + m.bias
        return logit, {"emb_l2": inp["l2"]}

    return stateless("WideDeep", fs, parts, fwd)


def DeepFM(fs: FeatureSet, hidden: Tuple[int, ...] = (256, 128, 64)) -> Model:
    """DeepFM: first-order + FM second-order + MLP over shared embeddings."""
    f, d, nd = _dims(fs)
    parts = {"embedding": FusedEmbedding(fs),
             "mlp": MLP(f * d + nd, hidden, activation="relu", out_dim=1),
             "bias": _bias(), **_maybe_dense_linear(fs)}

    def fwd(m, batch, train):
        inp = embed_inputs(m.embedding, batch)
        deep = m.mlp(_deep_input(inp, nd), train)
        logit = (_first_order(m, inp) + fm_interaction(inp["emb"])
                 + deep[:, 0] + m.bias)
        return logit, {"emb_l2": inp["l2"]}

    return stateless("DeepFM", fs, parts, fwd)


def xDeepFM(fs: FeatureSet, cin_hidden: Tuple[int, ...] = (128, 128),
            hidden: Tuple[int, ...] = (256, 128),
            cin_kernel: str = "auto") -> Model:
    """xDeepFM: CIN + DNN + linear terms summed into one logit.
    ``cin_kernel``: 'auto' | 'pallas' | 'off' (see ``ops.interactions.CIN``)."""
    f, d, nd = _dims(fs)
    parts = {"embedding": FusedEmbedding(fs),
             "cin": CIN(f, d, cin_hidden, out_logit=True, kernel=cin_kernel),
             "mlp": MLP(f * d + nd, hidden, activation="relu", out_dim=1),
             "bias": _bias(), **_maybe_dense_linear(fs)}

    def fwd(m, batch, train):
        inp = embed_inputs(m.embedding, batch)
        deep = m.mlp(_deep_input(inp, nd), train)
        logit = (_first_order(m, inp) + m.cin(inp["emb"])
                 + deep[:, 0] + m.bias)
        return logit, {"emb_l2": inp["l2"]}

    return stateless("xDeepFM", fs, parts, fwd)


class _SENet(nn.Module):
    """FiBiNET's squeeze-excitation: field weights relu(relu(z·w1)·w2) from
    the field means z, as plain f32 products (the reference uses no
    ``bf16_matmul`` here)."""

    def __init__(self, n_fields: int, mid: int):
        super().__init__()
        self.w1 = nn.Parameter(torch.empty(n_fields, mid))
        self.w2 = nn.Parameter(torch.empty(mid, n_fields))

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.w1.copy_(normal_init(self.w1.shape, generator, stddev=0.1))
        self.w2.copy_(normal_init(self.w2.shape, generator, stddev=0.1))

    def forward(self, e: torch.Tensor) -> torch.Tensor:
        z = e.mean(dim=-1)                                         # squeeze (B, F)
        return torch.relu(torch.relu(z @ self.w1) @ self.w2)       # excitation


def FiBiNET(fs: FeatureSet, reduction: int = 3, bilinear_type: str = "each",
            hidden: Tuple[int, ...] = (128, 64)) -> Model:
    """FiBiNET: SENET reweights the field embeddings (``se``), a bilinear
    layer (``bilinear_w``: (F, D, D) for 'each', (D, D) for 'all') crosses
    every field pair of both the raw and the reweighted embeddings, and the
    pair vectors (with the dense features) feed ``mlp``; plus the first-order
    terms and ``bias``."""
    f, d, nd = _dims(fs)
    if bilinear_type not in ("all", "each"):
        raise ValueError(f"bilinear_type {bilinear_type!r} not in "
                         "('all', 'each')")
    n_pairs = f * (f - 1) // 2
    kshape = (d, d) if bilinear_type == "all" else (f, d, d)
    parts = {"embedding": FusedEmbedding(fs),
             "se": _SENet(f, max(1, f // reduction)),
             "bilinear_w": nn.Parameter(torch.empty(kshape)),
             "mlp": MLP(2 * n_pairs * d + nd, hidden, activation="relu", out_dim=1),
             "bias": _bias(), **_maybe_dense_linear(fs)}
    inits = {"bilinear_w": lambda g: normal_init(kshape, g, stddev=0.05)}
    spec = "bfd,de->bfe" if bilinear_type == "all" else "bfd,fde->bfe"

    def bilinear(w, e, iu, ju):
        t = torch.einsum(spec, e, w)
        return (t[:, iu, :] * e[:, ju, :]).reshape(e.shape[0], -1)

    def fwd(m, batch, train):
        inp = embed_inputs(m.embedding, batch)
        e = inp["emb"]
        v = e * m.se(e)[..., None]                                 # reweight
        iu, ju = triu_pairs(e)
        parts = [bilinear(m.bilinear_w, e, iu, ju), bilinear(m.bilinear_w, v, iu, ju)]
        if nd:
            parts.append(inp["dense"])
        deep = m.mlp(torch.cat(parts, dim=-1), train)
        logit = _first_order(m, inp) + deep[:, 0] + m.bias
        return logit, {"emb_l2": inp["l2"]}

    return stateless("FiBiNET", fs, parts, fwd, inits)


def DLRM(fs: FeatureSet, bottom: Tuple[int, ...] = (64,),
         top: Tuple[int, ...] = (256, 128)) -> Model:
    """DLRM: dense features through the ``bottom`` MLP into the embedding
    width, joined as the first pseudo-field; the f32 dot of every field pair
    (a Gram product read at the upper triangle); [bottom output ∥ pair dots]
    into the ``top`` MLP. No first-order term and no bias; the embedding has
    no ``linear`` table. Without dense features there is no ``bottom``."""
    f, d, nd = _dims(fs)
    n_fields = f + (1 if nd else 0)
    top_dim = (d if nd else 0) + n_fields * (n_fields - 1) // 2
    parts = {"embedding": FusedEmbedding(fs, with_linear=False),
             "top": MLP(top_dim, top, activation="relu", out_dim=1)}
    if nd:
        parts["bottom"] = MLP(nd, tuple(bottom) + (d,), activation="relu")

    def fwd(m, batch, train):
        inp = embed_inputs(m.embedding, batch, with_linear=False)
        e = inp["emb"]
        parts = []
        if nd:
            x0 = m.bottom(inp["dense"], train)                     # (B, D)
            e = torch.cat([x0[:, None, :], e], dim=1)
            parts.append(x0)
        gram = torch.einsum("bid,bjd->bij", e, e)
        iu, ju = triu_pairs(e)
        parts.append(gram[:, iu, ju])
        logit = m.top(torch.cat(parts, dim=-1), train)
        return logit[:, 0], {"emb_l2": inp["l2"]}

    return stateless("DLRM", fs, parts, fwd)


def AutoInt(fs: FeatureSet, n_layers: int = 2, num_heads: int = 2,
            head_dim: int = 16) -> Model:
    """AutoInt: stacked multi-head self-attention over the field embeddings
    (``mha0`` … ``mha{n-1}``), then flatten → logit (``head``). Dense
    features join as one projected pseudo-field (``dense_proj``), the last.
    The embedding keeps its ``linear`` table, as the reference's does, and
    does not read it. Under a sharding context with ``pp_microbatches`` and
    a model group above 1, the block stack runs as a GPipe pipeline
    (``pipelined_blocks``); ``model.pipelined_forward(batch, mesh, micro)``
    takes that route on any mesh."""
    f, d, nd = _dims(fs)
    n_fields = f + (1 if nd else 0)
    parts = {"embedding": FusedEmbedding(fs), "head": Dense(n_fields * d, 1)}
    if nd:
        parts["dense_proj"] = Dense(nd, d)
    for i in range(n_layers):
        parts[f"mha{i}"] = MultiHeadAttention(d, num_heads, head_dim,
                                              use_res=True, use_ln=True)

    def pp():
        """(mesh, microbatches) when the context asks for the pipeline over
        a model group above 1."""
        from ..parallel import context as pctx
        micro = pctx.pp_microbatches()
        if not micro or pctx.model_axis_size() <= 1:
            return None
        return pctx.active_mesh(), micro

    def run(m, batch, pipe):
        inp = embed_inputs(m.embedding, batch, with_linear=False)
        e = inp["emb"]
        if nd:
            e = torch.cat([e, m.dense_proj(inp["dense"])[:, None, :]], dim=1)
        blocks = [getattr(m, f"mha{i}") for i in range(n_layers)]
        if pipe is not None:
            e = pipelined_blocks(blocks, e, *pipe)
        else:
            for blk in blocks:
                e = blk(e)
        logit = m.head(e.reshape(e.shape[0], -1))
        return logit[:, 0], {"emb_l2": inp["l2"]}

    def fwd(m, batch, train):
        return run(m, batch, pp())

    model = stateless("AutoInt", fs, parts, fwd)
    # the forward with the pipeline taken on any mesh, a one-stage one too
    model.add_helper("pipelined_forward",
                     lambda m, batch, mesh, micro: run(m, batch, (mesh, micro)))
    return model


def pipelined_blocks(blocks, e: torch.Tensor, mesh, micro: int) -> torch.Tensor:
    """AutoInt's block stack on e (B, F, D) as a GPipe pipeline of
    ``micro`` microbatches over ``mesh``'s model group: the rank at model
    coordinate s runs ``blocks[s·bps]`` … ``blocks[s·bps+bps−1]``, bps =
    len(blocks) / stages."""
    from ..parallel.pipeline import make_pipeline, stack_stage_params
    if len(blocks) % mesh.model:
        raise ValueError(f"pipeline over {mesh.model} stages needs n_layers "
                         f"divisible ({len(blocks)} blocks)")
    bps = len(blocks) // mesh.model
    stacked = stack_stage_params([
        {f"b{j}": dict(blocks[s * bps + j].named_parameters()) for j in range(bps)}
        for s in range(mesh.model)])

    def stage_fn(sp, x):
        eb = x.reshape(x.shape[0], *e.shape[1:])
        for j in range(bps):
            eb = torch.func.functional_call(blocks[j], sp[f"b{j}"], (eb,))
        return eb.reshape(x.shape[0], -1)

    pipe = make_pipeline(mesh, stage_fn, n_microbatches=micro)
    return pipe(stacked, e.reshape(e.shape[0], -1)).reshape(e.shape)


def DCN(fs: FeatureSet, cross_depth: int = 3,
        hidden: Tuple[int, ...] = (256, 128), version: int = 1) -> Model:
    """Deep & Cross: ``cross`` (``CrossNet`` for version 1, ``CrossNetMix``
    otherwise) and ``mlp`` over x0 = [flattened embeddings ∥ dense], their
    outputs joined into ``head``."""
    f, d, nd = _dims(fs)
    x_dim = f * d + nd
    parts = {"embedding": FusedEmbedding(fs),
             "cross": (CrossNet if version == 1 else CrossNetMix)(x_dim, cross_depth),
             "mlp": MLP(x_dim, hidden, activation="relu"),
             "head": Dense(x_dim + hidden[-1], 1)}

    def fwd(m, batch, train):
        inp = embed_inputs(m.embedding, batch, with_linear=False)
        x0 = _deep_input(inp, nd)
        xc = m.cross(x0)
        xd = m.mlp(x0, train)
        logit = m.head(torch.cat([xc, xd], dim=-1))
        return logit[:, 0], {"emb_l2": inp["l2"]}

    return stateless("DCN", fs, parts, fwd)


def NFM(fs: FeatureSet, hidden: Tuple[int, ...] = (128, 64)) -> Model:
    """Neural FM: the bi-interaction vector (with the dense features)
    through ``mlp``, + the first-order terms and ``bias``."""
    f, d, nd = _dims(fs)
    parts = {"embedding": FusedEmbedding(fs),
             "mlp": MLP(d + nd, hidden, activation="relu", out_dim=1),
             "bias": _bias(), **_maybe_dense_linear(fs)}

    def fwd(m, batch, train):
        inp = embed_inputs(m.embedding, batch)
        bi = fm_interaction_vector(inp["emb"])
        h = torch.cat([bi] + ([inp["dense"]] if nd else []), dim=-1)
        deep = m.mlp(h, train)
        logit = _first_order(m, inp) + deep[:, 0] + m.bias
        return logit, {"emb_l2": inp["l2"]}

    return stateless("NFM", fs, parts, fwd)


def AFM(fs: FeatureSet, attn_dim: int = 16) -> Model:
    """Attentional FM: the first-order terms + ``attn`` over every field
    pair's product + ``bias``."""
    f, d, nd = _dims(fs)
    parts = {"embedding": FusedEmbedding(fs), "attn": AFMAttention(d, attn_dim),
             "bias": _bias(), **_maybe_dense_linear(fs)}

    def fwd(m, batch, train):
        inp = embed_inputs(m.embedding, batch)
        logit = (_first_order(m, inp) + m.attn(pairwise_products(inp["emb"]))
                 + m.bias)
        return logit, {"emb_l2": inp["l2"]}

    return stateless("AFM", fs, parts, fwd)


def FNN(fs: FeatureSet, hidden: Tuple[int, ...] = (200, 200, 200)) -> Model:
    """FM-supported NN: each field's z_i = (v_i, w_i), the cross row and
    its first-order weight, with the dense features through ``mlp``, +
    ``bias``. ``fnn_from_fm`` warm-starts its store from a trained FM."""
    f, d, nd = _dims(fs)
    parts = {"embedding": FusedEmbedding(fs),
             "mlp": MLP(f * (d + 1) + nd, hidden, activation="relu", out_dim=1),
             "bias": _bias()}

    def fwd(m, batch, train):
        inp = embed_inputs(m.embedding, batch)
        e = inp["emb"]
        z = torch.cat([e.reshape(e.shape[0], -1), inp["linear"]]
                      + ([inp["dense"]] if nd else []), dim=-1)
        deep = m.mlp(z, train)
        return deep[:, 0] + m.bias, {"emb_l2": inp["l2"]}

    return stateless("FNN", fs, parts, fwd)


def fnn_from_fm(fnn: Model, fm: Model) -> Model:
    """Warm-start FNN from a trained FM: copies FM's ``embedding`` (the
    (V, D) table and the (V, 1) linear) into ``fnn`` in place, the FNN
    paper's pretraining step. Returns ``fnn``."""
    fnn.embedding.load_state_dict(fm.embedding.state_dict())
    return fnn
