"""Skip-gram word2vec with negative sampling, in PyTorch on the card.

Counterpart of ``ml_function_tpu/embedding_pretrain/word2vec.py``, which
replaces the reference's gensim dependency
(``kon/model/embedding/backone_language_model.py:4-22``): skip-gram with
negative sampling over (center, context) pairs, unigram^0.75 noise, optax's
Adam (``train/optimizers.py``), and the reference's embedding-trainer
callbacks (EarlyStopping, ReduceLROnPlateau, keep-best) on the epoch's mean
loss through ``train/control.py``.

Random draws: the initial tables come from ``init`` when given (the JAX
package's, in the parity tests), else from a ``torch.Generator`` on the
tables' device seeded by ``cfg.seed``; the negatives' noise-table slots come
from ``sampler(batch, negatives)`` when given (a replay of the JAX package's
key chain, in the parity tests), else from that generator.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .._device import DeviceLike, resolve_device
from ..ops.base import normal_init


@dataclass
class Word2VecConfig:
    dim: int = 64
    negatives: int = 5
    # batched training (mean loss) → adaptive optimizer, not gensim's
    # per-sample SGD schedule
    learning_rate: float = 0.01
    batch_size: int = 4096
    epochs: int = 1
    min_steps: int = 400   # small corpora loop extra epochs up to this
    seed: int = 0
    # reference embedding-trainer callbacks (walk_core_model.py:203-227:
    # EarlyStopping + ReduceLROnPlateau + ModelCheckpoint(save_best_only)),
    # driven by the per-epoch mean loss (train/control.py):
    patience: int = 0            # stop after N non-improving epochs (0=off)
    plateau_factor: float = 0.0  # >0 enables LR reduction on plateau
    plateau_patience: int = 2
    min_lr: float = 1e-5
    keep_best: bool = True       # return the best-loss epoch's embeddings


def _noise_table(counts: np.ndarray, power: float = 0.75,
                 table_size: int = 1 << 20) -> np.ndarray:
    p = np.asarray(counts, np.float64) ** power
    p /= p.sum()
    return np.searchsorted(np.cumsum(p), np.random.default_rng(0).random(
        table_size)).astype(np.int32)


Sampler = Callable[[int, int], object]


def skipgram_loss(emb_in: torch.Tensor, emb_out: torch.Tensor, center: torch.Tensor,
                  context: torch.Tensor, negs: torch.Tensor) -> torch.Tensor:
    """The negative-sampling loss of one batch: −(mean log σ(v·u⁺) + mean Σ_k
    log σ(−v·u⁻_k))."""
    v = emb_in[center]                                  # (B, D)
    pos = F.logsigmoid((v * emb_out[context]).sum(-1))
    neg = F.logsigmoid(-torch.einsum("bd,bkd->bk", v, emb_out[negs]))
    return -(pos.mean() + neg.sum(-1).mean())


def train_word2vec(pairs: np.ndarray, vocab_size: int,
                   cfg: Word2VecConfig = Word2VecConfig(),
                   init: Optional[Tuple[np.ndarray, np.ndarray]] = None,
                   sampler: Optional[Sampler] = None,
                   device: DeviceLike = None) -> np.ndarray:
    """(P, 2) (center, context) int32 pairs → (vocab_size, dim) embeddings,
    trained on ``device`` (default: the card)."""
    from ..train.control import EarlyStopping, ReduceLROnPlateau
    from ..train.optimizers import make_optimizer, set_learning_rate

    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(cfg.seed)
    if init is None:
        emb_in = normal_init((vocab_size, cfg.dim), gen, 0.5 / cfg.dim)
        emb_out = torch.zeros((vocab_size, cfg.dim), device=dev)
    else:
        emb_in, emb_out = (torch.tensor(np.asarray(a, np.float32), device=dev)
                           for a in init)
    emb_in.requires_grad_()
    emb_out.requires_grad_()

    counts = np.bincount(pairs[:, 0], minlength=vocab_size)
    noise = torch.as_tensor(_noise_table(np.maximum(counts, 1)), device=dev).long()
    k_neg = cfg.negatives
    if sampler is None:
        def sampler(b, k):
            return torch.randint(0, noise.shape[0], (b, k), generator=gen, device=dev)
    # an injectable LR, so that ReduceLROnPlateau can retune it between epochs
    opt = make_optimizer("adam", cfg.learning_rate, inject_lr=True).init(
        [("emb_in", emb_in), ("emb_out", emb_out)])

    def step(batch: torch.Tensor) -> torch.Tensor:
        slots = torch.as_tensor(sampler(batch.shape[0], k_neg), device=dev).long()
        opt.zero_grad(set_to_none=True)
        loss = skipgram_loss(emb_in, emb_out, batch[:, 0], batch[:, 1], noise[slots])
        loss.backward()
        opt.step()
        return loss.detach()

    stopper = (EarlyStopping(cfg.patience, monitor="loss")
               if cfg.patience else None)
    reducer = (ReduceLROnPlateau(base_lr=cfg.learning_rate,
                                 factor=cfg.plateau_factor,
                                 patience=cfg.plateau_patience,
                                 min_lr=cfg.min_lr, monitor="loss")
               if cfg.plateau_factor else None)

    pairs_t = torch.as_tensor(np.asarray(pairs), device=dev).long()
    bs = min(cfg.batch_size, len(pairs))
    n = max((len(pairs) // bs) * bs, bs)
    steps_per_epoch = max(n // bs, 1)
    epochs = max(cfg.epochs, -(-cfg.min_steps // steps_per_epoch))
    best = None
    best_loss = float("inf")
    for epoch in range(epochs):
        ep_losses = [step(pairs_t[i:i + bs]) for i in range(0, n - bs + 1, bs)]
        mean_loss = float(torch.stack(ep_losses).mean())
        if cfg.keep_best and mean_loss < best_loss:
            best_loss = mean_loss
            best = emb_in.detach().cpu().numpy().copy()
        if reducer is not None:
            new_lr = reducer.update(mean_loss, epoch)
            if new_lr is not None:
                set_learning_rate(opt, new_lr)
        if stopper is not None and stopper.update(mean_loss, epoch):
            break
    if cfg.keep_best and best is not None:
        return best
    return emb_in.detach().cpu().numpy()


def embeddings_to_dict(emb: np.ndarray, node_names) -> Dict[str, np.ndarray]:
    """Match the reference API: ``transform() -> {node_name: vector}``
    (deepwalk.py:23-26)."""
    return {name: emb[i] for i, name in enumerate(node_names)}
