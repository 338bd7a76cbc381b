"""Held-out AUC after each epoch of ``fit`` on synthetic Criteo-like data.

    python -m ml_function_tpu_torch.tools.learning_curve [--model xdeepfm]
        [--vocab 1000] [--device cuda]

The model is at full width (26 fields, dim 8, 13 dense; xDeepFM's CIN
(128, 128) and MLP (256, 128)), with weights from seed 0, trained as
chip_smoke.py's learning phase is: ``make_criteo_like(n_rows=262_144,
seed=0)`` split 80/20 (``train_test_split(seed=1)``), 3 epochs of Adam at
B 4096 and lr 5e-3. Prints one line: the held-out AUC after each epoch and
the streaming train AUC. A recipe whose held-out AUC falls from the first
epoch on overfits.
"""

from __future__ import annotations

import argparse

import torch

ROWS, EPOCHS, BATCH, LR = 262_144, 3, 4096, 5e-3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default="xdeepfm")
    ap.add_argument("--vocab", type=int, default=1000, help="ids a field")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card (raises without one)")
    args = ap.parse_args(argv)

    from ..features.synthetic import make_criteo_like
    from ..models import get_model
    from ..train.loop import fit, train_test_split

    torch.backends.cuda.matmul.allow_tf32 = False
    fs, data = make_criteo_like(n_rows=ROWS, vocab_size=args.vocab, seed=0)
    tr, te = train_test_split(data, 0.2, seed=1)
    model = get_model(args.model, fs, device=args.device,
                      generator=torch.Generator().manual_seed(0))
    _, res = fit(model, tr, epochs=EPOCHS, batch_size=BATCH, learning_rate=LR,
                 eval_data=te, seed=0, eval_every=-(-len(tr["label"]) // BATCH),
                 restore_best=False)
    print(f"{args.model} vocab {args.vocab} rows {ROWS} B {BATCH} lr {LR}: "
          f"held-out AUC by epoch {res.history.series('auc')}, streaming train "
          f"AUC {res.train_metrics['auc']:.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
