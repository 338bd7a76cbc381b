"""GBDT baseline / feature-filter harness.

A copy of ``ml_function_tpu/tools/gbdt.py`` in the port (pandas and
sklearn on the host; nothing of it runs on the card).

Counterpart of the reference's LightGBM ``base_model``
(``kon/model/feature_eng/base_model.py:31-239``): stratified k-fold fit with
early stopping + AUC eval (:144-182, :43-53), F1-threshold evaluation
(:68-85), out-of-fold + test prediction blending (:96-141), feature
importances and zero-importance filtering (:58-63, :180), timestamped
submission export (:184-208), and the ``fit_transform`` entry (:210-224).

Backend: sklearn ``HistGradientBoostingClassifier`` (LightGBM-style
histogram GBDT). The harness API is
backend-agnostic — pass any estimator factory.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

try:
    import pandas as pd
except Exception:  # pragma: no cover
    pd = None

from sklearn.ensemble import HistGradientBoostingClassifier
from sklearn.inspection import permutation_importance
from sklearn.metrics import f1_score, roc_auc_score
from sklearn.model_selection import StratifiedKFold


def default_estimator(**kw):
    params = dict(max_iter=300, learning_rate=0.1, max_leaf_nodes=31,
                  early_stopping=True, validation_fraction=0.1,
                  n_iter_no_change=30, random_state=0)
    params.update(kw)
    return HistGradientBoostingClassifier(**params)


@dataclass
class GBDTModel:
    n_folds: int = 10                       # reference: 10-fold (:147)
    threshold_quantile: float = 0.103       # reference F1 threshold (:78-84)
    estimator_factory: Callable = default_estimator
    estimator_kw: Dict = field(default_factory=dict)
    models_: List = field(default_factory=list)
    fold_aucs_: List[float] = field(default_factory=list)
    importances_: Optional[np.ndarray] = None
    feature_names_: Optional[List[str]] = None

    # ---- core k-fold fit (reference n_fold_fit, :144-182) ---------------

    def fit(self, x, y, feature_names: Optional[Sequence[str]] = None):
        x = np.asarray(x, np.float32)
        y = np.asarray(y).astype(int)
        self.models_, self.fold_aucs_ = [], []
        skf = StratifiedKFold(self.n_folds, shuffle=True, random_state=0)
        oof = np.zeros(len(y), np.float64)
        for tr, va in skf.split(x, y):
            m = self.estimator_factory(**self.estimator_kw)
            m.fit(x[tr], y[tr])
            p = m.predict_proba(x[va])[:, 1]
            oof[va] = p
            self.fold_aucs_.append(roc_auc_score(y[va], p))
            self.models_.append(m)
        self.oof_ = oof
        self.feature_names_ = (list(feature_names) if feature_names
                               else [f"f{i}" for i in range(x.shape[1])])
        return self

    # ---- prediction blending (reference avg_model_pred, :96-141) --------

    def predict_proba(self, x, weights: Optional[Sequence[float]] = None
                      ) -> np.ndarray:
        """AUC-weighted average of per-fold predictions."""
        x = np.asarray(x, np.float32)
        w = np.asarray(weights if weights is not None else self.fold_aucs_,
                       np.float64)
        w = w / w.sum()
        out = np.zeros(len(x), np.float64)
        for wi, m in zip(w, self.models_):
            out += wi * m.predict_proba(x)[:, 1]
        return out

    # ---- evaluation ------------------------------------------------------

    def auc(self, y) -> float:
        return float(roc_auc_score(np.asarray(y).astype(int), self.oof_))

    def f1_at_threshold(self, y, proba: Optional[np.ndarray] = None) -> float:
        """Top-q% cut F1 (reference eval_fun, :68-85: threshold at the
        prediction quantile so positives rate ≈ threshold_quantile)."""
        p = self.oof_ if proba is None else proba
        cut = np.quantile(p, 1.0 - self.threshold_quantile)
        return float(f1_score(np.asarray(y).astype(int), (p >= cut).astype(int)))

    # ---- importance + filtering (reference :58-63, :180) ----------------

    def feature_importance(self, x, y, n_repeats: int = 3) -> np.ndarray:
        m = self.models_[0]
        r = permutation_importance(m, np.asarray(x, np.float32),
                                   np.asarray(y).astype(int),
                                   n_repeats=n_repeats, random_state=0,
                                   scoring="roc_auc")
        self.importances_ = r.importances_mean
        return self.importances_

    def useless_features(self, x, y, tol: float = 0.0) -> List[str]:
        imp = (self.importances_ if self.importances_ is not None
               else self.feature_importance(x, y))
        return [n for n, v in zip(self.feature_names_, imp) if v <= tol]

    # ---- export (reference :184-208) ------------------------------------

    def export_submission(self, ids, proba, out_dir: str = ".",
                          id_name: str = "id", target_name: str = "target"
                          ) -> str:
        if pd is None:
            raise RuntimeError("pandas required for export")
        path = os.path.join(out_dir,
                            f"submission_{time.strftime('%Y%m%d_%H%M%S')}.csv")
        pd.DataFrame({id_name: ids, target_name: proba}).to_csv(path,
                                                                index=False)
        return path

    # ---- one-call entry (reference fit_transform, :210-224) -------------

    def fit_transform(self, x_train, y_train, x_test
                      ) -> Tuple[np.ndarray, float]:
        self.fit(x_train, y_train)
        return self.predict_proba(x_test), self.auc(y_train)


def adversarial_validation(train_x, test_x, auc_bar: float = 0.65) -> Tuple[float, bool]:
    """Train/test distribution-shift check (reference
    ``feature_transform.py:382-394``): classifier separating train from test;
    AUC < bar ⇒ distributions agree."""
    x = np.concatenate([np.asarray(train_x, np.float32),
                        np.asarray(test_x, np.float32)])
    y = np.concatenate([np.zeros(len(train_x)), np.ones(len(test_x))])
    m = default_estimator(max_iter=100)
    order = np.random.default_rng(0).permutation(len(x))
    cut = int(len(x) * 0.8)
    m.fit(x[order[:cut]], y[order[:cut]])
    auc = roc_auc_score(y[order[cut:]], m.predict_proba(x[order[cut:]])[:, 1])
    return float(auc), bool(auc < auc_bar)


@dataclass
class GBDTLRModel:
    """GBDT+LR stacking (He et al., ADKDD 2014 — "[GBDT+LR] Practical
    Lessons from Predicting Clicks on Ads at Facebook" on the reference's
    Next-Read shelf, paper/Next Read/).

    Boosted trees as a feature transform: each example maps to the one-hot of
    the leaf it lands in per tree; a sparse logistic regression over those
    leaf indicators produces the final CTR. The classic pre-deep-learning
    production CTR stack, useful here as a strong calibrated baseline and as
    a leaf-feature generator for the deep models.
    """

    n_estimators: int = 100
    max_depth: int = 3
    learning_rate: float = 0.1
    lr_c: float = 1.0

    def fit(self, x, y):
        from sklearn.ensemble import GradientBoostingClassifier
        from sklearn.linear_model import LogisticRegression
        from sklearn.preprocessing import OneHotEncoder

        x = np.asarray(x, np.float32)
        y = np.asarray(y).astype(int)
        self.gbdt_ = GradientBoostingClassifier(
            n_estimators=self.n_estimators, max_depth=self.max_depth,
            learning_rate=self.learning_rate, random_state=0)
        self.gbdt_.fit(x, y)
        leaves = self.gbdt_.apply(x)[:, :, 0].astype(np.int64)
        self.encoder_ = OneHotEncoder(handle_unknown="ignore")
        feats = self.encoder_.fit_transform(leaves)
        self.lr_ = LogisticRegression(C=self.lr_c, max_iter=1000)
        self.lr_.fit(feats, y)
        return self

    def transform(self, x):
        """Leaf one-hot features (n, Σ leaves/tree) — usable as extra deep
        inputs too."""
        leaves = self.gbdt_.apply(np.asarray(x, np.float32))[:, :, 0]
        return self.encoder_.transform(leaves.astype(np.int64))

    def predict_proba(self, x) -> np.ndarray:
        return self.lr_.predict_proba(self.transform(x))[:, 1]

    def auc(self, x, y) -> float:
        return float(roc_auc_score(np.asarray(y).astype(int),
                                   self.predict_proba(x)))
