"""TF-IDF + model stacking for text-ish id sequences.

A copy of ``ml_function_tpu/tools/stacking.py`` in the port (pandas and
sklearn on the host; nothing of it runs on the card).

Counterpart of the reference's tfidf + 5-model sklearn stacking
(``kon/model/feature_eng/feature_transform.py:715-774``): vectorize a
behavior-string column with TF-IDF, fit a panel of linear/GBDT models with
out-of-fold predictions, and stack them with a logistic meta-learner. Output
columns slot into the tabular feature set (or the GBDT harness).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
from sklearn.ensemble import HistGradientBoostingClassifier
from sklearn.feature_extraction.text import TfidfVectorizer
from sklearn.linear_model import LogisticRegression, SGDClassifier
from sklearn.metrics import roc_auc_score
from sklearn.model_selection import StratifiedKFold
from sklearn.naive_bayes import MultinomialNB
from sklearn.svm import LinearSVC


def default_panel():
    """The reference stacks LR / SGD / NB / SVC / GBDT-style models
    (feature_transform.py:729-741)."""
    return [
        ("lr", LogisticRegression(max_iter=300)),
        ("sgd", SGDClassifier(loss="log_loss", max_iter=30)),
        ("nb", MultinomialNB()),
        ("svc", LinearSVC(max_iter=500)),
        ("gbdt", HistGradientBoostingClassifier(max_iter=120)),
    ]


@dataclass
class TfidfStacker:
    max_features: int = 20000
    n_folds: int = 5
    panel: Optional[List] = None
    vectorizer_: Optional[TfidfVectorizer] = None
    meta_: Optional[LogisticRegression] = None
    models_: Dict[str, List] = field(default_factory=dict)

    @staticmethod
    def _dense_if_needed(model, x):
        # HistGradientBoosting requires dense input
        if isinstance(model, HistGradientBoostingClassifier):
            return np.asarray(x.todense())
        return x

    def _proba(self, model, x):
        x = self._dense_if_needed(model, x)
        if hasattr(model, "predict_proba"):
            return model.predict_proba(x)[:, 1]
        return model.decision_function(x)

    def fit(self, texts: Sequence[str], y) -> "TfidfStacker":
        y = np.asarray(y).astype(int)
        self.vectorizer_ = TfidfVectorizer(max_features=self.max_features,
                                           token_pattern=r"[^|, ]+")
        x = self.vectorizer_.fit_transform([str(t) for t in texts])
        panel = self.panel or default_panel()
        skf = StratifiedKFold(self.n_folds, shuffle=True, random_state=0)
        oof = np.zeros((len(y), len(panel)))
        self.models_ = {name: [] for name, _ in panel}
        for tr, va in skf.split(x, y):
            for j, (name, proto) in enumerate(panel):
                import copy
                m = copy.deepcopy(proto)
                m.fit(self._dense_if_needed(m, x[tr]), y[tr])
                oof[va, j] = self._proba(m, x[va])
                self.models_[name].append(m)
        self.oof_ = oof
        self.meta_ = LogisticRegression(max_iter=300).fit(oof, y)
        self.oof_auc_ = roc_auc_score(y, self.meta_.predict_proba(oof)[:, 1])
        return self

    def predict_proba(self, texts: Sequence[str]) -> np.ndarray:
        x = self.vectorizer_.transform([str(t) for t in texts])
        feats = np.column_stack([
            np.mean([self._proba(m, x) for m in ms], axis=0)
            for ms in self.models_.values()])
        return self.meta_.predict_proba(feats)[:, 1]
