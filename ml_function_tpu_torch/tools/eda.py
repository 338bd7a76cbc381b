"""CTR EDA: aggregation tables + headless PNG plots.

A copy of ``ml_function_tpu/tools/eda.py`` in the port (pandas and
sklearn on the host; nothing of it runs on the card).

Counterpart of the reference's ``feature_tool.ctr_eda`` suite
(``kon/model/feature_eng/feature_transform.py:110-235``), which draws an
hour-of-day CVR heatmap, per-day CVR / data-count bars, and per-user
search/download curves straight to ``plt.show()``. Here every function
returns the aggregated DataFrame (usable headless / in tests) and only
renders when ``save_path`` is given; rendering rules: one hue for magnitude
(sequential colormap, never rainbow), one y-axis per panel (the reference's
combined count+cvr overlay becomes stacked panels sharing the x-axis),
recessive grid.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

try:  # pandas is a hard dep of the tools layer (as in the reference)
    import pandas as pd
except ImportError:  # pragma: no cover
    pd = None

_HUE = "#4c78a8"  # single categorical-neutral blue; magnitude uses "Blues"


def _ax_style(ax):
    ax.grid(True, axis="y", alpha=0.25, linewidth=0.5)
    ax.set_axisbelow(True)
    for side in ("top", "right"):
        ax.spines[side].set_visible(False)


def _save(fig, save_path: str):
    fig.tight_layout()
    fig.savefig(save_path, dpi=120)
    import matplotlib.pyplot as plt
    plt.close(fig)


def rate_by_category(df, col: str, label_col: str = "label",
                     save_path: Optional[str] = None,
                     min_count: int = 1):
    """Per-category positive rate + count (reference day-cvr bars,
    feature_transform.py:152-163). Returns DataFrame[col, count, rate]."""
    g = df.groupby(col)[label_col].agg(count="size", rate="mean").reset_index()
    g = g[g["count"] >= min_count]
    if save_path:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        fig, ax = plt.subplots(figsize=(10, 4))
        ax.bar(g[col].astype(str), g["rate"], color=_HUE, width=0.7)
        ax.set_xlabel(col)
        ax.set_ylabel(f"{label_col} rate")
        ax.set_title(f"{label_col} rate by {col}")
        _ax_style(ax)
        if len(g) > 30:
            ax.tick_params(axis="x", labelrotation=90, labelsize=6)
        _save(fig, save_path)
    return g


def rate_heatmap(df, row_col: str, col_col: str, label_col: str = "label",
                 save_path: Optional[str] = None):
    """2-D positive-rate pivot (reference hour-of-day CVR heatmap,
    feature_transform.py:118-128). Returns the pivot DataFrame."""
    pv = df.pivot_table(index=row_col, columns=col_col, values=label_col,
                        aggfunc="mean")
    if save_path:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        fig, ax = plt.subplots(figsize=(10, 5))
        im = ax.imshow(pv.to_numpy(), aspect="auto", cmap="Blues")
        ax.set_xticks(range(len(pv.columns)), [str(c) for c in pv.columns],
                      fontsize=6)
        ax.set_yticks(range(len(pv.index)), [str(i) for i in pv.index],
                      fontsize=6)
        ax.set_xlabel(col_col)
        ax.set_ylabel(row_col)
        ax.set_title(f"{label_col} rate: {row_col} × {col_col}")
        fig.colorbar(im, ax=ax, label=f"{label_col} rate")
        _save(fig, save_path)
    return pv


def activity_curve(df, entity_col: str, save_path: Optional[str] = None):
    """Per-entity event counts, sorted descending (reference user-search /
    user-download curves, feature_transform.py:176-199). Returns Series."""
    counts = df.groupby(entity_col).size().sort_values(ascending=False)
    if save_path:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        fig, ax = plt.subplots(figsize=(10, 4))
        ax.plot(np.arange(len(counts)), counts.to_numpy(), color=_HUE,
                linewidth=2)
        ax.set_xlabel(f"{entity_col} (rank)")
        ax.set_ylabel("events")
        ax.set_yscale("log")
        ax.set_title(f"activity per {entity_col}")
        _ax_style(ax)
        _save(fig, save_path)
    return counts


def time_panel(df, time_col: str, label_col: str = "label",
               save_path: Optional[str] = None):
    """Stacked count + rate panels over a time bucket (reference's combined
    search/cvr/download overlay, feature_transform.py:201-224 — rebuilt as
    TWO single-axis panels sharing x instead of a multi-scale overlay).
    Returns DataFrame[time, count, rate]."""
    g = (df.groupby(time_col)[label_col]
         .agg(count="size", rate="mean").reset_index()
         .sort_values(time_col))
    if save_path:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        fig, (ax1, ax2) = plt.subplots(2, 1, figsize=(10, 6), sharex=True)
        x = g[time_col].to_numpy()
        ax1.bar(x, g["count"], color=_HUE, width=0.7)
        ax1.set_ylabel("events")
        ax2.plot(x, g["rate"], color=_HUE, linewidth=2)
        ax2.set_ylabel(f"{label_col} rate")
        ax2.set_xlabel(time_col)
        for ax in (ax1, ax2):
            _ax_style(ax)
        ax1.set_title(f"volume and {label_col} rate by {time_col}")
        _save(fig, save_path)
    return g


def eda_report(df, *, time_col: Optional[str] = None,
               entity_col: Optional[str] = None,
               category_cols: Sequence[str] = (),
               label_col: str = "label", out_dir: Optional[str] = None):
    """One-call EDA over a CTR frame (reference ``ctr_eda`` entry point).
    Returns {name: aggregation}; writes PNGs under ``out_dir`` if given."""
    import os
    out = {}

    def path(name):
        return os.path.join(out_dir, f"{name}.png") if out_dir else None

    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    if time_col is not None:
        out["time_panel"] = time_panel(df, time_col, label_col,
                                       path("time_panel"))
    if entity_col is not None:
        out["activity"] = activity_curve(df, entity_col, path("activity"))
    for c in category_cols:
        out[f"rate_by_{c}"] = rate_by_category(df, c, label_col,
                                               path(f"rate_by_{c}"))
    if time_col is not None and category_cols:
        out["heatmap"] = rate_heatmap(df, category_cols[0], time_col,
                                      label_col, path("heatmap"))
    return out
