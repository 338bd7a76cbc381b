"""Train and eval steps and the host-side fit loop of the port.

Counterpart of ``ml_function_tpu/train/loop.py``. The loss is the
reference's

    loss = weighted mean BCE(logits, labels) + Σ aux losses

with the ``weight`` mask of the padded tail batch. Where the reference
threads a ``TrainState`` pytree through jitted steps, the port keeps the
parameters in the model, the optimizer state in a bound optimizer
(``optimizers.OptimizerSpec.init``) and the update count on it; a step is
forward, ``backward()`` and the optimizer's update, on the model's device.
The model is never moved: batches go to its device, as ``Model.forward``
does.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch

from ..bridge import params_from_numpy, state_from_numpy
from ..models.base import as_tensors
from ..ops.embedding import has_int8_tables
from .control import EarlyStopping, History, MetricMonitor, ReduceLROnPlateau
from .metrics import (bce_with_logits, calibration, gauc, init_metrics,
                      metrics_summary, update_metrics)
from .optimizers import OptimizerSpec, make_optimizer, set_learning_rate


@dataclass
class TrainState:
    """What ``fit`` trained: the model (its parameters and running state,
    in place), its bound optimizer, the number of steps taken and the
    ``torch.Generator`` the steps draw from, if any (the reference's
    ``rng``); ``train/checkpoint.py`` saves and restores all of them."""
    model: torch.nn.Module
    optimizer: Any
    step: int
    rng: Optional[torch.Generator] = None


def _device(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


to_device = as_tensors


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def loss_fn(model, batch: Mapping[str, Any], train: bool = True):
    """(total, (logits, state, aux, bce)) for one batch already on the
    model's device."""
    logits, new_state, aux = model(batch, train=train)
    w = batch.get("weight")
    per_ex = bce_with_logits(logits, batch["label"])
    if w is not None:
        bce = (per_ex * w).sum() / torch.clamp_min(w.sum(), 1.0)
    else:
        bce = per_ex.mean()
    total = bce + sum(aux.values()) if aux else bce
    return total, (logits, new_state, aux, bce)


def make_train_step(model, optimizer):
    """``train_step(batch) -> {"loss", "bce", "logits", "label"}``: forward,
    loss, backward and one update of ``optimizer`` (bound to ``model``)."""
    if has_int8_tables(model):
        raise ValueError("a model with int8 serving tables cannot train")
    dev = _device(model)

    def train_step(batch):
        batch = to_device(batch, dev)
        optimizer.zero_grad(set_to_none=True)
        total, (logits, _, _, bce) = loss_fn(model, batch)
        total.backward()
        optimizer.step()
        return {"loss": total.detach(), "bce": bce.detach(),
                "logits": logits.detach(), "label": batch["label"]}

    return train_step


def make_eval_step(model):
    """``eval_step(metrics, batch) -> (metrics, logits)`` without gradients."""
    dev = _device(model)

    @torch.no_grad()
    def eval_step(metrics, batch):
        batch = to_device(batch, dev)
        logits, _, _ = model(batch, train=False)
        return update_metrics(metrics, logits, batch["label"],
                              batch.get("weight")), logits

    return eval_step


# ---------------------------------------------------------------------------
# host-side data iteration (static shapes, weighted tail batch)


def prefetch(iterator: Iterator, size: int = 2) -> Iterator:
    """Background-thread prefetch: overlaps host batch marshalling with
    device steps."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=size)
    sentinel = object()

    def producer():
        try:
            for item in iterator:
                q.put(item)
        finally:
            q.put(sentinel)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is sentinel:
            return
        yield item


def iter_batches(data: Dict[str, Any], batch_size: int, *, shuffle: bool = False,
                 seed: int = 0, drop_last: bool = False,
                 pad_last: bool = True) -> Iterator[Dict[str, Any]]:
    """Yield static-shape batches from a dict-of-arrays dataset.

    ``data`` maps name → (N, …) array, with ``seq`` an optional sub-dict.
    The tail batch is padded to ``batch_size`` with copies of row 0 and a
    ``weight`` vector marks the real rows (every batch carries ``weight``).
    """
    n = len(data["label"])
    idx = np.arange(n)
    if shuffle:
        np.random.default_rng(seed).shuffle(idx)

    for start in range(0, n, batch_size):
        sl = idx[start:start + batch_size]
        actual = len(sl)
        if actual < batch_size:
            if drop_last or not pad_last:
                return
            sl = np.concatenate([sl, np.zeros(batch_size - actual, np.int64)])
        batch = {}
        for k, v in data.items():
            if k == "seq":
                batch["seq"] = {name: a[sl] for name, a in v.items()}
            else:
                batch[k] = v[sl]
        w = np.zeros(batch_size, np.float32)
        w[:actual] = 1.0
        batch["weight"] = w
        yield batch


def train_test_split(data: Dict[str, Any], test_frac: float = 0.2,
                     seed: int = 0) -> Tuple[Dict, Dict]:
    """Index split with the reference's permutation, so both packages split
    a dataset the same way."""
    n = len(data["label"])
    idx = np.random.default_rng(seed).permutation(n)
    cut = int(n * (1 - test_frac))
    tr_idx, te_idx = idx[:cut], idx[cut:]

    def sel(d, ix):
        out = {}
        for k, v in d.items():
            out[k] = sel(v, ix) if isinstance(v, dict) else v[ix]
        return out

    return sel(data, tr_idx), sel(data, te_idx)


def evaluate(model, data: Dict[str, Any], batch_size: int = 256,
             group_key: str = "group") -> Dict[str, float]:
    """Eval summary over ``data``: streaming AUC, logloss and count, and,
    when the data carries a ``group`` column, GAUC and calibration (ratio
    and ECE)."""
    has_group = group_key in data
    step = make_eval_step(model)
    em = init_metrics(device=_device(model))
    probs, labels, groups = [], [], []
    for b in iter_batches(data, batch_size):
        em, logits = step(em, b)
        if has_group:
            keep = b["weight"] > 0           # drop tail padding
            probs.append(torch.sigmoid(logits).cpu().numpy()[keep])
            labels.append(np.asarray(b["label"])[keep])
            groups.append(np.asarray(b[group_key])[keep])
    summ = metrics_summary(em)
    if has_group:
        p = np.concatenate(probs)
        y = np.concatenate(labels)
        g, used = gauc(y, p, np.concatenate(groups))
        summ["gauc"] = float(g)
        summ["gauc_groups"] = float(used)
        summ.update(calibration(y, p))      # 'ratio' + 'ece'
    return summ


@dataclass
class FitResult:
    train_metrics: Dict[str, float]
    eval_metrics: Dict[str, float]
    steps: int
    examples_per_sec: float
    # eval-driven training control (train/control.py):
    history: Any = None            # History of periodic evals (or None)
    best_step: int = -1            # step of the best monitored eval
    stopped_early: bool = False    # early stopping fired


def fit(model, data: Dict[str, Any], *, epochs: int = 1,
        batch_size: int = 256, learning_rate: float = 1e-3,
        optimizer: Optional[OptimizerSpec] = None,
        eval_data: Optional[Dict[str, Any]] = None, seed: int = 0,
        log_every: int = 0, verbose: bool = False,
        steps_per_call: int = 1,
        init_params=None,
        eval_every: int = 0, patience: int = 0, monitor: str = "auc",
        min_delta: float = 0.0, restore_best: Optional[bool] = None,
        plateau: Optional[Dict[str, Any]] = None
        ) -> Tuple[TrainState, FitResult]:
    """Train ``model`` in place on its device; the reference's ``fit``.

    - batches: ``iter_batches`` shuffled with ``seed + epoch``;
    - ``optimizer``: an ``OptimizerSpec`` (default Adam at
      ``learning_rate``), bound here to the model's parameters;
    - ``init_params=(params, model_state)`` warm-starts from nested dicts
      of arrays by key path (``bridge.params_from_numpy`` and
      ``state_from_numpy``; the JAX package's parameters and BatchNorm
      state after ``np.asarray``), with a fresh optimizer;
    - ``steps_per_call`` runs the same single steps in order (the reference
      chains them to amortise the TPU's dispatch), so the result equals the
      unchained run; the examples/s timer then leaves out the first group;
    - examples/s leaves out the first step, which builds the kernels;
    - eval-driven control: ``eval_every`` steps between evals over
      ``eval_data`` (once per epoch when ``patience``/``plateau`` are set),
      early stopping after ``patience`` evals without a ``min_delta`` gain
      in ``monitor``, ``restore_best`` (default True under control) puts
      the best eval's parameters back, and ``plateau`` =
      dict(factor=, patience=, min_lr=, cooldown=) reduces the LR, which
      needs an optimizer built with ``inject_lr=True`` (built so when
      ``optimizer`` is None).
    """
    control = bool(patience or plateau or (eval_every and
                                           eval_data is not None))
    if control and steps_per_call > 1:
        raise ValueError("training control (eval_every/patience/plateau) "
                         "is unsupported with steps_per_call > 1 — chained "
                         "steps cannot stop mid-dispatch")
    if control and eval_data is None:
        raise ValueError("patience/plateau need eval_data to monitor")
    if init_params is not None:
        p0, s0 = init_params
        params_from_numpy(model, p0)
        if s0:
            state_from_numpy(model, s0)
    spec = optimizer or make_optimizer("adam", learning_rate,
                                       inject_lr=bool(plateau))
    opt = spec.init(model)
    if plateau and not getattr(opt, "injected", False):
        # fail now, not when the first LR reduction fires
        raise ValueError(
            "fit(plateau=...) needs an optimizer built with inject_lr=True "
            "(make_optimizer(..., inject_lr=True)) so the host can retune "
            "the LR")
    dev = _device(model)
    train_step = make_train_step(model, opt)

    stopper = history = reducer = best_tracker = None
    best = None  # a copy of the parameters at the best eval
    if control:
        history = History()
        best_tracker = MetricMonitor(monitor, min_delta=min_delta)
        if patience:
            stopper = EarlyStopping(patience, monitor, min_delta=min_delta)
        if plateau:
            reducer = ReduceLROnPlateau(base_lr=learning_rate,
                                        monitor=monitor,
                                        min_delta=min_delta, **plateau)
        if not eval_every:
            eval_every = -(-len(data["label"]) // batch_size)  # per epoch
        if restore_best is None:
            restore_best = True

    metrics = init_metrics(device=dev)
    warm = max(1, steps_per_call)   # steps the timer leaves out
    steps = 0
    n_examples = 0
    t0 = None
    stopped = False
    for epoch in range(epochs):
        for batch in prefetch(iter_batches(data, batch_size, shuffle=True,
                                           seed=seed + epoch)):
            out = train_step(batch)
            metrics = update_metrics(metrics, out["logits"], out["label"],
                                     torch.as_tensor(batch["weight"], device=dev))
            steps += 1
            if steps == warm:
                _sync(dev)
                t0 = time.perf_counter()
            elif steps > warm:
                n_examples += batch_size
            if log_every and steps % log_every == 0 and verbose:
                print(f"step {steps} loss {float(out['loss']):.4f}")
            if control and steps % eval_every == 0:
                summ = evaluate(model, eval_data, batch_size=batch_size)
                extra = {}
                if reducer is not None:
                    new_lr = reducer.update(summ[monitor], steps)
                    if new_lr is not None:
                        set_learning_rate(opt, new_lr)
                    extra["lr"] = reducer.lr
                history.append(steps, summ, **extra)
                if verbose:
                    print(f"eval @ step {steps}: {summ}"
                          + (f" lr={extra.get('lr')}" if extra else ""))
                if best_tracker.improved(summ[monitor], steps):
                    best = {k: v.detach().clone()
                            for k, v in model.state_dict().items()}
                if stopper is not None and stopper.update(summ[monitor],
                                                         steps):
                    stopped = True
                    break
        if stopped:
            break
    _sync(dev)
    dt = (time.perf_counter() - t0) if t0 else float("inf")
    eps = n_examples / dt if dt > 0 else 0.0

    if control and restore_best and best is not None:
        model.load_state_dict(best)

    ev = {}
    if eval_data is not None:
        ev = evaluate(model, eval_data, batch_size=batch_size)
    return TrainState(model, opt, steps), FitResult(
        train_metrics=metrics_summary(metrics), eval_metrics=ev, steps=steps,
        examples_per_sec=eps, history=history,
        best_step=best_tracker.best_step if best_tracker else -1,
        stopped_early=stopped)
