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

Where the reference scans K steps over a stacked group inside one jit
(``make_chained_train_step``), the port captures K steps into one CUDA graph
and replays it once a group (``ChainedTrainStep``); on the CPU the same K
steps run one after another.
"""

from __future__ import annotations

import os
import time
import traceback
from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, Mapping, Optional, Tuple

import numpy as np
import torch

from ..bridge import params_from_numpy, state_from_numpy
from ..models.base import as_tensors
from ..ops.embedding import has_int8_tables
from ..ops.kernels import launches
from .control import EarlyStopping, History, MetricMonitor, ReduceLROnPlateau
from .metrics import (MetricState, bce_with_logits, calibration, gauc,
                      init_metrics, metrics_summary, update_metrics,
                      update_metrics_)
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


def stack_batches(batches) -> Dict[str, Any]:
    """K same-shape batch dicts (``seq`` a nested dict) → one (K, …)-stacked
    group of numpy arrays, the reference's ``stack_batches``."""
    return {k: stack_batches([b[k] for b in batches]) if isinstance(v, Mapping)
            else np.stack([np.asarray(b[k]) for b in batches])
            for k, v in batches[0].items()}


def _index(group: Mapping[str, Any], i: int) -> Dict[str, Any]:
    return {k: _index(v, i) if isinstance(v, Mapping) else v[i]
            for k, v in group.items()}


def _shapes(group: Mapping[str, Any]) -> Dict[str, Any]:
    return {k: _shapes(v) if isinstance(v, Mapping) else (tuple(v.shape), v.dtype)
            for k, v in group.items()}


def _copy(dst: Dict[str, Any], src: Mapping[str, Any], non_blocking: bool) -> None:
    for k, buf in dst.items():
        if isinstance(buf, dict):
            _copy(buf, src[k], non_blocking)
        else:
            buf.copy_(src[k], non_blocking=non_blocking)


class ChainedTrainStep:
    """K train steps a call over a (K, B, …) group (``stack_batches``), the
    reference's ``make_chained_train_step``: ``step(group) -> {"loss": (K,),
    "logits": (K, B), "label": (K, B), "weight": (K, B) or None}``, each step
    the single step of ``make_train_step`` (the same code, so the two round
    alike), its outputs folded into ``metrics`` in place when given.

    On the card the group is first copied into fixed device buffers
    (``_stage``), then:
    the first group runs as eager steps on a side stream (real steps, which
    build and load the kernels, set their attributes and make cuBLAS's and
    autograd's state); the second is captured as K steps into one CUDA graph
    (gradients set to None first, so that the backward allocates them from
    the graph's pool), which is then replayed; every later group is one copy
    into the buffers and one replay. The optimizer keeps its count, its
    schedule's LR and its state on the device and updates them in place, and
    the metric fold adds into fixed buffers, so a replay reads and writes
    what the steps did. A capture that fails raises, naming the line that
    broke it; it never falls back to eager steps. The kernels' launch
    counters (``ops/kernels/launches.py``) move by the capture's count at
    every replay and not at the capture. On the CPU the K steps run one after
    another: the plain version of the graph.
    """

    def __init__(self, model, optimizer, chain: int,
                 metrics: Optional[MetricState] = None):
        if chain < 1:
            raise ValueError(f"a chain of {chain} steps")
        self.chain = chain
        self.metrics = metrics
        self.device = _device(model)
        self.step_one = make_train_step(model, optimizer)
        self.optimizer = optimizer
        self.groups = 0        # full groups taken
        self.graph = None
        self.launches: launches.Counts = {}   # the kernels a replay launches
        self._inputs = self._outputs = self._layout = self._pinned = self._copied = None
        # the side stream of the eager group and the capture
        self._stream = (torch.cuda.Stream(self.device) if self.device.type == "cuda"
                        else None)

    def _run(self, group: Mapping[str, Any], write) -> None:
        for i in range(self.chain):
            batch = _index(group, i)
            out = self.step_one(batch)
            if self.metrics is not None:
                update_metrics_(self.metrics, out["logits"], out["label"],
                                batch.get("weight"))
            write(i, out)

    def __call__(self, group: Mapping[str, Any]) -> Dict[str, Any]:
        if len(group["label"]) != self.chain:
            raise ValueError(f"a group of {len(group['label'])} batches for a "
                             f"chain of {self.chain}")
        if self.device.type != "cuda":
            group = as_tensors(group, self.device)
            outs: List[Dict[str, torch.Tensor]] = []
            self._run(group, lambda i, out: outs.append(out))
            self.groups += 1
            return {"loss": torch.stack([o["loss"] for o in outs]),
                    "logits": torch.stack([o["logits"] for o in outs]),
                    "label": group["label"], "weight": group.get("weight")}
        self._stage(group)
        if self.groups == 0:
            self._eager()
        else:
            if self.graph is None:
                self._capture()
            self.graph.replay()
            launches.add(self.launches)
        self.groups += 1
        out = {k: v.clone() for k, v in self._outputs.items()}
        weight = self._inputs.get("weight")
        return {**out, "label": self._inputs["label"].clone(),
                "weight": None if weight is None else weight.clone()}

    def _stage(self, group: Mapping[str, Any]) -> None:
        """The group into the fixed device buffers through one of two pinned
        host copies, taken in turn: a host copy into it (once its last copy
        to the card has run), then one non-blocking copy a field to the
        card (a copy from pageable memory makes the host wait, and pinning
        a fresh copy each group allocates)."""
        host = as_tensors(group, torch.device("cpu"))
        if self._inputs is None:
            self._layout = _shapes(host)
            self._inputs = _like(host, self.device)
            self._pinned = [_like(host, torch.device("cpu"), pin=True) for _ in range(2)]
            self._copied = [None, None]
        elif _shapes(host) != self._layout:
            raise ValueError("a chained step takes groups of one shape and type")
        turn = self.groups % 2
        if self._copied[turn] is not None:
            self._copied[turn].synchronize()
        _copy(self._pinned[turn], host, non_blocking=False)
        _copy(self._inputs, self._pinned[turn], non_blocking=True)
        self._copied[turn] = torch.cuda.Event()
        self._copied[turn].record()

    def _write(self, i: int, out: Dict[str, torch.Tensor]) -> None:
        if self._outputs is None:
            self._outputs = {k: out[k].new_empty((self.chain, *out[k].shape))
                             for k in ("loss", "logits")}
        self._outputs["loss"][i].copy_(out["loss"])
        self._outputs["logits"][i].copy_(out["logits"])

    def _eager(self) -> None:
        cur = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(cur)
        with torch.cuda.stream(self._stream):
            self._run(self._inputs, self._write)
        cur.wait_stream(self._stream)

    def _capture(self) -> None:
        self.optimizer.zero_grad(set_to_none=True)
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()
        before = launches.snapshot()
        graph = torch.cuda.CUDAGraph()
        failed = None
        with torch.cuda.stream(self._stream):
            graph.capture_begin(capture_error_mode="global")
            try:
                self._run(self._inputs, self._write)
            except Exception as err:     # re-raised below, once capture has ended
                failed = err
            try:
                graph.capture_end()
            except RuntimeError as err:
                failed = failed or err
        # the capture ran nothing: its launches count at each replay
        self.launches = launches.since(before)
        launches.add(self.launches, -1)
        if failed is not None:
            raise RuntimeError(f"chained train step: capturing {self.chain} steps "
                               f"into a CUDA graph failed at {_culprit(failed)}: "
                               f"{failed}") from failed
        self.graph = graph


def _like(group: Dict[str, Any], device, pin: bool = False) -> Dict[str, Any]:
    return {k: _like(v, device, pin) if isinstance(v, dict)
            else torch.empty(v.shape, dtype=v.dtype, device=device, pin_memory=pin)
            for k, v in group.items()}


def _culprit(err: BaseException) -> str:
    """The innermost line outside PyTorch that the error came through."""
    torch_dir = os.path.dirname(torch.__file__)
    frames = [f for f in traceback.extract_tb(err.__traceback__)
              if not f.filename.startswith(torch_dir)]
    if not frames:
        return "an operation of the step"
    f = frames[-1]
    return f"{f.filename}:{f.lineno} ({f.line})"


def make_chained_train_step(model, optimizer, chain: int,
                            metrics: Optional[MetricState] = None
                            ) -> ChainedTrainStep:
    """K = ``chain`` train steps a call over a stacked group; see
    ``ChainedTrainStep``."""
    return ChainedTrainStep(model, optimizer, chain, metrics)


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


def _batch_rows(n: int, batch_size: int, shuffle: bool, seed: int,
                drop_last: bool = False, pad_last: bool = True):
    """Each batch's row indices and its count of real rows: the tail padded
    with row 0 to ``batch_size``, or dropped."""
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
        yield sl, actual


def _take(data: Dict[str, Any], rows: np.ndarray, shape) -> Dict[str, Any]:
    """``data``'s rows, each field reshaped to ``shape`` + its row's shape."""
    return {k: _take(v, rows, shape) if k == "seq"
            else v[rows].reshape(*shape, *v.shape[1:]) for k, v in data.items()}


def _weight(actual: int, batch_size: int) -> np.ndarray:
    w = np.zeros(batch_size, np.float32)
    w[:actual] = 1.0
    return w


def iter_batches(data: Dict[str, Any], batch_size: int, *, shuffle: bool = False,
                 seed: int = 0, drop_last: bool = False,
                 pad_last: bool = True) -> Iterator[Dict[str, Any]]:
    """Yield static-shape batches from a dict-of-arrays dataset.

    ``data`` maps name → (N, …) array, with ``seq`` an optional sub-dict.
    The tail batch is padded to ``batch_size`` with copies of row 0 and a
    ``weight`` vector marks the real rows (every batch carries ``weight``).
    """
    for sl, actual in _batch_rows(len(data["label"]), batch_size, shuffle, seed,
                                  drop_last, pad_last):
        yield {**_take(data, sl, (batch_size,)), "weight": _weight(actual, batch_size)}


def iter_groups(data: Dict[str, Any], batch_size: int, k: int, *,
                shuffle: bool = False, seed: int = 0) -> Iterator[Tuple[str, Dict[str, Any]]]:
    """``iter_batches``' batches, ``k`` at a time: ``("group", g)`` with ``g``
    the ``stack_batches`` of each run of ``k`` of them, gathered with one
    indexing a field, then ``("batch", b)`` for each batch past the last
    full run."""
    rows = list(_batch_rows(len(data["label"]), batch_size, shuffle, seed))
    full = len(rows) // k * k
    for g in range(0, full, k):
        run = rows[g:g + k]
        yield "group", {**_take(data, np.concatenate([sl for sl, _ in run]), (k, batch_size)),
                        "weight": np.stack([_weight(a, batch_size) for _, a in run])}
    for sl, actual in rows[full:]:
        yield "batch", {**_take(data, sl, (batch_size,)),
                        "weight": _weight(actual, batch_size)}


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
    - ``steps_per_call=K`` > 1 trains each full group of K batches through
      one ``ChainedTrainStep`` (``_fit_chained``, the reference's chained
      branch): on the card one CUDA graph replay a group, after an eager
      first group and the capture of the second; the same K steps one
      after another on the CPU. The result equals the unchained run's. A
      partial tail group takes single steps, so no data is dropped.
      Examples/s leaves out the eager and capture groups;
    - otherwise examples/s leaves out the first step, which builds the
      kernels;
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
    metrics = init_metrics(device=dev)
    if steps_per_call > 1:
        return _fit_chained(model, data, opt, metrics, epochs=epochs,
                            batch_size=batch_size, eval_data=eval_data,
                            seed=seed, steps_per_call=steps_per_call)
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

    steps = 0
    n_examples = 0
    t0 = None
    stopped = False
    for epoch in range(epochs):
        for batch in prefetch(iter_batches(data, batch_size, shuffle=True,
                                           seed=seed + epoch)):
            out = train_step(batch)
            update_metrics_(metrics, out["logits"], out["label"],
                            torch.as_tensor(batch["weight"], device=dev))
            steps += 1
            if steps == 1:
                _sync(dev)
                t0 = time.perf_counter()     # leave out the kernels' build
            else:
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


def _fit_chained(model, data, opt, metrics, *, epochs, batch_size, eval_data,
                 seed, steps_per_call) -> Tuple[TrainState, FitResult]:
    """``fit``'s chained branch: each epoch's full groups of
    ``steps_per_call`` batches through one ``ChainedTrainStep`` (the metric
    fold inside it), the partial tail group through single steps, as the
    reference's ``_fit_chained``, the groups gathered whole
    (``iter_groups``). The timer starts after the second group, which the
    card captures (the first runs eagerly)."""
    dev = _device(model)
    chained = make_chained_train_step(model, opt, steps_per_call, metrics)
    train_one = chained.step_one
    steps, n_examples, t0 = 0, 0, None
    for epoch in range(epochs):
        for kind, item in prefetch(iter_groups(data, batch_size, steps_per_call,
                                               shuffle=True, seed=seed + epoch)):
            if kind == "group":
                chained(item)
                steps += steps_per_call
                if chained.groups == 2:
                    _sync(dev)
                    t0 = time.perf_counter()
                elif t0 is not None:
                    n_examples += batch_size * steps_per_call
                continue
            batch = item          # the partial tail group: single steps
            out = train_one(batch)
            update_metrics_(metrics, out["logits"], out["label"],
                            torch.as_tensor(batch["weight"], device=dev))
            steps += 1
            if t0 is not None:
                n_examples += batch_size
    _sync(dev)
    dt = (time.perf_counter() - t0) if t0 else float("inf")
    ev = {}
    if eval_data is not None:
        ev = evaluate(model, eval_data, batch_size=batch_size)
    return TrainState(model, opt, steps), FitResult(
        train_metrics=metrics_summary(metrics), eval_metrics=ev, steps=steps,
        examples_per_sec=n_examples / dt if dt > 0 else 0.0)
