"""Checkpoint and resume of the port.

Counterpart of ``ml_function_tpu/train/checkpoint.py``, its dense format:
one ``arrays.npz`` of '/'-joined key paths → arrays plus a
``manifest.json`` (step, format, keys, the caller's ``extra``), written to
a temporary directory and renamed into place, the last ``keep`` kept.

A checkpoint holds everything that continues a run, under the reference's
top-level names so that a reader finds each key's counterpart:

- ``params/<path>``: the model's parameters by their JAX key path
  (``bridge.flat_params``);
- ``model_state/<path>``: its running state, BatchNorm's ``mean`` and
  ``var`` buffers (``bridge.state_buffers``);
- ``opt_state/<name>/<path>``: the bound optimizer's per-parameter state
  (Adam's ``mu`` and ``nu``, Adagrad's ``sum_of_squares``, SGD's
  ``trace``, FTRL's ``z`` and ``n``) and its update ``count``, with
  ``hyperparams/learning_rate`` for an optimizer built with
  ``inject_lr=True``; an ``embedding_partitioned`` optimizer nests each
  part under its label (``opt_state/table/sum_of_squares/...``);
- ``step``, and ``rng``: the state of the ``torch.Generator`` the steps
  draw from, where the ``TrainState`` has one.

The port keeps its state in the model and the optimizer, so a restore fills
the template's model and optimizer in place, on the device they live on
(``get_model`` puts them on the card unless given ``device="cpu"``).

``restore_latest`` falls back past a torn newest checkpoint and renames it
``<name>.corrupt``. ``load_jax_checkpoint`` reads a dense checkpoint that
the JAX package wrote (optax's state layout) into a port model and
optimizer, so that the port continues the JAX run. The sharded format
comes with parallelism (ROADMAP.md Queue 1 item 8).
"""

from __future__ import annotations

import json
import os
import re
import shutil
import tempfile
import zipfile
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from ..bridge import flat_params, params_from_numpy, state_buffers
from ..utils.logging import logger
from .loop import TrainState
from .optimizers import OptaxRule, Partitioned

# what a torn or truncated checkpoint raises on reading: a missing file, a
# zip without its central directory, a short member, a bad manifest
_UNREADABLE = (OSError, ValueError, KeyError, EOFError, zipfile.BadZipFile,
               json.JSONDecodeError)
_SHARDED = ("the sharded checkpoint format comes with parallelism "
            "(ROADMAP.md Queue 1 item 8)")


def _parts(optimizer) -> Iterator[Tuple[str, OptaxRule]]:
    """(key prefix, rule) for each bound rule of the optimizer."""
    if isinstance(optimizer, Partitioned):
        for label, rule in optimizer.parts.items():
            yield f"{label}/", rule
    elif optimizer is not None:
        yield "", optimizer


def _rule_params(rule: OptaxRule, names: Dict[int, str]):
    """(JAX key path, parameter) of each parameter the rule updates."""
    for group in rule.param_groups:
        for p in group["params"]:
            yield names[id(p)], p


def _param_names(model) -> Dict[int, str]:
    return {id(p): n.replace(".", "/") for n, p in model.named_parameters()}


def _opt_arrays(model, optimizer) -> Dict[str, np.ndarray]:
    names = _param_names(model)
    out: Dict[str, np.ndarray] = {}
    for prefix, rule in _parts(optimizer):
        out[f"opt_state/{prefix}count"] = np.asarray(rule.count, np.int64)
        if rule.injected:
            out[f"opt_state/{prefix}hyperparams/learning_rate"] = np.asarray(
                rule.param_groups[0]["lr"], np.float32)
        for path, p in _rule_params(rule, names):
            state = rule.state[p]
            if not state:   # not stepped yet: the state its first step makes
                state.update(rule._init(p))
            for k, v in state.items():
                out[f"opt_state/{prefix}{k}/{path}"] = v.detach().cpu().numpy().copy()
    return out


def state_arrays(ts: TrainState) -> Dict[str, np.ndarray]:
    """The checkpoint's flat key → array map of a ``TrainState``."""
    flat = dict(flat_params(ts.model))
    flat.update({"model_state/" + k: v.detach().cpu().numpy().copy()
                 for k, v in state_buffers(ts.model).items()})
    flat.update(_opt_arrays(ts.model, ts.optimizer))
    flat["step"] = np.asarray(ts.step, np.int64)
    if ts.rng is not None:
        flat["rng"] = ts.rng.get_state().numpy().copy()
    return flat


def save_checkpoint(ckpt_dir: str, ts: TrainState, *,
                    extra: Optional[Dict[str, Any]] = None,
                    keep: int = 3, format: Optional[str] = None) -> str:
    """Atomically write a step-stamped checkpoint and keep the last
    ``keep``; returns its path."""
    if format not in (None, "dense"):
        raise NotImplementedError(_SHARDED)
    step = int(ts.step)
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"ckpt_{step:010d}")
    flat = state_arrays(ts)
    tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_")
    try:
        np.savez(os.path.join(tmp, "arrays.npz"), **flat)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump({"step": step, "format": "dense",
                       "keys": sorted(flat), "extra": extra or {}}, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    except Exception:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    for old in all_checkpoints(ckpt_dir)[:-keep]:
        shutil.rmtree(old, ignore_errors=True)
    return final


def all_checkpoints(ckpt_dir: str):
    if not os.path.isdir(ckpt_dir):
        return []
    out = [os.path.join(ckpt_dir, d) for d in os.listdir(ckpt_dir)
           if re.fullmatch(r"ckpt_\d{10}", d)]
    return sorted(out)


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    cks = all_checkpoints(ckpt_dir)
    return cks[-1] if cks else None


def restore_latest(ckpt_dir: str, ts_template: TrainState
                   ) -> Tuple[Optional[TrainState], Dict[str, Any], str]:
    """Restore the newest readable checkpoint into the template, falling
    back to older ones when the newest is torn (a process killed
    mid-write, a truncated file system). Returns ``(ts | None, extra,
    path | '')``; each unreadable candidate is renamed ``<name>.corrupt``
    so that the next restart does not try it again."""
    last_err: Optional[Exception] = None
    for path in reversed(all_checkpoints(ckpt_dir)):
        try:
            _probe_checkpoint(path)
            ts, extra = restore_checkpoint(path, ts_template)
            if last_err is not None:
                logger.warning("restored older checkpoint %s (newer ones "
                               "corrupt: %s)", path, last_err)
            return ts, extra, path
        except _UNREADABLE as e:
            last_err = e
            logger.warning("checkpoint %s unreadable (%s): trying older",
                           path, e)
            try:
                os.replace(path, path + ".corrupt")
            except OSError:
                pass
    if last_err is not None:
        logger.error("no readable checkpoint in %s (last error: %s)",
                     ckpt_dir, last_err)
    return None, {}, ""


def _manifest(path: str) -> Dict[str, Any]:
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    if manifest.get("format", "dense") != "dense":
        raise NotImplementedError(_SHARDED)
    return manifest


def _probe_checkpoint(path: str) -> None:
    """Cheap readability probe, no array bytes decompressed: the manifest
    parses, and the npz's central directory parses and lists every key of
    the manifest. Raises on failure."""
    manifest = _manifest(path)
    with np.load(os.path.join(path, "arrays.npz"), allow_pickle=False) as npz:
        if not set(manifest["keys"]) <= set(npz.files):
            raise KeyError(f"checkpoint {path} npz is missing keys")


def _load_arrays(path: str) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
    manifest = _manifest(path)
    with np.load(os.path.join(path, "arrays.npz"), allow_pickle=False) as npz:
        arrays = {k: npz[k] for k in npz.files}
    return arrays, manifest


def _fill_model(model, arrays: Dict[str, np.ndarray]) -> None:
    """``params/...`` into the parameters and ``model_state/...`` into the
    BatchNorm buffers, strictly (``bridge.params_from_numpy``)."""
    params = {k: v for k, v in arrays.items() if k.startswith("params/")}
    if not params:
        raise KeyError("checkpoint holds no parameters")
    state = {"state/" + k[len("model_state/"):]: v for k, v in arrays.items()
             if k.startswith("model_state/")}
    params_from_numpy(model, {**params, **state})


@torch.no_grad()
def _fill_optimizer(model, optimizer, get) -> None:
    """Fill each bound rule's state from ``get(kind, prefix, name, path)``
    (``kind`` one of 'count', 'lr', 'state'), which returns an array or
    None where it has none (a rule with no count, no injected LR)."""
    names = _param_names(model)
    for prefix, rule in _parts(optimizer):
        count = get("count", prefix, None, None)
        if count is None:
            raise KeyError(f"checkpoint has no update count for "
                           f"'{prefix or 'the optimizer'}'")
        rule.count = int(count)
        if rule.injected:
            lr = get("lr", prefix, None, None)
            if lr is not None:
                for group in rule.param_groups:
                    group["lr"] = float(lr)
        for path, p in _rule_params(rule, names):
            fresh = rule._init(p)
            for k, like in fresh.items():
                arr = get("state", prefix, k, path)
                if arr is None:
                    raise KeyError(f"checkpoint missing optimizer state "
                                   f"{prefix}{k}/{path}")
                if tuple(arr.shape) != tuple(like.shape):
                    raise ValueError(f"shape mismatch for {prefix}{k}/{path}: "
                                     f"checkpoint {arr.shape} vs template "
                                     f"{tuple(like.shape)}")
                fresh[k] = torch.tensor(arr, dtype=like.dtype,
                                        device=like.device)
            rule.state[p].clear()
            rule.state[p].update(fresh)


def restore_checkpoint(path: str, ts_template: TrainState
                       ) -> Tuple[TrainState, Dict[str, Any]]:
    """Restore a checkpoint into the template's model, optimizer and
    generator, in place; returns ``(ts, extra)`` with the template's
    objects and the checkpoint's step."""
    arrays, manifest = _load_arrays(path)
    model = ts_template.model
    _fill_model(model, arrays)

    def get(kind, prefix, name, p):
        key = {"count": f"opt_state/{prefix}count",
               "lr": f"opt_state/{prefix}hyperparams/learning_rate",
               "state": f"opt_state/{prefix}{name}/{p}"}[kind]
        return arrays.get(key)

    _fill_optimizer(model, ts_template.optimizer, get)
    if "step" not in arrays:
        raise KeyError("checkpoint missing key 'step'")
    if ts_template.rng is not None:
        if "rng" not in arrays:
            raise KeyError("checkpoint missing key 'rng'")
        ts_template.rng.set_state(torch.from_numpy(arrays["rng"].copy()))
    ts = TrainState(model, ts_template.optimizer, int(arrays["step"]),
                    ts_template.rng)
    return ts, manifest.get("extra", {})


# ---------------------------------------------------------------------------
# A dense checkpoint of the JAX package

# optax's per-parameter state names; the port's rules keep the same ones
_OPTAX_STATE = ("mu", "nu", "sum_of_squares", "trace", "z", "n")


def _optax_index(arrays: Dict[str, np.ndarray], prefix: str):
    """(state by (name, path), count, learning rate) of one optax state
    tree under ``opt_state/<prefix>``. The chain's own nodes (tuple
    indices, ``inner_state``) come before a state name or a ``count``;
    every count of a chain is its number of updates, so the first is
    taken."""
    state: Dict[Tuple[str, str], np.ndarray] = {}
    counts = []
    lr = None
    root = "opt_state/" + prefix
    for key in sorted(arrays):
        if not key.startswith(root):
            continue
        parts = key[len(root):].split("/")
        if parts[-2:] == ["hyperparams", "learning_rate"]:
            lr = arrays[key]
            continue
        i = 0
        while i < len(parts) and (parts[i].isdigit() or parts[i] == "inner_state"):
            i += 1
        if parts[i:] == ["count"]:
            counts.append(arrays[key])
        elif i < len(parts) and parts[i] in _OPTAX_STATE:
            state[(parts[i], "/".join(parts[i + 1:]))] = arrays[key]
    return state, (counts[0] if counts else None), lr


def load_jax_checkpoint(path: str, model, optimizer=None
                        ) -> Tuple[TrainState, Dict[str, Any]]:
    """Read a dense checkpoint written by the JAX package's
    ``save_checkpoint`` into ``model`` (parameters through
    ``bridge.params_from_numpy``, ``model_state`` into the BatchNorm
    buffers) and ``optimizer`` (a bound rule of ``make_optimizer``, or an
    ``embedding_partitioned`` pair), in place, so that the port continues
    the JAX run. optax's state maps by name: Adam's ``count``, ``mu`` and
    ``nu``, Adagrad's ``sum_of_squares``, SGD's ``trace``, FTRL's ``z`` and
    ``n``; a rule whose optax state has no count (Adagrad, SGD, FTRL)
    takes the step as its count. The JAX ``rng`` (a Threefry key) has no
    port counterpart and is not read. Returns ``(TrainState, extra)``."""
    arrays, manifest = _load_arrays(path)
    _fill_model(model, arrays)
    step = int(arrays["step"])
    index = {}

    def get(kind, prefix, name, p):
        if prefix not in index:
            label = prefix.rstrip("/")
            index[prefix] = _optax_index(
                arrays, f"inner_states/{label}/" if label else "")
        st, count, lr = index[prefix]
        if kind == "count":
            return step if count is None else count
        if kind == "lr":
            return lr
        return st.get((name, p))

    _fill_optimizer(model, optimizer, get)
    return TrainState(model, optimizer, step), manifest.get("extra", {})
