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

A sparse-row state (``train/sparse.SparseTrainState``) keeps its dense
optimizer under ``opt_state/dense/...`` and its row states under
``opt_state/rows/<group>/<name>``, as the JAX package's ``{"dense",
"rows"}`` tree does.

Two formats, one API, as in the reference:

- ``dense``: one ``arrays.npz`` of whole arrays;
- ``sharded`` (the default when the process group has more than one rank,
  or ``format='sharded'``): the state of a sharded model
  (``parallel/train.ShardedTrainState``, ``parallel/sparse``) in blocks.
  The ranks whose data coordinate is 0 write their table and expert blocks
  (parameters and the moments beside them) as ``shards_<rank>.npz``,
  members named ``key::span`` (``lo-hi,lo-hi`` of the padded global array,
  the reference's ``_span_key``); rank 0 writes the replicated arrays and
  the manifest (global shapes, dtypes, each sharded key's unpadded rows);
  barriers sit where the reference's ``_sync`` calls are. On the same grid
  a restore reads each rank's own blocks; on another grid (or into an
  unsharded state, (2, 2) into (1, 1) too) it stitches the affected array
  on the host, keeping the rows past the saved padding as the template has
  them.

``restore_latest`` falls back past a torn newest checkpoint, a missing or
truncated shard file too, and renames it ``<name>.corrupt``.
``load_jax_checkpoint`` reads a checkpoint that the JAX package wrote,
dense or sharded (stitched, the padding rows dropped; optax's state
layout), into a port model and optimizer, so that the port continues the
JAX run.
"""

from __future__ import annotations

import contextlib
import dataclasses
import glob
import json
import os
import re
import shutil
import tempfile
import zipfile
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch
import torch.distributed

from ..bridge import flat_params, params_from_numpy, state_buffers
from ..utils.logging import logger
from ..parallel import comm
from ..parallel.multihost import process_count as _world
from ..parallel.multihost import process_index as _rank
from .loop import TrainState
from .optimizers import OptaxRule, Partitioned, set_learning_rate

# what a torn or truncated checkpoint raises on reading: a missing file, a
# zip without its central directory, a short member, a bad manifest
_UNREADABLE = (OSError, ValueError, KeyError, EOFError, zipfile.BadZipFile,
               json.JSONDecodeError)


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


def _optimizers(ts) -> Iterator[Tuple[str, Any]]:
    """(key root, bound optimizer) of a state: ``TrainState.optimizer`` at
    ``opt_state/``, a sparse state's dense optimizer at
    ``opt_state/dense/``."""
    if hasattr(ts, "dense"):
        yield "dense/", ts.dense
    else:
        yield "", ts.optimizer


def _opt_arrays(model, optimizer, root: str = "") -> Dict[str, np.ndarray]:
    names = _param_names(model)
    out: Dict[str, np.ndarray] = {}
    for prefix, rule in _parts(optimizer):
        prefix = root + prefix
        out[f"opt_state/{prefix}count"] = np.asarray(int(rule.count), np.int64)
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


def state_arrays(ts) -> Dict[str, np.ndarray]:
    """The checkpoint's flat key → array map of a ``TrainState`` (or a
    sparse-row state); a sharded state's arrays are this rank's blocks."""
    flat = dict(flat_params(ts.model))
    flat.update({"model_state/" + k: v.detach().cpu().numpy().copy()
                 for k, v in state_buffers(ts.model).items()})
    for root, opt in _optimizers(ts):
        flat.update(_opt_arrays(ts.model, opt, root))
    for g, st in (getattr(ts, "rows", None) or {}).items():
        flat.update({f"opt_state/rows/{g}/{k}": v.detach().cpu().numpy().copy()
                     for k, v in st.items()})
    flat["step"] = np.asarray(ts.step, np.int64)
    if getattr(ts, "rng", None) is not None:
        flat["rng"] = ts.rng.get_state().numpy().copy()
    return flat


def save_checkpoint(ckpt_dir: str, ts, *, extra: Optional[Dict[str, Any]] = None,
                    keep: int = 3, format: Optional[str] = None) -> str:
    """Atomically write a step-stamped checkpoint and keep the last
    ``keep``; returns its path. ``format``: None → 'sharded' when the
    process group has more than one rank, else 'dense'. Under the sharded
    format every rank of the mesh calls this (barriers inside)."""
    fmt = format or ("sharded" if _world() > 1 else "dense")
    if fmt not in ("dense", "sharded"):
        raise ValueError(f"unknown checkpoint format {fmt!r}")
    step = int(ts.step)
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"ckpt_{step:010d}")
    if fmt == "sharded":
        _save_sharded(ckpt_dir, final, ts, step, extra)
    else:
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
    if _rank() == 0:
        for old in all_checkpoints(ckpt_dir)[:-keep]:
            shutil.rmtree(old, ignore_errors=True)
    return final


# ---------------------------------------------------------------------------
# the sharded format


def _sharded_rows(ts, keys) -> Dict[str, Tuple[int, int]]:
    """Each of ``keys`` (a sharded state's arrays) that holds a row block →
    (its unpadded rows, its padded rows): the layout's parameters, the
    optimizer moments beside them and the row states of their groups."""
    layout = getattr(ts, "layout", None) or {}
    paths = {name.replace(".", "/"): rows for name, rows in layout.items()}
    out = {}
    for key in keys:
        for path, rows in paths.items():
            if key == "params/" + path or (key.startswith("opt_state/")
                                           and key.endswith("/" + path)):
                out[key] = rows
        if key.startswith("opt_state/rows/"):
            g = key.split("/")[2]
            path = g if g in paths else f"embedding/{g}"
            if path in paths:
                out[key] = paths[path]
    return out


def _span(lo: int, hi: int, shape) -> str:
    """The reference's ``_span_key``: 'lo-hi,lo-hi' over every axis, the
    first one ``[lo, hi)``; 'scalar' for a 0-d array."""
    if not len(shape):
        return "scalar"
    return ",".join([f"{lo}-{hi}"] + [f"0-{d}" for d in shape[1:]])


def _span_slices(span: str) -> Tuple[slice, ...]:
    if span == "scalar":
        return ()
    return tuple(slice(*map(int, p.split("-"))) for p in span.split(","))


def _mesh_of(ts):
    return getattr(ts, "mesh", None)


def _save_sharded(ckpt_dir: str, final: str, ts, step: int,
                  extra: Optional[Dict[str, Any]]) -> None:
    mesh = _mesh_of(ts)
    rank = _rank()
    tmp = os.path.join(ckpt_dir, f".tmp_ckpt_{step:010d}")
    if rank == 0 and os.path.exists(tmp):
        shutil.rmtree(tmp)
    comm.barrier()
    os.makedirs(tmp, exist_ok=True)
    flat = state_arrays(ts)
    rows = _sharded_rows(ts, flat)
    shapes, dtypes, mine = {}, {}, {}
    for key, arr in flat.items():
        dtypes[key] = arr.dtype.name
        if key in rows:
            r = arr.shape[0]
            block_lo = (mesh.model_index if mesh is not None else 0) * r
            shapes[key] = [rows[key][1]] + list(arr.shape[1:])
            if mesh is None or mesh.data_index == 0:
                mine[f"{key}::{_span(block_lo, block_lo + r, arr.shape)}"] = arr
        else:
            shapes[key] = list(arr.shape)
            if rank == 0:
                mine[f"{key}::{_span(0, arr.shape[0] if arr.ndim else 0, arr.shape)}"] = arr
    if mine:
        np.savez(os.path.join(tmp, f"shards_{rank:05d}.npz"), **mine)
    comm.barrier()
    if rank == 0:
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump({"step": step, "format": "sharded", "keys": sorted(flat),
                       "shapes": shapes, "dtypes": dtypes,
                       "rows": {k: v[0] for k, v in rows.items()},
                       "process_count": _world(),
                       "mesh": [mesh.data, mesh.model] if mesh is not None else [1, 1],
                       "extra": extra or {}}, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    comm.barrier()


@contextlib.contextmanager
def _shard_index(path: str):
    """key → span → (open npz, member) over every shard file, nothing
    decompressed yet; the files close when the block ends."""
    files = sorted(glob.glob(os.path.join(path, "shards_*.npz")))
    if not files:
        raise OSError(f"no shard files in {path}")
    with contextlib.ExitStack() as stack:
        index: Dict[str, Dict[str, Tuple[Any, str]]] = {}
        for fp in files:
            npz = stack.enter_context(np.load(fp, allow_pickle=False))
            for name in npz.files:
                key, span = name.rsplit("::", 1)
                index.setdefault(key, {})[span] = (npz, name)
        yield index


def _check_covered(spans, shape, key: str) -> None:
    """Raise ``KeyError`` unless the saved blocks cover the whole array.
    The blocks of both packages' writers partition it (one writer a
    distinct block), so the blocks' sizes summing to the array's means
    every element was saved."""
    if "scalar" in spans:
        return
    saved = sum(int(np.prod([s.stop - s.start for s in _span_slices(span)]))
                for span in spans)
    if saved != int(np.prod(shape)):
        raise KeyError(f"checkpoint blocks of {key!r} cover {saved} of "
                       f"{int(np.prod(shape))} elements (a shard file missing)")


def _stitch(spans: Dict[str, Tuple[Any, str]], shape, key: str) -> np.ndarray:
    """The whole array from its saved blocks, which must cover it."""
    if "scalar" in spans:
        npz, name = spans["scalar"]
        return npz[name]
    _check_covered(spans, shape, key)
    out = None
    for span, (npz, name) in spans.items():
        arr = npz[name]
        if out is None:
            out = np.zeros(tuple(shape), arr.dtype)
        out[_span_slices(span)] = arr
    if out is None:
        raise KeyError(f"no blocks saved for {key!r}")
    return out


def _sharded_arrays(path: str, manifest: Dict[str, Any], ts) -> Dict[str, np.ndarray]:
    """This rank's arrays of the template ``ts`` from a sharded checkpoint:
    its own blocks where the grid is the same, else the stitched array's
    rows, those past the saved padding kept as the template has them."""
    with _shard_index(path) as index:
        return _blocks_of(index, manifest, ts)


def _blocks_of(index, manifest: Dict[str, Any], ts) -> Dict[str, np.ndarray]:
    shapes = manifest["shapes"]
    mine = state_arrays(ts)
    rows = _sharded_rows(ts, mine)
    mesh = _mesh_of(ts)
    out = {}
    for key, like in mine.items():
        if key not in index:
            raise KeyError(f"checkpoint missing key {key!r}")
        saved = tuple(shapes[key])
        if key in rows or (key in manifest.get("rows", {}) and like.ndim):
            r = like.shape[0]
            lo = (mesh.model_index * r) if (key in rows and mesh is not None) else 0
            if tuple(saved[1:]) != tuple(like.shape[1:]):
                raise ValueError(f"shape mismatch for {key!r}: checkpoint {saved} vs "
                                 f"template {like.shape}")
            span = _span(lo, lo + r, like.shape)
            if span in index[key] and saved[0] == (rows[key][1] if key in rows else r):
                npz, name = index[key][span]
                out[key] = npz[name]
                continue
            whole = _stitch(index[key], saved, key)
            block = like.copy()
            n = max(0, min(lo + r, saved[0]) - lo)
            block[:n] = whole[lo:lo + n]
            out[key] = block
        else:
            if saved != tuple(like.shape):
                raise ValueError(f"shape mismatch for {key!r}: checkpoint {saved} vs "
                                 f"template {like.shape}")
            out[key] = _stitch(index[key], saved, key)
    return out


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
    so that the next restart does not try it again. Several ranks agree
    first: rank 0 alone probes and quarantines, and every rank restores the
    step it broadcasts, so that no rank resumes from another step."""
    if _world() > 1:
        return _restore_latest_consensus(ckpt_dir, ts_template)
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


def _restore_latest_consensus(ckpt_dir: str, ts_template):
    sel = [-1]
    if _rank() == 0:
        for path in reversed(all_checkpoints(ckpt_dir)):
            try:
                _probe_checkpoint(path)
                sel = [int(os.path.basename(path).split("_")[1])]
                break
            except _UNREADABLE as e:
                logger.warning("checkpoint %s unreadable (%s): trying older", path, e)
                try:
                    os.replace(path, path + ".corrupt")
                except OSError:
                    pass
    torch.distributed.broadcast_object_list(sel, src=0)
    if sel[0] < 0:
        return None, {}, ""
    path = os.path.join(ckpt_dir, f"ckpt_{sel[0]:010d}")
    # the agreed path failing now is a real error: raise rather than let
    # the ranks train from different steps
    ts, extra = restore_checkpoint(path, ts_template)
    return ts, extra, path


def _manifest(path: str) -> Dict[str, Any]:
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)


def _is_sharded(manifest: Dict[str, Any]) -> bool:
    return manifest.get("format", "dense") == "sharded"


def _probe_checkpoint(path: str) -> None:
    """Cheap readability probe, no array bytes decompressed: the manifest
    parses, and the npz central directories (every shard file's, in the
    sharded format) parse and list every key of the manifest, whose saved
    blocks cover each array. Raises on failure."""
    manifest = _manifest(path)
    if _is_sharded(manifest):
        with _shard_index(path) as index:
            missing = set(manifest["keys"]) - set(index)
            if missing:
                raise KeyError(f"checkpoint {path} missing keys {sorted(missing)[:3]}")
            for key in manifest["keys"]:
                _check_covered(index[key], manifest["shapes"][key], key)
        return
    with np.load(os.path.join(path, "arrays.npz"), allow_pickle=False) as npz:
        if not set(manifest["keys"]) <= set(npz.files):
            raise KeyError(f"checkpoint {path} npz is missing keys")


def _load_arrays(path: str) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
    """Every array whole: the dense file, or each sharded key stitched."""
    manifest = _manifest(path)
    if _is_sharded(manifest):
        with _shard_index(path) as index:
            return ({k: _stitch(index[k], manifest["shapes"][k], k) for k in index},
                    manifest)
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
        rule.count.fill_(int(count))
        if rule.injected:
            lr = get("lr", prefix, None, None)
            if lr is not None:
                set_learning_rate(rule, float(lr))
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
            # into the tensors a step already made, where there are any: a
            # captured step keeps reading them
            state = rule.state[p]
            if state.keys() == fresh.keys():
                for k, v in fresh.items():
                    state[k].copy_(v)
            else:
                state.clear()
                state.update(fresh)


def restore_checkpoint(path: str, ts_template) -> Tuple[Any, Dict[str, Any]]:
    """Restore a checkpoint into the template's model, optimizer (or dense
    optimizer and row states) and generator, in place; returns ``(ts,
    extra)``: the template with the checkpoint's step. A sharded
    checkpoint fills a sharded template's blocks (stitching where the grid
    differs) or an unsharded template whole."""
    manifest = _manifest(path)
    if _is_sharded(manifest):
        arrays = _sharded_arrays(path, manifest, ts_template)
    else:
        arrays, _ = _load_arrays(path)
    model = ts_template.model
    _fill_model(model, arrays)
    for root, opt in _optimizers(ts_template):
        def get(kind, prefix, name, p, root=root):
            key = {"count": f"opt_state/{root}{prefix}count",
                   "lr": f"opt_state/{root}{prefix}hyperparams/learning_rate",
                   "state": f"opt_state/{root}{prefix}{name}/{p}"}[kind]
            return arrays.get(key)

        _fill_optimizer(model, opt, get)
    with torch.no_grad():
        for g, st in (getattr(ts_template, "rows", None) or {}).items():
            for k, like in st.items():
                key = f"opt_state/rows/{g}/{k}"
                if key not in arrays:
                    raise KeyError(f"checkpoint missing key {key!r}")
                if tuple(arrays[key].shape) != tuple(like.shape):
                    raise ValueError(f"shape mismatch for {key!r}")
                like.copy_(torch.as_tensor(arrays[key]))
    if "step" not in arrays:
        raise KeyError("checkpoint missing key 'step'")
    rng = getattr(ts_template, "rng", None)
    if rng is not None:
        if "rng" not in arrays:
            raise KeyError("checkpoint missing key 'rng'")
        rng.set_state(torch.from_numpy(arrays["rng"].copy()))
    return (dataclasses.replace(ts_template, step=int(arrays["step"])),
            manifest.get("extra", {}))


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


def _trim_padding(arrays: Dict[str, np.ndarray], model) -> Dict[str, np.ndarray]:
    """The arrays of a row-sharded JAX state with their padding rows
    dropped: a parameter's, and each optimizer state's of that parameter,
    cut to the model's rows."""
    shapes = {n.replace(".", "/"): tuple(p.shape) for n, p in model.named_parameters()}
    out = dict(arrays)
    for key, arr in arrays.items():
        for path, shape in shapes.items():
            if ((key == "params/" + path or key.endswith("/" + path))
                    and arr.ndim == len(shape) and arr.ndim
                    and arr.shape[0] > shape[0] and arr.shape[1:] == shape[1:]):
                out[key] = arr[:shape[0]]
    return out


def load_jax_checkpoint(path: str, model, optimizer=None
                        ) -> Tuple[TrainState, Dict[str, Any]]:
    """Read a checkpoint written by the JAX package's ``save_checkpoint``,
    dense or sharded (its blocks stitched, the tables' padding rows
    dropped), into ``model`` (parameters through
    ``bridge.params_from_numpy``, ``model_state`` into the BatchNorm
    buffers) and ``optimizer`` (a bound rule of ``make_optimizer``, or an
    ``embedding_partitioned`` pair), in place, so that the port continues
    the JAX run. optax's state maps by name: Adam's ``count``, ``mu`` and
    ``nu``, Adagrad's ``sum_of_squares``, SGD's ``trace``, FTRL's ``z`` and
    ``n``; a rule whose optax state has no count (Adagrad, SGD, FTRL)
    takes the step as its count. The JAX ``rng`` (a Threefry key) has no
    port counterpart and is not read. Returns ``(TrainState, extra)``."""
    arrays, manifest = _load_arrays(path)
    arrays = _trim_padding(arrays, model)
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
