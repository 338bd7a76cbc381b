"""Config tree of the port.

A copy of ``ml_function_tpu/train/config.py``: the reference has no config
system (hyperparameters are Python kwargs, ``models.py:44-45``); here a
dataclass tree (model / data / mesh / train) with dotted-path overrides
(``apply_overrides``), serialized into a checkpoint's ``extra`` for
reproducibility. ``MeshConfig`` is the CLI's mesh (``train/cli.py``); its
fields keep the reference's names.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Sequence, Tuple


@dataclass
class ModelConfig:
    name: str = "deepfm"
    hidden: Tuple[int, ...] = (256, 128, 64)
    embed_dim: int = 8
    # behavior-model routing (ignored by interaction models)
    candidate: Tuple[str, ...] = ("item", "cate")
    behavior: Tuple[str, ...] = ("hist_item", "hist_cate")
    extra: Dict[str, Any] = field(default_factory=dict)


@dataclass
class DataConfig:
    source: str = "synthetic"    # synthetic | csv | stream | behavior_stream
    path: Optional[str] = None         # csv/tsv path
    n_rows: int = 100_000
    n_dense: int = 13
    n_sparse: int = 26
    vocab_size: int = 100_000
    seq_len: int = 0                   # >0 → behavior data
    hash_features: bool = False
    test_frac: float = 0.1
    # stream source (native C++ loader, out-of-core):
    hash_buckets: int = 1 << 20
    eval_path: Optional[str] = None    # held-out TSV for eval (loaded whole)
    chunk_mb: int = 64                 # stream chunk size
    # behavior_stream source (features/behavior_stream.py):
    cate_buckets: int = 1 << 10        # category-id bucket space
    long_seq_len: int = 0              # >0 adds the hist_long lifelong field


@dataclass
class MeshConfig:
    data: int = 0                      # 0 → all devices
    model: int = 1
    exchange: str = "psum"             # embedding lookup: 'psum' | 'a2a'
    compress: str = ""                 # '' | 'bf16' row-payload compression across chips
    # sparse-row backward routing: 'a2a' owner-routed (default) | 'allgather'
    grad_exchange: str = "a2a"
    # a2a per-bucket unique-id capacity: '' = lossless worst case (N/M),
    # 'auto' = planner.plan_capacity from frequency stats, or an int string.
    # With a finite capacity the step output reports a2a_overflow drops.
    capacity: str = ""
    # same for the sparse-row BACKWARD's owner-routed buckets
    grad_capacity: str = ""
    # shard lifelong-sequence KEY axes over 'model' (SIM's GSU routes
    # through parallel/longseq.py — the seq-parallel tier)
    seq_shard: bool = False
    # > 0 pipelines deep tower stacks (AutoInt blocks) over 'model' with
    # this many GPipe microbatches (parallel/pipeline.py)
    pp_microbatches: int = 0


@dataclass
class TrainConfig:
    batch_size: int = 4096
    epochs: int = 1
    learning_rate: float = 1e-3
    optimizer: str = "adam"            # adam | adagrad | sgd (dense params)
    # '' = dense full-table updates; 'adagrad' | 'adam' = sparse-row path
    # (parallel/sparse.py): row-sharded tables with O(ids/step) updates
    row_optimizer: str = ""
    row_learning_rate: float = 1e-2
    seed: int = 0
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 0          # steps; 0 → end of training only
    # eval-driven control (train/control.py — reference EarlyStopping /
    # ReduceLROnPlateau driver behavior):
    eval_every: int = 0                # steps between periodic evals (0=off)
    patience: int = 0                  # early-stop after N bad evals (0=off)
    min_delta: float = 0.0
    monitor: str = "auc"               # eval metric to monitor
    save_best: bool = True             # keep best-eval ckpt in <dir>/best
    lr_schedule: str = ""              # '' | cosine | exponential | warmup_cosine
    lr_decay_steps: int = 10_000
    lr_warmup_steps: int = 0
    log_every: int = 100
    debug_nans: bool = False
    profile_dir: Optional[str] = None  # profiler trace output (utils.debug.profile)


@dataclass
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    train: TrainConfig = field(default_factory=TrainConfig)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), default=str, indent=2)


def _coerce(value: str, current: Any) -> Any:
    if isinstance(current, bool):
        return value.lower() in ("1", "true", "yes")
    if isinstance(current, int):
        return int(value)
    if isinstance(current, float):
        return float(value)
    if isinstance(current, tuple):
        parts = [p for p in value.strip("()[] ").split(",") if p]
        elem = current[0] if current else ""
        return tuple(type(elem)(p) if current else p for p in parts)
    if current is None:
        return value if value.lower() != "none" else None
    return value


def apply_overrides(cfg: Config, argv: Sequence[str]) -> Config:
    """--config.a.b=v dotted-path overrides (unknown paths raise)."""
    for arg in argv:
        if not arg.startswith("--config."):
            raise ValueError(f"unknown argument {arg!r} (use --config.x.y=v)")
        path, _, value = arg[len("--config."):].partition("=")
        keys = path.split(".")
        obj = cfg
        for k in keys[:-1]:
            if not hasattr(obj, k):
                raise AttributeError(f"no config section {k!r} in {path!r}")
            obj = getattr(obj, k)
        leaf = keys[-1]
        if isinstance(obj, dict):
            # free-form dicts (model.extra): parse JSON literals so
            # --config.model.extra.n_layers=4 arrives as an int (and
            # lists/bools work); unparseable values stay strings
            try:
                obj[leaf] = json.loads(value)
            except (json.JSONDecodeError, ValueError):
                obj[leaf] = value
        else:
            if not dataclasses.is_dataclass(obj) or not hasattr(obj, leaf):
                raise AttributeError(f"no config field {path!r}")
            setattr(obj, leaf, _coerce(value, getattr(obj, leaf)))
    return cfg
