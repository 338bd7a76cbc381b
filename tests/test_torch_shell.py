"""The port's single-process shell against the JAX package's, on the CPU:
the config tree and its dotted overrides (``to_json`` equal), the
structured ``MetricLogger``, ``find_nonfinite`` over a module and over a
nested dict, a ``StepWatchdog`` that fires and one that does not,
``enable_nan_checks``, ``profile`` and the feature-column wrappers."""

import json
import threading

import numpy as np
import pytest
import torch

from ml_function_tpu import wrapper as jwrapper
from ml_function_tpu.train import config as jconfig
from ml_function_tpu_torch import wrapper as twrapper
from ml_function_tpu_torch.ops.core import MLP
from ml_function_tpu_torch.train import config as tconfig
from ml_function_tpu_torch.utils import debug, logging as tlogging

torch.set_num_threads(1)

OVERRIDES = [
    [],
    ["--config.model.name=xdeepfm", "--config.train.batch_size=8192",
     "--config.model.hidden=(64,32)", "--config.train.debug_nans=true",
     "--config.train.learning_rate=3e-4", "--config.data.path=/data/x.tsv",
     "--config.model.extra.n_layers=4", "--config.model.extra.tag=abc",
     "--config.mesh.capacity=auto", "--config.train.checkpoint_dir=none"],
]


@pytest.mark.parametrize("argv", OVERRIDES)
def test_config_overrides_and_json(argv):
    t = tconfig.apply_overrides(tconfig.Config(), argv)
    j = jconfig.apply_overrides(jconfig.Config(), argv)
    assert t.to_json() == j.to_json()
    assert json.loads(t.to_json())["mesh"] == json.loads(j.to_json())["mesh"]


@pytest.mark.parametrize("bad", ["--config.nope.x=1", "--config.train.nope=1",
                                 "train.batch_size=1"])
def test_config_rejects_unknown_paths(bad):
    with pytest.raises((AttributeError, ValueError)) as t_err:
        tconfig.apply_overrides(tconfig.Config(), [bad])
    with pytest.raises((AttributeError, ValueError)) as j_err:
        jconfig.apply_overrides(jconfig.Config(), [bad])
    assert t_err.type is j_err.type


def test_metric_logger(tmp_path):
    path = tmp_path / "m.jsonl"
    log = tlogging.MetricLogger(str(path))
    log.log(1, loss=0.5, auc=np.float32(0.75))
    log.log(2, loss=torch.tensor(0.25))
    log.close()
    recs = [json.loads(ln) for ln in path.read_text().splitlines()]
    assert [r["step"] for r in recs] == [1, 2]
    assert recs[0]["loss"] == 0.5 and recs[0]["auc"] == 0.75
    assert recs[1]["loss"] == 0.25 and recs[1]["dt_ms"] >= 0
    assert tlogging.logger.name == "ml_function_tpu_torch"


def test_find_nonfinite():
    mlp = MLP(4, (3,), norm="batch")
    assert debug.find_nonfinite(mlp) == []
    with torch.no_grad():
        mlp.layer0.dense.w[0, 1] = float("nan")
        mlp.layer0.norm.var[2] = float("inf")
    assert debug.find_nonfinite(mlp) == ["layer0/dense/w", "layer0/norm/var"]
    tree = {"a": {"b": torch.tensor([1.0, float("inf")]), "c": np.ones(2)},
            "ids": np.array([1, 2]), "l": [np.array([np.nan]), torch.zeros(2)]}
    assert debug.find_nonfinite(tree, prefix="p/") == ["p/a/b", "p/l/0"]


def test_step_watchdog_fires():
    fired = threading.Event()
    with debug.StepWatchdog(0.05, on_timeout=fired.set):
        assert fired.wait(5.0)


def test_step_watchdog_quiet_while_pinged():
    fired = threading.Event()
    with debug.StepWatchdog(0.5, on_timeout=fired.set) as wd:
        for _ in range(5):
            wd.ping()
    assert not fired.wait(0.8)


def test_nan_checks_and_profile(tmp_path):
    debug.enable_nan_checks(True)
    try:
        assert torch.is_anomaly_enabled()
        x = torch.tensor([-1.0], requires_grad=True)
        with pytest.raises(RuntimeError):
            torch.sqrt(x).sum().backward()     # NaN made in the backward
    finally:
        debug.enable_nan_checks(False)
    assert not torch.is_anomaly_enabled()
    with debug.profile(str(tmp_path / "trace")) as prof:
        torch.ones(8).sum()
    assert prof is not None and (tmp_path / "trace" / "trace.json").stat().st_size > 0
    with debug.profile(None) as none:
        assert none is None


def test_wrapper_specs():
    pairs = [
        (twrapper.NumsFea("I1"), jwrapper.NumsFea("I1")),
        (twrapper.CateFea("C1", 1000, cross_unit=4, emb_reg=1e-6,
                          is_trainable=False, unused=1),
         jwrapper.CateFea("C1", 1000, cross_unit=4, emb_reg=1e-6,
                          is_trainable=False, unused=1)),
        (twrapper.BehaviorFea("hist", 500, 20, vocab_name="item"),
         jwrapper.BehaviorFea("hist", 500, 20, vocab_name="item")),
    ]
    for t, j in pairs:
        assert type(t).__name__ == type(j).__name__
        assert repr(t) == repr(j)
