"""The JAX CLI's runs for ``test_torch_cli.py``, in a process of their own.

    python -X faulthandler tests/jax_cli_child.py IN.pkl OUT.pkl

``IN.pkl`` holds a list of argument lists; ``OUT.pkl`` receives, for each,
the JAX CLI's result and its initial ``(params, model_state)`` as numpy
(padded for its model axis). The process sets JAX up as
``tests/conftest.py`` does: the CPU, 8 virtual devices and f32 matmuls at
``jax_default_matmul_precision="highest"``. A fault in XLA's CPU runtime
then ends this process, not the test's, and its stderr (with the Python
stacks that ``-X faulthandler`` prints) stays readable to the test.
"""

import os
import pickle
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402  (import after the environment)

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_default_matmul_precision", "highest")

import numpy as np  # noqa: E402

import ml_function_tpu.parallel.sparse as jsparse  # noqa: E402
from ml_function_tpu.train import cli as jcli  # noqa: E402


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def jax_run(argv):
    """The JAX CLI's result on ``argv`` and its initial ``(params,
    model_state)`` as numpy (padded for its model axis)."""
    seen = {}

    def capture(make):
        def wrapped(*args, **kw):
            ts = make(*args, **kw)
            seen["init"] = (_np(ts.params), _np(ts.model_state))
            return ts
        return wrapped

    real = jcli.create_sharded_state, jsparse.create_sparse_sharded_state
    jcli.create_sharded_state = capture(real[0])
    jsparse.create_sparse_sharded_state = capture(real[1])
    try:
        res = jcli.main(argv)
    finally:
        jcli.create_sharded_state, jsparse.create_sparse_sharded_state = real
    return res, seen["init"]


if __name__ == "__main__":
    with open(sys.argv[1], "rb") as f:
        argvs = pickle.load(f)
    out = [jax_run(a) for a in argvs]
    with open(sys.argv[2], "wb") as f:
        pickle.dump(out, f)
