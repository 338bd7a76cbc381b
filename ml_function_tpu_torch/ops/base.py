"""Parameter init and the bf16 matmul of the port.

Counterpart of ``ml_function_tpu/ops/base.py``. Blocks are ``nn.Module``s
whose parameter names follow the JAX key paths; each block that owns
parameters draws them in ``reset_parameters(generator)`` from an explicit
``torch.Generator``. The two packages draw different numbers from one seed:
parity tests copy the JAX parameters across with ``bridge.params_from_numpy``.
"""

from __future__ import annotations

import math
import os
from typing import Sequence

import torch
from torch import nn

PARAM_DTYPE = torch.float32


def glorot_uniform(shape: Sequence[int], generator: torch.Generator,
                   dtype=PARAM_DTYPE) -> torch.Tensor:
    fan_in, fan_out = shape[-2], shape[-1]
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    return torch.empty(tuple(shape), dtype=dtype, device=generator.device
                       ).uniform_(-limit, limit, generator=generator)


def normal_init(shape: Sequence[int], generator: torch.Generator,
                stddev: float = 0.05, dtype=PARAM_DTYPE) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=generator.device
                       ).normal_(0.0, stddev, generator=generator)


def zeros(shape: Sequence[int], dtype=PARAM_DTYPE) -> torch.Tensor:
    return torch.zeros(tuple(shape), dtype=dtype)


def init_parameters(root: nn.Module, generator: torch.Generator) -> nn.Module:
    """Draw every parameter of ``root`` afresh: each submodule that owns
    parameters fills them in its ``reset_parameters(generator)``."""
    with torch.no_grad():
        for m in root.modules():
            reset = getattr(m, "reset_parameters", None)
            if reset is not None:
                reset(generator)
    return root


def bf16_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """bf16-rounded inputs, f32 products and sums, f32 output (the JAX
    ``dot_general(..., preferred_element_type=f32)`` on bf16 operands).

    ``torch.matmul`` on bf16 tensors would return bf16, which the reference
    never does, so the operands are rounded and multiplied in f32.
    ``ML_FUNCTION_TPU_F32_MATMUL=1``, read at call time as in the reference,
    keeps the inputs f32."""
    if os.environ.get("ML_FUNCTION_TPU_F32_MATMUL") == "1":
        return torch.matmul(x, w)
    return torch.matmul(x.bfloat16().float(), w.bfloat16().float())
