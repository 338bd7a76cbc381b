"""What the kernels' wrappers check before a launch.

A wrapper runs its kernel's plain version only when every tensor it was
given lies on the CPU; anything else goes to these checks, and a tensor the
kernel does not take raises rather than falling back.
"""

from __future__ import annotations

from typing import Mapping

import torch


def on_cpu(*tensors: torch.Tensor) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def check_cuda_inputs(what: str, ndims: Mapping[str, int],
                      **tensors: torch.Tensor) -> None:
    """The kernels take contiguous f32 tensors on one CUDA device, each of
    the rank ``ndims`` gives for its name; raises ``ValueError`` otherwise."""
    dev = next(iter(tensors.values())).device
    for name, t in tensors.items():
        ndim = ndims[name]
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"{what}: {name} is on {t.device}; all inputs "
                             "must be on one CUDA device (or all on the CPU)")
        if t.dtype != torch.float32 or t.dim() != ndim or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be a contiguous "
                             f"{ndim}-d float32 tensor, got {t.dtype} "
                             f"{tuple(t.shape)} contiguous={t.is_contiguous()}")


def refuse_double_backward(what: str) -> None:
    """A kernel's backward is not itself differentiable. Autograd runs a
    backward with grad mode on only for ``create_graph=True`` (a
    second-order gradient, as the cold-start meta step takes): raise then,
    on the card and on the CPU alike, rather than return a gradient that
    lacks the second-order term."""
    if torch.is_grad_enabled():
        raise RuntimeError(f"{what}: the kernel's backward has no double "
                           "backward; a second-order gradient (create_graph="
                           "True) cannot pass through it")
