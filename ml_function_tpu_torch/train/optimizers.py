"""Optimizers with optax's update rules and defaults, written out.

Counterpart of ``ml_function_tpu/train/optimizers.py``. ``torch.optim``'s
own classes are not used: their defaults differ from optax's (Adagrad starts
its accumulator at 0 with eps 1e-10 where optax starts at 0.1 with eps 1e-7;
AdamW decays weights by 1e-2 where optax decays by 1e-4), and a model must
train the same in both packages.

``make_optimizer`` returns an ``OptimizerSpec``, which like an optax
``GradientTransformation`` holds no parameters; ``spec.init(model)`` binds it
to a model's parameters, on their device. Every rule keeps optax's single
update count and treats a parameter without a gradient as one with a zero
gradient, as a JAX gradient tree would carry it.

A step reads nothing from the host that changes between steps, so a CUDA
graph can replay it (``train/loop.py``'s chained step): the count is an
int32 scalar on the parameters' device, as optax's ``count``; the learning
rate of a schedule, an injected learning rate and Adam's bias corrections
are f32 scalars computed there from it, with optax's arithmetic; and every
state tensor is updated in place.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Optional, Tuple, Union

import torch
from torch import nn

Schedule = Callable[[Union[int, torch.Tensor]], Union[float, torch.Tensor]]
LearningRate = Union[float, Schedule]
NamedParams = List[Tuple[str, nn.Parameter]]


class OptaxRule(torch.optim.Optimizer):
    """One optax update rule over a list of parameters. ``lr`` is a float or
    a schedule of the update count (0 for the first update). Subclasses give
    ``_init(p)`` (the per-parameter state), ``_scalars(lr, group)`` (what
    every parameter's update of one step shares) and ``_update(g, p, state,
    scalars, group)`` (the update that ``optax.apply_updates`` adds to
    ``p``, with the state updated in place)."""

    def __init__(self, params, lr: LearningRate, injected: bool = False,
                 **defaults):
        super().__init__(params, dict(lr=lr, **defaults))
        dev = self.param_groups[0]["params"][0].device
        # updates applied so far, optax's int32 count, on the device
        self.count = torch.zeros((), dtype=torch.int32, device=dev)
        self.injected = injected  # the host may set the LR between steps
        # the injected LR as the step reads it (set by set_learning_rate)
        self.lr_tensor = (torch.full((), float(lr), dtype=torch.float32, device=dev)
                          if injected else None)

    def _init(self, p: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {}

    def _learning_rate(self, group) -> Union[float, torch.Tensor]:
        """This step's LR: a schedule's f32 value at the count (on the
        device), the injected f32 LR, or the constant float."""
        lr = group["lr"]
        if callable(lr):
            return lr(self.count)
        return self.lr_tensor if self.injected else lr

    def _scalars(self, lr, group):
        return -lr                # optax's scale_by_learning_rate

    def _update(self, g, p, state, scalars, group) -> torch.Tensor:
        raise NotImplementedError

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            scalars = self._scalars(self._learning_rate(group), group)
            for p in group["params"]:
                g = p.grad if p.grad is not None else torch.zeros_like(p)
                state = self.state[p]
                if not state:
                    state.update(self._init(p))
                p.add_(self._update(g, p, state, scalars, group))
        self.count.add_(1)


class Adam(OptaxRule):
    """``optax.adam`` (and ``optax.adamw`` with ``weight_decay``):
    scale_by_adam, add_decayed_weights, scale_by_learning_rate."""

    def __init__(self, params, lr, b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0,
                 weight_decay=0.0, injected=False):
        super().__init__(params, lr, injected, b1=b1, b2=b2, eps=eps,
                         eps_root=eps_root, weight_decay=weight_decay)

    def _init(self, p):
        return {"mu": torch.zeros_like(p), "nu": torch.zeros_like(p)}

    def _scalars(self, lr, group):
        # optax's bias corrections 1 − b**k at k = count + 1, in f32 on the
        # device (optax.tree.bias_correction)
        k = self.count + 1
        return (-lr, 1 - torch.pow(group["b1"], k), 1 - torch.pow(group["b2"], k))

    def _update(self, g, p, state, scalars, group):
        # optax's expression, one rounding an operation as there, in place
        # on mu, nu and two scratch tensors: a table's update allocates two
        # table-sized temporaries instead of a dozen
        neg_lr, bc1, bc2 = scalars
        b1, b2 = group["b1"], group["b2"]
        mu, nu = state["mu"], state["nu"]
        t = torch.mul(g, 1 - b1)
        mu.mul_(b1).add_(t)                                 # (1 − b1)·g + b1·mu
        torch.mul(g, g, out=t).mul_(1 - b2)
        nu.mul_(b2).add_(t)                                 # (1 − b2)·g² + b2·nu
        u = torch.div(mu, bc1)
        torch.div(nu, bc2, out=t).add_(group["eps_root"]).sqrt_().add_(group["eps"])
        u.div_(t)
        if group["weight_decay"]:
            u.add_(torch.mul(p, group["weight_decay"], out=t))
        return u.mul_(neg_lr)


class Adagrad(OptaxRule):
    """``optax.adagrad``: scale_by_rss (accumulator from 0.1, eps 1e-7)."""

    def __init__(self, params, lr, initial_accumulator_value=0.1, eps=1e-7,
                 injected=False):
        super().__init__(params, lr, injected,
                         initial_accumulator_value=initial_accumulator_value,
                         eps=eps)

    def _init(self, p):
        return {"sum_of_squares": torch.full_like(
            p, self.defaults["initial_accumulator_value"])}

    def _update(self, g, p, state, neg_lr, group):
        sos = state["sum_of_squares"]
        sos.add_(g * g)                                     # g² + sos
        inv = torch.where(sos > 0, torch.rsqrt(sos + group["eps"]),
                          torch.zeros_like(sos))
        return (inv * g) * neg_lr


class SGD(OptaxRule):
    """``optax.sgd``: an optional trace (momentum, Nesterov), then -lr."""

    def __init__(self, params, lr, momentum=None, nesterov=False,
                 injected=False):
        super().__init__(params, lr, injected, momentum=momentum,
                         nesterov=nesterov)

    def _init(self, p):
        return {"trace": torch.zeros_like(p)} if self.defaults["momentum"] else {}

    def _update(self, g, p, state, neg_lr, group):
        m = group["momentum"]
        if m:
            t = state["trace"]
            t.mul_(m).add_(g)                               # g + m·trace
            g = g + m * t if group["nesterov"] else t
        return g * neg_lr


class FTRL(OptaxRule):
    """FTRL-Proximal (McMahan et al., KDD 2013), the JAX package's ``ftrl``:

    w = 0                                    if |z| ≤ λ1
        −(z − sign(z)λ1) / ((β + √n)/α + λ2)  otherwise
    """

    def __init__(self, params, lr=0.05, beta=1.0, lambda1=0.0, lambda2=0.0,
                 injected=False):
        super().__init__(params, lr, injected, beta=beta, lambda1=lambda1,
                         lambda2=lambda2)

    def _init(self, p):
        return {"z": torch.zeros_like(p), "n": torch.zeros_like(p)}

    def _scalars(self, lr, group):
        return lr

    def _update(self, g, p, state, lr, group):
        z, n = state["z"], state["n"]
        n_new = n + g * g
        sigma = (torch.sqrt(n_new) - torch.sqrt(n)) / lr
        z.add_(g).sub_(sigma * p)                           # z + g − σ·w
        denom = (group["beta"] + torch.sqrt(n_new)) / lr + group["lambda2"]
        l1 = group["lambda1"]
        w_new = torch.where(z.abs() <= l1, torch.zeros_like(p),
                            -(z - torch.sign(z) * l1) / denom)
        n.copy_(n_new)
        return w_new - p


class AdamW(Adam):
    """``optax.adamw``: Adam with decoupled weight decay, 1e-4 by default."""

    def __init__(self, params, lr, weight_decay=1e-4, **kw):
        super().__init__(params, lr, weight_decay=weight_decay, **kw)


RULES = {"adam": Adam, "adagrad": Adagrad, "sgd": SGD, "adamw": AdamW,
         "ftrl": FTRL}


@dataclass(frozen=True)
class OptimizerSpec:
    """An optimizer not yet bound to parameters (what an optax
    ``GradientTransformation`` is to the JAX package)."""

    name: str
    lr: LearningRate
    injected: bool = False
    hp: Dict = field(default_factory=dict)

    def init(self, model: Union[nn.Module, Iterable]) -> OptaxRule:
        params = [p for _, p in _named(model)]
        return RULES[self.name](params, self.lr, injected=self.injected,
                                **self.hp)


def _named(model) -> NamedParams:
    if isinstance(model, nn.Module):
        return list(model.named_parameters())
    return list(model)


# ---------------------------------------------------------------------------
# Learning-rate schedules (optax's formulas, in f32 on the count's device)


def _count(count) -> torch.Tensor:
    return torch.as_tensor(count)


def _cosine(init_value: float, decay_steps: int, alpha: float) -> Schedule:
    if not decay_steps > 0:
        raise ValueError("The cosine_decay_schedule requires positive "
                         f"decay_steps, got decay_steps={decay_steps!r}.")

    def schedule(count):
        c = torch.clamp_max(_count(count).float(), float(decay_steps))
        cosine_decay = 0.5 * (1 + torch.cos(math.pi * c / decay_steps))
        return init_value * ((1 - alpha) * cosine_decay + alpha)
    return schedule


def _exponential(init_value: float, transition_steps: int,
                 decay_rate: float) -> Schedule:
    if transition_steps <= 0 or decay_rate == 0:
        return lambda count: init_value

    def schedule(count):
        count = _count(count)
        p = count / transition_steps
        return torch.where(count <= 0, init_value,
                           init_value * torch.pow(decay_rate, p))
    return schedule


def _warmup_cosine(init_value: float, peak_value: float, warmup_steps: int,
                   decay_steps: int, end_value: float) -> Schedule:
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cosine = _cosine(peak_value, decay_steps - warmup_steps, alpha)

    def warmup(count):        # optax's linear_schedule
        if warmup_steps <= 0:
            return init_value
        frac = 1 - torch.clamp(count, 0, warmup_steps) / warmup_steps
        return (init_value - peak_value) * frac + peak_value

    def schedule(count):      # optax's join_schedules
        count = _count(count)
        return torch.where(count < warmup_steps, warmup(count),
                           cosine(count - warmup_steps))
    return schedule


def make_lr_schedule(name: str, base_lr: float, *, decay_steps: int = 10_000,
                     warmup_steps: int = 0, decay_rate: float = 0.96,
                     transition_steps: int = 1000, end_lr_frac: float = 0.0
                     ) -> LearningRate:
    """Step-based LR schedules, as optax's ``cosine_decay_schedule``,
    ``exponential_decay`` and ``warmup_cosine_decay_schedule``; 'constant'
    is the float itself."""
    name = (name or "constant").lower()
    if name == "constant":
        return base_lr
    if name == "cosine":
        return _cosine(base_lr, decay_steps, end_lr_frac)
    if name == "exponential":
        return _exponential(base_lr, transition_steps, decay_rate)
    if name == "warmup_cosine":
        return _warmup_cosine(0.0, base_lr, warmup_steps, decay_steps,
                              base_lr * end_lr_frac)
    raise ValueError(f"unknown lr schedule {name!r}")


def make_optimizer(name: str = "adam", learning_rate: float = 1e-3,
                   schedule: str = "", inject_lr: bool = False,
                   **kw) -> OptimizerSpec:
    """``schedule``: '' | cosine | exponential | warmup_cosine (step-based,
    kwargs forwarded to :func:`make_lr_schedule`). ``inject_lr=True`` lets
    the host retune the LR between steps (``set_learning_rate``, the
    ReduceLROnPlateau mechanism); incompatible with a step schedule."""
    name = name.lower()
    if name not in RULES:
        raise ValueError(f"unknown optimizer {name!r}")
    if schedule and inject_lr:
        raise ValueError("pick ONE of schedule= (step-based) or "
                         "inject_lr= (host-controlled plateau)")
    sched_kw = {k: kw.pop(k) for k in ("decay_steps", "warmup_steps",
                                       "decay_rate", "transition_steps",
                                       "end_lr_frac") if k in kw}
    lr = make_lr_schedule(schedule, learning_rate, **sched_kw) \
        if schedule else learning_rate
    return OptimizerSpec(name, lr, inject_lr, dict(kw))


def set_learning_rate(optimizer, lr: float):
    """Set the LR of an optimizer built with ``inject_lr=True``, in place,
    between steps (the host's float and the f32 scalar its steps read on
    the device); returns the optimizer."""
    if not getattr(optimizer, "injected", False):
        raise ValueError("optimizer was not built with inject_lr=True")
    for group in optimizer.param_groups:
        group["lr"] = float(lr)
    optimizer.lr_tensor.fill_(float(lr))
    return optimizer


def get_learning_rate(optimizer) -> float:
    return float(optimizer.param_groups[0]["lr"])


def _is_table(name: str) -> bool:
    keys = name.split(".")
    # the row tables of FusedEmbedding (with the narrow-width sub-tables
    # "table{d}"/"linear{d}" of the reference; align{d} routes to dense)
    return "embedding" in keys and any(
        k.startswith("table") or k.startswith("linear") for k in keys)


class Partitioned:
    """Two bound optimizers, one over the embedding tables and one over
    everything else, stepped together."""

    def __init__(self, parts: Dict[str, OptaxRule]):
        self.parts = parts

    def step(self, closure=None):
        for opt in self.parts.values():
            opt.step()

    def zero_grad(self, set_to_none: bool = True):
        for opt in self.parts.values():
            opt.zero_grad(set_to_none=set_to_none)


@dataclass(frozen=True)
class PartitionedSpec:
    dense: OptimizerSpec
    table: OptimizerSpec

    def init(self, model) -> Partitioned:
        named = _named(model)
        parts = {}
        for label, spec in (("dense", self.dense), ("table", self.table)):
            chosen = [(n, p) for n, p in named if _is_table(n) == (label == "table")]
            if chosen:
                parts[label] = spec.init(chosen)
        return Partitioned(parts)


def embedding_partitioned(dense_opt: OptimizerSpec,
                          table_opt: Optional[OptimizerSpec] = None,
                          table_lr: float = 1e-2) -> PartitionedSpec:
    """Route the embedding tables' gradients to ``table_opt`` (default
    Adagrad at ``table_lr``) and every other parameter's to ``dense_opt``."""
    return PartitionedSpec(dense_opt,
                           table_opt or make_optimizer("adagrad", table_lr))
