"""Optimizer and epoch-level learning-rate schedules (JAX
``training/optimizer.py``), with optax's arithmetic.

``Optimizer`` is the JAX trainer's chain ``clip_by_global_norm(max_norm)``
-> ``adam`` | ``adamw`` | ``sgd``, optionally inside ``MultiSteps(k)``:

- clip: with ``g_norm = sqrt(sum g^2)``, ``g / g_norm * max_norm`` when
  ``g_norm >= max_norm`` (no epsilon; ``clip_grad_norm_`` differs; under
  tensor parallelism the norm of the full gradient, ``global_norm``);
- Adam: ``m = (1 - b1) g + b1 m``, ``v = (1 - b2) g^2 + b2 v``, count + 1,
  ``u = (m / (1 - b1^count)) / (sqrt(v / (1 - b2^count)) + eps)``;
  AdamW adds ``wd * p`` to ``u``; ``p += -lr * u``;
- SGD: ``t = g + momentum t``, ``u = g + momentum t`` (Nesterov) or ``t``;
- MultiSteps: a running mean ``acc += (g - acc) / (mini_step + 1)``; the k-th
  micro-step applies the chain to the mean of the k gradients, the others
  change no parameter.

The clip and Adam / AdamW run through ``ops/cuda_optimizer.py``: on CUDA
tensors the kernels ``global_sq_norm`` and ``adam_update``, one launch each
over every parameter tensor; on CPU tensors their plain versions, the loops
over the tensors. SGD and the accumulation keep their loops. Counters:
``optimizer.fused_steps`` (steps that launched ``adam_update``) and
``optimizer.loop_steps`` (steps that looped).

The learning rate is a field (``lr``) that the trainer sets once per epoch.
Schedules map epoch -> lr; ``cosine`` ignores ``warmup_epochs`` as the
reference does (only ``warmup_cosine`` warms up).
``warmup_cosine_step_schedule`` maps a step to an lr, for step-driven runs.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..ops import cuda_optimizer
from ..parallel.collectives import all_reduce_
from ..utils import tracing


def global_norm(grads: Sequence[torch.Tensor],
                params: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
    """sqrt of the sum of squares of every element, as ``optax.global_norm``.
    Under tensor parallelism (``params`` given, the shards among them marked
    by ``shard_model`` with their ``tp_group``) it is the norm of the full
    gradient: the shards' squares summed over the model group, the replicated
    leaves' counted once. Every model rank then clips by the same factor.
    Without tensor parallelism it is ``cuda_optimizer.global_norm``: one
    ``global_sq_norm`` launch on CUDA tensors."""
    groups = [getattr(p, "tp_group", None) for p in params] if params is not None else []
    group = next((g for g in groups if g is not None), None)
    if group is None:
        return cuda_optimizer.global_norm(grads)
    sharded = sum(torch.sum(g * g) for g, s in zip(grads, groups) if s is not None)
    replicated = sum((torch.sum(g * g) for g, s in zip(grads, groups) if s is None),
                     torch.zeros_like(sharded))
    return torch.sqrt(all_reduce_(sharded.clone(), group) + replicated)


class Optimizer:
    """Global-norm clip, then Adam / AdamW / SGD, with optional gradient
    accumulation over ``accum_steps`` micro-steps. ``step`` takes the
    gradients of ``params`` in order and updates the parameters in place
    (under ``torch.no_grad``)."""

    def __init__(self, params: Sequence[torch.Tensor], name: str = "adamw", lr: float = 1e-4,
                 betas: Sequence[float] = (0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.01, momentum: Optional[float] = 0.9,
                 nesterov: bool = False, max_norm: Optional[float] = 1.0, accum_steps: int = 1):
        name = name.lower()
        if name not in ("adam", "adamw", "sgd"):
            raise ValueError(f"Unknown optimizer: {name}")
        self.params = list(params)
        self.name = name
        self.lr = float(lr)
        self.b1, self.b2 = (float(b) for b in betas)
        self.eps = float(eps)
        self.weight_decay = float(weight_decay)
        self.momentum = momentum
        self.nesterov = nesterov
        self.max_norm = max_norm if max_norm and max_norm > 0 else None
        self.accum_steps = int(accum_steps)
        self.count = 0  # applied optimizer steps (Adam's bias-correction count)
        self.mini_step = 0
        zeros = lambda: [torch.zeros_like(p) for p in self.params]  # noqa: E731
        self.mu = zeros() if name in ("adam", "adamw") else None
        self.nu = zeros() if name in ("adam", "adamw") else None
        self.trace = zeros() if name == "sgd" and momentum is not None else None
        self.acc = zeros() if self.accum_steps > 1 else None

    @classmethod
    def from_config(cls, params, config: dict) -> "Optimizer":
        tc = config.get("training", config)
        oc = tc.get("optimizer", {})
        return cls(
            params, name=oc.get("name", "adamw"),
            lr=oc.get("lr", 1e-4),
            betas=tuple(oc.get("betas", (0.9, 0.999))), eps=oc.get("eps", 1e-8),
            weight_decay=oc.get("weight_decay", 0.01), momentum=oc.get("momentum", 0.9),
            nesterov=oc.get("nesterov", False), max_norm=tc.get("gradient_clip_max_norm", 1.0),
            accum_steps=tc.get("gradient_accumulation_steps", 1),
        )

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> bool:
        """One (micro-)step; True when it changed the parameters."""
        grads = list(grads)
        if self.acc is not None:
            n = self.mini_step
            for a, g in zip(self.acc, grads):
                a.add_((g - a) / (n + 1))
            self.mini_step = (self.mini_step + 1) % self.accum_steps
            if self.mini_step != 0:
                return False
            grads = [a.clone() for a in self.acc]
            for a in self.acc:
                a.zero_()
        g_norm = global_norm(grads, self.params) if self.max_norm is not None else None
        self.count += 1
        if self.mu is not None:
            fused = cuda_optimizer.adam_update(
                self.params, grads, self.mu, self.nu, lr=self.lr, b1=self.b1, b2=self.b2,
                eps=self.eps, weight_decay=self.weight_decay, adamw=self.name == "adamw",
                count=self.count, g_norm=g_norm, max_norm=self.max_norm)
        else:
            fused = False
            if self.max_norm is not None:
                grads = cuda_optimizer.clip_plain(grads, g_norm, self.max_norm)
            lr = -self.lr
            for i, (p, g) in enumerate(zip(self.params, grads)):
                u = g
                if self.trace is not None:
                    t = self.trace[i]
                    t.copy_(g + self.momentum * t)
                    u = g + self.momentum * t if self.nesterov else t
                p.add_(lr * u)
        tracing.count("optimizer.fused_steps" if fused else "optimizer.loop_steps")
        return True

    def state_dict(self) -> Dict:
        """The optimizer's state as plain values and lists of tensors."""
        return {"name": self.name, "lr": self.lr, "count": self.count,
                "mini_step": self.mini_step,
                **{k: getattr(self, k) for k in ("mu", "nu", "trace", "acc")
                   if getattr(self, k) is not None}}

    @torch.no_grad()
    def load_state_dict(self, state: Dict) -> None:
        if state["name"] != self.name:
            raise ValueError(f"optimizer state of {state['name']!r}, not {self.name!r}")
        self.lr = float(state["lr"])
        self.count = int(state["count"])
        self.mini_step = int(state["mini_step"])
        for k in ("mu", "nu", "trace", "acc"):
            own = getattr(self, k)
            if own is None:
                continue
            if k not in state or len(state[k]) != len(own):
                raise ValueError(f"optimizer state {k!r} does not match the parameters")
            for dst, src in zip(own, state[k]):
                src = torch.from_numpy(np.array(src)) if isinstance(src, np.ndarray) else src
                dst.copy_(src.reshape(dst.shape))


# ---------------------------------------------------------------------------
# Epoch-level learning-rate schedules
# ---------------------------------------------------------------------------


@dataclass
class PlateauState:
    best: float = math.inf
    bad_epochs: int = 0
    lr: float = 0.0


class EpochScheduler:
    """epoch -> lr; ``scheduler(epoch, val_loss)`` (plateau needs the loss)."""

    def __init__(self, fn: Callable[[int], float], name: str):
        self.fn = fn
        self.name = name

    def __call__(self, epoch: int, val_loss: Optional[float] = None) -> float:
        return self.fn(epoch)


class PlateauScheduler(EpochScheduler):
    """ReduceLROnPlateau on the validation loss."""

    def __init__(self, base_lr: float, patience: int, factor: float, min_lr: float):
        super().__init__(lambda e: self.state.lr, "plateau")
        self.state = PlateauState(lr=base_lr)
        self.patience = patience
        self.factor = factor
        self.min_lr = min_lr

    def __call__(self, epoch: int, val_loss: Optional[float] = None) -> float:
        if val_loss is not None:
            if val_loss < self.state.best - 1e-12:
                self.state.best = val_loss
                self.state.bad_epochs = 0
            else:
                self.state.bad_epochs += 1
                if self.state.bad_epochs > self.patience:
                    self.state.lr = max(self.state.lr * self.factor, self.min_lr)
                    self.state.bad_epochs = 0
        return self.state.lr


def create_scheduler(config: dict, num_epochs: Optional[int] = None) -> EpochScheduler:
    """The epoch schedule of ``training.scheduler``: ``none``, ``cosine``
    (no warmup), ``warmup_cosine``, ``step`` or ``plateau``."""
    tc = config.get("training", config)
    sc = tc.get("scheduler", {})
    base_lr = tc.get("optimizer", {}).get("lr", 1e-4)
    name = sc.get("name", "cosine").lower()
    total = num_epochs or tc.get("num_epochs", 100)
    min_lr = sc.get("min_lr", 1e-6)

    if name in ("none", "", "constant"):
        return EpochScheduler(lambda e: base_lr, "none")
    if name == "cosine":
        def fn(epoch: int) -> float:
            t = min(epoch, total) / max(total, 1)
            return min_lr + 0.5 * (base_lr - min_lr) * (1 + math.cos(math.pi * t))
        return EpochScheduler(fn, "cosine")
    if name == "warmup_cosine":
        warmup = sc.get("warmup_epochs", 5)

        def fn(epoch: int) -> float:
            if epoch < warmup:
                return base_lr * (epoch + 1) / max(warmup, 1)
            t = min((epoch - warmup) / max(total - warmup, 1), 1.0)
            return min_lr + 0.5 * (base_lr - min_lr) * (1 + math.cos(math.pi * t))
        return EpochScheduler(fn, "warmup_cosine")
    if name == "step":
        step_size = sc.get("step_size", 30)
        gamma = sc.get("gamma", 0.1)
        return EpochScheduler(lambda e: base_lr * gamma ** (e // step_size), "step")
    if name == "plateau":
        return PlateauScheduler(base_lr, patience=sc.get("patience", 5),
                                factor=sc.get("factor", 0.5), min_lr=min_lr)
    raise ValueError(f"Unknown scheduler: {name}")


def warmup_cosine_step_schedule(base_lr: float, warmup_steps: int, total_steps: int,
                                min_lr: float = 0.0) -> Callable[[int], float]:
    """step -> lr, as ``optax.warmup_cosine_decay_schedule(0, base_lr,
    warmup_steps, total_steps, min_lr)``: linear from 0 to ``base_lr`` over
    ``warmup_steps`` (none at 0), then a cosine from ``base_lr`` to
    ``min_lr`` over the remaining ``total_steps - warmup_steps``, then
    ``min_lr``."""
    decay = total_steps - warmup_steps
    if decay <= 0:
        raise ValueError(f"total_steps ({total_steps}) must exceed warmup_steps ({warmup_steps})")
    alpha = 0.0 if base_lr == 0.0 else min_lr / base_lr

    def schedule(step: int) -> float:
        if step < warmup_steps or step < 0:
            return base_lr * max(step, 0) / max(warmup_steps, 1)
        t = min(step - warmup_steps, decay)
        return base_lr * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * t / decay)) + alpha)

    return schedule


def parameters(model: torch.nn.Module) -> List[torch.Tensor]:
    """The trainable parameters in ``named_parameters`` order."""
    return [p for p in model.parameters() if p.requires_grad]
