"""Train state: the model's parameters, the optimizer, its LR schedule and
the EMA weights.

Counterpart of ``deepmimic_diffusion_mujoco_tpu/train/state.py``, with the
update rules of its optax optimizers and ``TrainState.apply_gradients``:

- ``make_optimizer``: ``torch.optim.Adam`` / ``AdamW`` (eps 1e-8, no
  eps-root, as optax's) with a ``LambdaLR`` that gives optax's schedules.
  optax reads a schedule at the update count BEFORE the update, so the
  first update uses ``schedule(0)``; the scheduler steps once per real
  update. ``exponential`` is continuous (``lr * rate**(count / steps)``,
  not staircase); ``cosine`` and ``linear`` run over ``num_train_steps``.
  optax's ``adamw`` decays as ``p - lr * (u + wd * p)``, as torch's
  ``AdamW`` does.
- Gradient accumulation is ``optax.MultiSteps``: ``step`` counts
  micro-steps; the k gradients are AVERAGED (Welford's running mean, as
  optax computes it), and the optimizer steps, and Adam's count advances,
  only on every k-th micro-step; between real updates the parameters do
  not change.
- The EMA gates are read at the micro-step count and are NOT rescaled by k
  (the JAX ``cli/train.py`` wraps ``MultiSteps`` itself and passes
  ``wrap_accum=False``): at a micro-step where ``step % every == 0`` the
  EMA copies the parameters if ``step < start``, else lerps
  ``ema = decay * ema + (1 - decay) * params``.

The EMA weights are a plain dict of tensors keyed like the model's state
dict, updated in place (JAX rebuilds the pytree each step).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class EMAConfig:
    decay: float = 0.995
    start: int = 2000       # copy params before this micro-step
    every: int = 10         # update cadence, in micro-steps


def _lr_multiplier(schedule: str | None, num_train_steps: int = 10000,
                  schedule_kwargs: dict | None = None, lr: float = 2e-5):
    """optax's schedule divided by its initial value, as a function of the
    update count (the ``LambdaLR`` lambda)."""
    kw = schedule_kwargs or {}
    if schedule == "cosine":
        alpha = kw.get("alpha", 0.0)

        def mult(count):
            c = min(count, num_train_steps)
            return (1 - alpha) * 0.5 * (1 + math.cos(math.pi * c / num_train_steps)) + alpha
    elif schedule == "linear":
        end = kw.get("end_lr", 0.0)

        def mult(count):
            frac = 1 - min(max(count, 0), num_train_steps) / num_train_steps
            return ((lr - end) * frac + end) / lr
    elif schedule == "exponential":
        steps, rate = kw.get("decay_steps", 1000), kw.get("decay_rate", 0.99)

        def mult(count):
            return rate ** (count / steps)
    elif schedule is None:
        def mult(count):
            return 1.0
    else:
        raise ValueError(f"unknown schedule {schedule!r}")
    return mult


def make_optimizer(
    params,
    kind: str = "adam",
    lr: float = 2e-5,
    weight_decay: float = 0.0,
    betas: tuple[float, float] = (0.9, 0.999),
    schedule: str | None = None,
    num_train_steps: int = 10000,
    schedule_kwargs: dict | None = None,
) -> tuple[torch.optim.Optimizer, torch.optim.lr_scheduler.LambdaLR]:
    """-> (optimizer, LR scheduler) over ``params``."""
    mult = _lr_multiplier(schedule, num_train_steps, schedule_kwargs, lr)
    betas = tuple(betas)
    if kind == "adam":
        opt = torch.optim.Adam(params, lr=lr, betas=betas, eps=1e-8, weight_decay=0.0)
    elif kind == "adamw":
        opt = torch.optim.AdamW(params, lr=lr, betas=betas, eps=1e-8, weight_decay=weight_decay)
    else:
        raise ValueError(f"unknown optimizer {kind!r}")
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, mult)


class TrainState:
    """Parameters (the model's), optimizer, LR schedule, EMA and the
    micro-step count, for a model trained with ``accum``-way gradient
    accumulation."""

    def __init__(self, model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                 scheduler: torch.optim.lr_scheduler.LRScheduler,
                 ema: EMAConfig = EMAConfig(), accum: int = 1):
        self.model = model
        self.optimizer = optimizer
        self.scheduler = scheduler
        self.ema_config = ema
        self.accum = max(1, accum)
        self.step = 0
        state = model.state_dict()
        self.ema_params = {k: v.detach().clone() for k, v in state.items()}
        self._live = list(state.values())
        self._ema = list(self.ema_params.values())
        self._params = list(model.parameters())
        self._acc = ([torch.zeros_like(p) for p in self._params] if self.accum > 1 else None)

    def apply_gradients(self):
        """One micro-step with the gradients in ``p.grad`` (None reads as
        zero, as JAX's gradient of an unused parameter is)."""
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in self._params]
        n_acc = self.step % self.accum
        self.step += 1
        if self._acc is None:
            self._update(grads)
        else:
            diff = torch._foreach_sub(grads, self._acc)
            torch._foreach_div_(diff, n_acc + 1)
            torch._foreach_add_(self._acc, diff)
            if n_acc == self.accum - 1:
                self._update(self._acc)
                torch._foreach_zero_(self._acc)
        cfg = self.ema_config
        if self.step % cfg.every == 0:
            with torch.no_grad():
                if self.step < cfg.start:
                    torch._foreach_copy_(self._ema, self._live)
                else:
                    torch._foreach_mul_(self._ema, cfg.decay)
                    torch._foreach_add_(self._ema, self._live, alpha=1.0 - cfg.decay)

    def _update(self, grads):
        for p, g in zip(self._params, grads):
            p.grad = g
        self.optimizer.step()
        self.scheduler.step()

    def opt_state_dict(self) -> dict:
        """The optimizer's and the LR schedule's state and the gradient
        accumulator (None without accumulation), for a checkpoint."""
        return {"optimizer": self.optimizer.state_dict(),
                "scheduler": self.scheduler.state_dict(), "acc_grads": self._acc}

    def load(self, payload: dict):
        """Restore a checkpoint's step, params, EMA and optimizer state."""
        self.step = int(payload["step"])
        self.model.load_state_dict(payload["params"])
        with torch.no_grad():
            for k, v in payload["ema_params"].items():
                self.ema_params[k].copy_(v)
        self.optimizer.load_state_dict(payload["opt_state"]["optimizer"])
        self.scheduler.load_state_dict(payload["opt_state"]["scheduler"])
        if self._acc is not None:
            torch._foreach_copy_(self._acc, payload["opt_state"]["acc_grads"])
