"""Training loop: one eager update step, batches fed from the host.

Counterpart of ``deepmimic_diffusion_mujoco_tpu/train/loop.py``:
``make_loss_fn`` for every loss kind (stack A's "diffuser", stack B's
"v4", "x0" and "kl" with CFG label drop, "angle_velocity"), the train step
(loss, backward, optimizer, EMA), the loss-aware timestep sampler's
update, and ``Trainer.train``'s per-step loop with its log records,
best-model window and periodic saves, and ``save_metrics`` (the same
``training_metrics.json``).

The JAX package's ``lax.scan`` chunking (``_train_scanned``,
``make_train_many``) compiles ``scan_chunk`` updates into one call. Here
every micro-step runs through the same per-step loop whatever
``TrainerConfig.scan_chunk`` is; the chunk sets only the log records. With
``scan_chunk > 1`` there is one record per ``scan_chunk`` micro-steps and
one for a ragged tail, each with ``step``, that micro-step's ``loss`` and
``steps_per_s`` in micro-steps, as the scanned trainer writes them; with
``scan_chunk <= 1`` one every ``log_every`` micro-steps with the loss's
scalar ``info`` fields too. The best model is tracked over every
micro-step either way, exactly as the scanned path does (the post-update
state of the lowest-loss micro-step at or after optimizer step
``int(n * (1 - best_window_frac))``). Timesteps, noise, label-drop masks
and dropout masks come from the trainer's ``torch.Generator`` on the
device (``Trainer.draw``, the loss function's ``generator``), so they
differ from the JAX package's draws; tests inject the same ones into both.
"""
from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass
from typing import Callable

import torch

from ..diffusion import process
from ..diffusion import timestep_sampling as ts
from ..diffusion.schedules import Schedule
from .state import TrainState

LOSS_KINDS = ("diffuser", "v4", "x0", "kl", "angle_velocity")


def make_loss_fn(
    sched: Schedule,
    model: torch.nn.Module,
    kind: str = "diffuser",
    *,
    predict_epsilon: bool = True,
    weights: torch.Tensor | None = None,
    loss_kind: str = "l2",
    conditioning_fn=None,
    label_drop_prob: float = 0.1,
    null_label: int | None = None,
    smooth_loss_weight: float = 0.1,
    use_mask: bool = False,
    dropout: bool = False,
) -> Callable:
    """The per-batch loss ``loss_fn(x0, t, noise, *, y=None, mask=None,
    t_weights=None, generator=None, drop=None) -> (loss, info)``.

    kind="diffuser": stack A's weighted p_losses (conditioning applied
    inside); "v4": stack B's epsilon-space MSE; "x0": the same in x0 space;
    "kl": the posterior KL; "angle_velocity": the tuning model's x0 +
    velocity loss. For v4 / x0 / kl with labels ``y`` and a ``null_label``,
    a Bernoulli(``label_drop_prob``) mask ``drop`` (drawn from
    ``generator`` unless given) sends labels to the null label, which
    trains CFG's unconditional branch. ``use_mask`` takes the (B, H) frame
    mask into the v4 / x0 loss; ``t_weights`` are the loss-aware sampler's
    importance weights. ``dropout=True`` hands ``generator`` to the model,
    whose dropout then draws its keep masks from it."""
    if kind not in LOSS_KINDS:
        raise ValueError(f"unknown loss kind {kind!r}; expected one of {LOSS_KINDS}")

    def loss_fn(x0, t, noise, *, y=None, mask=None, t_weights=None, generator=None, drop=None):
        model_kw = {"generator": generator} if dropout else {}
        if kind == "diffuser":
            return process.diffuser_p_losses(
                sched, lambda x, tt: model(x, tt, **model_kw), x0, t, noise, weights,
                predict_epsilon=predict_epsilon, loss_kind=loss_kind,
                conditioning_fn=conditioning_fn,
            )
        if kind == "angle_velocity":
            return process.angle_velocity_loss(
                sched, lambda x, tt: model(x, tt, **model_kw), x0, t, noise,
                smooth_loss_weight=smooth_loss_weight)
        if y is not None and null_label is not None:
            if drop is None:
                drop = torch.rand(y.shape, generator=generator,
                                  device=generator.device) < label_drop_prob
            y = torch.where(drop, torch.full_like(y, null_label), y)

        def model_fn(x, tt):
            return model(x, tt, y, **model_kw)

        if kind == "kl":
            return process.kl_training_loss(sched, model_fn, x0, t, noise,
                                            predict_x0=not predict_epsilon)
        return process.v4_training_loss(
            sched, model_fn, x0, t, noise, predict_x0=not predict_epsilon,
            mask=mask if use_mask else None, t_weights=t_weights,
            loss_space="x0" if kind == "x0" else "eps",
        )

    return loss_fn


def train_step(state: TrainState, loss_fn: Callable, x0, t, noise, **loss_kw):
    """loss -> backward -> optimizer (every ``accum`` micro-steps) -> EMA.
    -> (loss, info), detached."""
    state.optimizer.zero_grad(set_to_none=True)
    loss, info = loss_fn(x0, t, noise, **loss_kw)
    loss.backward()
    state.apply_gradients()
    return loss.detach(), {k: v.detach() for k, v in info.items()}


@dataclass
class TrainerConfig:
    num_train_steps: int = 5000
    batch_size: int = 64
    gradient_accumulate_every: int = 1
    log_every: int = 100
    save_every: int | None = None
    best_window_frac: float = 0.15   # best-model tracking window
    seed: int = 0
    scan_chunk: int = 1              # > 1: one log record per chunk of micro-steps
    class_balanced: bool = False


class Trainer:
    """Feeds batches, logs, checkpoints. ``dataset`` exposes
    ``.epochs(batch_size, seed, class_balanced=...)`` (data/datasets.py);
    each numpy batch is copied to the model's device. A
    ``LossSecondMomentState`` as ``sampler_state`` turns on the loss-aware
    timestep sampler: t is drawn from it, the loss is importance-weighted,
    and each step's per-sample losses are recorded in it."""

    def __init__(self, state: TrainState, loss_fn: Callable, dataset,
                 config: TrainerConfig = TrainerConfig(), checkpointer=None,
                 log_fn=print, num_timesteps: int = 1000,
                 sampler_state: ts.LossSecondMomentState | None = None):
        self.state = state
        self.sampler_state = sampler_state
        self.loss_fn = loss_fn
        self.dataset = dataset
        self.config = config
        self.checkpointer = checkpointer
        self.log_fn = log_fn
        self.num_timesteps = num_timesteps
        self.device = next(state.model.parameters()).device
        self.generator = torch.Generator(device=self.device).manual_seed(config.seed)
        self.metrics: list[dict] = []
        self.best_loss = float("inf")
        self.best_step = -1

    def draw(self, x0: torch.Tensor):
        """Timesteps (B,), uniform in [0, T) or from the loss-aware sampler,
        and Gaussian noise like x0."""
        if self.sampler_state is None:
            t, _ = ts.uniform_timesteps(self.generator, x0.shape[0], self.num_timesteps)
        else:
            t, _ = ts.loss_aware_timesteps(self.sampler_state, self.generator, x0.shape[0])
        noise = torch.randn(x0.shape, generator=self.generator, device=self.device)
        return t, noise

    def _to_device(self, a):
        a = torch.from_numpy(a)
        if self.device.type == "cuda":
            a = a.pin_memory()  # so that the copy does not wait for the device
        return a.to(self.device, non_blocking=True)

    def _save(self):
        st = self.state
        self.checkpointer.save(st.step, st.model.state_dict(), st.ema_params,
                               st.opt_state_dict())

    def train(self, num_steps: int | None = None) -> TrainState:
        cfg = self.config
        n = num_steps if num_steps is not None else cfg.num_train_steps
        accum = max(1, cfg.gradient_accumulate_every)
        batches = self.dataset.epochs(cfg.batch_size, seed=cfg.seed,
                                      class_balanced=cfg.class_balanced)
        best_from = int(n * (1.0 - cfg.best_window_frac))
        self.state.model.train()
        micro = n * accum
        chunk = cfg.scan_chunk if cfg.scan_chunk > 1 else None
        t0 = time.time()
        last_saved = 0
        for i in range(micro):
            batch = next(batches)
            x0, y, mask = (self._to_device(a) for a in
                           (batch.trajectories, batch.motion_class, batch.mask))
            t, noise = self.draw(x0)
            t_weights = (None if self.sampler_state is None
                         else ts.importance_weights(self.sampler_state, t))
            loss, info = train_step(self.state, self.loss_fn, x0, t, noise, y=y.long(),
                                    mask=mask, t_weights=t_weights, generator=self.generator)
            if self.sampler_state is not None:
                ts.update_with_losses(self.sampler_state, t, info["per_sample_loss"])
            # state.step counts micro-steps; report/compare in optimizer steps
            opt_step = self.state.step // accum
            if chunk is not None:
                log = (i + 1) % chunk == 0 or i + 1 == micro
            else:
                log = (i + 1) % cfg.log_every == 0
            if log:
                loss_v = float(loss)
                dt = time.time() - t0
                rec = {"step": opt_step, "loss": loss_v, "steps_per_s": (i + 1) / dt}
                if chunk is None:
                    rec.update({k: float(v) for k, v in info.items() if v.dim() == 0})
                self.metrics.append(rec)
                self.log_fn(f"step {opt_step}: loss {loss_v:.6f} "
                            f"({rec['steps_per_s']:.1f} steps/s)")
            # best model: every micro-step inside the final window
            if opt_step >= best_from:
                loss_v = float(loss)
                if loss_v < self.best_loss:
                    self.best_loss = loss_v
                    self.best_step = opt_step
                    if self.checkpointer is not None:
                        self.checkpointer.save_best(self.state.step, self.state.model.state_dict(),
                                                    self.state.ema_params, loss_v)
            if (cfg.save_every and self.checkpointer is not None
                    and opt_step // cfg.save_every > last_saved // cfg.save_every):
                last_saved = opt_step
                self._save()
        if self.checkpointer is not None:
            self._save()
        return self.state

    def save_metrics(self, path: str):
        """training_metrics.json: the log records, best loss and step."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump({"metrics": self.metrics, "best_loss": self.best_loss,
                       "best_step": self.best_step}, f, indent=2)
