"""Checkpoints with the JAX package's metadata-autodetect contract.

The JAX package writes orbax directories, which cannot be read without JAX.
The port writes ``<directory>/<name>.pt`` (``torch.save`` of
``{"step", "params", "ema_params"}``, params as state dicts, plus
``"opt_state"`` in periodic saves: the optimizer's and the LR schedule's
state dicts and the gradient accumulator, which ``--resume`` continues
from) and, beside it, the same
sidecar ``<name>.json`` metadata: ``step``, ``git_rev`` and, for the best
model, ``loss`` and ``best_loss``. Names are ``state_<step>`` for periodic
saves and ``best_model``; ``step`` counts micro-steps, as the JAX
package's ``TrainState.step`` does under gradient accumulation. The best
model serves inference and carries no optimizer state.
"""
from __future__ import annotations

import glob
import json
import os
import re
import subprocess

import torch


def _git_rev() -> str | None:
    """The code revision recorded with every checkpoint."""
    try:
        return subprocess.run(
            ["git", "rev-parse", "HEAD"], capture_output=True, text=True,
            timeout=5, cwd=os.path.dirname(os.path.abspath(__file__)),
        ).stdout.strip() or None
    except (OSError, subprocess.SubprocessError):
        return None


class Checkpointer:
    def __init__(self, directory: str, metadata: dict | None = None):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.metadata = dict(metadata or {})
        self.metadata.setdefault("git_rev", _git_rev())

    # -- save ------------------------------------------------------------

    def _save_at(self, name: str, step: int, params: dict, ema_params: dict,
                 extra_meta: dict, opt_state: dict | None = None):
        payload = {"step": int(step), "params": params, "ema_params": ema_params}
        if opt_state is not None:
            payload["opt_state"] = opt_state
        path = os.path.join(self.directory, name + ".pt")
        torch.save(payload, path + ".tmp")
        os.replace(path + ".tmp", path)
        meta = {**self.metadata, "step": int(step), **extra_meta}
        with open(os.path.join(self.directory, name + ".json"), "w") as f:
            json.dump(meta, f, indent=2)

    def save(self, step: int, params: dict, ema_params: dict, opt_state: dict | None = None):
        self._save_at(f"state_{int(step)}", step, params, ema_params, {}, opt_state)

    def save_best(self, step: int, params: dict, ema_params: dict, loss: float):
        # "loss" is the reference's checkpoint-filename field, "best_loss"
        # the one compare reports read
        self._save_at("best_model", step, params, ema_params,
                      {"loss": loss, "best_loss": loss})

    # -- load ------------------------------------------------------------

    def latest_step(self) -> int | None:
        steps = [
            int(m.group(1))
            for p in glob.glob(os.path.join(self.directory, "state_*.pt"))
            if (m := re.match(r".*state_(\d+)\.pt$", p))
        ]
        return max(steps) if steps else None

    def restore(self, step: int | None = None, best: bool = False,
                map_location: str | torch.device = "cpu") -> tuple[dict, dict]:
        """-> (payload, metadata). Raises FileNotFoundError if absent."""
        if best:
            name = "best_model"
        else:
            step = step if step is not None else self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoints in {self.directory}")
            name = f"state_{step}"
        path = os.path.join(self.directory, name + ".pt")
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        payload = torch.load(path, map_location=map_location, weights_only=True)
        meta = {}
        meta_path = os.path.join(self.directory, name + ".json")
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                meta = json.load(f)
        return payload, meta


def autodetect_metadata(directory: str, name: str = "best_model") -> dict:
    """Read a checkpoint's sidecar metadata."""
    with open(os.path.join(directory, name + ".json")) as f:
        return json.load(f)
