"""Tensor-parallel parameters by module-name rules.

Counterpart of ``deepmimic_diffusion_mujoco_tpu/parallel/tp.py`` on
``torch.distributed.tensor.parallel``: Megatron-style column parallel for
the attention's query/key/value and the feed-forward's expansion, row
parallel for the attention's output and the feed-forward's contraction,
so each layer's attention and feed-forward need one all_reduce each. Rules
map regex patterns over the port's module names to "colwise" or
"rowwise"; a matched ``nn.Linear`` is split only when its split width
divides the ranks and, inside an attention, holds whole heads (the
attention reads its head count off the projections' width,
``models.transformer.MultiHeadAttention``). Unmatched modules and shapes
that do not split stay replicated.

The rules cover the MDM transformer (``models.transformer``). The local
transformer's fused q/k/v projection and GEGLU input projection lay q, k, v
(and value, gate) side by side along the output axis, which a contiguous
column split does not keep whole, so its layers stay replicated.
"""
from __future__ import annotations

import re

import torch.nn as nn


def default_tp_rules() -> list[tuple[str, str]]:
    """Column/row-parallel rules for the MDM transformer's layers."""
    return [
        (r"layers\.\d+\.attn\.(query|key|value)", "colwise"),
        (r"layers\.\d+\.attn\.out", "rowwise"),
        (r"layers\.\d+\.ff\.dense_0", "colwise"),
        (r"layers\.\d+\.ff\.dense_1", "rowwise"),
    ]


def _splits(model: nn.Module, name: str, linear: nn.Linear, style: str, ranks: int) -> bool:
    width = linear.out_features if style == "colwise" else linear.in_features
    if width % ranks:
        return False
    parent = model.get_submodule(name.rpartition(".")[0])
    dim_head = getattr(parent, "dim_head", None)
    return dim_head is None or (width // ranks) % dim_head == 0


def shard_params(model: nn.Module, mesh, rules: list[tuple[str, str]] | None = None) -> dict:
    """Split ``model``'s rule-matched Linear layers over ``mesh`` (a 1-D
    ``DeviceMesh``) in place; the rest stay replicated. Every rank must hold
    the same weights: each keeps its own share of them, nothing is sent.
    Returns the plan (module name -> style)."""
    from torch.distributed.tensor.parallel import (
        ColwiseParallel,
        RowwiseParallel,
        parallelize_module,
    )

    rules = default_tp_rules() if rules is None else rules
    styles = {"colwise": ColwiseParallel, "rowwise": RowwiseParallel}
    ranks = mesh.size()
    plan = {}
    for name, module in model.named_modules():
        for pattern, style in rules:
            if re.fullmatch(pattern, name):
                if isinstance(module, nn.Linear) and _splits(model, name, module, style, ranks):
                    plan[name] = style
                break
    parallelize_module(model, mesh, {n: styles[s]() for n, s in plan.items()},
                       src_data_rank=None)
    return plan
