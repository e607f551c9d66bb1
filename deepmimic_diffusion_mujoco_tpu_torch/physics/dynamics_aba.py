"""The articulated-body link tree of the humanoid.

From ``deepmimic_diffusion_mujoco_tpu/physics/dynamics_aba.py`` only the
link tables are ported (`_link_tables`, :86-110): the whole-control-step
kernel and its plain version (``dynamics_kernel.py``) walk this tree. The
env-last ABA engine itself (`forward_dynamics_aba`, `step_physics_aba`) is
not ported yet (ROADMAP Queue A).
"""
from __future__ import annotations

import numpy as np

from .dynamics import JOINT_BODY, NJ
from .humanoid_model import BODIES, BODY_INDEX


def _link_tables():
    """Expand the (body, 1-3 hinge) tree into one link per hinge DOF.

    A body's hinges fold sequentially (declaration order), so hinge k of a
    body hangs off hinge k-1 of the same body; the first hinge hangs off the
    parent body's LAST hinge link (or the root). The body's inertia attaches
    to its last hinge link; intermediate links are massless (always
    well-posed: armature > 0 keeps every D_i > 0)."""
    parent = np.zeros(NJ, np.int32)
    carrier = -np.ones(NJ, np.int32)
    last_link: dict[int, int] = {}
    for i in range(NJ):
        b = int(JOINT_BODY[i])
        if i > 0 and int(JOINT_BODY[i - 1]) == b:
            parent[i] = i - 1
        else:
            pb = BODY_INDEX[BODIES[b].parent]
            parent[i] = -1 if pb == 0 else last_link[pb]
        last_link[b] = i
    for b, i in last_link.items():
        carrier[i] = b
    return parent, carrier, last_link


LINK_PARENT, LINK_CARRIER, _BODY_LAST_LINK = _link_tables()
