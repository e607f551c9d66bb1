"""DeepMimic humanoid kinematic model: tree spec + MuJoCo XML generation.

The port's own copy of ``deepmimic_diffusion_mujoco_tpu/physics/
humanoid_model.py`` (numpy only; the tests hold it equal to the JAX
package's). The numeric skeleton (body offsets, joint axes/anchors, masses,
geometry) is transcribed from the reference model definition
(diffusion/assets/dp_env_v2.xml:20-107) — it is the humanoid these mocap
clips are authored for, so the numbers must match for playback/reward
parity. A declarative spec consumed by

- physics/kinematics.py: batched forward kinematics on torch tensors,
- physics/dynamics.py and dynamics_kernel.py: the static tables of the
  dynamics engine and of the CUDA kernels' header,
- to_xml(): regenerates a MuJoCo XML for a host-side player or oracle.

qpos layout matches data/skeleton.py: free root (3 pos + 4 quat wxyz) then
BODY_JOINTS order with hinge triples (x,y,z) or single hinges — 35 dims.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..data.skeleton import BODY_JOINTS, DOF_DEF

X, Y, Z = (1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (0.0, 0.0, 1.0)
NEG_Y = (0.0, -1.0, 0.0)
O = (0.0, 0.0, 0.0)


@dataclass(frozen=True)
class Hinge:
    axis: tuple
    pos: tuple = O
    range_deg: tuple = (-180.0, 180.0)


@dataclass(frozen=True)
class Geom:
    mass: float
    com: tuple            # body-frame center of mass of this geom
    kind: str = "sphere"  # sphere|capsule|box (rendering only)
    size: tuple = (0.05,)
    fromto: tuple | None = None
    pos: tuple | None = None


@dataclass(frozen=True)
class Body:
    name: str
    parent: str | None
    offset: tuple               # position in parent frame
    joints: tuple = ()          # Hinge list, declaration order
    geoms: tuple = ()
    end_effector: tuple | None = None   # body-frame point (wrist/foot)


def _cap(mass, zlo, zhi, size):
    return Geom(mass, (0.0, 0.0, (zlo + zhi) / 2), "capsule", (size,),
                fromto=(0, 0, zlo, 0, 0, zhi))


# dp_env_v2.xml:20-107 transcription. Ranges only matter for XML round-trip.
BODIES: tuple[Body, ...] = (
    Body("root", None, (0.0, 0.0, 1.0),
         geoms=(Geom(2.5, (0, 0, 0.07), "sphere", (0.09,), pos=(0, 0, 0.07)),)),
    Body("chest", "root", (0.0, 0.0, 0.236151),
         joints=(Hinge(X, O, (-68.75, 68.75)), Hinge(Y, O, (-68.75, 68.75)),
                 Hinge(Z, O, (-68.75, 68.75))),
         geoms=(Geom(3.0, (0, 0, 0.12), "sphere", (0.11,), pos=(0, 0, 0.12)),)),
    Body("neck", "chest", (0.0, 0.0, 0.223894),
         joints=(Hinge(X, O, (-40, 40)), Hinge(Y, O, (-57.3, 57.3)),
                 Hinge(Z, O, (-57.3, 57.3))),
         geoms=(Geom(2.0, (0, 0, 0.175), "sphere", (0.1025,), pos=(0, 0, 0.175)),)),
    Body("right_shoulder", "chest", (-0.02405, -0.18311, 0.2435),
         joints=(Hinge(X, O, (-170, 28.65)), Hinge(Y, O, (-180.0, 40.11)),
                 Hinge(Z, O, (-85.94, 85.94))),
         geoms=(_cap(1.5, -0.05, -0.23, 0.045),)),
    Body("right_elbow", "right_shoulder", (0.0, 0.0, -0.274788),
         joints=(Hinge(NEG_Y, (0.028, 0.0, 0.0), (0, 140)),),
         geoms=(_cap(1.0, -0.0525, -0.1875, 0.04),
                Geom(0.5, (0, 0, -0.258947), "sphere", (0.04,), pos=(0, 0, -0.258947))),
         end_effector=(0.0, 0.0, -0.258947)),
    Body("left_shoulder", "chest", (-0.02405, 0.18311, 0.2435),
         joints=(Hinge(X, O, (-28.65, 170)), Hinge(Y, O, (-180, 40.11)),
                 Hinge(Z, O, (-85.94, 85.94))),
         geoms=(_cap(1.5, -0.05, -0.23, 0.045),)),
    Body("left_elbow", "left_shoulder", (0.0, 0.0, -0.274788),
         joints=(Hinge(NEG_Y, (0.028, 0.0, 0.0), (0, 140)),),
         geoms=(_cap(1.0, -0.0525, -0.1875, 0.04),
                Geom(0.5, (0, 0, -0.258947), "sphere", (0.04,), pos=(0, 0, -0.258947))),
         end_effector=(0.0, 0.0, -0.258947)),
    Body("right_hip", "root", (0.0, -0.094887, -0.05),
         joints=(Hinge(X, O, (-68.75, 68.75)), Hinge(Y, (0.02, 0.0, 0.0), (-140, 80)),
                 Hinge(Z, O, (-57.3, 57.3))),
         geoms=(_cap(4.5, -0.06, -0.36, 0.055),)),
    Body("right_knee", "right_hip", (0.0, 0.0, -0.421546),
         joints=(Hinge(NEG_Y, (-0.035, 0.0, 0.0), (-130, 0)),),
         geoms=(_cap(3.0, -0.045, -0.355, 0.05),)),
    Body("right_ankle", "right_knee", (0.0, 0.0, -0.40987),
         joints=(Hinge(X, O, (-40, 40)), Hinge(Y, (-0.02, 0.0, 0.0), (-50.0, 80.0)),
                 Hinge(Z, O, (-20, 20))),
         geoms=(Geom(1.0, (0.045, 0, -0.0425), "box", (0.088, 0.045, 0.027),
                     pos=(0.045, 0, -0.0425)),),
         end_effector=(0.045, 0.0, -0.0425)),
    Body("left_hip", "root", (0.0, 0.094887, -0.05),
         joints=(Hinge(X, O, (-68.75, 68.75)), Hinge(Y, (0.02, 0.0, 0.0), (-140, 80)),
                 Hinge(Z, O, (-57.3, 57.3))),
         geoms=(_cap(4.5, -0.06, -0.36, 0.055),)),
    Body("left_knee", "left_hip", (0.0, 0.0, -0.421546),
         joints=(Hinge(NEG_Y, (-0.035, 0.0, 0.0), (-130, 0)),),
         geoms=(_cap(3.0, -0.045, -0.355, 0.05),)),
    Body("left_ankle", "left_knee", (0.0, 0.0, -0.40987),
         joints=(Hinge(X, O, (-57.3, 57.3)), Hinge(Y, (-0.02, 0.0, 0.0), (-50.0, 80.0)),
                 Hinge(Z, O, (-20, 20))),
         geoms=(Geom(1.0, (0.045, 0, -0.0425), "box", (0.088, 0.045, 0.027),
                     pos=(0.045, 0, -0.0425)),),
         end_effector=(0.045, 0.0, -0.0425)),
)

BODY_INDEX = {b.name: i for i, b in enumerate(BODIES)}
TOTAL_MASS = float(sum(g.mass for b in BODIES for g in b.geoms))
END_EFFECTOR_BODIES = tuple(b.name for b in BODIES if b.end_effector)

# sanity: the qpos joint layout implied by the tree matches data/skeleton.py
_tree_joints = [b.name for b in BODIES[1:]]
assert tuple(_tree_joints) == tuple(BODY_JOINTS)
assert all(len(b.joints) == DOF_DEF[b.name] for b in BODIES[1:])


# joint dynamics defaults from the reference model (dp_env_v2.xml:4):
# every hinge carries armature 0.02, damping 5, stiffness 10; the free root
# has none (dp_env_v2.xml:25); the floor has friction "1 .1 .1" (line 19)
JOINT_ARMATURE = 0.02
JOINT_DAMPING = 5.0
JOINT_STIFFNESS = 10.0
FLOOR_FRICTION = 1.0
GRAVITY = 9.81


def to_xml(timestep: float = 0.002) -> str:
    """Generate a MuJoCo XML equivalent of the spec (radians, explicit
    masses, reference joint-dynamics defaults) for the host-side player,
    the FK parity oracle and the forward-dynamics oracle tests."""

    def geom_xml(b: Body, g: Geom, i: int) -> str:
        name = f"{b.name}_g{i}"
        if g.kind == "capsule":
            ft = " ".join(str(v) for v in g.fromto)
            return (f'<geom name="{name}" type="capsule" fromto="{ft}" '
                    f'size="{g.size[0]}" mass="{g.mass}"/>')
        pos = " ".join(str(v) for v in g.pos)
        size = " ".join(str(v) for v in g.size)
        return (f'<geom name="{name}" type="{g.kind}" pos="{pos}" '
                f'size="{size}" mass="{g.mass}"/>')

    def body_xml(name: str, indent: str) -> str:
        b = BODIES[BODY_INDEX[name]]
        off = " ".join(str(v) for v in b.offset)
        lines = [f'{indent}<body name="{b.name}" pos="{off}">']
        if b.parent is None:
            lines.append(f'{indent}  <joint name="root" type="free" limited="false"/>')
        for k, j in enumerate(b.joints):
            ax = " ".join(str(v) for v in j.axis)
            jp = " ".join(str(v) for v in j.pos)
            lo, hi = (np.deg2rad(j.range_deg[0]), np.deg2rad(j.range_deg[1]))
            lines.append(
                f'{indent}  <joint name="{b.name}_{k}" type="hinge" axis="{ax}" '
                f'pos="{jp}" range="{lo} {hi}" limited="true" '
                f'armature="{JOINT_ARMATURE}" damping="{JOINT_DAMPING}" '
                f'stiffness="{JOINT_STIFFNESS}"/>'
            )
        for i, g in enumerate(b.geoms):
            lines.append(indent + "  " + geom_xml(b, g, i))
        for child in BODIES:
            if child.parent == b.name:
                lines.append(body_xml(child.name, indent + "  "))
        lines.append(f"{indent}</body>")
        return "\n".join(lines)

    return f"""<mujoco model="dmdm_humanoid">
  <compiler angle="radian" inertiafromgeom="true"/>
  <option timestep="{timestep}"/>
  <worldbody>
    <geom name="floor" type="plane" size="20 20 0.125" condim="3" friction="{FLOOR_FRICTION} .1 .1"/>
{body_xml("root", "    ")}
  </worldbody>
</mujoco>
"""
