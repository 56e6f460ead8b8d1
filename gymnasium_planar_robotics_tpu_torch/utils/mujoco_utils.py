"""The reference's ``utils/mujoco_utils`` surface, for MuJoCo models.

Counterpart of ``gymnasium_planar_robotics_tpu/utils/mujoco_utils.py``: the
name-keyed MuJoCo accessors user envs call (reference
``utils/mujoco_utils.py:10-62``, ``extract_mj_names`` ``:193-254``,
``MujocoModelNames`` ``:257-486``), working on the 3D mirror model of
``utils/mujoco_viewer`` (body, joint and site names ``mover_{k}``,
``mover_joint_{k}``) or any user-owned MuJoCo model.  The engine's own state
is read through the Gym adapters' ``get_mover_qpos/qvel/qacc``
(``envs/gym_env.py``).  It uses mujoco's named access (``model.joint(name)``
carries ``qposadr``/``dofadr``/``type``); a ball joint reads 3 qvel/qacc
entries where the reference reads 4 (planar-robotics scenes use free joints
only, where both agree).  mujoco is imported when first needed.
"""

from __future__ import annotations

import numpy as np

try:  # the engine core never needs mujoco; this shim and the viewers do
    import mujoco
except ImportError:  # pragma: no cover - mujoco is present in CI
    mujoco = None

__all__ = [
    'MJ_OBJ_TYPES',
    'MujocoModelNames',
    'extract_mj_names',
    'get_joint_qacc',
    'get_joint_qpos',
    'get_joint_qvel',
    'get_mujoco_type_names',
    'set_actuator_ctrl',
    'set_joint_qpos',
    'set_joint_qvel',
]

#: object types MujocoModelNames indexes (reference mujoco_utils.py:72-80)
MJ_OBJ_TYPES = [
    'mjOBJ_BODY',
    'mjOBJ_JOINT',
    'mjOBJ_GEOM',
    'mjOBJ_SITE',
    'mjOBJ_CAMERA',
    'mjOBJ_ACTUATOR',
    'mjOBJ_SENSOR',
]


def _joint_span(model, name: str, kind: str) -> tuple[int, int]:
    """(address, width) of a named joint's qpos or dof slice."""
    j = model.joint(name)  # raises KeyError for unknown names
    jtype = int(np.asarray(j.type).reshape(-1)[0])
    if kind == 'qpos':
        widths = {int(mujoco.mjtJoint.mjJNT_FREE): 7, int(mujoco.mjtJoint.mjJNT_BALL): 4}
        return int(np.asarray(j.qposadr).reshape(-1)[0]), widths.get(jtype, 1)
    widths = {int(mujoco.mjtJoint.mjJNT_FREE): 6, int(mujoco.mjtJoint.mjJNT_BALL): 3}
    return int(np.asarray(j.dofadr).reshape(-1)[0]), widths.get(jtype, 1)


def get_joint_qpos(model, data, name: str) -> np.ndarray:
    """Named joint's qpos slice (reference mujoco_utils.py:110-134)."""
    adr, n = _joint_span(model, name, 'qpos')
    return data.qpos[adr:adr + n].copy()


def set_joint_qpos(model, data, name: str, value) -> None:
    """Write a named joint's qpos slice (reference mujoco_utils.py:83-107)."""
    adr, n = _joint_span(model, name, 'qpos')
    value = np.asarray(value, dtype=np.float64).reshape(-1)
    assert value.shape == (n,), f'qpos for joint {name!r} must have shape ({n},), got {value.shape}'
    data.qpos[adr:adr + n] = value


def get_joint_qvel(model, data, name: str) -> np.ndarray:
    """Named joint's qvel slice (reference mujoco_utils.py:167-190)."""
    adr, n = _joint_span(model, name, 'dof')
    return data.qvel[adr:adr + n].copy()


def set_joint_qvel(model, data, name: str, value) -> None:
    """Write a named joint's qvel slice (reference mujoco_utils.py:137-164)."""
    adr, n = _joint_span(model, name, 'dof')
    value = np.asarray(value, dtype=np.float64).reshape(-1)
    assert value.shape == (n,), f'qvel for joint {name!r} must have shape ({n},), got {value.shape}'
    data.qvel[adr:adr + n] = value


def get_joint_qacc(model, data, name: str) -> np.ndarray:
    """Named joint's qacc slice (reference mujoco_utils.py:23-47)."""
    adr, n = _joint_span(model, name, 'dof')
    return data.qacc[adr:adr + n].copy()


def set_actuator_ctrl(model, data, actuator_name: str, value: float) -> None:
    """Write one actuator's control input (reference mujoco_utils.py:10-20)."""
    data.ctrl[model.actuator(actuator_name).id] = value


def _num_objects(model, obj_type) -> int:
    counts = {
        int(mujoco.mjtObj.mjOBJ_BODY): model.nbody,
        int(mujoco.mjtObj.mjOBJ_JOINT): model.njnt,
        int(mujoco.mjtObj.mjOBJ_GEOM): model.ngeom,
        int(mujoco.mjtObj.mjOBJ_SITE): model.nsite,
        int(mujoco.mjtObj.mjOBJ_LIGHT): model.nlight,
        int(mujoco.mjtObj.mjOBJ_CAMERA): model.ncam,
        int(mujoco.mjtObj.mjOBJ_ACTUATOR): model.nu,
        int(mujoco.mjtObj.mjOBJ_SENSOR): model.nsensor,
        int(mujoco.mjtObj.mjOBJ_TENDON): model.ntendon,
        int(mujoco.mjtObj.mjOBJ_MESH): model.nmesh,
    }
    key = int(obj_type)
    if key not in counts:
        raise ValueError(
            f'`{obj_type}` was passed as the MuJoCo model object type. The MuJoCo model '
            f'object type can only be of the following mjtObj enum types: {MJ_OBJ_TYPES}.'
        )
    return counts[key]


def extract_mj_names(model, obj_type):
    """(names-ordered-by-id, name2id, id2name) for one mjtObj type
    (reference mujoco_utils.py:193-254; unnamed objects map to None in
    id2name and are absent from name2id, same as the reference)."""
    n_obj = _num_objects(model, obj_type)
    id2name: dict[int, str | None] = {}
    name2id: dict[str, int] = {}
    for i in range(n_obj):
        name = mujoco.mj_id2name(model, obj_type, i)
        id2name[i] = name if name else None
        if name:
            name2id[name] = i
    names = tuple(id2name[i] for i in sorted(name2id.values()))
    return names, name2id, id2name


class MujocoModelNames:
    """Name/id registry for a MuJoCo model (reference mujoco_utils.py:257-486).

    Exposes ``{type}_names`` (tuple ordered by id), ``{type}_name2id`` and
    ``{type}_id2name`` for body, joint, geom, site, camera, actuator and
    sensor — the surface custom envs use to discover their injected
    actuators/sites.  Works on the engine's 3D mirror model
    (``utils/mujoco_viewer``) and any user model.
    """

    def __init__(self, model):
        for type_name in MJ_OBJ_TYPES:
            short = type_name.removeprefix('mjOBJ_').lower()
            names, name2id, id2name = extract_mj_names(model, getattr(mujoco.mjtObj, type_name))
            setattr(self, f'_{short}_names', names)
            setattr(self, f'_{short}_name2id', name2id)
            setattr(self, f'_{short}_id2name', id2name)

    def __getattr__(self, item):
        # property surface without 21 hand-written @property defs
        if item.endswith(('_names', '_name2id', '_id2name')) and not item.startswith('_'):
            try:
                return self.__dict__[f'_{item}']
            except KeyError:
                pass
        raise AttributeError(item)


def get_mujoco_type_names(model, obj_type: str, name_pattern: str = '') -> list[str]:
    """Names of one object type matching a substring pattern (reference
    mujoco_utils.py:50-62) — e.g. ``get_mujoco_type_names(model, 'actuator',
    'mover_actuator_x')``."""
    names = getattr(MujocoModelNames(model), f'{obj_type}_names')
    return [name for name in names if name_pattern in name]
