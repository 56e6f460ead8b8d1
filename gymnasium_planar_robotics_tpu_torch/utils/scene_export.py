"""MJCF scene export: MuJoCo interop for visualization and cross-checking.

Counterpart of ``gymnasium_planar_robotics_tpu/utils/scene_export.py``.  The
reference is driven by generated MJCF
(``gymnasium_planar_robotics/envs/basic_envs.py:933-1203``); the engine
needs no XML, but users coming from the reference want to view a
configuration in a MuJoCo viewer and cross-check trajectories against
MuJoCo.  This module renders the params into an equivalent MJCF string,
honouring the reference's seven user-injectable hook keys
(basic_envs.py:950-968).  Mesh movers are sized from the port's own
``utils/meshes``.  It imports no mujoco.
"""

from __future__ import annotations

import numpy as np

from gymnasium_planar_robotics_tpu_torch.ops.kernels import to_numpy

# the reference's hook keys (basic_envs.py:950-968)
HOOK_KEYS = (
    'custom_compiler_xml_str',
    'custom_visual_xml_str',
    'custom_option_xml_str',
    'custom_assets_xml_str',
    'custom_default_xml_str',
    'custom_worldbody_xml_str',
    'custom_outworldbody_xml_str',
)

_MATERIALS = {
    'black': '0.25 0.25 0.25 1',
    'gray': '0.5 0.5 0.5 1',
    'light_gray': '0.7 0.7 0.7 1',
    'white': '1 1 1 1',
    'green': '0 0.8 0.2 1',
    'blue': '0.1 0.3 0.9 1',
    'light_blue': '0.4 0.7 1 1',
    'orange': '1 0.55 0.1 1',
    'red': '0.9 0.1 0.1 1',
    'yellow': '0.95 0.85 0.1 1',
    'line_mat': '0.1 0.1 0.1 1',
}
_GOAL_COLORS = ('green', 'blue', 'orange', 'red', 'yellow', 'light_blue')


def _materials_xml() -> str:
    return '\n'.join(
        f'    <material name="{n}" rgba="{rgba}" reflectance="0.01" shininess="0.01" specular="0.1"/>'
        for n, rgba in _MATERIALS.items()
    )


def export_scene_xml(
    params,
    mover_xy: np.ndarray | None = None,
    goals_xy: np.ndarray | None = None,
    mover_shape: str = 'box',
    table_height: float = 0.4,
    object_xy: np.ndarray | None = None,
    object_goal_xy: np.ndarray | None = None,
    custom_xml_strings: dict[str, str] | None = None,
    mesh_cfg: dict | None = None,
) -> str:
    """Render an env configuration as a MuJoCo MJCF string.

    ``params`` is a ``PlanningParams`` or ``PushingParams``; mover and
    goal positions default to the tile centers.  ``mover_shape='mesh'`` emits
    mesh assets + geoms from ``mesh_cfg`` (the ``mover_params['mesh']`` keys:
    ``mover_stl_path``, ``bumper_stl_path``, ``bumper_mass``, ``scale``) so
    the 3D mirror shows the real mover silhouettes (reference
    basic_envs.py:895-929).
    """
    hooks = dict(custom_xml_strings or {})
    unknown = set(hooks) - set(HOOK_KEYS)
    assert not unknown, f'unknown custom xml keys: {sorted(unknown)}'

    grid = params.grid
    layout = to_numpy(grid.layout)
    tx = to_numpy(grid.tile_x)
    ty = to_numpy(grid.tile_y)
    ts = to_numpy(grid.tile_size)
    zpos = float(to_numpy(params.initial_zpos))

    # mover geometry: planning params carry [M, 3] sizes, pushing carries a
    # single [2] half-extent pair
    if hasattr(params, 'mover_size'):
        mover_half = to_numpy(params.mover_size).reshape(-1, 3)
    else:
        mh = to_numpy(params.mover_half)
        mover_half = np.concatenate([mh, [0.006]])[None, :]
    masses = to_numpy(params.mover_mass).reshape(-1)
    num_movers = mover_half.shape[0] if mover_xy is None else np.asarray(mover_xy).reshape(-1, 2).shape[0]

    tile_centers = [(tx[i, j], ty[i, j]) for i in range(layout.shape[0]) for j in range(layout.shape[1]) if layout[i, j]]
    if mover_xy is None:
        assert num_movers <= len(tile_centers), 'more movers than tiles and no start positions given'
        mover_xy = np.asarray(tile_centers[:num_movers])
    mover_xy = np.asarray(mover_xy).reshape(-1, 2)

    # --- worldbody pieces ---------------------------------------------------
    tiles = []
    for i in range(layout.shape[0]):
        for j in range(layout.shape[1]):
            if layout[i, j]:
                tiles.append(f'      <geom name="tile_{i}_{j}" class="tile" pos="{tx[i, j]} {ty[i, j]} 0"/>')
    # grid-line sites on interior edges between adjacent tiles
    lh = 0.0005
    lz = ts[2] - lh + 1e-5
    for i in range(layout.shape[0]):
        for j in range(layout.shape[1]):
            if not layout[i, j]:
                continue
            if i > 0 and layout[i - 1, j]:
                x = 2 * i * ts[0]
                tiles.append(
                    f'      <site type="box" size="{lh}" material="line_mat" '
                    f'fromto="{x} {2 * j * ts[1]} {lz} {x} {2 * (j + 1) * ts[1]} {lz}"/>'
                )
            if j > 0 and layout[i, j - 1]:
                y = 2 * j * ts[1]
                tiles.append(
                    f'      <site type="box" size="{lh}" material="line_mat" '
                    f'fromto="{2 * i * ts[0]} {y} {lz} {2 * (i + 1) * ts[0]} {y} {lz}"/>'
                )

    mesh_assets = []
    bumper_line = None
    if mover_shape == 'mesh':
        from gymnasium_planar_robotics_tpu_torch.utils import meshes as _meshes

        mc = dict(mesh_cfg or {})
        scale = ' '.join(str(float(s)) for s in np.broadcast_to(np.asarray(mc.get('scale', 1.0)), (3,)))
        mover_stl = _meshes.resolve_mesh_path(mc.get('mover_stl_path', 'beckhoff_apm4330_mover'))
        mesh_assets.append(f'    <mesh name="mover_mesh" file="{mover_stl}" scale="{scale}"/>')
        bumper_name = mc.get('bumper_stl_path', 'beckhoff_apm4330_bumper')
        if bumper_name is not None:
            bumper_stl = _meshes.resolve_mesh_path(bumper_name)
            mesh_assets.append(f'    <mesh name="bumper_mesh" file="{bumper_stl}" scale="{scale}"/>')
            bumper_line = (
                f'<geom name="bumper_geom_K" type="mesh" mesh="bumper_mesh" '
                f'mass="{float(mc.get("bumper_mass", 0.1))}" material="black"/>'
            )

    movers = []
    for k in range(mover_xy.shape[0]):
        half = mover_half[min(k, mover_half.shape[0] - 1)]
        mass = masses[min(k, masses.shape[0] - 1)]
        mat = _GOAL_COLORS[k] if goals_xy is not None and k < len(_GOAL_COLORS) and k < len(np.asarray(goals_xy)) else 'gray'
        z = zpos + ts[2] + half[2]
        if mover_shape == 'cylinder':
            geom = f'<geom name="mover_geom_{k}" type="cylinder" size="{half[0]} {half[2]}" mass="{mass}" material="{mat}"/>'
        elif mover_shape == 'mesh':
            geom = f'<geom name="mover_geom_{k}" type="mesh" mesh="mover_mesh" mass="{mass}" material="{mat}"/>'
            if bumper_line is not None:
                geom += '\n        ' + bumper_line.replace('bumper_geom_K', f'bumper_geom_{k}')
        else:
            geom = f'<geom name="mover_geom_{k}" type="box" size="{half[0]} {half[1]} {half[2]}" mass="{mass}" material="{mat}"/>'
        movers.append(
            f'      <body name="mover_{k}" pos="{mover_xy[k, 0]} {mover_xy[k, 1]} {z}" gravcomp="1">\n'
            f'        <joint name="mover_joint_{k}" type="free" damping="0"/>\n'
            f'        {geom}\n'
            f'      </body>'
        )

    goals = []
    if goals_xy is not None:
        for k, g in enumerate(np.asarray(goals_xy).reshape(-1, 2)):
            mat = _GOAL_COLORS[k % len(_GOAL_COLORS)]
            goals.append(
                f'      <site name="goal_site_mover_{k}" type="sphere" material="{mat}" size="0.02" '
                f'pos="{g[0]} {g[1]} {zpos + ts[2]}"/>'
            )

    obj = []
    if object_xy is not None:
        oh = to_numpy(getattr(params, 'object_half', [0.035, 0.035]))
        obj.append(
            f'      <body name="object" pos="{object_xy[0]} {object_xy[1]} 0.02">\n'
            f'        <joint name="object_joint" type="free" damping="0.01"/>\n'
            f'        <geom name="object_geom" type="box" size="{oh[0]} {oh[1]} 0.02" mass="0.01" material="red"/>\n'
            f'      </body>'
        )
        if object_goal_xy is not None:
            obj.append(
                f'      <site name="object_goal_site" type="sphere" material="red" size="0.02" '
                f'pos="{object_goal_xy[0]} {object_goal_xy[1]} 0.02"/>'
            )

    max_x = layout.shape[0] * 2 * ts[0]
    max_y = layout.shape[1] * 2 * ts[1]
    table = (
        f'      <geom name="ground_plane" type="plane" size="{max_x} {max_y} 1" material="white" '
        f'pos="{max_x / 2} {max_y / 2} {-table_height - ts[2]}"/>\n'
        f'      <geom name="table" type="box" size="{max_x / 2} {max_y / 2} {table_height / 2}" material="light_gray" '
        f'pos="{max_x / 2} {max_y / 2} {-table_height / 2 - ts[2]}"/>'
    )

    compiler = hooks.get('custom_compiler_xml_str', '  <compiler angle="radian" coordinate="local"/>')
    visual = hooks.get('custom_visual_xml_str', '  <visual>\n    <headlight ambient="0.4 0.4 0.4"/>\n  </visual>')
    option = hooks.get(
        'custom_option_xml_str',
        '  <option timestep="0.001" cone="elliptic" gravity="0 0 -9.81"/>',
    )

    parts = [
        '<?xml version="1.0" encoding="utf-8"?>',
        '<mujoco model="planar_robotics_tpu">',
        compiler,
        visual,
        option,
        '  <default>',
        f'    <default class="tile">\n      <geom type="box" size="{ts[0]} {ts[1]} {ts[2]}" material="black" mass="5.6"/>\n    </default>',
        hooks.get('custom_default_xml_str', ''),
        '  </default>',
        '  <asset>',
        _materials_xml(),
        *mesh_assets,
        hooks.get('custom_assets_xml_str', ''),
        '  </asset>',
        '  <worldbody>',
        '    <light pos="0 0 3" dir="0 0 -1"/>',
        *tiles,
        *movers,
        *goals,
        *obj,
        table,
        hooks.get('custom_worldbody_xml_str', ''),
        '  </worldbody>',
        hooks.get('custom_outworldbody_xml_str', ''),
        '</mujoco>',
    ]
    return '\n'.join(p for p in parts if p)
