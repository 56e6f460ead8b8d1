"""Live 3D MuJoCo viewing of the port's state (``MujocoViewerCollection``).

Counterpart of ``gymnasium_planar_robotics_tpu/utils/mujoco_viewer.py`` and
of the reference's rendering stack (``rendering.py:99-280``): one optional
interactive 'human' viewer plus offscreen viewers made on first use, keyed
``mode_camid``, serving ``rgb_array`` / ``depth_array`` frames with
geom-group filtering.  The physics runs in the port, so the collection owns
a mirror ``MjModel``/``MjData`` built once from ``utils/scene_export``, and
``update(state)`` writes the engine's poses into it (qpos, then
``mj_forward``); the reference's model reload at every reset reduces to
moving goal sites in place.  Params and state may hold tensors on any
device.  MuJoCo is optional and offscreen rendering needs a GL backend
(EGL/OSMesa); without them the calls raise ImportError or RuntimeError.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from gymnasium_planar_robotics_tpu_torch.ops.kernels import to_numpy

DEFAULT_SIZE = 480


def _require_mujoco():
    try:
        import mujoco
    except ImportError as e:  # pragma: no cover
        raise ImportError(
            'the 3D viewer needs the mujoco package (pip install mujoco)'
        ) from e
    return mujoco


def hud_overlay_entries(
    *,
    run_speed: float,
    render_every_frame: bool,
    ncam: int,
    cam_id: int,
    contacts: bool,
    transparent: bool,
    paused: bool | None,
    frames_on: bool,
    captured_path: str | None,
    fps: int,
    step: int,
    timestep: float,
) -> list[tuple[str, str, str]]:
    """(grid-position, label, value) rows for the interactive viewer HUD —
    the reference's keyboard/status overlay (rendering.py:14-66) as a pure
    function so the assembly logic is testable without a window.  Top-left:
    the keyboard map; bottom-left: FPS / physics step / timestep."""
    top, bottom = 'topleft', 'bottomleft'
    rows: list[tuple[str, str, str]] = []
    if render_every_frame:
        rows.append((top, '', ''))
    else:
        rows.append((top, f'Run speed = {run_speed:.3f} x real time', '[S]lower, [F]aster'))
    rows.append((top, f'Switch camera (#cams = {ncam + 1})', f'[Tab] (camera ID = {cam_id})'))
    rows.append((top, '[C]ontact forces', 'On' if contacts else 'Off'))
    rows.append((top, 'T[r]ansparent', 'On' if transparent else 'Off'))
    if paused is not None:
        if paused:
            rows.append((top, 'Start', '[Space]'))
            rows.append((top, 'Advance simulation by one step', '[right arrow]'))
        else:
            rows.append((top, 'Stop', '[Space]'))
    rows.append((top, 'Referenc[e] frames', 'On' if frames_on else 'Off'))
    rows.append((top, '[H]ide Menu', ''))
    rows.append((top, 'Cap[t]ure frame', f'Saved as {captured_path}' if captured_path else ''))
    rows.append((top, 'Toggle geomgroup visibility', '0-4'))
    rows.append((bottom, 'FPS', f'{fps} '))
    rows.append((bottom, 'Step', str(step)))
    rows.append((bottom, 'timestep', f'{timestep:.5f}'))
    return rows


def make_window_viewer_hud(model, data):
    """Gymnasium WindowViewer subclass with the reference's HUD overlay
    (rendering.py:14-66): keyboard map top-left, FPS/step/timestep
    bottom-left.  Needs a windowing system (glfw); factory-scoped so headless
    hosts can still import this module."""
    import mujoco
    from gymnasium.envs.mujoco.mujoco_rendering import WindowViewer

    class MujocoWindowViewerHUD(WindowViewer):
        def __init__(self, model, data):
            super().__init__(model=model, data=data)
            self.is_running = True

        def close(self):
            super().close()
            self.is_running = False

        def _create_overlay(self):
            grid = {
                'topleft': mujoco.mjtGridPos.mjGRID_TOPLEFT,
                'bottomleft': mujoco.mjtGridPos.mjGRID_BOTTOMLEFT,
            }
            captured = None
            if getattr(self, '_image_idx', 0) > 0:
                captured = self._image_path % (self._image_idx - 1)
            for pos, label, value in hud_overlay_entries(
                run_speed=self._run_speed,
                render_every_frame=self._render_every_frame,
                ncam=self.model.ncam,
                cam_id=self.cam.fixedcamid,
                contacts=self._contacts,
                transparent=self._transparent,
                paused=self._paused,
                frames_on=self.vopt.frame == 1,
                captured_path=captured,
                fps=int(1 / self._time_per_render),
                step=round(self.data.time / self.model.opt.timestep),
                timestep=self.model.opt.timestep,
            ):
                self.add_overlay(grid[pos], label, value)

    return MujocoWindowViewerHUD(model, data)


class MujocoViewerCollection:
    """Stream the engine's env state into a mirror MuJoCo model and render it.

    :param params: ``PlanningParams`` or ``PushingParams``
    :param num_movers: movers in the scene (defaults from params)
    :param width/height: offscreen framebuffer size
    :param default_cam_config: dict of ``MjvCamera`` attributes (reference
        ``rendering.py:116``), e.g. ``{'distance': 2.0, 'elevation': -40}``
    :param use_mj_passive_viewer: use ``mujoco.viewer.launch_passive`` for
        'human' mode (reference ``rendering.py:246-252``)
    """

    def __init__(
        self,
        params,
        num_movers: int | None = None,
        mover_shape: str = 'box',
        width: int = DEFAULT_SIZE,
        height: int = DEFAULT_SIZE,
        default_cam_config: dict[str, Any] | None = None,
        use_mj_passive_viewer: bool = True,
        mesh_cfg: dict[str, Any] | None = None,
    ):
        from gymnasium_planar_robotics_tpu_torch.utils import scene_export

        mujoco = _require_mujoco()
        self._mujoco = mujoco
        self.params = params
        self._pushing = hasattr(params, 'object_half')
        if num_movers is None:
            num_movers = 1 if self._pushing else to_numpy(params.mover_mass).reshape(-1).shape[0]
        self.num_movers = num_movers

        ts = to_numpy(params.grid.tile_size)
        zpos = float(to_numpy(params.initial_zpos))
        if hasattr(params, 'mover_size'):
            half_z = to_numpy(params.mover_size).reshape(-1, 3)[:, 2]
        else:
            half_z = np.full((num_movers,), 0.006)
        self._mover_z = zpos + ts[2] + half_z  # scene_export mover z
        self._goal_z = zpos + ts[2]

        goals0 = np.tile(np.asarray([[0.12, 0.12]]), (num_movers, 1))
        xml = scene_export.export_scene_xml(
            params,
            goals_xy=None if self._pushing else goals0,
            mover_shape=mover_shape,
            object_xy=np.asarray([0.36, 0.36]) if self._pushing else None,
            object_goal_xy=np.asarray([0.36, 0.36]) if self._pushing else None,
            mesh_cfg=mesh_cfg,
        )
        self.model = mujoco.MjModel.from_xml_string(xml)
        self.data = mujoco.MjData(self.model)
        self._qpos_adr = [
            self.model.joint(f'mover_joint_{k}').qposadr[0] for k in range(num_movers)
        ]
        self._qvel_adr = [
            self.model.joint(f'mover_joint_{k}').dofadr[0] for k in range(num_movers)
        ]
        if self._pushing:
            self._obj_qpos_adr = self.model.joint('object_joint').qposadr[0]
            self._obj_qvel_adr = self.model.joint('object_joint').dofadr[0]
            self._obj_site = self.model.site('object_goal_site').id
            self._obj_z = float(self.data.qpos[self._obj_qpos_adr + 2])
        else:
            self._goal_sites = [
                self.model.site(f'goal_site_mover_{k}').id for k in range(num_movers)
            ]
        mujoco.mj_forward(self.model, self.data)

        self.width = width
        self.height = height
        self._cam_config = dict(default_cam_config or {})
        self._use_passive = use_mj_passive_viewer
        self._viewers: dict[str, Any] = {}  # mode_camid -> Renderer (offscreen)
        self._human_viewer = None

    # -- state streaming -----------------------------------------------------

    def update(self, state, env_index: int = 0) -> None:
        """Write one env's engine state into the mirror MjData and refresh
        kinematics.  ``state`` is a (possibly batched) ``PlanningState`` or
        ``PushingState``; ``env_index`` picks the batch row."""
        pos = to_numpy(state.pos)
        vel = to_numpy(state.vel)
        if self._pushing:
            yaw = to_numpy(getattr(state, 'obj_yaw', 0.0))
            omega = to_numpy(getattr(state, 'obj_w', 0.0))
            if pos.ndim == 2:  # batched [B, 2]
                pos, vel = pos[env_index], vel[env_index]
                obj_pos = to_numpy(state.obj_pos)[env_index]
                obj_vel = to_numpy(state.obj_vel)[env_index]
                goal = to_numpy(state.goal)[env_index]
                if yaw.ndim:
                    yaw, omega = yaw[env_index], omega[env_index]
            else:
                obj_pos = to_numpy(state.obj_pos)
                obj_vel = to_numpy(state.obj_vel)
                goal = to_numpy(state.goal)
            self._write_mover(0, pos, vel)
            a = self._obj_qpos_adr
            self.data.qpos[a : a + 3] = [obj_pos[0], obj_pos[1], self._obj_z]
            # z-rotation quaternion from the engine's yaw state
            self.data.qpos[a + 3 : a + 7] = [np.cos(yaw / 2), 0.0, 0.0, np.sin(yaw / 2)]
            v = self._obj_qvel_adr
            self.data.qvel[v : v + 6] = 0.0
            self.data.qvel[v : v + 2] = obj_vel
            self.data.qvel[v + 5] = omega
            self.model.site_pos[self._obj_site][:2] = goal
        else:
            goals = to_numpy(state.goals)
            if pos.ndim == 3:  # batched [B, M, 2]
                pos, vel, goals = pos[env_index], vel[env_index], goals[env_index]
            for k in range(self.num_movers):
                self._write_mover(k, pos[k], vel[k])
                self.model.site_pos[self._goal_sites[k]][:2] = goals[k]
                self.model.site_pos[self._goal_sites[k]][2] = self._goal_z
        self._mujoco.mj_forward(self.model, self.data)

    def _write_mover(self, k: int, xy, v) -> None:
        a = self._qpos_adr[k]
        self.data.qpos[a : a + 3] = [xy[0], xy[1], self._mover_z[min(k, len(self._mover_z) - 1)]]
        self.data.qpos[a + 3 : a + 7] = [1.0, 0.0, 0.0, 0.0]
        dv = self._qvel_adr[k]
        self.data.qvel[dv : dv + 6] = 0.0
        self.data.qvel[dv : dv + 2] = v

    # -- rendering -----------------------------------------------------------

    def render(
        self,
        render_mode: str = 'rgb_array',
        camera_id: int | None = None,
        camera_name: str | None = None,
        geomgroup: np.ndarray | None = None,
    ):
        """Render the current mirror state.

        Mirrors the reference dispatch (``rendering.py:129-195``): 'human'
        drives the interactive window and returns None; 'rgb_array' returns
        ``[H, W, 3] uint8``; 'depth_array' returns ``[H, W] float32`` depths.
        ``geomgroup`` is a 6-element 0/1 mask (``rendering.py:85-92``)."""
        mujoco = self._mujoco
        if render_mode == 'human':
            self._ensure_human_viewer()
            if hasattr(self._human_viewer, 'sync'):  # passive backend
                self._human_viewer.sync()
            else:  # WindowViewer backend (HUD overlay)
                self._human_viewer.render()
            return None

        assert render_mode in ('rgb_array', 'depth_array'), f'unknown render mode {render_mode!r}'
        assert camera_id is None or camera_name is None, 'specify camera_id OR camera_name'
        if camera_name is not None:
            camera_id = mujoco.mj_name2id(self.model, mujoco.mjtObj.mjOBJ_CAMERA, camera_name)
        if camera_id is None:
            camera_id = -1

        key = f'{render_mode}_{camera_id}'
        renderer = self._viewers.get(key)
        if renderer is None:
            renderer = mujoco.Renderer(self.model, height=self.height, width=self.width)
            if render_mode == 'depth_array':
                renderer.enable_depth_rendering()
            self._viewers[key] = renderer

        if camera_id == -1:
            camera = mujoco.MjvCamera()
            mujoco.mjv_defaultFreeCamera(self.model, camera)
            for attr, value in self._cam_config.items():
                setattr(camera, attr, value)
        else:
            camera = camera_id

        scene_option = None
        if geomgroup is not None:
            scene_option = mujoco.MjvOption()
            mujoco.mjv_defaultOption(scene_option)
            for i, g in enumerate(np.asarray(geomgroup).reshape(-1)[:6]):
                scene_option.geomgroup[i] = int(g)
        renderer.update_scene(self.data, camera=camera, scene_option=scene_option)
        return renderer.render()

    def _ensure_human_viewer(self):
        if self._human_viewer is not None:
            return
        if self._use_passive:
            import mujoco.viewer

            self._human_viewer = mujoco.viewer.launch_passive(self.model, self.data)
        else:  # pragma: no cover - needs a windowing system (glfw)
            # Gymnasium WindowViewer with the reference's keyboard/FPS HUD
            # (rendering.py:14-66)
            self._human_viewer = make_window_viewer_hud(self.model, self.data)

    def reload_model(self, params=None) -> None:
        """Reference API parity (``rendering.py:258-280``): the reference
        rebuilds MJCF per reset; the mirror only needs site moves, which
        ``update`` already performs.  Passing new ``params`` rebuilds."""
        if params is not None:
            self.close()
            self.__init__(params, num_movers=self.num_movers,
                          width=self.width, height=self.height,
                          default_cam_config=self._cam_config,
                          use_mj_passive_viewer=self._use_passive)

    def close(self) -> None:
        """Free every lazily-created offscreen renderer and the human viewer."""
        for r in self._viewers.values():
            r.close()
        self._viewers.clear()
        if self._human_viewer is not None:
            self._human_viewer.close()
            self._human_viewer = None
