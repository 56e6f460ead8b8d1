"""Gymnasium single-env adapters (a B = 1 view over the batched port).

Counterpart of ``gymnasium_planar_robotics_tpu/envs/gym_env.py``: the same
observation and action spaces, reset ``options``, batched HER
``compute_reward`` / ``compute_terminated`` / ``compute_truncated`` (arrays
of info dicts included), info keys, name-keyed state accessors, clipping
with a warning, reward-shape guard, per-cycle rendering and viewers.  The
physics runs on ``envs/runner.EnvRunner``: the eager ``step`` /
``step_with_cycles`` / ``reset`` on the params' device (the card unless
``device='cpu'``), one host transfer a step.  ``dtype=None`` is float32.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

import gymnasium as gym

from gymnasium_planar_robotics_tpu_torch.envs.runner import EnvRunner
from gymnasium_planar_robotics_tpu_torch.models import planning as planning_model
from gymnasium_planar_robotics_tpu_torch.models import pushing as pushing_model
from gymnasium_planar_robotics_tpu_torch.ops.kernels import to_numpy


def torch_dtype(dtype) -> torch.dtype:
    """float32 for None (the kernels' type), else the torch dtype of a torch,
    numpy or JAX dtype or its name."""
    if dtype is None:
        return torch.float32
    if isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, np.dtype(dtype).name)


def _info_to_collision_arrays(info) -> tuple[int, np.ndarray, np.ndarray]:
    """One info dict or an ndarray of per-transition info dicts (SB3 HER):
    (batch, mover collision, wall collision)."""
    if isinstance(info, (np.ndarray, list, tuple)):
        batch = len(info)
        mover = np.array([bool(i['mover_collision']) for i in info])
        wall = np.array([bool(i['wall_collision']) for i in info])
        return batch, mover, wall
    if info is None:
        return 1, np.zeros(1, bool), np.zeros(1, bool)
    return 1, np.array([bool(info['mover_collision'])]), np.array([bool(info['wall_collision'])])


def _frame(stack: np.ndarray, c: int) -> torch.Tensor:
    """Cycle ``c`` of a per-cycle stack as a one-env host tensor."""
    return torch.as_tensor(np.asarray(stack[c]))[None]


class _TorchGymEnv(gym.Env):
    """Shared shell: owns the runner (config, params, state, generator)."""

    metadata = {'render_modes': ['human', 'rgb_array', 'depth_array', 'human_2d', 'rgb_array_2d'], 'render_fps': 25}

    def __init__(self, config, params, render_mode: str | None = None, render_every_cycle: bool = False,
                 show_2D_plot: bool = False, mover_colors_2D_plot=None, use_mj_passive_viewer: bool = False):
        self.config = config
        self.params = params
        self.render_mode = render_mode
        #: render after every 1 ms control cycle inside step(), not just at
        #: step boundaries
        self.render_every_cycle = bool(render_every_cycle)
        #: a live top-down matplotlib debug plot updated every reset and
        #: step, independent of render_mode
        self._show_2d = bool(show_2D_plot)
        self._mover_colors_2d = list(mover_colors_2D_plot) if mover_colors_2D_plot else None
        #: the 'human' 3D backend is mujoco.viewer.launch_passive
        self._use_passive = bool(use_mj_passive_viewer)
        self._viewer2d_live = None
        self._viewer = None
        self._viewer3d = None
        self._runner = EnvRunner(config, params)
        self._seeded = False
        # a sensor-noise stream of its own for the name-keyed accessors,
        # reseeded with the env on reset
        self._rng_noise = np.random.default_rng()

    @property
    def _state(self):
        return self._runner.state

    @_state.setter
    def _state(self, state):
        self._runner.state = state

    # -- Gymnasium API ------------------------------------------------------

    def reset(self, seed: int | None = None, options: dict[str, Any] | None = None):
        super().reset(seed=seed)
        if seed is not None:
            self._runner.seed(seed)
        elif not self._seeded:
            self._runner.seed(int(self.np_random.integers(2**31)))
        self._seeded = True
        self._rng_noise = np.random.default_rng(seed)
        obs, info = self._reset_core(options or {})
        if self.render_mode is not None:
            self.render()
        self._render_2d_live()
        return self._np_obs(obs), self._np_info(info)

    def step(self, action):
        assert self._state is not None, 'call reset() first'
        action = np.asarray(action, dtype=np.float64)
        assert action.shape == self.action_space.shape, 'action dim != action_space dim'
        # clip with a warning; the step clips again
        if not self.action_space.contains(action.astype(self.action_space.dtype)):
            gym.logger.warn(f'The desired action is not within the action space and will be clipped: {action}')
            action = np.clip(action, self.action_space.low, self.action_space.high)
        if self.render_every_cycle and self.render_mode is not None:
            obs, reward, terminated, truncated, info, cyc = self._runner.step(action, with_cycles=True)
            self._render_cycles(cyc)
        else:
            obs, reward, terminated, truncated, info = self._runner.step(action)
        # reward-shape guard: a scalar or shape-(1,) array; anything else
        # means a broken compute_reward override
        r = np.asarray(reward)
        if r.shape not in ((), (1,)):
            raise ValueError(f'the reward has to be a float or an array of shape (1,), got shape {r.shape}')
        if self.render_mode is not None:
            self.render()
        self._render_2d_live()
        return (
            self._np_obs(obs),
            float(r.reshape(-1)[0]) if r.shape else float(r),
            bool(terminated),
            bool(truncated),
            self._np_info(info),
        )

    # -- name-keyed state accessors -----------------------------------------

    @property
    def mover_names(self) -> list[str]:
        """Body names of the movers, ``mover_{k}``, as in the exported scene
        and the 3D mirror model."""
        return [f'mover_{i}' for i in range(getattr(self.config, 'num_movers', 1))]

    def _mover_plane(self, attr: str, mover_name: str) -> np.ndarray:
        assert self._state is not None, 'call reset() first'
        idx = self.mover_names.index(mover_name)
        return to_numpy(getattr(self._state, attr)).astype(np.float64).reshape(-1, 2)[idx]

    def get_mover_qpos(self, mover_name: str, add_noise: bool = False) -> np.ndarray:
        """(x, y, z, quat wxyz) of the named mover; z is the distance between
        the mover's bottom and the tile top (pushing's live mover z,
        planning's hover height).  The noise draws are taken either way,
        scaled by the gate."""
        xy = self._mover_plane('pos', mover_name)
        z = float(to_numpy(self._state.mover_z).reshape(-1)[0]) if hasattr(self._state, 'mover_z') else float(
            to_numpy(self.params.initial_zpos))
        qpos = np.array([xy[0], xy[1], z, 1.0, 0.0, 0.0, 0.0])
        std = float(to_numpy(self.params.std_noise).reshape(-1)[0])
        return qpos + self._rng_noise.normal(loc=0.0, scale=std * int(add_noise), size=qpos.shape[0])

    def get_mover_qvel(self, mover_name: str, add_noise: bool = False) -> np.ndarray:
        """(vx, vy, vz, wx, wy, wz) of the named mover."""
        xy = self._mover_plane('vel', mover_name)
        qvel = np.array([xy[0], xy[1], 0.0, 0.0, 0.0, 0.0])
        std = float(to_numpy(self.params.std_noise).reshape(-1)[1])
        return qvel + self._rng_noise.normal(loc=0.0, scale=std * int(add_noise), size=qvel.shape[0])

    def get_mover_qacc(self, mover_name: str, add_noise: bool = False) -> np.ndarray:
        """(ax, ay, az, al_x, al_y, al_z) of the named mover."""
        xy = self._mover_plane('acc', mover_name)
        qacc = np.array([xy[0], xy[1], 0.0, 0.0, 0.0, 0.0])
        std = float(to_numpy(self.params.std_noise).reshape(-1)[2])
        return qacc + self._rng_noise.normal(loc=0.0, scale=std * int(add_noise), size=qacc.shape[0])

    def _render_2d_live(self):
        """Update the live show_2D_plot window (a debug plot that updates
        every step whatever render_mode is)."""
        if not self._show_2d:
            return
        from gymnasium_planar_robotics_tpu_torch.utils import rendering

        if self._viewer2d_live is None:
            self._viewer2d_live = rendering.Planar2DViewer(self.params, interactive=True,
                                                           mover_colors=self._mover_colors_2d)
        self._viewer2d_live.render(self._render_state())

    def _render_cycles(self, cyc):
        """Replay the per-cycle poses through the active viewer: each frame
        swaps the state's pose fields, renders, then the final state is
        restored.  The replay stops after the colliding cycle's frame, so
        the frozen poses after a collision are never shown twice."""
        final_state = self._state
        done = np.asarray(cyc[-1])
        for c in range(int(done.shape[0])):
            self._state = self._cycle_state(final_state, cyc, c)
            self.render()
            if done[c]:
                break
        self._state = final_state

    def _cycle_state(self, final_state, cyc, c):
        return dataclasses.replace(final_state, pos=_frame(cyc[0], c), vel=_frame(cyc[1], c))

    def render(self):
        """'human', 'rgb_array' and 'depth_array' drive the live 3D MuJoCo
        mirror (``utils/mujoco_viewer.MujocoViewerCollection``); the '_2d'
        variants the matplotlib top-down view.  Without mujoco or a GL
        backend 'rgb_array' falls back to the 2D view with a warning."""
        if self.render_mode is None:
            return None
        if self.render_mode in ('human', 'rgb_array', 'depth_array') and self._viewer3d is not False:
            try:
                from gymnasium_planar_robotics_tpu_torch.utils.mujoco_viewer import MujocoViewerCollection

                # mesh movers mirror with their real silhouettes
                if self._viewer3d is None:
                    self._viewer3d = MujocoViewerCollection(
                        self.params, num_movers=self.config.num_movers if hasattr(self.config, 'num_movers') else 1,
                        mover_shape=getattr(self, '_mover_shape', 'box'), mesh_cfg=getattr(self, '_mesh_cfg', None),
                        use_mj_passive_viewer=self._use_passive,
                    )
                self._viewer3d.update(self._state)
                return self._viewer3d.render(self.render_mode)
            except Exception as e:  # no mujoco / no GL backend
                if self.render_mode != 'rgb_array':
                    raise
                gym.logger.warn(f'3D rendering unavailable ({e}); falling back to the 2D viewer')
                self._viewer3d = False  # do not retry per frame
        from gymnasium_planar_robotics_tpu_torch.utils import rendering

        if self._viewer is None:
            self._viewer = rendering.Planar2DViewer(self.params, interactive=self.render_mode == 'human_2d')
        frame = self._viewer.render(self._render_state())
        return frame if self.render_mode in ('rgb_array_2d', 'rgb_array') else None

    def close(self):
        if self._viewer is not None:
            self._viewer.close()
            self._viewer = None
        if self._viewer2d_live is not None:
            self._viewer2d_live.close()
            self._viewer2d_live = None
        if self._viewer3d:
            self._viewer3d.close()
        self._viewer3d = None

    # -- helpers ------------------------------------------------------------

    @staticmethod
    def _np_obs(obs) -> dict[str, np.ndarray]:
        return {k: np.asarray(v, dtype=np.float64) for k, v in obs.items()}

    @staticmethod
    def _np_info(info) -> dict[str, Any]:
        out = {}
        for k, v in info.items():
            a = np.asarray(v)
            out[k] = a.item() if a.shape == () else a
        return out


class PlanningGymEnv(_TorchGymEnv):
    """Collision-free multi-mover goal reaching (``BenchmarkPlanningEnv-v0``)."""

    def __init__(self, layout_tiles=None, num_movers: int = 1, render_mode: str | None = None, dtype=None,
                 render_every_cycle: bool = False, show_2D_plot: bool = False, mover_colors_2D_plot=None,
                 use_mj_passive_viewer: bool = False, device=None, **kwargs):
        layout_tiles = np.ones((3, 3)) if layout_tiles is None else np.asarray(layout_tiles)
        mp = kwargs.get('mover_params') or {}
        self._mover_shape = mp.get('shape', 'box')
        self._mesh_cfg = mp.get('mesh')
        config, params = planning_model.make_planning_env(layout_tiles=layout_tiles, num_movers=num_movers,
                                                          dtype=torch_dtype(dtype), device=device, **kwargs)
        super().__init__(config, params, render_mode, render_every_cycle=render_every_cycle,
                         show_2D_plot=show_2D_plot, mover_colors_2D_plot=mover_colors_2D_plot,
                         use_mj_passive_viewer=use_mj_passive_viewer)

        m = config.num_movers
        hi = to_numpy(params.grid.workspace_max_xy).astype(np.float64)
        low_goals = np.zeros(m * 2)
        high_goals = np.tile(hi, m)
        jerk_dims = (1 + int(config.learn_jerk)) * 2
        self.observation_space = gym.spaces.Dict({
            'observation': gym.spaces.Box(-np.inf, np.inf, shape=(m * jerk_dims,), dtype=np.float64),
            'achieved_goal': gym.spaces.Box(low=low_goals, high=high_goals, dtype=np.float64),
            'desired_goal': gym.spaces.Box(low=low_goals, high=high_goals, dtype=np.float64),
        })
        limit = float(params.j_max if config.learn_jerk else params.a_max)
        self.action_space = gym.spaces.Box(-limit, limit, shape=(m * 2,), dtype=np.float64)

    def _reset_core(self, options):
        # start and goal overrides (the reference's initial_mover_start_xy_pos
        # and initial_mover_goal_xy_pos)
        return self._runner.reset(start_xy=options.get('mover_start_xy_pos'),
                                  goals_xy=options.get('mover_goal_xy_pos'))

    def _render_state(self):
        return {
            'mover_xy': to_numpy(self._state.pos)[0],
            'mover_vel': to_numpy(self._state.vel)[0],
            'goals': to_numpy(self._state.goals)[0],
        }

    # -- HER API (batched, NumPy) ------------------------------------------

    def compute_reward(self, achieved_goal, desired_goal, info=None):
        """Batched HER reward recomputation: -50 on a collision recorded in
        ``info``, else the sparse 0/-1 goal-distance reward (+50 when every
        goal is reached).  Takes single samples, stacked arrays, or an array
        of info dicts as Stable-Baselines3 HER passes."""
        batch, mover, wall = _info_to_collision_arrays(info)
        a = np.asarray(achieved_goal).reshape(batch, -1)
        d = np.asarray(desired_goal).reshape(batch, -1)
        dtype = self.params.min_xy.dtype
        r = to_numpy(planning_model.compute_reward(
            self.config, self.params, torch.as_tensor(a, dtype=dtype), torch.as_tensor(d, dtype=dtype),
            torch.as_tensor(mover), torch.as_tensor(wall)))
        return r if batch > 1 else float(r[0])

    def compute_terminated(self, achieved_goal, desired_goal, info=None):
        """Relabelled termination: true where the recomputed reward is the
        +-50 of a success or a collision."""
        r = self.compute_reward(achieved_goal, desired_goal, info)
        out = np.abs(r) == planning_model.REWARD_SUCCESS
        return out if isinstance(r, np.ndarray) else bool(out)

    def compute_truncated(self, achieved_goal, desired_goal, info=None):
        """Always false: truncation comes from the TimeLimit wrapper, not
        from the goal state."""
        batch = achieved_goal.shape[0] if np.asarray(achieved_goal).ndim > 1 else 1
        return np.zeros(batch, bool) if batch > 1 else False


class PushingGymEnv(_TorchGymEnv):
    """Push the box object to its goal (``BenchmarkPushingEnv-v0``)."""

    def __init__(self, render_mode: str | None = None, dtype=None, render_every_cycle: bool = False,
                 use_mj_passive_viewer: bool = False, device=None, **kwargs):
        mp = kwargs.get('mover_params') or {}
        self._mover_shape = mp.get('shape', 'box')
        self._mesh_cfg = mp.get('mesh')
        config, params = pushing_model.make_pushing_env(dtype=torch_dtype(dtype), device=device, **kwargs)
        super().__init__(config, params, render_mode, render_every_cycle=render_every_cycle,
                         use_mj_passive_viewer=use_mj_passive_viewer)

        hi = to_numpy(params.grid.workspace_max_xy).astype(np.float64)
        jerk_dims = (2 + int(config.learn_jerk)) * 2
        self.observation_space = gym.spaces.Dict({
            'observation': gym.spaces.Box(-np.inf, np.inf, shape=(jerk_dims,), dtype=np.float64),
            'achieved_goal': gym.spaces.Box(low=np.zeros(2), high=hi, dtype=np.float64),
            'desired_goal': gym.spaces.Box(low=np.zeros(2), high=hi, dtype=np.float64),
        })
        limit = float(params.j_max if config.learn_jerk else params.a_max)
        self.action_space = gym.spaces.Box(-limit, limit, shape=(2,), dtype=np.float64)

    def _cycle_state(self, final_state, cyc, c):
        return dataclasses.replace(final_state, **{k: _frame(cyc[i], c) for i, k in enumerate(
            ('pos', 'vel', 'obj_pos', 'obj_yaw'))})

    def _reset_core(self, options):
        return self._runner.reset(mover_start_xy_pos=options.get('mover_start_xy_pos'),
                                  object_goal_xy_pos=options.get('object_goal_xy_pos'))

    def _render_state(self):
        return {
            'mover_xy': to_numpy(self._state.pos),
            'mover_vel': to_numpy(self._state.vel),
            'goals': to_numpy(self._state.goal),
            'object_xy': to_numpy(self._state.obj_pos)[0],
            'object_half': to_numpy(self.params.object_half),
        }

    def compute_reward(self, achieved_goal, desired_goal, info=None):
        """Batched HER reward for pushing: -50 on a wall collision recorded
        in ``info``, else the sparse 0/-1 object-to-goal distance reward."""
        batch, _, wall = _info_to_collision_arrays(info)
        a = np.asarray(achieved_goal).reshape(batch, -1)
        d = np.asarray(desired_goal).reshape(batch, -1)
        dtype = self.params.min_xy.dtype
        r = to_numpy(pushing_model.compute_reward(self.params, torch.as_tensor(a, dtype=dtype),
                                               torch.as_tensor(d, dtype=dtype), torch.as_tensor(wall)))
        return r if batch > 1 else float(r[0])

    def compute_terminated(self, achieved_goal, desired_goal, info=None):
        """Relabelled termination: pushing ends on a wall collision only
        (reaching the goal does not end the episode)."""
        r = self.compute_reward(achieved_goal, desired_goal, info)
        out = r == pushing_model.REWARD_WALL_COLLISION
        return out if isinstance(r, np.ndarray) else bool(out)

    def compute_truncated(self, achieved_goal, desired_goal, info=None):
        """Always false: truncation comes from the TimeLimit wrapper only."""
        batch = achieved_goal.shape[0] if np.asarray(achieved_goal).ndim > 1 else 1
        return np.zeros(batch, bool) if batch > 1 else False


# registration entry points (envs/registration.py)

def make_planning_env(**kwargs) -> PlanningGymEnv:
    """Entry point of ``planar_robotics_torch/BenchmarkPlanningEnv-v0``."""
    return PlanningGymEnv(**kwargs)


def make_pushing_env(**kwargs) -> PushingGymEnv:
    """Entry point of ``planar_robotics_torch/BenchmarkPushingEnv-v0``."""
    return PushingGymEnv(**kwargs)
