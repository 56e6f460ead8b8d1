"""PettingZoo parallel multi-agent adapter.

Counterpart of ``gymnasium_planar_robotics_tpu/envs/pettingzoo_env.py``:
one agent per mover (``mover_i``), each commanding its own (x, y)
acceleration or jerk and observing its own velocity (and acceleration),
position (achieved goal) and goal, with the planning env's shared collision
and termination split per agent; truncation at ``max_episode_steps``.  The
physics is ``envs/runner.EnvRunner`` at M movers (the eager step; on the
card kernel A draws the observation noise), one host transfer a step.
Without ``pettingzoo`` installed a stand-in ``ParallelEnv`` keeps it
importable.
"""

from __future__ import annotations

from typing import Any

import numpy as np

import gymnasium as gym

from gymnasium_planar_robotics_tpu_torch.envs.gym_env import torch_dtype
from gymnasium_planar_robotics_tpu_torch.envs.runner import EnvRunner
from gymnasium_planar_robotics_tpu_torch.models import planning as planning_model
from gymnasium_planar_robotics_tpu_torch.ops.kernels import to_numpy

try:
    from pettingzoo import ParallelEnv
except ImportError:  # pragma: no cover - pettingzoo is an optional extra
    class ParallelEnv:  # type: ignore[no-redef]
        """Minimal stand-in so the adapter is importable without pettingzoo."""


class PlanningParallelEnv(ParallelEnv):
    """Parallel multi-agent planning env: one agent per mover."""

    metadata = {'render_modes': ['human', 'rgb_array'], 'name': 'planning_parallel_v0'}

    def __init__(self, layout_tiles=None, num_movers: int = 4, dtype=None, render_mode=None, device=None, **kwargs):
        layout_tiles = np.ones((4, 4)) if layout_tiles is None else np.asarray(layout_tiles)
        config, params = planning_model.make_planning_env(layout_tiles=layout_tiles, num_movers=num_movers,
                                                          dtype=torch_dtype(dtype), device=device, **kwargs)
        self.config = config
        self.params = params
        self.render_mode = render_mode
        # agent names are the movers' body names
        self.possible_agents = [f'mover_{i}' for i in range(num_movers)]
        self.agents = []
        self._runner = EnvRunner(config, params)
        self._viewer = None

        limit = float(params.j_max if config.learn_jerk else params.a_max)
        hi = to_numpy(params.grid.workspace_max_xy).astype(np.float64)
        jerk_dims = (1 + int(config.learn_jerk)) * 2
        self._obs_space = gym.spaces.Dict({
            'observation': gym.spaces.Box(-np.inf, np.inf, shape=(jerk_dims,), dtype=np.float64),
            'achieved_goal': gym.spaces.Box(np.zeros(2), hi, dtype=np.float64),
            'desired_goal': gym.spaces.Box(np.zeros(2), hi, dtype=np.float64),
        })
        self._act_space = gym.spaces.Box(-limit, limit, shape=(2,), dtype=np.float64)

    @property
    def _state(self):
        return self._runner.state

    def observation_space(self, agent):
        return self._obs_space

    def action_space(self, agent):
        return self._act_space

    def reset(self, seed: int | None = None, options: dict[str, Any] | None = None):
        # unseeded resets continue the runner's stream, seeded at random
        if seed is not None:
            self._runner.seed(seed)
        obs, info = self._runner.reset()
        self.agents = list(self.possible_agents)
        return self._split_obs(obs), {a: self._shared_info(info) for a in self.agents}

    def step(self, actions: dict[str, np.ndarray]):
        assert self._state is not None, 'call reset() first'
        m = self.config.num_movers
        flat = np.zeros((m, 2))
        for i, a in enumerate(self.possible_agents):
            flat[i] = np.asarray(actions[a])
        obs, reward, terminated, truncated, info = self._runner.step(flat.reshape(-1))
        steps = self._runner.steps
        if self.render_mode is not None:
            self.render()

        # per-agent reward split: the shared collision penalty, own-goal shaping
        achieved = np.asarray(obs['achieved_goal']).reshape(m, 2)
        desired = np.asarray(obs['desired_goal']).reshape(m, 2)
        dist = np.linalg.norm(achieved - desired, axis=-1)
        reached = dist <= float(self.params.threshold_pos)
        collided = bool(info['mover_collision']) or bool(info['wall_collision'])
        if collided:
            rewards = {a: -planning_model.REWARD_SUCCESS for a in self.possible_agents}
        elif reached.all():
            rewards = {a: planning_model.REWARD_SUCCESS for a in self.possible_agents}
        else:
            rewards = {a: float(-(~reached[i]).astype(float)) for i, a in enumerate(self.possible_agents)}

        term = bool(terminated)
        # the Gymnasium registrations cap episodes at 50 steps through
        # TimeLimit; the parallel API carries the same limit in truncations
        trunc = (not term) and steps >= self.config.max_episode_steps
        terminations = {a: term for a in self.possible_agents}
        truncations = {a: trunc for a in self.possible_agents}
        infos = {a: self._shared_info(info) for a in self.possible_agents}
        observations = self._split_obs(obs)
        if term or trunc:
            self.agents = []
        return observations, rewards, terminations, truncations, infos

    def render(self):
        if self.render_mode is None:
            return None
        from gymnasium_planar_robotics_tpu_torch.utils import rendering

        if self._viewer is None:
            self._viewer = rendering.Planar2DViewer(self.params, interactive=self.render_mode == 'human')
        frame = self._viewer.render({'mover_xy': to_numpy(self._state.pos)[0],
                                     'mover_vel': to_numpy(self._state.vel)[0],
                                     'goals': to_numpy(self._state.goals)[0]})
        return frame if self.render_mode == 'rgb_array' else None

    def close(self):
        if self._viewer is not None:
            self._viewer.close()
            self._viewer = None

    # -- helpers ------------------------------------------------------------

    def _split_obs(self, obs) -> dict[str, dict[str, np.ndarray]]:
        m = self.config.num_movers
        jerk = self.config.learn_jerk
        observation = np.asarray(obs['observation'], dtype=np.float64)
        vel = observation[: m * 2].reshape(m, 2)
        acc = observation[m * 2:].reshape(m, 2) if jerk else None
        achieved = np.asarray(obs['achieved_goal'], dtype=np.float64).reshape(m, 2)
        desired = np.asarray(obs['desired_goal'], dtype=np.float64).reshape(m, 2)
        out = {}
        for i, a in enumerate(self.possible_agents):
            own = np.concatenate([vel[i], acc[i]]) if jerk else vel[i]
            out[a] = {'observation': own, 'achieved_goal': achieved[i], 'desired_goal': desired[i]}
        return out

    @staticmethod
    def _shared_info(info) -> dict[str, Any]:
        return {
            'is_success': bool(np.asarray(info['is_success'])),
            'mover_collision': bool(np.asarray(info['mover_collision'])),
            'wall_collision': bool(np.asarray(info['wall_collision'])),
        }
