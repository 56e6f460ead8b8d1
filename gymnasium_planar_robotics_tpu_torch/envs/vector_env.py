"""Gymnasium VectorEnv adapters over the batched port.

Counterpart of ``gymnasium_planar_robotics_tpu/envs/vector_env.py``: B envs
stepped as one call with in-place autoreset, ``AutoresetMode.SAME_STEP``
semantics (the observation returned for a finished episode is the first of
the new one; the final observation rides in ``info['final_observation']``),
env 0's top-down render.  The stepping is ``envs/runner.VectorRunner``: the
fused autoreset step (kernel C, C box, F or H) where a kernel covers the
configuration (``using_fused``), else the eager ``step_autoreset``; one
host transfer a step.  ``device_state`` is the state on the device.

Over a device mesh (``mesh=``, ``parallel/sharding.make_mesh``: one
``torch.distributed`` rank a device, NCCL on the card, gloo on the CPU)
``num_envs`` is the global batch, which must divide by ``mesh.size()``.
Each rank holds and steps its shard (``sharding.make_sharded_fused_step``
where a kernel covers the configuration, else ``sharding.sharded_step_fn``
over the eager step), its draws split by ``sharding.rank_generator``;
``step`` takes the global actions and every rank returns the global batch,
gathered with one collective a step, as the JAX package's env hands its
one process the whole batch.  ``device_state`` is the rank's shard;
``render`` shows env 0 of the global batch (a collective: every rank calls
it).  At world size 1 the env is the unsharded one, bit for bit.  The
tensors live on the mesh's device unless ``device=`` names one.
"""

from __future__ import annotations

from typing import Any

import numpy as np

import gymnasium as gym

from gymnasium_planar_robotics_tpu_torch.envs.gym_env import torch_dtype
from gymnasium_planar_robotics_tpu_torch.envs.runner import VectorRunner
from gymnasium_planar_robotics_tpu_torch.models import planning as planning_model
from gymnasium_planar_robotics_tpu_torch.models import pushing as pushing_model
from gymnasium_planar_robotics_tpu_torch.ops.kernels import to_numpy
from gymnasium_planar_robotics_tpu_torch.parallel import sharding


def _autoreset_mode():
    # standard vector wrappers assert isinstance(..., AutoresetMode)
    try:
        return gym.vector.AutoresetMode.SAME_STEP
    except AttributeError:  # older gymnasium without the enum
        return 'SameStep'


def _device(mesh, device):
    """The envs' device: ``device`` if named, else the mesh's (None: the card)."""
    return sharding.mesh_device(mesh) if device is None and mesh is not None else device


class _TorchVectorEnv(gym.vector.VectorEnv):
    metadata = {'autoreset_mode': _autoreset_mode()}

    def __init__(self, config, params, num_envs: int, mesh=None):
        self.config = config
        self.params = params
        self.num_envs = num_envs
        self._runner = VectorRunner(config, params, num_envs, mesh)
        #: True when steps run through the fused kernel (observable, so a run
        #: on the card can assert that the fast path engaged)
        self.using_fused = self._runner.using_fused

    def reset(self, seed: int | None = None, options: dict[str, Any] | None = None):
        # unseeded resets continue the runner's stream, seeded at random
        if seed is not None:
            self._runner.seed(seed)
        return self._runner.reset()

    def step(self, actions):
        return self._runner.step(np.asarray(actions))

    # direct on-device access for learners that skip the NumPy boundary
    @property
    def device_state(self):
        return self._runner.device_state

    @property
    def _state(self):
        return self._runner.state

    def render(self):
        """Top-down rgb frame of env 0, a debugging window into the batch."""
        assert self._state is not None, 'call reset() first'
        from gymnasium_planar_robotics_tpu_torch.utils import rendering

        if getattr(self, '_viewer2d', None) is None:
            self._viewer2d = rendering.Planar2DViewer(self.params)
        return self._viewer2d.render(self._render_state0(self._runner.env0()))

    def close_extras(self, **kwargs):
        if getattr(self, '_viewer2d', None) is not None:
            self._viewer2d.close()
            self._viewer2d = None


class PlanningVectorEnv(_TorchVectorEnv):
    def __init__(self, num_envs: int, layout_tiles=None, num_movers: int = 1, mesh=None, dtype=None, device=None,
                 **kwargs):
        layout_tiles = np.ones((3, 3)) if layout_tiles is None else np.asarray(layout_tiles)
        config, params = planning_model.make_planning_env(layout_tiles=layout_tiles, num_movers=num_movers,
                                                          dtype=torch_dtype(dtype), device=_device(mesh, device),
                                                          **kwargs)
        super().__init__(config, params, num_envs, mesh)
        m = config.num_movers
        space_dtype = np.dtype(to_numpy(params.v_max).dtype)
        limit = float(params.j_max if config.learn_jerk else params.a_max)
        hi = to_numpy(params.grid.workspace_max_xy).astype(np.float64)
        jerk_dims = (1 + int(config.learn_jerk)) * 2
        self.single_observation_space = gym.spaces.Dict({
            'observation': gym.spaces.Box(-np.inf, np.inf, shape=(m * jerk_dims,), dtype=space_dtype),
            'achieved_goal': gym.spaces.Box(np.zeros(m * 2), np.tile(hi, m), dtype=space_dtype),
            'desired_goal': gym.spaces.Box(np.zeros(m * 2), np.tile(hi, m), dtype=space_dtype),
        })
        self.single_action_space = gym.spaces.Box(-limit, limit, shape=(m * 2,), dtype=np.float64)
        self.observation_space = gym.vector.utils.batch_space(self.single_observation_space, num_envs)
        self.action_space = gym.vector.utils.batch_space(self.single_action_space, num_envs)

    def _render_state0(self, s):
        return {'mover_xy': to_numpy(s.pos[0]), 'mover_vel': to_numpy(s.vel[0]), 'goals': to_numpy(s.goals[0])}


class PushingVectorEnv(_TorchVectorEnv):
    def __init__(self, num_envs: int, mesh=None, dtype=None, device=None, **kwargs):
        config, params = pushing_model.make_pushing_env(dtype=torch_dtype(dtype), device=_device(mesh, device),
                                                        **kwargs)
        super().__init__(config, params, num_envs, mesh)
        space_dtype = np.dtype(to_numpy(params.v_max).dtype)
        limit = float(params.j_max if config.learn_jerk else params.a_max)
        hi = to_numpy(params.grid.workspace_max_xy).astype(np.float64)
        jerk_dims = (2 + int(config.learn_jerk)) * 2
        self.single_observation_space = gym.spaces.Dict({
            'observation': gym.spaces.Box(-np.inf, np.inf, shape=(jerk_dims,), dtype=space_dtype),
            'achieved_goal': gym.spaces.Box(np.zeros(2), hi, dtype=space_dtype),
            'desired_goal': gym.spaces.Box(np.zeros(2), hi, dtype=space_dtype),
        })
        self.single_action_space = gym.spaces.Box(-limit, limit, shape=(2,), dtype=np.float64)
        self.observation_space = gym.vector.utils.batch_space(self.single_observation_space, num_envs)
        self.action_space = gym.vector.utils.batch_space(self.single_action_space, num_envs)

    def _render_state0(self, s):
        return {
            'mover_xy': to_numpy(s.pos[0])[None],
            'mover_vel': to_numpy(s.vel[0])[None],
            'goals': to_numpy(s.goal[0])[None],
            'object_xy': to_numpy(s.obj_pos[0]),
            'object_half': to_numpy(self.params.object_half),
        }
