"""Registration of the port's envs with Gymnasium.

Counterpart of ``gymnasium_planar_robotics_tpu/envs/registration.py``, under
ids of its own, ``planar_robotics_torch/BenchmarkPlanningEnv-v0`` and
``planar_robotics_torch/BenchmarkPushingEnv-v0`` (each with the 50-step time
limit), so that the JAX package's ``BenchmarkPlanningEnv-v0`` and
``BenchmarkPushingEnv-v0`` keep pointing at its own classes in a process
that imports both.  Nothing registers until ``register_gymnasium_envs()``
is called, and ``gymnasium`` is imported there.
"""

from __future__ import annotations

NAMESPACE = 'planar_robotics_torch'
PLANNING_ID = f'{NAMESPACE}/BenchmarkPlanningEnv-v0'
PUSHING_ID = f'{NAMESPACE}/BenchmarkPushingEnv-v0'


def register_gymnasium_envs() -> None:
    """Register the port's two envs with the Gymnasium registry
    (idempotent); ``gym.make(PLANNING_ID, device='cpu')`` then builds a
    ``PlanningGymEnv`` (the card unless ``device`` names another)."""
    import gymnasium as gym

    for env_id, entry in ((PLANNING_ID, 'make_planning_env'), (PUSHING_ID, 'make_pushing_env')):
        if env_id not in gym.registry:
            gym.register(id=env_id, entry_point=f'gymnasium_planar_robotics_tpu_torch.envs.gym_env:{entry}',
                         max_episode_steps=50)
