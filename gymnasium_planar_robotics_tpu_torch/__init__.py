"""PyTorch + CUDA port of the planar-robotics environment engine.

The fused serving paths of pushing (``models/pushing``) and of planning
with 1 to 735 movers (``models/planning``, ``models/multi_agent``) run on an
NVIDIA Hopper card through hand-written CUDA kernels (``csrc/``, built with
``nvcc`` at first use by ``ops/kernels/build``); on CPU tensors every kernel
wrapper runs its plain PyTorch version instead.  The Gymnasium, vector and
PettingZoo adapters (``envs/``), the viewers (``utils/rendering``,
``utils/mujoco_viewer``), the impedance controller (``utils/impedance``) and
the domain core (``core``) are reached through the names below, which import
them (and ``gymnasium``, ``matplotlib`` or ``mujoco``) only when asked for:
importing the package imports ``torch`` and ``numpy`` only and registers no
env id (``envs.register_gymnasium_envs`` does).
"""

__version__ = '0.1.0'

_SURFACE = {
    'PlanningGymEnv': ('gymnasium_planar_robotics_tpu_torch.envs.gym_env', 'PlanningGymEnv'),
    'PushingGymEnv': ('gymnasium_planar_robotics_tpu_torch.envs.gym_env', 'PushingGymEnv'),
    'PlanningVectorEnv': ('gymnasium_planar_robotics_tpu_torch.envs.vector_env', 'PlanningVectorEnv'),
    'PushingVectorEnv': ('gymnasium_planar_robotics_tpu_torch.envs.vector_env', 'PushingVectorEnv'),
    'PlanningParallelEnv': ('gymnasium_planar_robotics_tpu_torch.envs.pettingzoo_env', 'PlanningParallelEnv'),
    'Planar2DViewer': ('gymnasium_planar_robotics_tpu_torch.utils.rendering', 'Planar2DViewer'),
    'MujocoViewerCollection': ('gymnasium_planar_robotics_tpu_torch.utils.mujoco_viewer', 'MujocoViewerCollection'),
    'ImpedanceGains': ('gymnasium_planar_robotics_tpu_torch.utils.impedance', 'ImpedanceGains'),
    'impedance_wrench': ('gymnasium_planar_robotics_tpu_torch.utils.impedance', 'impedance_wrench'),
    'make_gains': ('gymnasium_planar_robotics_tpu_torch.utils.impedance', 'make_gains'),
    # the reference's names of the 2D viewer and of the domain core
    'Matplotlib2DViewer': ('gymnasium_planar_robotics_tpu_torch.utils.rendering', 'Planar2DViewer'),
    'BasicPlanarRoboticsEnv': ('gymnasium_planar_robotics_tpu_torch.core', 'PlanarRoboticsCore'),
}


def __getattr__(name):
    """The public env and viewer classes, imported on first use."""
    if name in _SURFACE:
        import importlib

        module, attr = _SURFACE[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(f'module {__name__!r} has no attribute {name!r}')
