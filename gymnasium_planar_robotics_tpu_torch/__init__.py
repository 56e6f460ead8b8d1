"""PyTorch + CUDA port of the planar-robotics environment engine.

The fused serving paths of pushing (``models/pushing``) and of planning
with 1 to 64 movers (``models/planning``, ``models/multi_agent``) run on an
NVIDIA Hopper card through hand-written CUDA kernels (``csrc/``, built with
``nvcc`` at first use by ``ops/kernels/build``); on CPU tensors every kernel
wrapper runs its plain PyTorch version instead.  This package imports
``torch`` and ``numpy`` only.
"""

__version__ = '0.1.0'
