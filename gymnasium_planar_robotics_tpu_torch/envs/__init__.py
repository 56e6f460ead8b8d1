"""Gymnasium and PettingZoo adapters at the edge of the port
(``register_gymnasium_envs`` registers the port's ids when called; the
card-facing part, ``runner``, imports neither package)."""

from gymnasium_planar_robotics_tpu_torch.envs.registration import register_gymnasium_envs  # noqa: F401
