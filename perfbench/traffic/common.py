"""What both kinds of traffic share: building the configuration's env
through the program's entry points, its initial batch, and the call's
readback."""

from __future__ import annotations

import importlib
import time

import numpy as np
import torch

PROGRAM = 'gymnasium_planar_robotics_tpu_torch'


def program(module: str):
    return importlib.import_module(f'{PROGRAM}.{module}')


def make_env(cfg: dict, device: torch.device):
    """``(module, config, params)`` of the configuration's family, built by
    the program's constructor from the configuration's settings."""
    env = cfg['env']
    collision = {'shape': cfg['collision_shape'], 'size': env['collision_size'], 'offset': env['collision_offset'],
                 'offset_wall': env['collision_offset_wall']}
    kw = dict(std_noise=env['std_noise'], num_cycles=env['num_cycles'], collision_params=collision,
              v_max=env['v_max'], a_max=env['a_max'], learn_jerk=env['learn_jerk'],
              threshold_pos=env['threshold_pos'], initial_mover_zpos=env['initial_mover_zpos'],
              max_reset_trials=env['max_reset_trials'], device=device)
    mod = program(f'models.{cfg["family"]}')
    if cfg['family'] == 'pushing':
        config, params = mod.make_pushing_env(**kw)
    else:
        config, params = mod.make_planning_env(np.asarray(cfg['layout']), env['num_movers'], **kw)
    if config.max_episode_steps != env['max_episode_steps']:
        raise ValueError(f'the program runs {config.max_episode_steps}-step episodes, the configuration states '
                         f'{env["max_episode_steps"]}')
    return mod, config, params


def synchronize(device: torch.device) -> None:
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


class Base:
    """A configuration's env on ``device`` under one traffic mix: the
    initial batch from the run's reset seed, the call's seeds."""

    def __init__(self, cfg: dict, mix: dict, device: torch.device, seeds: dict, spans):
        self.cfg, self.mix, self.device, self.seeds, self.spans = cfg, mix, device, seeds, spans
        self.envs, self.steps = mix['envs'], mix['steps_per_call']
        self.data = torch.Generator(device=device).manual_seed(seeds['data'])
        self.state = None
        self.initial = None

    def build(self) -> None:
        """The family's entry point for this kind of traffic."""
        raise NotImplementedError

    def setup(self) -> float:
        """Build the env and its initial batch; returns the milliseconds of
        ``init_batch`` (ending in a synchronise)."""
        self.mod, self.config, self.params = make_env(self.cfg, self.device)
        self.build()
        gen = torch.Generator(device=self.device).manual_seed(self.seeds['init'])
        synchronize(self.device)
        t0 = time.perf_counter()
        state, _, info = self.mod.init_batch(self.config, self.params, self.envs, generator=gen)
        synchronize(self.device)
        ms = (time.perf_counter() - t0) * 1e3
        self.state, self.initial = state, (state, info)
        return ms

    def call_seed(self, i: int) -> int:
        """The Philox seed of call ``i``: each of its launches adds its step
        (or chunk) index, so no two calls share a stream."""
        return self.seeds['kernel'] + i * self.steps

    def readback(self, out) -> list:
        """The call's reward sum, finished env-steps and collided env-steps,
        read to the host (the synchronise that ends the call)."""
        reward, term, trunc = out[:3]
        return torch.stack([reward.sum(), (term | trunc).sum().to(reward.dtype),
                            (reward == -50.0).sum().to(reward.dtype)]).tolist()

    def release(self) -> None:
        self.state = self.initial = None
