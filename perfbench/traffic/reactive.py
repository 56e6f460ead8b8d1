"""Reactive traffic: a policy in the loop.  The program's
``make_reactive_rollout`` runs the env step (kernel C-feat) and, between
its launches, the ``policy_step`` handed to it here: the program's
actor-critic (``models/ppo.ActorCritic``, ``sample_action_pm``) on the
features the kernel emits.  The policy's weights are drawn on the card
from the run's weight seed, in one call, and its exploration noise for
each call is drawn ahead from the data seed."""

from __future__ import annotations

import math
import re

import torch

from reference import policy as ref_policy
from traffic.common import Base, program


class Driver(Base):
    def build(self) -> None:
        if self.cfg['family'] != 'pushing':
            raise NotImplementedError('reactive traffic drives the pushing family (kernel C-feat)')
        ppo = program('models.ppo')
        mix = self.mix
        hidden, obs_dim, act_dim = list(mix['policy_hidden']), mix['obs_dim'], mix['action_dim']
        shapes = ref_policy.shapes(obs_dim, hidden, act_dim)
        n = sum(math.prod(s) for _, s in shapes)
        gen = torch.Generator(device=self.device).manual_seed(self.seeds['weights'])
        flat = torch.randn(n, generator=gen, device=self.device)
        leaves = ref_policy.unpack(flat, obs_dim, hidden, act_dim)
        scales = mix['weight_scales']  # trunk weights: a gain over the root of the fan-in
        with torch.no_grad():
            for name, leaf in leaves.items():
                key = re.sub(r'[0-9]', '', name)
                leaf.mul_(scales[key] / (math.sqrt(leaf.shape[1]) if key == 'trunk.weight' else 1.0))
        self.weights = flat
        pol = ppo.ActorCritic(obs_dim, tuple(hidden), act_dim, device=self.device)
        with torch.no_grad():
            for i, layer in enumerate(pol.trunk):
                layer.weight.copy_(leaves[f'trunk{i}.weight'])
                layer.bias.copy_(leaves[f'trunk{i}.bias'])
            for head in ('mu', 'value'):
                getattr(pol, head).weight.copy_(leaves[f'{head}.weight'])
                getattr(pol, head).bias.copy_(leaves[f'{head}.bias'])
            pol.log_std.copy_(leaves['log_std'])
        self.policy = pol
        a_max, spans = float(self.cfg['env']['a_max']), self.spans

        def policy_step(pol, eps, obs_pm):
            with spans('policy'):
                action, raw, logp, value = ppo.sample_action_pm(pol, obs_pm, eps, a_max)
            return action, (raw, logp, value)

        self.rollout = self.mod.make_reactive_rollout(self.config, self.params, policy_step, self.steps,
                                                      cand_k=self.cfg['cand_k'])

    def draw(self, i: int) -> torch.Tensor:
        return torch.randn((self.steps, self.mix['action_dim'], self.envs), generator=self.data, device=self.device)

    def call(self, i: int, eps: torch.Tensor):
        with torch.no_grad():
            state, traj, _ = self.rollout(self.state, self.policy, None, self.call_seed(i), policy_xs=eps)
        self.state = state
        obs, (raw, logp, value), reward, term, trunc, final = traj
        return reward, term, trunc, state, obs, raw, logp, value, final

    def capture(self, i: int, state_in, eps, out) -> dict:
        reward, term, trunc, state, obs, raw, logp, value, final = out
        return {'state_in': state_in, 'seed': self.call_seed(i), 'eps': eps, 'weights': self.weights,
                'actions': raw, 'state_out': state, 'reward': reward, 'terminated': term, 'truncated': trunc,
                'obs': obs.transpose(1, 2), 'final': final.transpose(1, 2), 'raw': raw.transpose(1, 2),
                'logp': logp, 'value': value}

    def release(self) -> None:
        super().release()
        self.policy = None
