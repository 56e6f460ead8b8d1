"""Open-loop traffic: each call's actions drawn ahead, uniform in
``[-a_max, a_max]`` on the card from the run's data seed, and one call of
the program's ``make_fused_rollout`` over them (``steps_per_launch`` steps
a kernel launch)."""

from __future__ import annotations

import torch

from traffic.common import Base


class Driver(Base):
    def build(self) -> None:
        self.rollout = self.mod.make_fused_rollout(self.config, self.params, cand_k=self.cfg['cand_k'],
                                                   steps_per_launch=self.mix['steps_per_launch'])
        m = self.cfg['env'].get('num_movers', 1)
        self.shape = (self.steps, self.envs, 2) if self.cfg['family'] == 'pushing' else (self.steps, self.envs, m, 2)
        self.a_max = float(self.cfg['env']['a_max'])

    def draw(self, i: int) -> torch.Tensor:
        u = torch.rand(self.shape, generator=self.data, device=self.device)
        return u.mul_(2.0 * self.a_max).sub_(self.a_max)

    def call(self, i: int, actions: torch.Tensor):
        with torch.no_grad():
            state, reward, term, trunc = self.rollout(self.state, actions, self.call_seed(i))
        self.state = state
        return reward, term, trunc, state

    def capture(self, i: int, state_in, actions, out) -> dict:
        reward, term, trunc, state = out
        return {'state_in': state_in, 'actions': actions, 'seed': self.call_seed(i), 'state_out': state,
                'reward': reward, 'terminated': term, 'truncated': trunc}
