"""SimpleQ — vanilla deep Q-learning without the DQN extensions.

Reference: rllib/algorithms/simple_q/simple_q.py (SimpleQ is the minimal
Q-learner the reference's DQN extends: single Q network + target net,
uniform replay, epsilon-greedy — no double-Q, no prioritized replay, no
n-step, no dueling). Here the relationship is inverted the same way the
config flags allow: SimpleQ is DQN with every extension switched off and
locked off, so the two stay behaviorally distinct even through
``.training()`` overrides.
"""

from __future__ import annotations

from ray_tpu_torch.rllib.algorithms.dqn.dqn import DQN, DQNConfig


class SimpleQConfig(DQNConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or SimpleQ)
        self.double_q = False
        self.prioritized_replay = False
        self.target_network_update_freq = 250

    def training(self, *, double_q=None, prioritized_replay=None, **kwargs) -> "SimpleQConfig":
        # The whole point of SimpleQ is the absence of the extensions;
        # silently honoring these would make it DQN with a different name.
        if double_q or prioritized_replay:
            raise ValueError(
                "SimpleQ is the extension-free Q-learner; use DQNConfig for "
                "double_q/prioritized_replay"
            )
        super().training(**kwargs)
        return self


class SimpleQ(DQN):
    @classmethod
    def get_default_config(cls) -> SimpleQConfig:
        return SimpleQConfig(cls)
