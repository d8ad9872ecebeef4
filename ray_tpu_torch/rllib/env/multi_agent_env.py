"""MultiAgentEnv (analog of reference rllib/env/multi_agent_env.py).

A copy of the JAX package's module (it imports no JAX); the one change is
that ``make_multi_agent`` of an env id builds it through the port's
``env.cartpole.make`` (the port's own CartPole-v1 and Pendulum-v1, gymnasium
for any other id), as every env id of the port does.

Dict-keyed multi-agent episodes with the gymnasium 5-tuple convention:
``step(action_dict) -> (obs, rewards, terminateds, truncateds, infos)``, each
a per-agent dict; ``terminateds["__all__"]`` ends the episode. Training uses
parameter sharing (one policy for every agent — the reference's default
policy mapping): the rollout layer flattens each agent into a vector-env
slot, so GAE, the learners, and the algorithms are agent-count-agnostic.
Fixed agent sets (``possible_agents``) are assumed — the reference's dynamic
agent turnover is out of scope for the shared-policy path.
"""

from __future__ import annotations

from typing import Optional


class MultiAgentEnv:
    """Subclass and define possible_agents, observation_space, action_space
    (shared across agents), reset(), step(action_dict)."""

    possible_agents: list = []

    @property
    def observation_space(self):
        raise NotImplementedError

    @property
    def action_space(self):
        raise NotImplementedError

    def reset(self, *, seed: Optional[int] = None):
        """-> (obs_dict, info_dict)"""
        raise NotImplementedError

    def step(self, action_dict: dict):
        """-> (obs, rewards, terminateds, truncateds, infos) per-agent dicts;
        terminateds/truncateds may carry the "__all__" key."""
        raise NotImplementedError

    def close(self):
        pass


def make_multi_agent(env_spec, num_agents: int = 2):
    """Lift a single-agent gym env into an N-agent MultiAgentEnv of
    independent copies (reference: rllib/env/multi_agent_env.py
    make_multi_agent) — each agent steps its own instance; the episode ends
    when every copy is done."""

    class _IndependentCopies(MultiAgentEnv):
        # Each agent's copy auto-resets on termination, so every agent is
        # live every step — the property the slot-flattening rollout path
        # needs (see MultiAgentVectorEnv).
        agent_auto_reset = True

        def __init__(self, config: Optional[dict] = None):
            config = dict(config or {})
            n = int(config.pop("num_agents", num_agents))
            self.possible_agents = [f"agent_{i}" for i in range(n)]
            self._envs = {}
            for aid in self.possible_agents:
                if callable(env_spec):
                    self._envs[aid] = env_spec(config)
                else:
                    from ray_tpu_torch.rllib.env.cartpole import make

                    self._envs[aid] = make(env_spec)
            self._done = {aid: False for aid in self.possible_agents}

        @property
        def observation_space(self):
            return next(iter(self._envs.values())).observation_space

        @property
        def action_space(self):
            return next(iter(self._envs.values())).action_space

        def reset(self, *, seed=None):
            obs, infos = {}, {}
            for i, (aid, env) in enumerate(self._envs.items()):
                # Large per-agent stride so (env seed + agent index) never
                # collides with a sibling env's agents.
                o, info = env.reset(seed=None if seed is None else seed + i * 100003)
                obs[aid], infos[aid] = o, info
                self._done[aid] = False
            return obs, infos

        def step(self, action_dict):
            obs, rewards, terms, truncs, infos = {}, {}, {}, {}, {}
            for aid, action in action_dict.items():
                o, r, term, trunc, info = self._envs[aid].step(action)
                info = dict(info)
                if term or trunc:
                    # The terminal observation must survive the auto-reset —
                    # truncated-episode bootstrapping reads it.
                    info["final_observation"] = o
                    o, _ = self._envs[aid].reset()
                obs[aid], rewards[aid] = o, r
                terms[aid], truncs[aid], infos[aid] = term, trunc, info
            terms["__all__"] = False
            truncs["__all__"] = False
            return obs, rewards, terms, truncs, infos

        def close(self):
            for env in self._envs.values():
                try:
                    env.close()
                except Exception:
                    pass

    return _IndependentCopies
