"""SampleBatch — columnar rollout data.

Reference: rllib/policy/sample_batch.py:96 (SampleBatch) — a dict of
parallel numpy arrays with concat/shuffle/slice/minibatch utilities. Kept
numpy-first: batches convert to device arrays only at the learner edge.
"""

from __future__ import annotations

from typing import Dict, Iterator, List

import numpy as np

OBS = "obs"
ACTIONS = "actions"
REWARDS = "rewards"
DONES = "dones"
NEXT_OBS = "next_obs"
LOGPS = "action_logp"
VF_PREDS = "vf_preds"
ADVANTAGES = "advantages"
VALUE_TARGETS = "value_targets"
EPS_ID = "eps_id"
NEXT_VF_PREDS = "next_vf_preds"
FRAG_CUT = "frag_cut"  # 1 on the last row of a rollout fragment


class SampleBatch(dict):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        for k, v in list(self.items()):
            if not isinstance(v, np.ndarray):
                self[k] = np.asarray(v)

    @property
    def count(self) -> int:
        for v in self.values():
            return len(v)
        return 0

    def __len__(self) -> int:  # len(batch) == row count, like the reference
        return self.count

    @staticmethod
    def concat_samples(batches: List["SampleBatch"]) -> "SampleBatch":
        batches = [b for b in batches if b.count > 0]
        if not batches:
            return SampleBatch()
        keys = batches[0].keys()
        return SampleBatch({k: np.concatenate([b[k] for b in batches]) for k in keys})

    def shuffle(self, seed=None) -> "SampleBatch":
        rng = np.random.default_rng(seed)
        idx = rng.permutation(self.count)
        return SampleBatch({k: v[idx] for k, v in self.items()})

    def slice(self, start: int, end: int) -> "SampleBatch":
        return SampleBatch({k: v[start:end] for k, v in self.items()})

    def minibatches(self, minibatch_size: int, shuffle: bool = True, seed=None) -> Iterator["SampleBatch"]:
        b = self.shuffle(seed) if shuffle else self
        for start in range(0, b.count, minibatch_size):
            mb = b.slice(start, min(start + minibatch_size, b.count))
            if mb.count == minibatch_size:
                yield mb

    def split_by_episode(self) -> List["SampleBatch"]:
        if EPS_ID not in self:
            return [self]
        out = []
        ids = self[EPS_ID]
        start = 0
        for i in range(1, len(ids) + 1):
            if i == len(ids) or ids[i] != ids[start]:
                out.append(self.slice(start, i))
                start = i
        return out


def compute_gae(
    batch: SampleBatch,
    last_value: float,
    gamma: float = 0.99,
    lambda_: float = 0.95,
) -> SampleBatch:
    """Generalized advantage estimation over one rollout fragment
    (reference: rllib/evaluation/postprocessing.py compute_advantages)."""
    rewards = batch[REWARDS].astype(np.float32)
    dones = batch[DONES].astype(np.float32)
    values = batch[VF_PREDS].astype(np.float32)
    n = len(rewards)
    adv = np.zeros(n, dtype=np.float32)
    next_value = float(last_value)
    gae = 0.0
    for t in range(n - 1, -1, -1):
        nonterminal = 1.0 - dones[t]
        delta = rewards[t] + gamma * next_value * nonterminal - values[t]
        gae = delta + gamma * lambda_ * nonterminal * gae
        adv[t] = gae
        next_value = values[t]
    batch[ADVANTAGES] = adv
    batch[VALUE_TARGETS] = adv + values
    # Bootstrap values for V-trace-style off-policy corrections (IMPALA):
    # next state's value within the fragment, last_value at the cut, 0 at
    # episode ends.
    next_vf = np.empty(n, dtype=np.float32)
    cuts = np.zeros(n, dtype=np.float32)
    if n:
        next_vf[:-1] = values[1:]
        next_vf[-1] = float(last_value)
        next_vf *= 1.0 - dones
        cuts[-1] = 1.0
    batch[NEXT_VF_PREDS] = next_vf
    batch[FRAG_CUT] = cuts
    return batch


class MultiAgentBatch:
    """Minimal multi-agent container (reference: sample_batch.py:1221)."""

    def __init__(self, policy_batches: Dict[str, SampleBatch]):
        self.policy_batches = policy_batches

    @property
    def count(self) -> int:
        return sum(b.count for b in self.policy_batches.values())
