"""Synthetic slate-recommendation environment (RecSim-style), numpy on the host.

Stands in for the reference's RecSim interest-evolution environment
(rllib/env/wrappers/recsim.py + google/recsim): the real RecSim package is
not in this image, so SlateQ trains and tests against this faithful
miniature:

- USER: a unit-norm interest vector over ``num_topics``, evolving toward
  the topics of clicked documents; a session-length budget ends episodes.
- DOCS: each step presents ``num_candidates`` documents with random topic
  feature vectors (unit-norm) and per-doc quality.
- CHOICE: the user clicks at most one slate item via a conditional
  logistic model over interest-document affinity, with a no-click option.
- REWARD: clicked document's engagement (affinity + quality); clicking
  also evolves the interest state — myopic slates (pure quality) differ
  from long-term-optimal ones, which is exactly the structure SlateQ's
  decomposition exploits.

Observation: concatenation of the interest vector and all candidate
feature rows (reference: RecSim observation dict, flattened). Action: a
slate — ``slate_size`` distinct candidate indices.

The JAX package's ``rllib/env/recsys.py`` as it is, its ``default_rng``
stream included: one seed gives the same episodes in both packages, step for
step.
"""

from __future__ import annotations

import numpy as np


class SlateRecEnv:
    def __init__(self, config: dict | None = None):
        config = dict(config or {})
        self.num_topics = int(config.get("num_topics", 6))
        self.num_candidates = int(config.get("num_candidates", 10))
        self.slate_size = int(config.get("slate_size", 2))
        self.session_budget = int(config.get("session_budget", 40))
        self.no_click_mass = float(config.get("no_click_mass", 1.0))
        self.interest_lr = float(config.get("interest_lr", 0.2))
        self._rng = np.random.default_rng(config.get("seed", 0))
        self.obs_dim = self.num_topics + self.num_candidates * (self.num_topics + 1)

    # gym-ish metadata used by SlateQ's setup
    @property
    def observation_dim(self) -> int:
        return self.obs_dim

    def _sample_docs(self):
        feats = self._rng.normal(size=(self.num_candidates, self.num_topics)).astype(np.float32)
        feats /= np.linalg.norm(feats, axis=1, keepdims=True) + 1e-8
        quality = self._rng.uniform(0.0, 1.0, self.num_candidates).astype(np.float32)
        return feats, quality

    def _obs(self):
        return np.concatenate(
            [self.interest, np.concatenate([self.doc_feats, self.doc_quality[:, None]], 1).ravel()]
        ).astype(np.float32)

    def reset(self, *, seed=None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self.interest = self._rng.normal(size=self.num_topics).astype(np.float32)
        self.interest /= np.linalg.norm(self.interest) + 1e-8
        self.budget = self.session_budget
        self.doc_feats, self.doc_quality = self._sample_docs()
        return self._obs(), {}

    def step(self, slate):
        slate = list(dict.fromkeys(int(i) for i in slate))[: self.slate_size]
        affinity = self.doc_feats[slate] @ self.interest  # [k]
        # Conditional logistic choice with a no-click alternative.
        scores = np.exp(np.concatenate([affinity, [np.log(self.no_click_mass + 1e-8)]]))
        probs = scores / scores.sum()
        choice = self._rng.choice(len(slate) + 1, p=probs)
        reward = 0.0
        clicked = -1
        if choice < len(slate):
            doc = slate[choice]
            clicked = doc
            engagement = float(affinity[choice] + self.doc_quality[doc])
            reward = max(engagement, 0.0)
            # Interest evolves TOWARD the clicked topic mix.
            self.interest = (1 - self.interest_lr) * self.interest + self.interest_lr * self.doc_feats[doc]
            self.interest /= np.linalg.norm(self.interest) + 1e-8
        self.budget -= 1
        done = self.budget <= 0
        self.doc_feats, self.doc_quality = self._sample_docs()
        return self._obs(), reward, done, False, {"clicked": clicked}

    def close(self):
        pass
