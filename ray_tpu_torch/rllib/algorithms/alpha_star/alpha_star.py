"""AlphaStar — league-based self-play training.

Reference: rllib/algorithms/alpha_star/ (alpha_star.py, league_builder.py;
Vinyals et al. 2019): a LEAGUE of policies trains concurrently —
* the MAIN agent, trained with prioritized fictitious self-play (PFSP)
  against frozen league snapshots (hard opponents weighted up) mixed with
  self-play against its live self;
* MAIN EXPLOITERS, trained only against the live main agent to find its
  weaknesses;
* LEAGUE EXPLOITERS, trained PFSP against the whole league;
and the main agent is periodically FROZEN into the league as a new
snapshot (league_builder.py AlphaStarLeagueBuilder: the same three slot
kinds, snapshot-on-winrate). Win-rates drive both matchmaking and
snapshotting.

This is the league ARCHITECTURE on simultaneous-move zero-sum envs
(env/two_player.py protocol); the reference binds the same machinery to
StarCraft II. Policy updates are A2C steps on the learner side of each match
(a global-norm clip and Adam through each slot's own ``OptaxChain``, in full
f32); opponents act frozen. Scripted opponents can be seeded into the league
(tests anchor on exploiting a biased rock-paper-scissors player).

Every slot is an ``RLModule`` on the config's device (the card unless it asks
for the CPU), drawn by the port from ``seed + i`` (``rl_module_params_from_jax``
carries the reference's across); a snapshot is a frozen copy on the device.
Acting is one forward and one read a step. The action draws are Gumbel
noise from a ``torch.Generator`` seeded ``seed + 99`` on the device
(``_draw_gumbel``; the reference draws ``jax.random.categorical`` from
``PRNGKey(seed + 99)``, which is the argmax of the logits plus Gumbel noise,
so a test can hand the reference's draws in). Matchmaking is numpy,
``default_rng(seed)`` as in the reference. The action space is checked by
what it reads like (``n`` and no bounds), so no gymnasium is needed.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.core.learner import OptaxChain, full_f32, global_norm
from ray_tpu_torch.rllib.core.rl_module import RLModule, _device, _is_discrete, tree_leaves
from ray_tpu_torch.rllib.policy.sample_batch import (
    ACTIONS,
    ADVANTAGES,
    DONES,
    LOGPS,
    OBS,
    REWARDS,
    VALUE_TARGETS,
    VF_PREDS,
    SampleBatch,
    compute_gae,
)


class _LeagueMember:
    """One frozen league entry: a parameter snapshot or a scripted actor."""

    def __init__(self, name: str, params=None, scripted: Optional[Callable] = None):
        self.name = name
        self.params = params  # a frozen RLModule on the device
        self.scripted = scripted
        # Per-learner win-rate bookkeeping: learner name -> [wins, games].
        self.results: Dict[str, List[float]] = {}

    def record(self, learner: str, win: float):
        w, g = self.results.get(learner, [0.0, 0.0])
        self.results[learner] = [w + win, g + 1.0]

    def winrate_of(self, learner: str) -> float:
        w, g = self.results.get(learner, [0.0, 0.0])
        return w / g if g else 0.5


def a2c_loss(module: RLModule, batch: dict, vf_coeff: float, ent_coeff: float):
    """(total loss, metrics) of the league's A2C step: advantages normalised
    by their mean and population std, the value's squared error, an entropy
    bonus. ``policy_terms`` is the mean magnitude of the policy loss's terms,
    the scale to hold that loss against: its terms cancel, the advantages
    having mean 0."""
    logp, entropy, value = module.action_logp_and_entropy(batch[OBS], batch[ACTIONS])
    adv = batch[ADVANTAGES]
    adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
    terms = logp * adv
    pl = -terms.mean()
    vl = ((value - batch[VALUE_TARGETS]) ** 2).mean()
    ent = entropy.mean()
    total = pl + vf_coeff * vl - ent_coeff * ent
    return total, {"total_loss": total, "policy_loss": pl, "vf_loss": vl, "entropy": ent,
                   "policy_terms": terms.detach().abs().mean()}


class AlphaStarConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or AlphaStar)
        self.lr = 5e-3
        self.entropy_coeff = 0.01
        self.vf_loss_coeff = 0.5
        self.grad_clip = 1.0
        self.num_main_exploiters = 1
        self.num_league_exploiters = 1
        self.episodes_per_slot = 8
        # Main-agent matchmaking mix (reference league_builder defaults:
        # 35% self-play / PFSP for the rest; we fold old-main PFSP in).
        self.self_play_fraction = 0.35
        self.snapshot_interval = 10       # iterations between league freezes
        self.snapshot_min_winrate = 0.6   # freeze only a main that's winning
        self.pfsp_power = 2.0             # (1 - winrate)^power weighting
        # Scripted league seeds: list of (name, callable(obs)->action).
        self.scripted_league_seeds: list = []

    def training(self, *, entropy_coeff=None, vf_loss_coeff=None,
                 num_main_exploiters=None, num_league_exploiters=None,
                 episodes_per_slot=None, self_play_fraction=None,
                 snapshot_interval=None, snapshot_min_winrate=None,
                 pfsp_power=None, scripted_league_seeds=None, **kwargs) -> "AlphaStarConfig":
        super().training(**kwargs)
        for name, val in (
            ("entropy_coeff", entropy_coeff),
            ("vf_loss_coeff", vf_loss_coeff),
            ("num_main_exploiters", num_main_exploiters),
            ("num_league_exploiters", num_league_exploiters),
            ("episodes_per_slot", episodes_per_slot),
            ("self_play_fraction", self_play_fraction),
            ("snapshot_interval", snapshot_interval),
            ("snapshot_min_winrate", snapshot_min_winrate),
            ("pfsp_power", pfsp_power),
            ("scripted_league_seeds", scripted_league_seeds),
        ):
            if val is not None:
                setattr(self, name, val)
        return self


class AlphaStar(Algorithm):
    @classmethod
    def get_default_config(cls) -> AlphaStarConfig:
        return AlphaStarConfig(cls)

    def setup(self, config: dict) -> None:
        cfg: AlphaStarConfig = self._algo_config
        self.device = _device(cfg.device)  # no card and no device="cpu": raise before the env
        self.cleanup()
        self.env = cfg.env(dict(cfg.env_config)) if callable(cfg.env) else cfg.env
        assert hasattr(self.env, "step") and hasattr(self.env, "reset"), "two-player env required"
        if not _is_discrete(self.env.action_space):
            raise ValueError(
                "AlphaStar league (this build) supports discrete simultaneous-move envs: the action space "
                f"must read like a Discrete (n, no bounds), not {self.env.action_space!r}"
            )
        from ray_tpu_torch.rllib.models import ModelCatalog

        self.module_spec = ModelCatalog.get_model_spec(
            self.env.observation_space, self.env.action_space, cfg.model_config()
        )
        # Learning slots: main + exploiters, each with its own optimizer.
        self.slots: Dict[str, dict] = {}
        names = (
            ["main"]
            + [f"main_exploiter_{i}" for i in range(cfg.num_main_exploiters)]
            + [f"league_exploiter_{i}" for i in range(cfg.num_league_exploiters)]
        )
        for i, name in enumerate(names):
            module = RLModule(self.module_spec, seed=cfg.seed + i, device=self.device)
            opt = OptaxChain(tree_leaves(module.param_tree()), cfg.lr, grad_clip=cfg.grad_clip or 1e9)
            self.slots[name] = {"params": module, "opt": opt}
        # League of frozen members; scripted seeds join immediately.
        self.league: List[_LeagueMember] = [
            _LeagueMember(name, scripted=fn) for name, fn in cfg.scripted_league_seeds
        ]
        self._snapshots = 0
        self._gen = torch.Generator(device=self.device).manual_seed(cfg.seed + 99)
        self._np_rng = np.random.default_rng(cfg.seed)
        self._timesteps_total = 0
        self._episode_reward_window: list = []
        self._iter = 0

    # -- the device work ----------------------------------------------------
    def _draw_gumbel(self) -> torch.Tensor:
        """One action draw's Gumbel noise, ``[1, n_actions]`` on the device."""
        e = torch.empty((1, self.module_spec.action_dim), device=self.device).exponential_(generator=self._gen)
        return -torch.log(e)

    @torch.inference_mode()
    def _sample(self, module: RLModule, obs) -> tuple:
        """(action, logp, value) of one observation: the argmax of the logits
        plus a Gumbel draw (``jax.random.categorical``), one forward on the
        device and one read."""
        x = torch.from_numpy(np.asarray(obs, np.float32)[None]).to(self.device)
        with full_f32(self.device):
            logits, value = module(x)
            logp_all = torch.log_softmax(logits, dim=-1)
            a = torch.argmax(logits + self._draw_gumbel(), dim=-1)
            out = torch.stack([a[0].to(logits.dtype), logp_all[0, a[0]], value[0]]).cpu().numpy()
        return int(out[0]), np.float32(out[1]), np.float32(out[2])

    def a2c_loss_and_grads(self, slot_name: str, batch: dict):
        """(metrics, gradients in the slot's ``opt.params`` order, their global
        norm) of one A2C step's batch (host columns), on the device in full
        f32."""
        from ray_tpu_torch.rllib.core.learner import to_device

        cfg: AlphaStarConfig = self._algo_config
        module = self.slots[slot_name]["params"]
        tb = to_device(batch, self.device)
        with full_f32(self.device):
            total, aux = a2c_loss(module, tb, cfg.vf_loss_coeff, cfg.entropy_coeff)
            grads = torch.autograd.grad(total, self.slots[slot_name]["opt"].params)
            g_norm = global_norm(grads)
        return {k: v.detach() for k, v in aux.items()}, grads, g_norm

    def a2c_step(self, slot_name: str, batch: dict) -> dict:
        """One A2C step of a slot (the reference's jitted ``a2c_step``): the
        loss and its gradients, the clip and Adam. Returns the metrics as
        tensors on the device."""
        aux, grads, g_norm = self.a2c_loss_and_grads(slot_name, batch)
        self.slots[slot_name]["opt"].step(grads, g_norm)
        return aux

    # -- matchmaking (reference: league_builder PFSP) ----------------------
    def _pfsp_pick(self, learner: str, candidates: List[_LeagueMember]) -> _LeagueMember:
        cfg: AlphaStarConfig = self._algo_config
        if not candidates:
            return None
        # Hard opponents (low learner win-rate) weighted up.
        w = np.array([
            (1.0 - m.winrate_of(learner)) ** cfg.pfsp_power + 1e-3 for m in candidates
        ])
        return candidates[self._np_rng.choice(len(candidates), p=w / w.sum())]

    def _choose_opponent(self, slot_name: str):
        """Returns (kind, member_or_params): per-slot matchmaking rules."""
        cfg: AlphaStarConfig = self._algo_config
        if slot_name.startswith("main_exploiter"):
            return "live_main", None
        if slot_name.startswith("league_exploiter"):
            m = self._pfsp_pick(slot_name, self.league)
            return ("league", m) if m is not None else ("live_main", None)
        # Main agent: self-play fraction vs live self, else PFSP league.
        if not self.league or self._np_rng.random() < cfg.self_play_fraction:
            return "self", None
        return "league", self._pfsp_pick(slot_name, self.league)

    # -- match execution ---------------------------------------------------
    def _opponent_actor(self, kind, member):
        if kind in ("self", "live_main"):
            module = self.slots["main"]["params"]
        elif member.scripted is not None:
            fn = member.scripted
            return lambda obs: int(fn(obs))
        else:
            module = member.params

        def act(obs):
            return self._sample(module, obs)[0]

        return act

    def _play_episode(self, learner_module, opponent_act):
        """One episode; returns (learner fragment cols, learner return)."""
        obs_a, obs_b = self.env.reset()
        cols = {k: [] for k in (OBS, ACTIONS, REWARDS, DONES, LOGPS, VF_PREDS)}
        total = 0.0
        while True:
            o = np.asarray(obs_a, np.float32)
            act_a, logp, v = self._sample(learner_module, o)
            act_b = opponent_act(np.asarray(obs_b, np.float32))
            obs_a, obs_b, r_a, _, done = self.env.step(act_a, act_b)
            total += r_a
            cols[OBS].append(o)
            cols[ACTIONS].append(np.int32(act_a))
            cols[REWARDS].append(np.float32(r_a))
            cols[DONES].append(np.float32(done))
            cols[LOGPS].append(logp)
            cols[VF_PREDS].append(v)
            self._timesteps_total += 1
            if done:
                break
        frag = SampleBatch({k: np.stack(v) for k, v in cols.items()})
        cfg = self._algo_config
        frag = compute_gae(frag, 0.0, cfg.gamma, cfg.lambda_)
        return frag, total

    def training_step(self) -> dict:
        cfg: AlphaStarConfig = self._algo_config
        self._iter += 1
        metrics: dict = {}
        losses = {}
        for name, slot in self.slots.items():
            frags, wins, games = [], 0.0, 0
            for _ in range(cfg.episodes_per_slot):
                kind, member = self._choose_opponent(name)
                opponent = self._opponent_actor(kind, member)
                frag, ret = self._play_episode(slot["params"], opponent)
                frags.append(frag)
                win = 1.0 if ret > 0 else (0.5 if ret == 0 else 0.0)
                wins += win
                games += 1
                if kind == "league" and member is not None:
                    member.record(name, win)
                if name == "main":
                    self._episode_reward_window.append(ret)
            batch = SampleBatch.concat_samples(frags)
            losses[name] = self.a2c_step(name, dict(batch))["total_loss"]
            metrics[f"{name}/winrate"] = wins / max(games, 1)
        # ONE device sync per iteration for every slot's loss.
        for name, loss in zip(losses, torch.stack(list(losses.values())).cpu().tolist()):
            metrics[f"{name}/loss"] = loss
        # League building: freeze a winning main (reference: snapshot when
        # the main agent's league win-rate clears the bar).
        if (
            self._iter % cfg.snapshot_interval == 0
            and metrics.get("main/winrate", 0.0) >= cfg.snapshot_min_winrate
        ):
            self._freeze("main")
        self._episode_reward_window = self._episode_reward_window[-100:]
        metrics["league_size"] = len(self.league)
        return metrics

    def _frozen_copy(self, params) -> RLModule:
        """A frozen RLModule on the device holding a copy of ``params`` (a
        module, or a params tree in the reference's layout)."""
        tree = params.param_tree() if isinstance(params, RLModule) else params
        return RLModule(self.module_spec, device=self.device).requires_grad_(False).load_params(tree)

    def _freeze(self, slot_name: str):
        self._snapshots += 1
        self.league.append(
            _LeagueMember(
                f"{slot_name}_snap_{self._snapshots}",
                params=self._frozen_copy(self.slots[slot_name]["params"]),
            )
        )

    def winrate_vs(self, member_name: str, learner: str = "main",
                   episodes: int = 20) -> float:
        """Evaluation probe: fresh matches of `learner` against a named
        league member (bypasses the PFSP bookkeeping)."""
        member = next(m for m in self.league if m.name == member_name)
        opponent = self._opponent_actor("league", member)
        wins = 0.0
        for _ in range(episodes):
            _, ret = self._play_episode(self.slots[learner]["params"], opponent)
            wins += 1.0 if ret > 0 else (0.5 if ret == 0 else 0.0)
        return wins / episodes

    def step(self) -> dict:
        t0 = time.time()
        result = self.training_step()
        result["episode_reward_mean"] = (
            float(np.mean(self._episode_reward_window))
            if self._episode_reward_window
            else float("nan")
        )
        result["timesteps_total"] = self._timesteps_total
        result["time_this_iter_s"] = time.time() - t0
        return result

    def compute_single_action(self, obs, explore: bool = False):
        module = self.slots["main"]["params"]
        x = torch.from_numpy(np.asarray(obs, np.float32)[None]).to(self.device)
        with torch.no_grad(), full_f32(self.device):
            actions, _, _ = module.sample_actions(x, torch.Generator(device=self.device).manual_seed(0), explore)
        return int(actions[0].cpu())

    def save_checkpoint(self):
        from ray_tpu_torch.air.checkpoint import Checkpoint

        return Checkpoint.from_dict({
            "slots": {n: s["params"].get_params() for n, s in self.slots.items()},
            "opt_state": {n: s["opt"].state_dict() for n, s in self.slots.items()},
            "league": [
                (m.name, m.params.get_params())
                for m in self.league
                if m.params is not None
            ],
            "rng": self._gen.get_state().cpu().numpy().copy(),
            "timesteps": self._timesteps_total,
        })

    def load_checkpoint(self, checkpoint) -> None:
        data = checkpoint.to_dict()
        for n, w in data["slots"].items():
            if n in self.slots:
                self.slots[n]["params"].load_params(w)
        for n, state in data.get("opt_state", {}).items():
            if n in self.slots:
                self.slots[n]["opt"].load_state_dict(state)
        # Scripted seeds persist via config; param snapshots reload here.
        self.league = [m for m in self.league if m.scripted is not None] + [
            _LeagueMember(name, params=self._frozen_copy(w))
            for name, w in data.get("league", [])
        ]
        if "rng" in data:
            self._gen.set_state(torch.from_numpy(np.array(data["rng"], np.uint8)))
        self._timesteps_total = data.get("timesteps", 0)

    def cleanup(self) -> None:
        env = getattr(self, "env", None)
        if env is not None:
            try:
                env.close()
            except Exception:
                pass
            self.env = None
        eval_ws = getattr(self, "_eval_workers", None)
        if eval_ws is not None:
            eval_ws.stop()
            self._eval_workers = None
