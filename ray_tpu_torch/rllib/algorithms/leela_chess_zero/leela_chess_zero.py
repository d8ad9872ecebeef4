"""LeelaChessZero — two-player zero-sum AlphaZero with the Lc0 network heads.

Reference: rllib/algorithms/leela_chess_zero/ (leela_chess_zero.py,
lc0_mcts.py, lc0_model.py): AlphaZero-style self-play for alternating-move
zero-sum board games, with the Lc0 network additions over plain AlphaZero —
a POLICY head masked to legal moves, a VALUE head (tanh, mover's
perspective), and a MOVES-LEFT head (Lc0's MLH, regressing remaining game
length; used as a training auxiliary that sharpens endgame play). The
reference binds it to chess through python-chess; here the algorithm runs
on any env/board_env.BoardGameEnv (TicTacToe in-tree — the image carries
no chess move-generator), which is the same separation the reference draws
between algorithm and MultiAgentEnv board wrapper.

Differences from the in-tree single-player AlphaZero (alpha_zero/):
* search values SIGN-FLIP between plies (zero-sum, alternating moves);
* no ranked-rewards transform — outcomes are already ±1/0;
* legal-action masks gate both the network policy and the search;
* the extra moves-left head, trained on |remaining plies|.

The network's forward (``predict``: one forward and one read of the
probabilities and the value together) and its update (Adam through
``OptaxChain``, full f32) run on the config's device, the card unless it asks
for the CPU; the search and the replay are numpy on the host, step for step
the JAX package's. ``lc0_forward`` keeps the reference's forms: the mask is
``where(legal, logits, -1e9)`` (a 0 target times a finite logp in the policy
loss), the moves-left head is ``logaddexp(x, 0)`` (``jax.nn.softplus``;
torch's ``softplus`` turns linear above 20), the value head ``tanh``. The
initial weights are drawn as the reference draws them (``normal *
sqrt(2 / fan_in)`` for the torso, ``normal / sqrt(hidden)`` for the heads,
zero biases) but from a CPU ``torch.Generator``; ``lc0_params_from_jax``
carries the reference's across.
"""

from __future__ import annotations

import math
import time
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.algorithms.off_policy import floats
from ray_tpu_torch.rllib.core.learner import OptaxChain, full_f32
from ray_tpu_torch.rllib.core.rl_module import _device, copy_into, host_tree, tree_leaves, tree_map


# ---------------------------------------------------------------------------
# Lc0-style network: shared torso, policy/value/moves-left heads.
# ---------------------------------------------------------------------------

def init_lc0_params(gen: torch.Generator, obs_dim: int, n_actions: int, hiddens):
    """The reference's layout (``torso``: a list of ``{"w", "b"}``;
    ``policy``, ``value``, ``mlh``), drawn from the CPU generator ``gen``."""
    dims = (obs_dim,) + tuple(hiddens)
    torso = [
        {"w": torch.randn(din, dout, generator=gen) * (2.0 / din) ** 0.5, "b": torch.zeros(dout)}
        for din, dout in zip(dims[:-1], dims[1:])
    ]
    h = dims[-1]
    s = h**-0.5

    def head(dout):
        return {"w": torch.randn(h, dout, generator=gen) * s, "b": torch.zeros(dout)}

    return {"torso": torso, "policy": head(n_actions), "value": head(1), "mlh": head(1)}


def lc0_params_from_jax(params: dict, *, device="cuda") -> dict:
    """The JAX package's Lc0 params (numpy leaves, as
    ``jax.tree_util.tree_map(np.asarray, ...)`` gives them) as f32 tensors on
    ``device``: the layouts agree (``w`` is ``[din, dout]``), the leaves copy
    as they are."""
    dev = _device(device)
    return tree_map(lambda a: torch.tensor(np.asarray(a), dtype=torch.float32, device=dev), params)


def lc0_forward(params, obs, legal_mask):
    """Returns (masked log-policy, value in [-1,1], moves_left >= 0)."""
    x = obs
    for layer in params["torso"]:
        x = torch.tanh(x @ layer["w"] + layer["b"])
    logits = x @ params["policy"]["w"] + params["policy"]["b"]
    logits = torch.where(legal_mask, logits, torch.full((), -1e9, dtype=logits.dtype, device=logits.device))
    logp = F.log_softmax(logits, dim=-1)
    value = torch.tanh(x @ params["value"]["w"] + params["value"]["b"])[..., 0]
    ml = x @ params["mlh"]["w"] + params["mlh"]["b"]
    moves_left = torch.logaddexp(ml, torch.zeros_like(ml))[..., 0]
    return logp, value, moves_left


def rows_to_batch(rows: list) -> dict:
    """Replay rows ``(obs, legal, pi, z, moves_left)`` as an update's batch
    of stacked host columns."""
    return {k: np.stack([row[j] for row in rows]) for j, k in enumerate(("obs", "legal", "pi", "z", "ml"))}


def lc0_loss(params, obs, legal, target_pi, target_v, target_ml, mlh_coeff: float):
    """(total loss, metrics) of one batch: the policy's cross-entropy to the
    search's visits, the value's and the moves-left head's squared errors."""
    logp, v, ml = lc0_forward(params, obs, legal)
    pi_loss = -(target_pi * logp).sum(-1).mean()
    v_loss = ((v - target_v) ** 2).mean()
    ml_loss = ((ml - target_ml) ** 2).mean()
    total = pi_loss + v_loss + mlh_coeff * ml_loss
    return total, {"total_loss": total, "policy_loss": pi_loss, "value_loss": v_loss, "moves_left_loss": ml_loss}


# ---------------------------------------------------------------------------
# Zero-sum PUCT search (lc0_mcts.py analog).
# ---------------------------------------------------------------------------

class _Node:
    __slots__ = ("state", "obs", "legal", "done", "reward", "children", "N", "W", "P")

    def __init__(self, state, obs, legal, done, reward):
        self.state = state
        self.obs = obs
        self.legal = legal
        self.done = done
        self.reward = reward  # terminal reward to the player who JUST moved
        self.children = {}
        n = len(legal)
        self.N = np.zeros(n, np.float32)
        self.W = np.zeros(n, np.float32)
        self.P = np.zeros(n, np.float32)


class ZeroSumMCTS:
    """PUCT over a cloneable BoardGameEnv; values flip sign per ply."""

    def __init__(self, env, predict, *, num_sims=50, c_puct=1.5,
                 dirichlet_alpha=0.6, dirichlet_eps=0.25, rng=None):
        self.env = env
        self.predict = predict  # obs, legal -> (prior probs, value)
        self.num_sims = num_sims
        self.c_puct = c_puct
        self.alpha = dirichlet_alpha
        self.eps = dirichlet_eps
        self.rng = rng or np.random.default_rng()

    def search(self, temperature: float = 1.0):
        root_state = self.env.get_state()
        root_obs = self.env.observe()
        root = _Node(root_state, root_obs, self.env.legal_actions(), False, 0.0)
        priors, _ = self.predict(root_obs, root.legal)
        noise = self.rng.dirichlet([self.alpha] * int(root.legal.sum()))
        p = priors.copy()
        p[root.legal] = (1 - self.eps) * p[root.legal] + self.eps * noise
        root.P = p

        for _ in range(self.num_sims):
            node = root
            path = []
            self.env.set_state(node.state)
            # -- selection --
            while True:
                if node.done:
                    value = 0.0 if node.reward == 0 else -node.reward
                    # value is from the perspective of the player to move at
                    # `node` (who just lost if reward=1 for the mover).
                    break
                a = self._select(node)
                path.append((node, a))
                if a not in node.children:
                    # -- expansion --
                    self.env.set_state(node.state)
                    obs, reward, done = self.env.step(a)
                    child = _Node(
                        self.env.get_state(), obs,
                        self.env.legal_actions() if not done else np.zeros_like(node.legal),
                        done, reward,
                    )
                    node.children[a] = child
                    if done:
                        value = 0.0 if reward == 0 else -reward
                    else:
                        probs, v = self.predict(obs, child.legal)
                        child.P = probs
                        value = v
                    node = child
                    break
                node = node.children[a]

            # -- backup with sign flip per ply --
            for parent, a in reversed(path):
                value = -value  # child's perspective -> parent's
                parent.N[a] += 1.0
                parent.W[a] += value

        visits = root.N
        if temperature <= 1e-6:
            pi = np.zeros_like(visits)
            pi[visits.argmax()] = 1.0
        else:
            v = visits ** (1.0 / temperature)
            pi = v / v.sum() if v.sum() > 0 else root.legal / root.legal.sum()
        self.env.set_state(root_state)
        q_root = float((root.W.sum() / max(root.N.sum(), 1.0)))
        return pi, q_root

    def _select(self, node: _Node) -> int:
        total = node.N.sum()
        q = np.where(node.N > 0, node.W / np.maximum(node.N, 1), 0.0)
        u = self.c_puct * node.P * math.sqrt(total + 1.0) / (1.0 + node.N)
        score = np.where(node.legal, q + u, -np.inf)
        return int(score.argmax())


class LeelaChessZeroConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or LeelaChessZero)
        self.lr = 2e-3
        self.num_sims = 60
        self.c_puct = 1.5
        self.dirichlet_alpha = 0.6
        self.dirichlet_eps = 0.25
        self.games_per_iter = 12
        self.temperature_moves = 4   # sample by visits for the first k plies
        self.train_batch_size = 256
        self.sgd_iters = 4
        self.replay_games = 400
        self.mlh_loss_coeff = 0.1
        self.model_hiddens = (128, 128)

    def training(self, *, num_sims=None, c_puct=None, dirichlet_alpha=None,
                 dirichlet_eps=None, games_per_iter=None, temperature_moves=None,
                 sgd_iters=None, replay_games=None, mlh_loss_coeff=None, **kwargs):
        super().training(**kwargs)
        for name, val in (
            ("num_sims", num_sims), ("c_puct", c_puct),
            ("dirichlet_alpha", dirichlet_alpha), ("dirichlet_eps", dirichlet_eps),
            ("games_per_iter", games_per_iter), ("temperature_moves", temperature_moves),
            ("sgd_iters", sgd_iters), ("replay_games", replay_games),
            ("mlh_loss_coeff", mlh_loss_coeff),
        ):
            if val is not None:
                setattr(self, name, val)
        return self


class LeelaChessZero(Algorithm):
    @classmethod
    def get_default_config(cls) -> LeelaChessZeroConfig:
        return LeelaChessZeroConfig(cls)

    def setup(self, config: dict) -> None:
        cfg: LeelaChessZeroConfig = self._algo_config
        self.device = _device(cfg.device)  # no card and no device="cpu": raise before the env
        self.cleanup()
        self.env = cfg.env(dict(cfg.env_config)) if callable(cfg.env) else cfg.env
        assert hasattr(self.env, "legal_actions") and hasattr(self.env, "get_state"), (
            "LeelaChessZero needs a BoardGameEnv (legal_actions/get_state/set_state)"
        )
        self.obs_dim = int(np.prod(self.env.observation_space.shape))
        self.n_actions = int(self.env.action_space.n)
        init = init_lc0_params(torch.Generator().manual_seed(int(cfg.seed)), self.obs_dim, self.n_actions,
                               cfg.model_hiddens)
        self.params = tree_map(lambda t: t.to(self.device).requires_grad_(True), init)
        self.opt = OptaxChain(tree_leaves(self.params), cfg.lr)
        self._np_rng = np.random.default_rng(cfg.seed)
        # Replay of recent self-play positions (obs, legal, pi, z, ml).
        self._replay: list = []
        self._timesteps_total = 0
        self._episode_reward_window: list = []

    @torch.inference_mode()
    def _predict(self, obs, legal):
        """(probabilities, value) of one position: one forward on the device
        and one read of both."""
        x = torch.from_numpy(np.asarray(obs, np.float32)[None]).to(self.device)
        m = torch.from_numpy(np.asarray(legal, bool)[None]).to(self.device)
        with full_f32(self.device):
            logp, v, _ = lc0_forward(self.params, x, m)
            out = torch.cat([torch.exp(logp[0]), v]).cpu().numpy()
        return out[:-1], float(out[-1])

    def loss_and_grads(self, batch: dict):
        """(metrics, gradients in ``opt.params``' order) of one update's batch
        (``obs``, ``legal``, ``pi``, ``z``, ``ml``), on the device in full
        f32."""
        tb = {k: torch.as_tensor(np.asarray(v), device=self.device) for k, v in batch.items()}
        with full_f32(self.device):
            total, aux = lc0_loss(self.params, tb["obs"], tb["legal"], tb["pi"], tb["z"], tb["ml"],
                                  self._algo_config.mlh_loss_coeff)
            grads = torch.autograd.grad(total, self.opt.params)
        return {k: v.detach() for k, v in aux.items()}, grads

    def update(self, batch: dict) -> dict:
        """One update (the reference's jitted ``update``). Returns the metrics
        as tensors on the device."""
        aux, grads = self.loss_and_grads(batch)
        self.opt.step(grads)
        return aux

    def _mcts(self) -> ZeroSumMCTS:
        cfg = self._algo_config
        return ZeroSumMCTS(
            self.env, self._predict, num_sims=cfg.num_sims, c_puct=cfg.c_puct,
            dirichlet_alpha=cfg.dirichlet_alpha, dirichlet_eps=cfg.dirichlet_eps,
            rng=self._np_rng,
        )

    def _self_play_game(self):
        """One self-play game; returns per-position training rows."""
        cfg: LeelaChessZeroConfig = self._algo_config
        obs = self.env.reset()
        mcts = self._mcts()
        rows = []  # (obs, legal, pi, player_sign)
        outcome = 0.0  # from player +1 (first mover) perspective
        sign = 1.0
        ply = 0
        while True:
            legal = self.env.legal_actions()
            temp = 1.0 if ply < cfg.temperature_moves else 1e-7
            pi, _ = mcts.search(temperature=temp)
            rows.append((np.asarray(obs, np.float32), legal.copy(), pi, sign, ply))
            a = int(self._np_rng.choice(self.n_actions, p=pi / pi.sum()))
            obs, reward, done = self.env.step(a)
            self._timesteps_total += 1
            ply += 1
            if done:
                outcome = reward * sign  # mover's reward -> first-mover frame
                break
            sign = -sign
        total_plies = ply
        out = []
        for o, legal, pi, s, p_idx in rows:
            # z from THIS position's player-to-move perspective.
            z = outcome * s
            moves_left = float(total_plies - p_idx)
            out.append((o, legal, pi.astype(np.float32), np.float32(z), np.float32(moves_left)))
        return out, outcome

    def _replay_batch(self, flat: list) -> dict:
        cfg: LeelaChessZeroConfig = self._algo_config
        idx = self._np_rng.choice(len(flat), cfg.train_batch_size, replace=False)
        return rows_to_batch([flat[i] for i in idx])

    def training_step(self) -> dict:
        cfg: LeelaChessZeroConfig = self._algo_config
        first_mover_results = []
        for _ in range(cfg.games_per_iter):
            rows, outcome = self._self_play_game()
            self._replay.append(rows)
            first_mover_results.append(outcome)
        self._replay = self._replay[-cfg.replay_games:]
        flat = [r for game in self._replay for r in game]
        metrics: dict = {}
        if len(flat) >= cfg.train_batch_size:
            for _ in range(cfg.sgd_iters):
                aux = self.update(self._replay_batch(flat))
            metrics = floats(aux)  # ONE device sync per iteration
        self._episode_reward_window += first_mover_results
        self._episode_reward_window = self._episode_reward_window[-100:]
        metrics["replay_positions"] = len(flat)
        # Draw rate is the convergence signal on solved games (perfect
        # tic-tac-toe play is all draws).
        metrics["draw_rate"] = float(np.mean([r == 0.0 for r in first_mover_results]))
        return metrics

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

    def compute_single_action(self, obs=None, explore: bool = False, num_sims: Optional[int] = None):
        """Best move for the env's CURRENT position by fresh search (greedy;
        the board protocol is stateful, so obs is taken from the env)."""
        mcts = self._mcts()
        if num_sims:
            mcts.num_sims = num_sims
        pi, _ = mcts.search(temperature=1e-7)
        return int(pi.argmax())

    def save_checkpoint(self):
        from ray_tpu_torch.air.checkpoint import Checkpoint

        return Checkpoint.from_dict({
            "weights": host_tree(self.params),
            "opt_state": self.opt.state_dict(),
            "timesteps": self._timesteps_total,
        })

    def load_checkpoint(self, checkpoint) -> None:
        data = checkpoint.to_dict()
        copy_into(self.params, data["weights"])
        if "opt_state" in data:
            self.opt.load_state_dict(data["opt_state"])
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
