"""R2D2 — Recurrent Replay Distributed DQN.

Reference: rllib/algorithms/r2d2/r2d2.py (+ r2d2_torch_policy.py): a
recurrent Q-network trained from a replay buffer of fixed-length
SEQUENCES, each stored with the hidden state the network had when the
sequence began. Training replays a burn-in prefix to refresh the hidden
state (stored states go stale as parameters move), computes double-Q TD
targets only on the post-burn-in steps, and uses the invertible value
rescaling h(x) from the R2D2 paper for reward-scale robustness.

The parameters are a tree of tensors in the JAX package's layout (dense
``w`` [din, dout] applied as ``x @ w``), on the config's device (the card by
default). The recurrent core is the reference's GRU written out in tensor
ops, NOT ``torch.nn.GRU``: the reference applies the reset gate to ``h``
before the candidate's dense over ``[x, r*h]`` (``torch.nn.GRU`` computes
``r * (W_hn h + b_hn)``, another function), with its own three dense layers
over ``[x, h]``. The sequence is unrolled step by step; the TD update (burn-in,
double-Q argmax, rescaled targets, masked Huber loss) runs over a [B, T, ...]
batch in full f32 (``full_f32``). Initialization draws are the port's own
(``r2d2_params_from_jax`` carries the reference's weights across).
"""

from __future__ import annotations

import numpy as np
import torch

from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.core.learner import OptaxChain, full_f32, global_norm
from ray_tpu_torch.rllib.core.rl_module import _device, tree_leaves, tree_map
from ray_tpu_torch.rllib.env.vector_env import VectorEnv

_LAYERS = ("enc", "gru_z", "gru_r", "gru_h", "val", "adv")

# ---------------------------------------------------------------------------
# Recurrent Q-network: encoder MLP -> GRU -> dueling Q head
# ---------------------------------------------------------------------------


def _dense(gen, n_in, n_out):
    scale = np.sqrt(2.0 / (n_in + n_out))
    return {"w": torch.randn(n_in, n_out, generator=gen) * float(scale), "b": torch.zeros(n_out)}


def init_params(seed: int, obs_dim: int, action_dim: int, hidden: int, *, device="cuda") -> dict:
    """The reference's shapes and scales, drawn from a torch generator
    seeded with ``seed`` on the CPU (so the card and the CPU start equal),
    then moved to ``device``."""
    gen = torch.Generator().manual_seed(seed)
    params = {
        "enc": _dense(gen, obs_dim, hidden),
        # GRU: update/reset/candidate gates over [x, h]
        "gru_z": _dense(gen, hidden * 2, hidden),
        "gru_r": _dense(gen, hidden * 2, hidden),
        "gru_h": _dense(gen, hidden * 2, hidden),
        "val": _dense(gen, hidden, 1),
        "adv": _dense(gen, hidden, action_dim),
    }
    return tree_map(lambda t: t.to(_device(device)), params)


def r2d2_params_from_jax(params: dict, *, device="cuda") -> dict:
    """The JAX package's R2D2 params (numpy leaves, as
    ``jax.tree_util.tree_map(np.asarray, params)`` gives them) as the port's
    tree of f32 tensors on ``device``: the layouts agree, leaves copy as they
    are."""
    dev = _device(device)
    return {name: {k: torch.tensor(np.asarray(params[name][k]), dtype=torch.float32, device=dev) for k in ("w", "b")}
            for name in _LAYERS}


def _apply(layer, x):
    return x @ layer["w"] + layer["b"]


def gru_cell(params, h, x):
    hx = torch.cat([x, h], dim=-1)
    z = torch.sigmoid(_apply(params["gru_z"], hx))
    r = torch.sigmoid(_apply(params["gru_r"], hx))
    cand = torch.tanh(_apply(params["gru_h"], torch.cat([x, r * h], dim=-1)))
    return (1.0 - z) * h + z * cand


def q_scan(params, obs_seq, h0):
    """obs_seq [B, T, obs] + h0 [B, H] -> q [B, T, A], h_T [B, H]."""
    x = torch.tanh(_apply(params["enc"], obs_seq))  # [B, T, H]
    h, hs = h0, []
    for t in range(x.shape[1]):
        h = gru_cell(params, h, x[:, t])
        hs.append(h)
    hs = torch.stack(hs, dim=1)  # [B, T, H]
    val = _apply(params["val"], hs)  # [B, T, 1]
    adv = _apply(params["adv"], hs)  # [B, T, A]
    q = val + adv - adv.mean(dim=-1, keepdim=True)  # dueling combine
    return q, h


def h_rescale(x, eps=1e-3):
    return torch.sign(x) * (torch.sqrt(torch.abs(x) + 1.0) - 1.0) + eps * x


def h_inverse(x, eps=1e-3):
    s = torch.sign(x)
    a = torch.abs(x)
    return s * (torch.square((torch.sqrt(1.0 + 4.0 * eps * (a + 1.0 + eps)) - 1.0) / (2.0 * eps)) - 1.0)


def r2d2_loss(params, target_params, batch: dict, gamma: float, burn_in: int, use_h_rescale: bool):
    """(masked Huber TD loss, {"td_abs"}) of a [B, T] sequence batch of
    tensors (``obs``, ``h0``, ``actions``, ``rewards``, ``dones``, ``mask``):
    double-Q over the next in-sequence step, the burn-in prefix masked out."""
    q_all, _ = q_scan(params, batch["obs"], batch["h0"])  # [B, T, A]
    with torch.no_grad():
        qt_all, _ = q_scan(target_params, batch["obs"], batch["h0"])
    acts = batch["actions"].long()  # [B, T]
    q_taken = q_all.gather(-1, acts[..., None])[..., 0]
    # Double-Q over the NEXT in-sequence step.
    best_next = q_all[:, 1:, :].detach().argmax(dim=-1)  # [B, T-1]
    q_next = qt_all[:, 1:, :].gather(-1, best_next[..., None])[..., 0]
    if use_h_rescale:
        q_next = h_inverse(q_next)
    target = batch["rewards"][:, :-1] + gamma * (1.0 - batch["dones"][:, :-1]) * q_next
    if use_h_rescale:
        target = h_rescale(target)
    td = q_taken[:, :-1] - target.detach()
    # Mask: valid steps only, and burn-in excluded from loss (the prefix
    # exists to refresh the hidden state).
    mask = batch["mask"][:, :-1].clone()
    mask[:, :burn_in] = 0.0
    huber = torch.where(torch.abs(td) < 1.0, 0.5 * td * td, torch.abs(td) - 0.5)
    denom = torch.clamp(torch.sum(mask), min=1.0)
    loss = torch.sum(huber * mask) / denom
    return loss, {"td_abs": torch.sum(torch.abs(td) * mask) / denom}


# ---------------------------------------------------------------------------
# Sequence replay buffer (reference: replay stores fixed-length sequences
# with the recurrent state at sequence start)
# ---------------------------------------------------------------------------


class SequenceReplayBuffer:
    def __init__(self, capacity: int, seed: int = 0):
        self.capacity = capacity
        self._items: list = []
        self._pos = 0
        self._rng = np.random.default_rng(seed)

    def add(self, seq: dict):
        if len(self._items) < self.capacity:
            self._items.append(seq)
        else:
            self._items[self._pos] = seq
            self._pos = (self._pos + 1) % self.capacity

    def __len__(self):
        return len(self._items)

    def sample(self, n: int) -> dict:
        idx = self._rng.integers(0, len(self._items), n)
        seqs = [self._items[i] for i in idx]
        return {k: np.stack([s[k] for s in seqs]) for k in seqs[0]}


# ---------------------------------------------------------------------------
# Config / algorithm
# ---------------------------------------------------------------------------


class R2D2Config(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or R2D2)
        self.lr = 1e-3
        self.num_rollout_workers = 0
        self.train_batch_size = 32          # sequences per update
        self.replay_buffer_capacity = 4000  # sequences
        self.learning_starts = 500          # env STEPS buffered before training
        self.target_network_update_freq = 200
        self.rollout_steps_per_iter = 1000
        self.train_intensity = 40           # env steps per update
        self.burn_in = 4
        self.seq_len = 20                   # training steps after burn-in
        self.hidden_size = 64
        self.epsilon_timesteps = 10_000
        self.initial_epsilon = 1.0
        self.final_epsilon = 0.02
        self.use_h_rescale = True

    def training(self, *, replay_buffer_capacity=None, learning_starts=None,
                 target_network_update_freq=None, rollout_steps_per_iter=None,
                 train_intensity=None, burn_in=None, seq_len=None,
                 hidden_size=None, epsilon_timesteps=None, final_epsilon=None,
                 use_h_rescale=None, **kwargs) -> "R2D2Config":
        super().training(**kwargs)
        for name, val in (
            ("replay_buffer_capacity", replay_buffer_capacity),
            ("learning_starts", learning_starts),
            ("target_network_update_freq", target_network_update_freq),
            ("rollout_steps_per_iter", rollout_steps_per_iter),
            ("train_intensity", train_intensity),
            ("burn_in", burn_in),
            ("seq_len", seq_len),
            ("hidden_size", hidden_size),
            ("epsilon_timesteps", epsilon_timesteps),
            ("final_epsilon", final_epsilon),
            ("use_h_rescale", use_h_rescale),
        ):
            if val is not None:
                setattr(self, name, val)
        return self


def _host(tree) -> dict:
    return tree_map(lambda t: t.detach().cpu().numpy().copy(), tree)


class R2D2(Algorithm):
    @classmethod
    def get_default_config(cls) -> R2D2Config:
        return R2D2Config(cls)

    def setup(self, config: dict) -> None:
        cfg: R2D2Config = self._algo_config
        self.device = _device(cfg.device)  # no card and no device="cpu": raise first
        spec = self._spec_from_env(cfg)
        assert spec.discrete, "R2D2 requires a discrete action space"
        self.obs_dim, self.action_dim = spec.obs_dim, spec.action_dim

        self.env = VectorEnv(cfg.env, max(cfg.num_envs_per_worker, 1), cfg.env_config, 0, seed=cfg.seed)
        self.n_envs = max(cfg.num_envs_per_worker, 1)
        self.params = init_params(cfg.seed, self.obs_dim, self.action_dim, cfg.hidden_size, device=self.device)
        for p in tree_leaves(self.params):
            p.requires_grad_(True)
        self.target_params = tree_map(lambda t: t.detach().clone(), self.params)
        # optax.chain(clip_by_global_norm(10), adam(lr)), over the leaves in
        # the tree's order.
        self.opt = OptaxChain(tree_leaves(self.params), cfg.lr, 10.0, "adam")
        self.buffer = SequenceReplayBuffer(cfg.replay_buffer_capacity, seed=cfg.seed)
        self._timesteps_total = 0
        self._updates = 0
        self._episode_reward_window: list = []
        self._rng = np.random.default_rng(cfg.seed)

        # Per-env recurrent state + open sequence builders.
        self._hidden = np.zeros((self.n_envs, cfg.hidden_size), np.float32)
        self._seq_open = [self._new_seq(self._hidden[i]) for i in range(self.n_envs)]
        self._T = cfg.burn_in + cfg.seq_len

    # -- weights ------------------------------------------------------------
    def get_weights(self) -> dict:
        """The online network's weights (a numpy tree, the reference's
        layout)."""
        return _host(self.params)

    @torch.no_grad()
    def set_weights(self, weights: dict) -> None:
        """Copy a params tree (numpy or tensors) into the online network,
        in place (the optimizer keeps its hold on the tensors)."""
        for p, v in zip(tree_leaves(self.params), tree_leaves(weights)):
            p.copy_(v if isinstance(v, torch.Tensor) else torch.from_numpy(np.require(v, np.float32, "W")))

    @torch.no_grad()
    def _act(self, obs: np.ndarray, h: np.ndarray):
        """Greedy actions and the next hidden state of a one-step forward
        from host arrays; the argmax on the device, both back on the host."""
        with full_f32(self.device):
            q, h2 = q_scan(self.params, torch.from_numpy(obs).to(self.device)[:, None, :],
                           torch.from_numpy(np.require(h, np.float32, "W")).to(self.device))
        return q[:, 0, :].argmax(-1).cpu().numpy(), h2.cpu().numpy()

    def _new_seq(self, h0):
        return {"h0": np.array(h0), "obs": [], "actions": [], "rewards": [], "dones": []}

    def _epsilon(self) -> float:
        cfg = self._algo_config
        frac = min(1.0, self._timesteps_total / max(cfg.epsilon_timesteps, 1))
        return cfg.initial_epsilon + frac * (cfg.final_epsilon - cfg.initial_epsilon)

    def _finish_seq(self, i: int):
        """Pad the open sequence to T and push it to replay."""
        seq = self._seq_open[i]
        n = len(seq["obs"])
        if n == 0:
            return
        T = self._T
        pad = T - n
        obs = np.asarray(seq["obs"], np.float32)
        if pad:
            obs = np.concatenate([obs, np.zeros((pad, self.obs_dim), np.float32)])
        item = {
            "h0": seq["h0"],
            "obs": obs,
            "actions": np.pad(np.asarray(seq["actions"], np.int32), (0, pad)),
            "rewards": np.pad(np.asarray(seq["rewards"], np.float32), (0, pad)),
            "dones": np.pad(np.asarray(seq["dones"], np.float32), (0, pad), constant_values=1.0),
            "mask": np.pad(np.ones(n, np.float32), (0, pad)),
        }
        self.buffer.add(item)
        self._seq_open[i] = self._new_seq(self._hidden[i])

    def training_step(self) -> dict:
        cfg: R2D2Config = self._algo_config
        metrics: dict = {}
        for _ in range(cfg.rollout_steps_per_iter // self.n_envs):
            obs = self.env.current_obs().astype(np.float32)
            actions, h_next = self._act(obs, self._hidden)
            eps_mask = self._rng.random(len(actions)) < self._epsilon()
            actions = np.where(
                eps_mask, self._rng.integers(0, self.action_dim, len(actions)), actions
            )
            next_obs, rewards, dones, _ = self.env.step(actions)
            for i in range(self.n_envs):
                seq = self._seq_open[i]
                seq["obs"].append(obs[i])
                seq["actions"].append(actions[i])
                seq["rewards"].append(rewards[i])
                seq["dones"].append(float(dones[i]))
                if dones[i]:
                    h_next[i] = 0.0  # recurrent state resets with the episode
                    self._hidden[i] = 0.0
                    self._finish_seq(i)
                elif len(seq["obs"]) >= self._T:
                    self._hidden[i] = h_next[i]
                    self._finish_seq(i)
            self._hidden = h_next
            self._timesteps_total += self.n_envs
            if (
                # learning_starts counts ENV STEPS (reference semantics);
                # the buffer stores sequences of up to T steps each.
                len(self.buffer) * self._T >= max(self._T, cfg.learning_starts)
                and self._timesteps_total % max(1, cfg.train_intensity) < self.n_envs
            ):
                metrics = self._train_once()
        stats_r, _ = self.env.pop_episode_stats()
        self._episode_reward_window += stats_r
        self._episode_reward_window = self._episode_reward_window[-100:]
        metrics["epsilon"] = self._epsilon()
        metrics["replay_sequences"] = len(self.buffer)
        return metrics

    def loss_and_grads(self, batch: dict):
        """(loss, {"td_abs"}, gradients in the tree's leaf order) of one
        host sequence batch, on the config's device in full f32."""
        cfg: R2D2Config = self._algo_config
        tb = {k: torch.from_numpy(np.require(v, requirements="W")).to(self.device) for k, v in batch.items()}
        with full_f32(self.device):
            loss, aux = r2d2_loss(self.params, self.target_params, tb, cfg.gamma, cfg.burn_in, cfg.use_h_rescale)
            grads = torch.autograd.grad(loss, tree_leaves(self.params))
        return loss, aux, grads

    def update(self, batch: dict) -> dict:
        """One TD update (the reference's jitted update_fn): the loss, the
        clipped Adam step, the metrics read back in one transfer."""
        loss, aux, grads = self.loss_and_grads(batch)
        with full_f32(self.device):
            self.opt.step(grads, global_norm(grads))
        host = torch.stack([aux["td_abs"].detach(), loss.detach()]).cpu().tolist()
        return {"td_abs": host[0], "total_loss": host[1]}

    def _train_once(self) -> dict:
        cfg = self._algo_config
        metrics = self.update(self.buffer.sample(cfg.train_batch_size))
        self._updates += 1
        if self._updates % cfg.target_network_update_freq == 0:
            self.target_params = tree_map(lambda t: t.detach().clone(), self.params)
        return metrics

    def step(self) -> dict:
        import time

        t0 = time.time()
        result = self.training_step()
        result["episode_reward_mean"] = (
            float(np.mean(self._episode_reward_window)) if self._episode_reward_window else float("nan")
        )
        result["timesteps_total"] = self._timesteps_total
        result["time_this_iter_s"] = time.time() - t0
        return result

    def _evaluate_local(self, duration: int, by_episodes: bool):
        """Recurrent eval must THREAD the GRU state across steps — the base
        loop's stateless compute_single_action would wipe the memory the
        policy was trained to use, scoring a memoryless policy instead."""
        env = self._make_eval_env()
        rewards, lens, steps = [], [], 0
        hidden_size = self._algo_config.hidden_size
        try:
            for _ in range(duration if by_episodes else 64):
                obs, _ = env.reset()
                state = np.zeros((1, hidden_size), np.float32)
                total, length = 0.0, 0
                for _ in range(10_000):
                    action, state = self.compute_single_action(
                        obs, explore=False, state=state
                    )
                    obs, r, terminated, truncated, _ = env.step(action)
                    total += float(r)
                    length += 1
                    steps += 1
                    if terminated or truncated:
                        break
                    if not by_episodes and steps >= duration:
                        break
                rewards.append(total)
                lens.append(length)
                if not by_episodes and steps >= duration:
                    break
        finally:
            try:
                env.close()
            except Exception:
                pass
        return rewards, lens

    def compute_single_action(self, obs, explore: bool = False, state=None):
        h = state if state is not None else np.zeros((1, self._algo_config.hidden_size), np.float32)
        actions, h2 = self._act(np.asarray(obs, np.float32)[None], h)
        action = int(actions[0])
        if state is not None:
            return action, h2
        return action

    def get_policy_weights(self):
        return self.get_weights()

    def save_checkpoint(self):
        from ray_tpu_torch.air.checkpoint import Checkpoint

        return Checkpoint.from_dict({
            "params": self.get_weights(),
            "target": _host(self.target_params),
            "opt_state": self.opt.state_dict(),
            "timesteps": self._timesteps_total,
            "updates": self._updates,
        })

    def load_checkpoint(self, checkpoint) -> None:
        data = checkpoint.to_dict()
        self.set_weights(data["params"])
        self.target_params = r2d2_params_from_jax(data["target"], device=self.device)
        self.opt.load_state_dict(data["opt_state"])
        self._timesteps_total = data.get("timesteps", 0)
        self._updates = data.get("updates", 0)

    def cleanup(self) -> None:
        self.env.close()
