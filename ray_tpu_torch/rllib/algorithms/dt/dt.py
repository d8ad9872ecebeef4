"""DT — Decision Transformer (offline RL as sequence modeling).

Reference: rllib/algorithms/dt/ (Chen et al. 2021): trajectories become
sequences of (return-to-go, state, action) token triples; a causal
transformer is trained to predict the action at each state token, and at
evaluation time acting is conditional generation — prompt with the TARGET
return and the model produces the behavior that achieves it.

The attention inside each block is the port's flash attention
(ops/attention.py, causal): on the card its CUDA kernels, the forward and
the two backward kernels in training, on the CPU their plain versions inside
the same autograd Function. So the same hot op backs the flagship LM and
offline RL. The model trains in f32 with the counterpart of
``optax.adamw(lr)`` (weight decay 1e-4 on every leaf; core/learner.py
OptaxChain) on ``AlgorithmConfig.resources(device=...)``, the card unless
the config asks for the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.core.learner import OptaxChain, full_f32
from ray_tpu_torch.rllib.core.rl_module import _device, tree_leaves, tree_map
from ray_tpu_torch.rllib.policy.sample_batch import ACTIONS, DONES, OBS, REWARDS


def _init_linear(gen, n_in, n_out, scale=None):
    scale = scale if scale is not None else np.sqrt(2.0 / n_in)
    return {"w": torch.randn(n_in, n_out, generator=gen) * scale, "b": torch.zeros(n_out)}


def _linear(p, x):
    return x @ p["w"] + p["b"]


def _layernorm(x, eps=1e-5):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps)


def _on(params, device):
    dev = _device(device)
    return tree_map(lambda t: t.to(dev).requires_grad_(), params)


def init_dt_params(obs_dim, n_actions, d, n_layers, n_heads, max_len, seed: int = 0, *, device="cuda"):
    """The port's own initialisation, with the reference's distributions
    (normal weights scaled by sqrt(2 / fan_in), zero biases, timestep
    embeddings at 0.02, the head at 0.01), drawn on the CPU from ``seed``
    and moved to ``device``: leaf tensors that require grad."""
    gen = torch.Generator().manual_seed(seed)
    params = {
        "emb_rtg": _init_linear(gen, 1, d),
        "emb_obs": _init_linear(gen, obs_dim, d),
        "emb_act": _init_linear(gen, n_actions, d),
        "emb_t": torch.randn(max_len, d, generator=gen) * 0.02,
        "head": _init_linear(gen, d, n_actions, scale=0.01),
        "blocks": [],
    }
    for _ in range(n_layers):
        params["blocks"].append({
            "qkv": _init_linear(gen, d, 3 * d),
            "proj": _init_linear(gen, d, d),
            "ff1": _init_linear(gen, d, 4 * d),
            "ff2": _init_linear(gen, 4 * d, d),
        })
    return _on(params, device)


def dt_params_from_jax(np_params: dict, *, device="cuda") -> dict:
    """The JAX package's DT params (numpy leaves, ``init_dt_params``'s
    layout: dense ``w`` [n_in, n_out] applied as ``x @ w``) as this
    module's leaf tensors; the layouts are the same, so leaves copy as they
    are."""
    return _on(tree_map(lambda a: torch.tensor(np.asarray(a), dtype=torch.float32), np_params), device)


def dt_forward(params, rtg, obs, act_onehot, timesteps, n_heads):
    """rtg [B,K,1], obs [B,K,obs_dim], act_onehot [B,K,n_actions],
    timesteps [B,K] int -> action logits [B,K,n_actions] (per state token)."""
    from ray_tpu_torch.ops.attention import flash_attention

    B, K = timesteps.shape
    pos = params["emb_t"][timesteps.long()]               # [B,K,d]
    tok_r = _linear(params["emb_rtg"], rtg) + pos
    tok_s = _linear(params["emb_obs"], obs) + pos
    tok_a = _linear(params["emb_act"], act_onehot) + pos
    # Interleave (r_t, s_t, a_t): [B, 3K, d]
    x = torch.stack([tok_r, tok_s, tok_a], dim=2).reshape(B, 3 * K, -1)
    d = x.shape[-1]
    dh = d // n_heads
    for blk in params["blocks"]:
        h = _layernorm(x)
        qkv = _linear(blk["qkv"], h).reshape(B, 3 * K, 3, n_heads, dh)
        q, k, v = (t.contiguous() for t in qkv.unbind(2))   # [B,3K,H,dh]
        o = flash_attention(q, k, v, causal=True)
        x = x + _linear(blk["proj"], o.reshape(B, 3 * K, d))
        h = _layernorm(x)
        x = x + _linear(blk["ff2"], torch.relu(_linear(blk["ff1"], h)))
    x = _layernorm(x)
    state_tokens = x.reshape(B, K, 3, d)[:, :, 1]          # predict action FROM s_t
    return _linear(params["head"], state_tokens)           # [B,K,n_actions]


def dt_loss(params, rtg, obs, act_oh, ts, actions, mask, n_heads):
    """Masked mean negative log-likelihood of the taken actions."""
    logits = dt_forward(params, rtg, obs, act_oh, ts, n_heads)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, actions[..., None].long())[..., 0]
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


class DTConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or DT)
        self.lr = 1e-3
        self.train_batch_size = 64
        self.context_length = 20
        self.embed_dim = 64
        self.n_layers = 2
        self.n_heads = 2
        self.max_ep_len = 1000
        self.target_return = None  # default: best dataset return
        self.updates_per_iter = 100
        self.eval_episodes = 5
        self.offline_input: str | None = None  # JsonReader path

    def training(self, *, context_length=None, embed_dim=None, n_layers=None,
                 n_heads=None, target_return=None, updates_per_iter=None,
                 eval_episodes=None, max_ep_len=None, **kwargs) -> "DTConfig":
        super().training(**kwargs)
        for name, val in (
            ("context_length", context_length), ("embed_dim", embed_dim),
            ("n_layers", n_layers), ("n_heads", n_heads),
            ("target_return", target_return), ("updates_per_iter", updates_per_iter),
            ("eval_episodes", eval_episodes), ("max_ep_len", max_ep_len),
        ):
            if val is not None:
                setattr(self, name, val)
        return self

    def offline_data(self, input_: str) -> "DTConfig":
        self.offline_input = input_
        return self


class DT(Algorithm):
    @classmethod
    def get_default_config(cls) -> DTConfig:
        return DTConfig(cls)

    def setup(self, config: dict) -> None:
        from ray_tpu_torch.rllib.env.cartpole import make

        cfg: DTConfig = self._algo_config
        self.device = _device(cfg.device)
        env = make(cfg.env) if isinstance(cfg.env, str) else cfg.env(dict(cfg.env_config))
        self.env = env
        self.obs_dim = int(np.prod(env.observation_space.shape))
        self.n_actions = int(env.action_space.n)
        assert cfg.offline_input, "DT is offline: configure .offline_data(path)"

        from ray_tpu_torch.rllib.offline import JsonReader

        reader = JsonReader(cfg.offline_input, gamma=1.0)
        batch = reader.next()  # full dataset
        self.trajectories = self._segment(batch)
        assert self.trajectories, "offline dataset contains no complete episode"
        # Length-weighted trajectory sampling probabilities (reference does
        # the same); fixed dataset -> computed once.
        lens = np.array([len(t["actions"]) for t in self.trajectories], np.float64)
        self._traj_probs = lens / lens.sum()
        returns = [t["rtg"][0] for t in self.trajectories]
        self.target_return = float(cfg.target_return or max(returns))

        self.params = init_dt_params(
            self.obs_dim, self.n_actions, cfg.embed_dim, cfg.n_layers,
            cfg.n_heads, cfg.max_ep_len + cfg.context_length, seed=cfg.seed, device=self.device,
        )
        self.set_params(self.params)
        self._rng = np.random.default_rng(cfg.seed)
        self._timesteps_total = 0
        self._episode_reward_window: list = []

    def set_params(self, params: dict) -> None:
        """Train from ``params`` (leaf tensors on this algorithm's device)
        with a fresh optimizer: optax.adamw(lr)'s counterpart."""
        self.params = params
        self.opt = OptaxChain(tree_leaves(params), self._algo_config.lr, weight_decay=1e-4)

    def train_step(self, rtg, obs, act_oh, ts, act, mask) -> torch.Tensor:
        """One AdamW step on one batch of windows (numpy arrays, as
        ``_sample_windows`` gives them); returns the loss (on the device)."""
        dev = self.device
        args = [torch.from_numpy(a).to(dev, non_blocking=True) for a in (rtg, obs, act_oh, ts, act, mask)]
        with full_f32(dev):
            loss = dt_loss(self.params, *args, self._algo_config.n_heads)
            grads = torch.autograd.grad(loss, self.opt.params)
            self.opt.step(grads)
        return loss.detach()

    def _segment(self, batch) -> list[dict]:
        """Split the flat offline batch into episodes with returns-to-go."""
        obs = np.asarray(batch[OBS], np.float32).reshape(len(batch[OBS]), -1)
        acts = np.asarray(batch[ACTIONS]).astype(np.int64).reshape(-1)
        rews = np.asarray(batch[REWARDS], np.float32).reshape(-1)
        dones = np.asarray(batch[DONES], np.float32).reshape(-1)
        out, start = [], 0
        for i in range(len(dones)):
            if dones[i] > 0:
                r = rews[start : i + 1]
                rtg = np.cumsum(r[::-1])[::-1].astype(np.float32)
                out.append({
                    "obs": obs[start : i + 1],
                    "actions": acts[start : i + 1],
                    "rtg": rtg,
                })
                start = i + 1
        return out

    def _sample_windows(self, n: int, K: int):
        obs = np.zeros((n, K, self.obs_dim), np.float32)
        rtg = np.zeros((n, K, 1), np.float32)
        act = np.zeros((n, K), np.int64)
        act_oh = np.zeros((n, K, self.n_actions), np.float32)
        ts = np.zeros((n, K), np.int32)
        mask = np.zeros((n, K), np.float32)
        for i in range(n):
            t = self.trajectories[self._rng.choice(len(self.trajectories), p=self._traj_probs)]
            L = len(t["actions"])
            end = self._rng.integers(1, L + 1)
            startw = max(0, end - K)
            w = end - startw
            obs[i, :w] = t["obs"][startw:end]
            rtg[i, :w, 0] = t["rtg"][startw:end]
            act[i, :w] = t["actions"][startw:end]
            act_oh[i, np.arange(w), t["actions"][startw:end]] = 1.0
            # Action inputs are PREVIOUS actions at prediction time; the
            # causal mask already hides a_t from s_t's prediction (a_t comes
            # after s_t in the token order), so feeding the true actions is safe.
            ts[i, :w] = np.arange(startw, end)
            mask[i, :w] = 1.0
        return rtg, obs, act_oh, ts, act, mask

    def training_step(self) -> dict:
        cfg: DTConfig = self._algo_config
        loss = None
        for _ in range(cfg.updates_per_iter):
            parts = self._sample_windows(cfg.train_batch_size, cfg.context_length)
            loss = self.train_step(*parts)
            self._timesteps_total += cfg.train_batch_size * cfg.context_length
        rewards = [self._eval_episode() for _ in range(cfg.eval_episodes)]
        self._episode_reward_window = (self._episode_reward_window + rewards)[-100:]
        return {"loss": float(loss) if loss is not None else float("nan")}

    def _eval_episode(self) -> float:
        cfg: DTConfig = self._algo_config
        K = cfg.context_length
        obs, _ = self.env.reset(seed=int(self._rng.integers(1 << 31)))
        rtg_hist = [self.target_return]
        obs_hist = [np.asarray(obs, np.float32).ravel()]
        act_hist: list = []
        total, t = 0.0, 0
        while t < cfg.max_ep_len:
            w = min(len(obs_hist), K)
            rtg = np.zeros((1, K, 1), np.float32)
            ob = np.zeros((1, K, self.obs_dim), np.float32)
            ah = np.zeros((1, K, self.n_actions), np.float32)
            ts = np.zeros((1, K), np.int32)
            rtg[0, :w, 0] = rtg_hist[-w:]
            ob[0, :w] = obs_hist[-w:]
            # Window covers timesteps t-w+1..t; position j holds the action
            # TAKEN AT that position's timestep (matching _sample_windows).
            # The current step's action (pos w-1) hasn't happened yet — its
            # token stays zero and is causally after the s_t query anyway.
            for j, a in enumerate(act_hist[t - w + 1 : t]):
                ah[0, j, a] = 1.0
            ts[0, :w] = np.arange(max(0, t - w + 1), t + 1)
            with torch.no_grad(), full_f32(self.device):
                logits = dt_forward(
                    self.params, *(torch.from_numpy(a).to(self.device) for a in (rtg, ob, ah, ts)),
                    cfg.n_heads,
                ).cpu().numpy()
            a = int(logits[0, w - 1].argmax())
            obs, r, term, trunc, _ = self.env.step(a)
            total += float(r)
            t += 1
            act_hist.append(a)
            obs_hist.append(np.asarray(obs, np.float32).ravel())
            rtg_hist.append(rtg_hist[-1] - float(r))
            if term or trunc:
                break
        return total

    def step(self) -> dict:
        import time

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

    def save_checkpoint(self):
        from ray_tpu_torch.air.checkpoint import Checkpoint

        return Checkpoint.from_dict({
            "params": tree_map(lambda t: t.detach().cpu().numpy(), self.params),
            "opt_state": self.opt.state_dict(),
            "target_return": self.target_return,
            "timesteps": self._timesteps_total,
        })

    def load_checkpoint(self, checkpoint) -> None:
        data = checkpoint.to_dict()
        self.set_params(dt_params_from_jax(data["params"], device=self.device))
        if "opt_state" in data:
            self.opt.load_state_dict(data["opt_state"])
        self.target_return = data.get("target_return", self.target_return)
        self._timesteps_total = data.get("timesteps", 0)

    def cleanup(self) -> None:
        try:
            self.env.close()
        except Exception:
            pass

    def compute_single_action(self, obs, explore: bool = False):
        raise NotImplementedError("DT acts with return conditioning; use evaluation")
