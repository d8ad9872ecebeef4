"""`rllib train` CLI (reference: rllib/train.py + rllib/scripts.py).

    python -m ray_tpu_torch.rllib train --run PPO --env CartPole-v1 \
        --stop-reward 150 --stop-iters 50 --config '{"lr": 3e-4}'
    python -m ray_tpu_torch.rllib evaluate --run PPO --env CartPole-v1 \
        --checkpoint /path/to/ckpt --episodes 5

The algorithms are the port's (``ray_tpu_torch.rllib``); their learners run on
the card unless ``--config`` carries ``"device": "cpu"``. ``evaluate`` plays
the env through the port's ``make`` (its own CartPole-v1 and Pendulum-v1;
gymnasium for any other id). The tuned examples are the port's own copies in
``tuned_examples/``; PyYAML, which reads them, is imported only by
``run_tuned_example``.
"""

from __future__ import annotations

import argparse
import json
import sys


# Names that don't round-trip through .upper() (hyphens normalize to _).
_ALGO_ALIASES = {"APEXDQN": "ApexDQN", "APEX_DQN": "ApexDQN"}


def available_algorithms() -> list:
    """The names of the algorithms ``ray_tpu_torch.rllib`` exports."""
    import ray_tpu_torch.rllib as rllib
    from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm

    return sorted(name for name, obj in vars(rllib).items()
                  if isinstance(obj, type) and issubclass(obj, Algorithm) and obj is not Algorithm)


def _algo_class(name: str):
    import ray_tpu_torch.rllib as rllib

    canonical = _ALGO_ALIASES.get(name.upper().replace("-", "_"), None)
    cls = (
        (getattr(rllib, canonical, None) if canonical else None)
        or getattr(rllib, name.upper(), None)
        or getattr(rllib, name, None)
    )
    if cls is None:
        raise SystemExit(f"unknown algorithm {name!r}; available: {', '.join(available_algorithms())}")
    return cls


def _build(args) -> tuple:
    import ray_tpu_torch

    if not ray_tpu_torch.is_initialized():
        ray_tpu_torch.init()
    cls = _algo_class(args.run)
    cfg = cls.get_default_config().environment(args.env)
    cfg.update_from_dict(json.loads(args.config) if args.config else {})
    algo = cfg.build()  # Trainable.__init__ runs setup()
    return algo, cfg


def run_tuned_example(path: str, max_iters_override: int | None = None) -> dict:
    """Run experiments from a tuned-example YAML (reference:
    rllib/tuned_examples/*.yaml driven by `rllib train file`). Returns
    {experiment_name: last_result}; raises if a stop criterion names a
    metric the algorithm never reports. Needs PyYAML: without it, raises
    ``ImportError`` naming the package and the file."""
    try:
        import yaml
    except ImportError as e:
        raise ImportError(f"reading the tuned example {path!r} needs the 'PyYAML' package (import yaml), "
                          "which is not installed") from e

    import ray_tpu_torch

    with open(path) as f:
        experiments = yaml.safe_load(f)
    if not ray_tpu_torch.is_initialized():
        ray_tpu_torch.init()
    out = {}
    for name, exp in experiments.items():
        cls = _algo_class(exp["run"])
        cfg = cls.get_default_config().environment(exp["env"])
        cfg.update_from_dict(exp.get("config") or {})
        stop = exp.get("stop") or {}
        max_iters = (
            max_iters_override
            if max_iters_override is not None
            else int(stop.get("training_iteration", 100))
        )
        algo = cfg.build()
        result: dict = {}
        try:
            for i in range(max_iters):
                result = algo.step()
                result["training_iteration"] = i + 1
                if i == 0:
                    # Typo'd stop keys would otherwise silently burn the full
                    # iteration budget.
                    missing = [k for k in stop if k not in result]
                    if missing:
                        raise ValueError(
                            f"experiment {name!r}: stop criteria {missing} name "
                            f"metrics the algorithm never reports "
                            f"(reported: {sorted(result)})"
                        )
                reward = result.get("episode_reward_mean", float("nan"))
                print(f"[{name}] iter {i + 1}: reward={reward:.2f}")
                if _stop_met(stop, result):
                    break
        finally:
            algo.cleanup()
        out[name] = result
    return out


def _stop_met(stop: dict, result: dict) -> bool:
    for key, bound in stop.items():
        v = result.get(key)
        if v is not None and v == v and v >= bound:  # v==v filters NaN
            return True
    return False


def cmd_train(args) -> int:
    if args.file:
        # Explicit --stop-iters bounds the YAML's own budget too.
        run_tuned_example(args.file, max_iters_override=args.stop_iters)
        return 0
    if not (args.run and args.env):
        raise SystemExit("train needs either -f <tuned.yaml> or --run + --env")
    algo, _ = _build(args)
    try:
        for i in range(100 if args.stop_iters is None else args.stop_iters):
            result = algo.step()
            reward = result.get("episode_reward_mean", float("nan"))
            print(f"iter {i + 1}: reward={reward:.2f} "
                  f"timesteps={result.get('timesteps_total', 0)}")
            if args.stop_reward is not None and reward >= args.stop_reward:
                print(f"stop-reward {args.stop_reward} reached")
                break
            if args.stop_timesteps and result.get("timesteps_total", 0) >= args.stop_timesteps:
                break
        if args.checkpoint_out:
            ckpt = algo.save_checkpoint()
            ckpt.to_directory(args.checkpoint_out)
            print(f"checkpoint written to {args.checkpoint_out}")
    finally:
        algo.cleanup()
    return 0


def cmd_evaluate(args) -> int:
    import numpy as np

    from ray_tpu_torch.rllib.env.cartpole import make

    algo, _ = _build(args)
    try:
        if args.checkpoint:
            from ray_tpu_torch.air.checkpoint import Checkpoint

            algo.load_checkpoint(Checkpoint.from_directory(args.checkpoint))
        env = make(args.env)
        rewards = []
        for ep in range(args.episodes):
            obs, _ = env.reset(seed=ep)
            total, done = 0.0, False
            while not done:
                action = algo.compute_single_action(obs, explore=False)
                obs, r, term, trunc, _ = env.step(action)
                total += float(r)
                done = term or trunc
            rewards.append(total)
            print(f"episode {ep + 1}: reward={total:.2f}")
        print(f"mean reward over {len(rewards)} episodes: {np.mean(rewards):.2f}")
        env.close()
    finally:
        algo.cleanup()
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="rllib", description=__doc__)
    sub = parser.add_subparsers(dest="command", required=True)
    for name in ("train", "evaluate"):
        p = sub.add_parser(name)
        p.add_argument("--run", required=(name == "evaluate"), default=None,
                       help="algorithm name, e.g. PPO")
        p.add_argument("--env", required=(name == "evaluate"), default=None,
                       help="gym env id or registered env")
        p.add_argument("--config", default=None, help="JSON config overrides")
    t = sub.choices["train"]
    t.add_argument("-f", "--file", default=None,
                   help="tuned-example YAML (rllib/tuned_examples/*.yaml)")
    t.add_argument("--stop-iters", type=int, default=None,
                   help="iteration cap (default: YAML stop / 100)")
    t.add_argument("--stop-reward", type=float, default=None)
    t.add_argument("--stop-timesteps", type=int, default=None)
    t.add_argument("--checkpoint-out", default=None)
    e = sub.choices["evaluate"]
    e.add_argument("--checkpoint", default=None)
    e.add_argument("--episodes", type=int, default=5)
    args = parser.parse_args(argv)
    return cmd_train(args) if args.command == "train" else cmd_evaluate(args)


if __name__ == "__main__":
    sys.exit(main())
