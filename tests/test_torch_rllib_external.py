"""The port's external-env path and its ``rllib train`` CLI on the CPU: the
reference's cases of ``tests/test_rllib_envs.py`` (the policy-server round
trip, the CLI's ``train``) and ``tests/test_rllib_external_training.py`` (MARWIL
from external clients, reader kwargs, DQN serving actions and training on
external episodes, concurrent clients), each with ``device="cpu"`` and the
port's own CartPole-v1 stepped client-side; ``ExternalEnv`` feeding DQN's
replay through ``ExternalEnvRunner``; one ``run_tuned_example`` iteration on a
copy of the port's tuned example, and its ``ImportError`` naming PyYAML when
``yaml`` cannot be imported. The policy server's batches are held to the JAX
package's server driven by the same calls, column for column.

One port cluster for the module (the CLI's PPO starts a rollout worker).
~25 s alone.
"""

import os
import shutil
import sys
import threading

import numpy as np
import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu.rllib.env.policy_server import PolicyClient as JPolicyClient
from ray_tpu.rllib.env.policy_server import PolicyServerInput as JPolicyServerInput
from ray_tpu_torch.rllib.env import ExternalEnv, ExternalEnvRunner, PolicyClient, PolicyServerInput
from ray_tpu_torch.rllib.env.cartpole import make

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(ROOT, "ray_tpu_torch", "rllib", "tuned_examples")


@pytest.fixture(scope="module")
def cluster():
    # One intra-op thread beside the rollout worker's process (as
    # tests/test_torch_rllib_learning.py), restored after.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    rt.init(num_cpus=4, object_store_memory=128 * 1024 * 1024)
    yield
    rt.shutdown()
    torch.set_num_threads(threads)


def _drive_external_episodes(address, n_episodes, policy=None, max_steps=40, seed=0):
    """External-sim loop: the port's CartPole-v1 stepped CLIENT-side, actions
    from the server (or a local scripted policy logged via log_action)."""
    client = PolicyClient(address)
    returns = []
    env = make("CartPole-v1")
    rng = np.random.default_rng(seed)
    for _ in range(n_episodes):
        obs, _ = env.reset(seed=int(rng.integers(1 << 30)))
        eid = client.start_episode()
        total, steps = 0.0, 0
        while True:
            if policy is None:
                action = client.get_action(eid, obs.astype(np.float32))
            else:
                action = policy(obs)
                client.log_action(eid, obs.astype(np.float32), action)
            obs, r, term, trunc, _ = env.step(int(action))
            client.log_returns(eid, float(r))
            total += float(r)
            steps += 1
            if term or trunc or steps >= max_steps:
                client.end_episode(eid, obs.astype(np.float32))
                break
        returns.append(total)
    return returns


def test_policy_server_roundtrip():
    """The reference test's round trip on the port's server, and the same
    calls to the JAX package's server: equal batches, column for column."""

    def compute_action(obs, explore):
        return int(obs.sum() > 0)

    servers = [PolicyServerInput(compute_action), JPolicyServerInput(compute_action)]
    try:
        batches = []
        for server, client_cls in zip(servers, (PolicyClient, JPolicyClient)):
            client = client_cls(server.address)
            eid = client.start_episode()
            for t in range(5):
                obs = np.ones(4) * (1 if t % 2 == 0 else -1)
                a = client.get_action(eid, obs)
                assert a == (1 if t % 2 == 0 else 0)
                client.log_returns(eid, 0.5)
            assert client.end_episode(eid) == 5
            batch = server.next_batch()
            assert batch.count == 5
            assert batch["rewards"].sum() == pytest.approx(2.5)
            assert batch["dones"][-1] == 1.0
            # Several shaping rewards per step accumulate onto that step.
            eid = client.start_episode()
            client.get_action(eid, np.ones(4))
            client.log_returns(eid, 1.0)
            client.log_returns(eid, 0.25)
            assert client.end_episode(eid) == 1
            b2 = server.next_batch()
            assert b2["rewards"][0] == pytest.approx(1.25)
            # Unknown episode -> server-side error surfaced client-side.
            with pytest.raises(Exception):
                client.get_action("nope", np.zeros(4))
            batches.append((batch, b2))
        for ours, ref in zip(*batches):
            assert sorted(ours) == sorted(ref)
            for k in ours:
                np.testing.assert_array_equal(np.asarray(ours[k]), np.asarray(ref[k]), err_msg=k)
                assert np.asarray(ours[k]).dtype == np.asarray(ref[k]).dtype, k
    finally:
        for server in servers:
            server.shutdown()


def test_marwil_trains_from_external_clients(cluster):
    """PolicyServerInput as config.input_: client-side expert episodes flow
    through ExternalInputReader into MARWIL updates."""
    from ray_tpu_torch.rllib import MARWILConfig

    server = PolicyServerInput(compute_action=lambda obs, explore: 0)
    try:
        expert = lambda obs: int(obs[2] > 0)  # noqa: E731 — push toward the pole's lean
        _drive_external_episodes(server.address, n_episodes=6, policy=expert)
        cfg = (
            MARWILConfig()
            .environment("CartPole-v1")
            .rollouts(num_rollout_workers=0)
            .training(lr=5e-3, train_batch_size=128, beta=1.0)
            .debugging(seed=0)
            .resources(device="cpu")
        )
        cfg.offline_data(input_=server)
        algo = cfg.build()
        algo.setup(cfg.to_dict())
        try:
            m = algo.step()
            assert np.isfinite(m.get("loss", m.get("total_loss", np.nan))), m
            # More external episodes mid-training fold into the window.
            _drive_external_episodes(server.address, n_episodes=2, policy=expert, seed=1)
            m2 = algo.step()
            assert np.isfinite(m2.get("loss", m2.get("total_loss", np.nan))), m2
            assert algo._timesteps_total > 0
        finally:
            algo.cleanup()
    finally:
        server.shutdown()


def test_input_reader_kwargs_reach_the_reader(cluster):
    from ray_tpu_torch.rllib import MARWILConfig
    from ray_tpu_torch.rllib.offline import ExternalInputReader

    server = PolicyServerInput(compute_action=lambda obs, explore: 0)
    try:
        _drive_external_episodes(server.address, 1, policy=lambda o: 0, max_steps=5)
        cfg = MARWILConfig().environment("CartPole-v1").rollouts(num_rollout_workers=0).resources(device="cpu")
        cfg.offline_data(
            input_=server,
            input_reader_kwargs={"timeout_s": 5.0, "min_episodes": 1, "window_rows": 256},
        )
        algo = cfg.build()
        algo.setup(cfg.to_dict())
        try:
            assert isinstance(algo.reader, ExternalInputReader)
            assert algo.reader._timeout == 5.0
            assert algo.reader._window.capacity == 256
        finally:
            algo.cleanup()
    finally:
        server.shutdown()


def test_dqn_serves_actions_and_trains_on_external_episodes(cluster):
    """The live algorithm's policy answers client get_action; its replay
    buffer ingests the collected external episodes and a gradient step
    runs on them."""
    from ray_tpu_torch.rllib import DQNConfig

    cfg = (
        DQNConfig()
        .environment("CartPole-v1")
        .rollouts(num_rollout_workers=0)
        .training(learning_starts=0, train_batch_size=32)
        .debugging(seed=0)
        .resources(device="cpu")
    )
    algo = cfg.build()
    algo.setup(cfg.to_dict())
    server = PolicyServerInput(
        compute_action=lambda obs, explore: int(algo.compute_single_action(np.asarray(obs, np.float32)))
    )
    try:
        returns = _drive_external_episodes(server.address, n_episodes=4)
        assert len(returns) == 4 and all(r > 0 for r in returns)
        batch = server.next_batch(min_episodes=4)
        assert batch is not None and len(batch) == int(sum(returns))
        algo.buffer.add(batch)
        algo._timesteps_total += len(batch)
        metrics = algo._train_once()
        loss = next(v for k, v in metrics.items() if "loss" in k.lower())
        assert np.isfinite(float(loss)), metrics
    finally:
        server.shutdown()
        algo.cleanup()


def test_concurrent_external_clients():
    """Multiple client sims against one server: episode isolation holds.
    Every client stamps its thread id into all its observations AND
    actions, so cross-episode contamination is directly detectable."""
    server = PolicyServerInput(compute_action=lambda obs, explore: 1)
    steps_per_ep, eps_per_client, n_clients = 7, 3, 3

    def drive(tid):
        client = PolicyClient(server.address)
        for ep in range(eps_per_client):
            eid = client.start_episode()
            for step in range(steps_per_ep):
                obs = np.array([tid, ep, step, 0], np.float32)
                client.log_action(eid, obs, int(tid))
                client.log_returns(eid, float(tid))
            client.end_episode(eid, np.array([tid, ep, steps_per_ep, 0], np.float32))

    try:
        threads = [threading.Thread(target=drive, args=(t,)) for t in range(n_clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        batch = server.next_batch(min_episodes=n_clients * eps_per_client)
        assert batch is not None
        assert len(batch) == n_clients * eps_per_client * steps_per_ep
        eps = np.asarray(batch["eps_id"])
        obs = np.asarray(batch["obs"])
        acts = np.asarray(batch["actions"])
        rews = np.asarray(batch["rewards"])
        dones = np.asarray(batch["dones"])
        assert len(set(eps.tolist())) == n_clients * eps_per_client
        # Episodes are CONTIGUOUS runs each ending in done=1.
        changes = np.flatnonzero(np.diff(eps) != 0)
        assert len(set(eps.tolist())) == len(changes) + 1
        for boundary in changes:
            assert dones[boundary] == 1.0
        assert dones[-1] == 1.0
        for e in set(eps.tolist()):
            rows = eps == e
            tids = obs[rows][:, 0]
            assert len(set(tids.tolist())) == 1, f"episode {e} mixes clients"
            tid = tids[0]
            assert (acts[rows] == tid).all()
            assert (rews[rows] == tid).all()
            assert obs[rows][:, 2].tolist() == list(range(steps_per_ep))
    finally:
        server.shutdown()


def test_external_env_feeds_dqn_replay(cluster):
    """Inverted control: a user thread owns the CartPole loop and asks the
    algorithm for actions (``compute_single_action``); ``ExternalEnvRunner``
    moves the finished episodes into DQN's replay, the reward window and the
    timesteps, and a gradient step runs on them."""
    from ray_tpu_torch.rllib import DQNConfig

    class CartPoleExternal(ExternalEnv):
        def __init__(self):
            env = make("CartPole-v1")
            super().__init__(env.action_space, env.observation_space)
            self._env = env
            self._stop = False

        def run(self):
            seed = 0
            while not self._stop:
                eid = self.start_episode()
                obs, _ = self._env.reset(seed=seed)
                seed += 1
                done = False
                while not done:
                    action = self.get_action(eid, obs)
                    obs, reward, term, trunc, _ = self._env.step(int(action))
                    self.log_returns(eid, reward)
                    done = term or trunc
                self.end_episode(eid, obs)

    cfg = (
        DQNConfig()
        .environment("CartPole-v1")
        .training(learning_starts=0, train_batch_size=32, rollout_steps_per_iter=0)
        .debugging(seed=0)
        .resources(device="cpu")
    )
    algo = cfg.build()
    ext = CartPoleExternal()
    runner = ExternalEnvRunner(ext, algo)
    try:
        steps = runner.collect(min_steps=100, timeout=60)
        assert steps >= 100 and len(algo.buffer) == steps == algo._timesteps_total
        assert algo._episode_reward_window and sum(algo._episode_reward_window) == steps
        metrics = algo._train_once()
        assert np.isfinite(float(next(v for k, v in metrics.items() if "loss" in k.lower()))), metrics
    finally:
        ext._stop = True
        algo.cleanup()


def test_rllib_cli_train(cluster, capsys):
    from ray_tpu_torch.rllib.train import main

    rc = main([
        "train", "--run", "PPO", "--env", "CartPole-v1",
        "--stop-iters", "2",
        "--config", '{"num_rollout_workers": 1, "train_batch_size": 400, "num_envs_per_worker": 2, '
                    '"device": "cpu"}',
    ])
    assert rc == 0
    out = capsys.readouterr().out
    assert "iter 1" in out and "reward=" in out
    with pytest.raises(SystemExit, match="AlphaZero, ApexDDPG"):
        main(["train", "--run", "NoSuchAlgo", "--env", "CartPole-v1"])


def test_tuned_examples_are_the_ports_own_copies():
    """The eight tuned examples sit in the port's package, equal to the JAX
    package's, each naming an algorithm the port exports."""
    import yaml

    from ray_tpu_torch.rllib.train import _algo_class

    names = sorted(os.listdir(EXAMPLES))
    assert names == sorted(os.listdir(os.path.join(ROOT, "ray_tpu", "rllib", "tuned_examples")))
    assert len(names) == 8
    for name in names:
        with open(os.path.join(EXAMPLES, name)) as f, \
                open(os.path.join(ROOT, "ray_tpu", "rllib", "tuned_examples", name)) as g:
            text = f.read()
            assert text == g.read(), name
        for exp in yaml.safe_load(text).values():
            assert _algo_class(exp["run"]).__module__.startswith("ray_tpu_torch.rllib.algorithms."), name


def test_run_tuned_example_one_iteration(cluster, tmp_path, capsys):
    """One iteration of a copy of the port's cartpole-ppo.yaml, its config
    asking for the CPU."""
    import yaml

    from ray_tpu_torch.rllib.train import run_tuned_example

    with open(os.path.join(EXAMPLES, "cartpole-ppo.yaml")) as f:
        experiments = yaml.safe_load(f)
    experiments["cartpole-ppo"]["config"].update(device="cpu", num_rollout_workers=1, train_batch_size=512)
    path = tmp_path / "cartpole-ppo.yaml"
    path.write_text(yaml.safe_dump(experiments))
    out = run_tuned_example(str(path), max_iters_override=1)
    assert "cartpole-ppo" in out and "episode_reward_mean" in out["cartpole-ppo"]
    assert out["cartpole-ppo"]["training_iteration"] == 1
    assert "[cartpole-ppo] iter 1" in capsys.readouterr().out


def test_run_tuned_example_names_pyyaml_without_it(tmp_path, monkeypatch):
    from ray_tpu_torch.rllib.train import run_tuned_example

    path = tmp_path / "cartpole-pg.yaml"
    shutil.copy(os.path.join(EXAMPLES, "cartpole-pg.yaml"), path)
    monkeypatch.setitem(sys.modules, "yaml", None)
    with pytest.raises(ImportError, match="PyYAML") as err:
        run_tuned_example(str(path))
    assert str(path) in str(err.value)
