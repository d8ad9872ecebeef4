"""The port's Tune on one port cluster (CPU only, module-scoped): the
assertions of the JAX package's Tuner tests (tests/test_tune.py,
test_tune_extras.py, test_tune_bohb_rcs.py, test_tune_analysis.py, the syncer
cases of test_platform_extras.py, the logger case of
test_loggers_rl_trainer.py), without the searchers' learning runs (their
suggestions, and every scheduler's decisions, are held to the reference's
in test_torch_tune.py): random search and tune.run's grid, class-trainable
stops and checkpoints, ASHA, PBT, retries, errors, Tuner.restore,
TorchTrainer and PPO as trials, the trial directories' loggers and the
syncer, the JAX package's ExperimentAnalysis reading a directory the port
wrote, and ROADMAP C19's pin. PBT runs ``chip_smoke.py``'s flagship function
trainable at a tiny size: the restored weights and AdamW state must be
bit-equal to the donor's. The three sweeps whose trials import torch run
at once, on threads, in one case. Run alone: ~34 s.
"""

import csv
import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import cloudpickle
import pytest

import ray_tpu_torch as rt
from ray_tpu_torch import tune
from ray_tpu_torch.air.checkpoint import Checkpoint
from ray_tpu_torch.air.config import RunConfig, ScalingConfig
from ray_tpu_torch.tune.schedulers import ASHAScheduler, PopulationBasedTraining

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def cluster():
    """One port cluster for the module; 16 CPUs of resource, so the three
    sweeps that run at once (test_pbt_ppo_and_trainer_as_trials) never wait
    on each other's CPUs."""
    # The card's machine has no tensorboardX, and the TensorBoard logger's
    # writer takes ~0.25 s to close a trial: the module runs without it, but
    # for the logger case that holds both behaviours.
    saved = sys.modules.get("tensorboardX", False)
    sys.modules["tensorboardX"] = None
    rt.init(num_cpus=16, object_store_memory=128 * 1024 * 1024)
    try:
        yield
    finally:
        rt.shutdown()
        if saved is False:
            del sys.modules["tensorboardX"]
        else:
            sys.modules["tensorboardX"] = saved


def _quadratic(config):
    for i in range(5):
        tune.report({"score": -((config["x"] - 3.0) ** 2) - 0.01 * (5 - i)})


def _report_iters(config):
    for i in range(1, config.get("iters", 20) + 1):
        tune.report({"acc": config["lr"] * i})


class _Counter(tune.Trainable):
    def setup(self, config):
        self.gain = config.get("gain", 1)
        self.total = 0

    def step(self):
        self.total += self.gain
        return {"total": self.total}

    def save_checkpoint(self):
        return Checkpoint.from_dict({"total": self.total})

    def load_checkpoint(self, ckpt):
        self.total = ckpt.to_dict()["total"]


def test_tuner_random_search(cluster, tmp_path):
    results = tune.Tuner(
        _quadratic, param_space={"x": tune.uniform(0, 6)},
        tune_config=tune.TuneConfig(metric="score", mode="max", num_samples=6, max_concurrent_trials=3),
        run_config=RunConfig(storage_path=str(tmp_path)),
    ).fit()
    assert len(results) == 6
    best = results.get_best_result("score", "max")
    assert best.metrics["score"] == max(r.metrics["score"] for r in results)


def test_tune_run_grid(cluster, tmp_path):
    results = tune.run(_quadratic, config={"x": tune.grid_search([1.0, 3.0, 5.0])}, metric="score", mode="max",
                       storage_path=str(tmp_path), name="grid")
    assert len(results) == 3
    assert abs(results.get_best_result("score", "max").metrics["score"] + 0.01) < 1e-6
    # Without tensorboardX (as on the card's machine) its logger is skipped
    # quietly: the CSV and JSON files are written, no event file.
    for td in [d for d in (tmp_path / "grid").iterdir() if d.is_dir()]:
        names = os.listdir(td)
        assert {"progress.csv", "result.json", "params.json"} <= set(names)
        assert not any(n.startswith("events.out") for n in names)


def test_class_trainable_stop_and_checkpoint(cluster, tmp_path):
    results = tune.run(_Counter, config={"gain": 2}, stop={"training_iteration": 4}, storage_path=str(tmp_path))
    assert results[0].metrics["training_iteration"] == 4
    assert results[0].metrics["total"] == 8
    ckpt = results[0].checkpoint
    assert ckpt is not None and ckpt.to_dict()["total"] == 8


def test_asha_stops_bad_trials_early(cluster, tmp_path):
    scheduler = ASHAScheduler(metric="acc", mode="max", max_t=20, grace_period=2, reduction_factor=2)
    results = tune.Tuner(
        _report_iters, param_space={"lr": tune.grid_search([10.0, 1.0, 0.1, 0.01])},
        tune_config=tune.TuneConfig(scheduler=scheduler, metric="acc", mode="max", max_concurrent_trials=2),
        run_config=RunConfig(storage_path=str(tmp_path)),
    ).fit()
    iters = sorted(r.metrics.get("training_iteration", 0) for r in results)
    assert iters[-1] >= 19
    assert iters[0] < 20


def _pbt_sweep(root):
    """chip_smoke.py's flagship trainable (tune phase (b)) at a tiny width on
    the CPU, the two trials at once: the slow learning rate's trial trains
    chunks 20 times longer, so at its second or fourth iteration (PBT's
    perturbations) the fast trial holds a checkpoint; it lands in the bottom
    quantile and takes that directory checkpoint."""
    sys.path.insert(0, ROOT)
    import chip_smoke

    cloudpickle.register_pickle_by_value(chip_smoke)
    model = dict(vocab_size=128, d_model=32, n_layers=1, n_heads=2, n_kv_heads=2, d_ff=64, max_seq_len=32,
                 remat=False, fused_loss=False, scan_unroll=1)
    ckpt_root = root / "ckpts"
    ckpt_root.mkdir(parents=True)
    pbt = PopulationBasedTraining(metric="loss", mode="min", perturbation_interval=2, quantile_fraction=0.5,
                                  hyperparam_mutations={"lr": tune.loguniform(1e-5, 1e-2)}, seed=0)
    results = tune.run(
        chip_smoke.pbt_trainable,
        config=dict(model=model, dtype="float32", batch=2, seq=16, param_seed=0, batch_seed=1,
                    ckpt_root=str(ckpt_root), device="cpu", iters=6, lr=tune.grid_search([1e-2, 1e-6]),
                    chunk=tune.sample_from(lambda spec: 4 if spec.config["lr"] > 1e-4 else 80)),
        metric="loss", mode="min", scheduler=pbt, stop={"training_iteration": 6}, storage_path=str(root),
        name="pbt", max_concurrent_trials=2)
    return results, ckpt_root


def _flaky(config, checkpoint=None):
    start = 0
    if checkpoint is not None:
        start = checkpoint.to_dict()["i"] + 1
    for i in range(start, 6):
        if i == 3 and start == 0:
            raise RuntimeError("boom")
        tune.report({"i": i}, checkpoint=Checkpoint.from_dict({"i": i}))


def test_retry_from_checkpoint_and_error_surfacing(cluster, tmp_path):
    results = tune.run(_flaky, config={}, max_failures=2, storage_path=str(tmp_path))
    assert not results.errors
    assert results[0].metrics["i"] == 5

    def bad(config):
        raise ValueError("nope")

    results = tune.run(bad, config={}, storage_path=str(tmp_path))
    assert len(results.errors) == 1 and "nope" in results.errors[0]


def test_tuner_restore(cluster, tmp_path):
    run_config = RunConfig(name="restore_exp", storage_path=str(tmp_path), stop={"training_iteration": 4})
    results = tune.Tuner(_Counter, param_space={"gain": tune.grid_search([1, 2])},
                         tune_config=tune.TuneConfig(metric="total", mode="max"), run_config=run_config).fit()
    assert len(results) == 2
    restored = tune.Tuner.restore(str(tmp_path / "restore_exp"), _Counter,
                                  tune_config=tune.TuneConfig(metric="total", mode="max"),
                                  run_config=RunConfig(stop={"training_iteration": 6})).fit()
    assert len(restored) == 2
    for r in restored:
        assert r.metrics["training_iteration"] >= 4


def _trainer_sweep(root):
    from ray_tpu_torch.train.torch import TorchTrainer

    def loop(config):
        from ray_tpu_torch.air import session

        for i in range(3):
            session.report({"loss": 1.0 / (config.get("lr", 1.0) * (i + 1))})

    trainer = TorchTrainer(loop, scaling_config=ScalingConfig(num_workers=1, use_gpu=False),
                           run_config=RunConfig(storage_path=str(root)))
    return tune.Tuner(trainer, param_space={"train_loop_config": {"lr": tune.grid_search([1.0, 2.0])}},
                      tune_config=tune.TuneConfig(metric="loss", mode="min")).fit()


def _ppo_sweep(root):
    from ray_tpu_torch.rllib import PPO

    return tune.Tuner(
        PPO,
        param_space={"env": "CartPole-v1", "num_rollout_workers": 1, "num_envs_per_worker": 2,
                     "train_batch_size": 256, "sgd_minibatch_size": 64, "num_sgd_iter": 2,
                     "lr": tune.grid_search([3e-4, 1e-3]), "device": "cpu"},
        tune_config=tune.TuneConfig(metric="episode_reward_mean", mode="max"),
        run_config=RunConfig(stop={"training_iteration": 2}, storage_path=str(root)),
    ).fit()


def test_pbt_ppo_and_trainer_as_trials(cluster, tmp_path):
    """The three sweeps whose trials train with torch, at once on threads
    (each trial process spends seconds in torch's and its optimizer's first
    imports): PBT of the tiny flagship restores the donor's weights and
    AdamW state bit for bit; PPO with a CPU learner gives two results;
    TorchTrainer's trials report the reference's losses (its 1/6)."""
    with ThreadPoolExecutor(3) as pool:
        futures = {name: pool.submit(fn, tmp_path / name) for name, fn in
                   (("pbt", _pbt_sweep), ("ppo", _ppo_sweep), ("trainer", _trainer_sweep))}
        (pbt, ckpt_root), ppo, trainer = (futures[n].result(timeout=600) for n in ("pbt", "ppo", "trainer"))

    assert not pbt.errors
    restored = [t.last_result.get("restored") for t in pbt._trials]
    assert any(restored), [t.metric_history for t in pbt._trials]
    for rst in filter(None, restored):
        assert rst["bit_equal"] and rst["tensors"] > 0
        assert rst["loss"] == rst["donor_loss"]
        assert os.path.dirname(rst["donor_dir"]) == str(ckpt_root)
    assert all(loss == loss for t in pbt._trials for loss in t.metric_history)

    assert len(ppo) == 2 and not ppo.errors
    assert ppo.get_best_result() is not None
    assert all(r.metrics["training_iteration"] == 2 for r in ppo)

    assert len(trainer) == 2
    assert trainer.get_best_result("loss", "min").metrics["loss"] == pytest.approx(1.0 / 6.0)


def _logged(config):
    for i in range(3):
        score = config["x"] * (i + 1)
        tune.report({"score": score, "note": "text-skipped-in-csv"}, checkpoint=Checkpoint.from_dict({"score": score}))


def test_logger_files_sync_and_both_analyses(cluster, tmp_path, monkeypatch):
    """The trial directories (progress.csv, result.json, params.json, the
    TensorBoard events where tensorboardX is installed), the syncer's copy,
    and ExperimentAnalysis of both packages over the port's directory: the
    same best trial, config, result, dataframes and checkpoint."""
    from ray_tpu.tune import ExperimentAnalysis as JaxAnalysis
    from ray_tpu_torch.tune import ExperimentAnalysis
    from ray_tpu_torch.tune.syncer import SyncConfig, SyncManager, get_syncer

    monkeypatch.delitem(sys.modules, "tensorboardX")
    results = tune.Tuner(
        _logged, param_space={"x": tune.grid_search([1.0, 2.0])},
        tune_config=tune.TuneConfig(metric="score", mode="max"),
        run_config=RunConfig(name="logexp", storage_path=str(tmp_path / "local"),
                             sync_config=SyncConfig(upload_dir=str(tmp_path / "up"), sync_period_s=0)),
    ).fit()
    assert len(results) == 2 and not results.errors
    exp_dir = tmp_path / "local" / "logexp"
    trial_dirs = [d for d in exp_dir.iterdir() if d.is_dir() and not d.name.startswith("checkpoint_")]
    assert len(trial_dirs) == 2
    for td in trial_dirs:
        with open(td / "progress.csv") as f:
            rows = list(csv.DictReader(f))
        assert len(rows) == 3 and float(rows[1]["score"]) == 2 * float(rows[0]["score"])
        with open(td / "result.json") as f:
            lines = [json.loads(line) for line in f if line.strip()]
        assert lines[0]["note"] == "text-skipped-in-csv"
        assert json.load(open(td / "params.json"))["x"] in (1.0, 2.0)
        assert any(n.startswith("events.out") for n in os.listdir(td)) == _has_tensorboardx()
    assert (tmp_path / "up" / "logexp" / "experiment_state.json").exists()

    exp_dir = str(tmp_path / "local" / "logexp")
    port, ref = ExperimentAnalysis(exp_dir), JaxAnalysis(exp_dir)
    assert port.stats == ref.stats and port.stats["num_trials"] == 2
    assert port.get_best_trial().trial_id == ref.get_best_trial().trial_id
    assert port.get_best_config() == ref.get_best_config() == {"x": 2.0}
    assert port.best_result == ref.best_result and port.best_result["score"] == pytest.approx(6.0)
    assert port.get_all_configs() == ref.get_all_configs()
    for scope in ("last", "all"):
        for mode in ("max", "min"):
            assert port.get_best_logdir(mode=mode, scope=scope) == ref.get_best_logdir(mode=mode, scope=scope)
    import pandas as pd

    pd.testing.assert_frame_equal(port.dataframe(), ref.dataframe())
    pd.testing.assert_frame_equal(port.dataframe(metric="score", mode="min"), ref.dataframe(metric="score", mode="min"))
    for tid, df in port.trial_dataframes.items():
        pd.testing.assert_frame_equal(df, ref.trial_dataframes[tid])
    assert port.get_best_checkpoint().to_dict() == ref.get_best_checkpoint().to_dict() == {"score": 6.0}
    t = tune.Tuner.restore(exp_dir, lambda cfg: None)
    assert len(t._restore_state["trials"]) == 2

    # The syncer on its own, and the cloud schemes it gates.
    src = tmp_path / "exp"
    (src / "sub").mkdir(parents=True)
    (src / "state.json").write_text("{}")
    (src / "sub" / "ckpt.bin").write_bytes(b"\x00" * 64)
    mgr = SyncManager(SyncConfig(upload_dir=str(tmp_path / "remote"), sync_period_s=0), str(src), "exp1")
    assert mgr.enabled and mgr.maybe_sync_up(force=True)
    assert (tmp_path / "remote" / "exp1" / "sub" / "ckpt.bin").read_bytes() == b"\x00" * 64
    with pytest.raises(ValueError, match="cloud"):
        get_syncer("s3://bucket/path")
    with pytest.raises(FileNotFoundError):
        ExperimentAnalysis(str(tmp_path / "exp"))


def _has_tensorboardx() -> bool:
    try:
        import tensorboardX  # noqa: F401
    except ImportError:
        return False
    return True


class _Sleeper:
    def nap(self, s):
        time.sleep(s)
        return s


def test_actor_manager_sees_a_start_while_a_task_runs(cluster):
    """ROADMAP C19: with a task in flight, ``next()`` used to wait out its
    whole timeout before it looked at an actor still starting, so a second
    trial started up to that long after the first."""
    from ray_tpu_torch.air.execution import ActorManager, FixedResourceManager

    manager = ActorManager(FixedResourceManager())
    started = {}
    first = manager.add_actor(_Sleeper, on_start=lambda tracked: started.setdefault("a", time.monotonic()))
    try:
        manager.wait_for_actors([first], timeout=60)
        manager.schedule_actor_task(first, "nap", (8.0,))
        t0 = time.monotonic()
        second = manager.add_actor(_Sleeper, on_start=lambda tracked: started.setdefault("b", time.monotonic()))
        while "b" not in started and time.monotonic() - t0 < 20:
            manager.next(timeout=10.0)
        assert "b" in started and started["b"] - t0 < 5.0, started
        assert second.actor_handle is not None
    finally:
        manager.clear()
