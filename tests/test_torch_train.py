"""The port's trainer on the CPU: ``TorchTrainer`` on ray_tpu_torch's own
cluster against ``JaxTrainer`` on the JAX package's (the same parameters and
batch give the same losses), the gang restart from the last checkpoint, a
2-worker gloo DDP run, a single worker with no placement group, the flagship
loop's report (and its mixture-of-experts config), and a GPU trainer refusing a cluster with no card. One port
cluster for the module, always shut down; the parity test also boots one JAX
cluster, and shuts it down before it trains on the port's."""

import os

import jax
import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch as rt
from ray_tpu.models import transformer as jt
from ray_tpu_torch.air import session
from ray_tpu_torch.air.checkpoint import Checkpoint
from ray_tpu_torch.air.config import FailureConfig, RunConfig, ScalingConfig
from ray_tpu_torch.train.flagship_loop import train_loop
from ray_tpu_torch.train.torch import TorchTrainer

# bench.py's CPU config (bench.py:72-86): f32, no remat, unfused loss, batch 4.
CPU_MODEL = dict(vocab_size=1024, d_model=128, n_layers=2, n_heads=4, n_kv_heads=4, d_ff=256,
                 max_seq_len=128, remat=False, fused_loss=False, scan_unroll=2)
BATCH, SEQ, STEPS = 4, 128, 3
CPU = ScalingConfig(num_workers=1, use_gpu=False)


def _loss_reports(result) -> list[dict]:
    """Every rank-0 report that carried a loss, in order."""
    rows = result.metrics_dataframe.to_dict("records")
    return [{k: v for k, v in r.items() if v == v} for r in rows if r.get("loss") == r.get("loss")]


@pytest.fixture(scope="module")
def cluster():
    rt.init(num_cpus=4, object_store_memory=128 * 1024 * 1024)
    try:
        yield
    finally:
        rt.shutdown()


def test_losses_match_jax_trainer(cluster, tmp_path):
    """The same 3 steps through JaxTrainer (a JAX worker actor, jitted step)
    and through TorchTrainer (a port worker actor, eager step on the CPU):
    every reported loss within 1e-5 (test_torch_transformer.py's bar)."""
    from ray_tpu.air.config import RunConfig as JaxRunConfig
    from ray_tpu.air.config import ScalingConfig as JaxScalingConfig
    from ray_tpu.train.jax import JaxTrainer

    cfg_j = jt.TransformerConfig(**CPU_MODEL, dtype=jax.numpy.float32)
    np_params = jax.tree.map(np.asarray, jt.init_params(jax.random.PRNGKey(0), cfg_j))
    tokens = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (BATCH, SEQ + 1), 0, cfg_j.vocab_size))
    config = {"model": CPU_MODEL, "params": np_params, "tokens": tokens, "batch": BATCH, "seq": SEQ, "steps": STEPS}

    def jax_loop(config):
        import jax
        import jax.numpy as jnp
        import optax

        from ray_tpu.air import session as jax_session
        from ray_tpu.models.transformer import TransformerConfig, make_train_step

        cfg = TransformerConfig(**config["model"], dtype=jnp.float32)
        params = jax.tree.map(jnp.asarray, config["params"])
        opt = optax.adamw(1e-3)
        opt_state = opt.init(params)
        step = jax.jit(make_train_step(cfg, opt))
        batch = {"tokens": jnp.asarray(config["tokens"])}
        losses = []
        for i in range(config["steps"]):
            params, opt_state, loss = step(params, opt_state, batch)
            losses.append(float(loss))
            jax_session.report({"step": i, "loss": losses[-1]})
        jax_session.report({"losses": losses})

    from ray_tpu_torch._private.rpc import RpcClient

    ray_tpu.init(num_cpus=2, object_store_memory=128 * 1024 * 1024)
    try:
        want = JaxTrainer(
            jax_loop, train_loop_config=config, scaling_config=JaxScalingConfig(num_workers=1),
            run_config=JaxRunConfig(storage_path=str(tmp_path / "jax")),
        ).fit().metrics["losses"]
        # The port refuses the JAX package's GCS, which speaks the same wire protocol.
        gcs = RpcClient(tuple(ray_tpu._global_node.gcs_address), label="gcs")
        with pytest.raises(ConnectionError, match="not a ray_tpu_torch GCS"):
            rt._check_port_gcs(gcs)
    finally:
        ray_tpu.shutdown()

    result = TorchTrainer(
        train_loop,
        train_loop_config=dict(config, dtype="float32", warmup=STEPS, rounds=0),
        scaling_config=CPU,
        run_config=RunConfig(storage_path=str(tmp_path / "torch")),
    ).fit()
    got = [r["loss"] for r in _loss_reports(result)]
    assert len(want) == len(got) == STEPS
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert result.metrics["first_loss"] == got[0]


def test_flagship_loop_reports_its_totals(cluster, tmp_path):
    """Warm-up, then ABBA raw/framework chunks: every framework step's loss
    reported in order through the lagged logger, then the totals."""
    config = {"model": CPU_MODEL, "dtype": "float32", "batch": 2, "seq": 32, "warmup": 2,
              "rounds": 2, "chunk": 3, "lag": 2, "profile_steps": 1, "param_seed": 0, "batch_seed": 1}
    result = TorchTrainer(train_loop, train_loop_config=config, scaling_config=CPU,
                          run_config=RunConfig(storage_path=str(tmp_path))).fit()
    m = result.metrics
    reported = _loss_reports(result)
    assert [h["step"] for h in reported] == list(range(2 + 2 * 3))
    assert all(np.isfinite(h["loss"]) for h in reported)
    assert m["steps"] == 2 + 2 * 2 * 3 + 1 and m["device_name"] == "cpu"
    # the profiled step ran in the worker; the CPU has no device time
    assert m["pid"] != os.getpid() and m["device_us"] == {}
    assert m["first_loss"] == reported[0]["loss"]
    # the plain versions run on the CPU: no kernel was launched
    assert m["launches"] == {"flash_fwd": 0, "flash_bwd_dkv": 0, "flash_bwd_dq": 0}
    assert m["tokens_per_sec_framework"] > 0 and m["tokens_per_sec_raw"] > 0 and m["ratio"] > 0


def test_flagship_loop_trains_a_mixture_of_experts_model(cluster, tmp_path):
    """The loop takes an expert config unchanged: its first loss is the
    port's MoE loss on the same seeded weights and batch, computed here."""
    from ray_tpu_torch.models import transformer as tt

    model = dict(CPU_MODEL, num_experts=4, n_layers=1)
    config = {"model": model, "dtype": "float32", "batch": 2, "seq": 32, "warmup": 2, "rounds": 0,
              "param_seed": 0, "batch_seed": 1}
    result = TorchTrainer(train_loop, train_loop_config=config, scaling_config=CPU,
                          run_config=RunConfig(storage_path=str(tmp_path))).fit()
    cfg = tt.TransformerConfig(**model, dtype=torch.float32)
    params = tt.init_params(cfg, seed=0, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 33), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = tt.loss_fn(params, {"tokens": tokens}, cfg).item()
    m = result.metrics
    assert m["steps"] == 2 and m["n_params"] == tt.num_params(params)
    np.testing.assert_allclose(m["first_loss"], want, rtol=1e-6)


def test_gang_restarts_from_the_last_checkpoint(cluster, tmp_path):
    """A worker that dies restarts the whole gang from the last checkpoint
    (mirror of tests/test_train.py::test_trainer_failure_restart)."""
    marker = str(tmp_path / "crashed")

    def flaky_loop(config):
        import os as _os
        import time as _time

        from ray_tpu_torch.air import session as s

        ckpt = s.get_checkpoint()
        start = ckpt.to_dict()["epoch"] + 1 if ckpt else 0
        for epoch in range(start, 4):
            if epoch == 2 and not _os.path.exists(config["marker"]):
                with open(config["marker"], "w") as f:
                    f.write("1")
                _os._exit(1)
            s.report({"epoch": epoch, "resumed": start > 0}, checkpoint=Checkpoint.from_dict({"epoch": epoch}))
            _time.sleep(0.3)  # let the driver poll before a crash (like a real step)

    result = TorchTrainer(
        flaky_loop,
        train_loop_config={"marker": marker},
        scaling_config=CPU,
        run_config=RunConfig(storage_path=str(tmp_path), failure_config=FailureConfig(max_failures=2)),
    ).fit()
    assert result.metrics["epoch"] == 3
    assert result.metrics["resumed"] is True


def test_ddp_two_workers_over_gloo(cluster):
    """Two CPU workers form a gloo group; DDP keeps their weights equal
    (mirror of tests/test_train_torch.py::test_torch_trainer_ddp_two_workers)."""

    def loop(config):
        import torch as _torch
        import torch.distributed as dist

        from ray_tpu_torch.air import session as s
        from ray_tpu_torch.train.torch import prepare_model

        assert dist.is_initialized() and dist.get_world_size() == 2
        assert dist.get_backend() == "gloo" and s.get_device().type == "cpu"
        _torch.manual_seed(0)
        model = prepare_model(_torch.nn.Linear(4, 1))
        opt = _torch.optim.SGD(model.parameters(), lr=0.1)
        g = _torch.Generator().manual_seed(s.get_world_rank())
        X = _torch.randn(64, 4, generator=g)
        y = X @ _torch.tensor([[1.0], [2.0], [-1.0], [0.5]]) + 0.1
        loss = None
        for _ in range(20):
            opt.zero_grad()
            loss = _torch.nn.functional.mse_loss(model(X), y)
            loss.backward()  # DDP allreduces grads here
            opt.step()
        flat = _torch.cat([p.detach().reshape(-1) for p in model.parameters()])
        gathered = [_torch.zeros_like(flat) for _ in range(2)]
        dist.all_gather(gathered, flat)
        assert _torch.allclose(gathered[0], gathered[1], atol=1e-6)
        s.report({"loss": float(loss)})

    result = TorchTrainer(loop, scaling_config=ScalingConfig(num_workers=2, use_gpu=False)).fit()
    assert result.metrics["loss"] < 1.0


def test_single_worker_forms_no_group(cluster):
    """One worker: no process group, no placement group, the model passes
    through (mirror of tests/test_train_torch.py::test_torch_trainer_single_worker_no_pg)."""

    def loop(config):
        import torch as _torch
        import torch.distributed as dist

        from ray_tpu_torch.air import session as s
        from ray_tpu_torch.train.torch import prepare_batch, prepare_data_loader, prepare_model

        assert not dist.is_initialized()
        model = prepare_model(_torch.nn.Linear(2, 1))
        dl = prepare_data_loader(
            _torch.utils.data.DataLoader(
                _torch.utils.data.TensorDataset(_torch.randn(8, 2), _torch.randn(8, 1)), batch_size=4
            )
        )
        batch = prepare_batch({"x": [[1.0, 2.0]]})
        try:
            s.get_mesh()
            mesh = "built"
        except NotImplementedError:
            mesh = "not ported"
        s.report({"batches": sum(1 for _ in dl), "is_plain": isinstance(model, _torch.nn.Linear),
                  "batch_device": str(batch["x"].device), "mesh": mesh})

    from ray_tpu_torch._private.state import GlobalState

    before = len(GlobalState().placement_groups())
    result = TorchTrainer(loop, scaling_config=CPU).fit()
    assert result.metrics == {"batches": 2, "is_plain": True, "batch_device": "cpu", "mesh": "not ported"}
    assert len(GlobalState().placement_groups()) == before


def test_gpu_trainer_refuses_a_cluster_without_a_card(cluster):
    """The default ScalingConfig asks for a card; with none in the cluster,
    fit() raises before any worker starts, and never trains on the CPU."""
    if rt.cluster_resources().get("GPU"):
        pytest.skip("this cluster has a GPU")
    workers = set(rt._global_node.raylet.workers)
    with pytest.raises(RuntimeError, match="use_gpu=False"):
        TorchTrainer(train_loop, train_loop_config={}).fit()
    assert set(rt._global_node.raylet.workers) == workers
    assert ScalingConfig().use_gpu and ScalingConfig().worker_resources() == {"GPU": 1}
    assert session.in_session() is False
