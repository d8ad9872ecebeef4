"""The port's two data paths on the CPU, against the JAX package's.

- Ingest: a dataset (seeded token rows, ``from_numpy`` in blocks,
  ``map_batches`` splitting inputs and targets, ``random_shuffle(seed=0)``)
  feeds ``TorchTrainer(datasets=...)`` running ``flagship_loop.dataset_loop``
  on a 2-layer flagship config in f32 on the CPU; ``JaxTrainer`` is fed the
  same rows through ``ray_tpu.data`` and the same weights (``params_from_jax``).
  Every step's loss within 1e-5 (``tests/test_torch_train.py``'s bar), the
  same rows in the same order, and the worker's shard a port ``Dataset``.
- Batch inference: ``BatchPredictor`` + ``TorchPredictor`` over the port's
  ``ViT_Tiny`` (``vit_params_from_jax``; attention through the forward
  kernel's plain version on the CPU) against ``BatchPredictor`` +
  ``JaxPredictor`` over the flax ``ViT_Tiny``, on the same seeded images:
  predictions within 1e-5 (``tests/test_torch_zoo.py``'s bar on logits).

One port cluster and one JAX cluster for the module; ~40 s here, most of it
the JAX compiles and the workers' start.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import ray_tpu
import ray_tpu.data as jd
import ray_tpu_torch as rt
import ray_tpu_torch.data as rd
from ray_tpu.models import transformer as jt
from ray_tpu.models import vit as jvit
from ray_tpu_torch.air.config import RunConfig, ScalingConfig
from ray_tpu_torch.models import vit as tvit
from ray_tpu_torch.train.flagship_loop import dataset_loop
from ray_tpu_torch.train.torch import TorchTrainer

# tests/test_torch_train.py's CPU config (bench.py's, 2 layers): f32, no remat, unfused loss.
CPU_MODEL = dict(vocab_size=1024, d_model=128, n_layers=2, n_heads=4, n_kv_heads=4, d_ff=256,
                 max_seq_len=128, remat=False, fused_loss=False, scan_unroll=2)
BATCH, SEQ, ROWS, BLOCKS = 4, 64, 24, 4
CLOSE = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def clusters():
    rt.init(num_cpus=4, object_store_memory=128 * 1024 * 1024)
    ray_tpu.init(num_cpus=4, object_store_memory=128 * 1024 * 1024)
    try:
        yield
    finally:
        ray_tpu.shutdown()
        rt.shutdown()


def _token_dataset(pkg):
    tokens = np.random.default_rng(1).integers(0, CPU_MODEL["vocab_size"], (ROWS, SEQ + 1)).astype(np.int32)
    return (pkg.from_numpy(np.split(tokens, BLOCKS))
            .map_batches(lambda b: {"inputs": b["data"][:, :-1], "targets": b["data"][:, 1:]})
            .random_shuffle(seed=0))


def test_dataset_feeds_torch_trainer_like_jax_trainer(clusters, tmp_path):
    from ray_tpu.air.config import RunConfig as JaxRunConfig
    from ray_tpu.air.config import ScalingConfig as JaxScalingConfig
    from ray_tpu.train.jax import JaxTrainer

    cfg_j = jt.TransformerConfig(**CPU_MODEL, dtype=jnp.float32)
    np_params = jax.tree.map(np.asarray, jt.init_params(jax.random.PRNGKey(0), cfg_j))

    def jax_loop(config):
        import jax
        import jax.numpy as jnp
        import numpy as np
        import optax

        from ray_tpu.air import session as jax_session
        from ray_tpu.models.transformer import TransformerConfig, make_train_step

        cfg = TransformerConfig(**config["model"], dtype=jnp.float32)
        params = jax.tree.map(jnp.asarray, config["params"])
        opt = optax.adamw(1e-3)
        opt_state = opt.init(params)
        step = jax.jit(make_train_step(cfg, opt))
        losses, keys = [], []
        for b in jax_session.get_dataset_shard("train").iter_batches(batch_size=config["batch"], drop_last=True):
            keys += b["inputs"][:, :4].tolist()
            tokens = np.concatenate([b["inputs"], b["targets"][:, -1:]], axis=1)
            params, opt_state, loss = step(params, opt_state, {"tokens": jnp.asarray(tokens)})
            losses.append(float(loss))
        jax_session.report({"losses": losses, "row_keys": keys})

    want = JaxTrainer(
        jax_loop, train_loop_config={"model": CPU_MODEL, "params": np_params, "batch": BATCH},
        scaling_config=JaxScalingConfig(num_workers=1), datasets={"train": _token_dataset(jd)},
        run_config=JaxRunConfig(storage_path=str(tmp_path / "jax")),
    ).fit().metrics

    ds = _token_dataset(rd)
    got = TorchTrainer(
        dataset_loop, train_loop_config={"model": CPU_MODEL, "params": np_params, "batch": BATCH, "dtype": "float32"},
        scaling_config=ScalingConfig(num_workers=1, use_gpu=False), datasets={"train": ds},
        run_config=RunConfig(storage_path=str(tmp_path / "torch")),
    ).fit().metrics
    assert got["steps"] == len(want["losses"]) == ROWS // BATCH
    assert got["row_keys"] == want["row_keys"]
    assert len({tuple(k) for k in got["row_keys"]}) == ROWS
    np.testing.assert_allclose(got["losses"], want["losses"], **CLOSE)
    assert got["batch_devices"] == ["cpu"] and got["first_loss"] == got["losses"][0]
    assert got["launches"] == {"flash_fwd": 0, "flash_bwd_dkv": 0, "flash_bwd_dq": 0}
    assert len(got["wait_ms"]) == got["steps"] and len(got["step_ms"]) == got["steps"]
    # The driver takes the same first batch from the same dataset.
    assert ds.take_batch(BATCH)["inputs"][:, :4].tolist() == got["row_keys"][:BATCH]


def test_trainer_passes_a_dataset_shard_through_unchanged(clusters):
    """``_shards_per_rank`` splits a port Dataset into port Datasets: the
    object ``session.get_dataset_shard`` returns in each worker."""
    from ray_tpu_torch.train.data_parallel_trainer import DataParallelTrainer

    ds = rd.range(10, parallelism=2)
    trainer = DataParallelTrainer(lambda c: None, scaling_config=ScalingConfig(num_workers=2, use_gpu=False),
                                  datasets={"train": ds, "const": {"k": 1}})
    shards = trainer._shards_per_rank()
    assert [type(s["train"]) for s in shards] == [rd.Dataset, rd.Dataset]
    assert [s["train"].count() for s in shards] == [5, 5]
    assert shards[0]["const"] == {"k": 1}


def _image_dataset(pkg):
    images = np.random.default_rng(5).integers(0, 256, (12, 32, 32, 3)).astype(np.uint8)
    return pkg.from_numpy(np.split(images, 3), column="image").map_batches(
        lambda b: {"image": (b["image"].astype(np.float32) / 255.0 - 0.5) / 0.25})


def test_batch_predictor_over_vit_matches_jax_predictor(clusters):
    from ray_tpu.air.checkpoint import Checkpoint as JaxCheckpoint
    from ray_tpu.train import BatchPredictor as JaxBatchPredictor
    from ray_tpu.train import JaxPredictor
    from ray_tpu_torch.air.checkpoint import Checkpoint
    from ray_tpu_torch.train import BatchPredictor, TorchPredictor

    model_j = jvit.ViT_Tiny(dtype=jnp.float32)
    variables = jax.tree.map(np.asarray, jax.jit(model_j.init)(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3))))
    variables["params"]["cls"] = np.random.default_rng(2).standard_normal((1, 1, 64)).astype(np.float32)

    ckpt_j = JaxCheckpoint.from_dict({"params": variables, "apply_fn": lambda v, x: model_j.apply(v, x)})
    want = JaxBatchPredictor.from_checkpoint(ckpt_j, JaxPredictor, input_column="image").predict(
        _image_dataset(jd), batch_size=4, max_scoring_workers=1)
    want = np.stack([r["predictions"] for r in want.take_all()])

    def vit_tiny_apply(params, images):
        """flax's ``model.apply`` for the port's ViT_Tiny: its forward with
        ``params`` (a state dict) as the weights."""
        import torch
        from torch.func import functional_call

        from ray_tpu_torch.models import vit

        skeleton = vit.ViT_Tiny(dtype=torch.float32, image_size=32, device="meta")
        return functional_call(skeleton, params, (images,))

    state = {k: v.numpy() for k, v in tvit.vit_params_from_jax(variables).items()}
    ckpt = Checkpoint.from_dict({"params": state, "apply_fn": vit_tiny_apply})
    scored = BatchPredictor.from_checkpoint(ckpt, TorchPredictor, input_column="image", device="cpu").predict(
        _image_dataset(rd), batch_size=4, max_scoring_workers=1)
    got = np.stack([r["predictions"] for r in scored.take_all()])
    assert got.shape == want.shape == (12, 10) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, **CLOSE)
