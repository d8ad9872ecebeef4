"""ray_tpu_torch's sharded train step, multichip dryrun and sharded
checkpoints against the JAX package's.

The sharded step: one f32 AdamW step of the dryrun's tiny transformer at
dp 2 x tp 2 (dense; fused and unfused loss) and at sp 2 x ep 2 (ring
attention, 2 experts), on the
port's 4 gloo ranks (one module-scoped ``RankPool``) and through
``__graft_entry__._sharded_step`` on 4 of the conftest's 8 virtual CPU
devices, from the same weights (JAX's ``init_params``, through
``params_from_jax``) and tokens. Loss within 1e-5; updated parameters within
1e-6 where the step's gradient is settled (|g| <= 1e-10 or >= 1e-6), the bars
of ``test_torch_transformer.py``. Then ``dryrun_multichip(4, device="cpu")``,
and the counterparts of ``tests/test_sharded_checkpoint.py``'s five cases
(the reshard on the pool: saved on tp 2 x dp 2, restored onto tp 4). About
60 s on an 8-core CPU host, most of it JAX's compiles of the sharded steps.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
import torch_parallel_ranks as ranks
from ray_tpu.models import transformer as jt
from ray_tpu.parallel.mesh import MeshConfig, create_mesh
from ray_tpu_torch.parallel.multichip import RankPool, dryrun_multichip, pass_configs
from ray_tpu_torch.train.torch.checkpointing import TrainCheckpointer, restore_sharded, save_sharded

N = 4


@pytest.fixture(scope="module")
def pool():
    with RankPool(N) as p:
        yield p


def _flat(tree):
    out = {n: np.asarray(v) for n, v in tree.items() if n != "layers"}
    out.update({f"layers.{n}": np.asarray(v) for n, v in tree["layers"].items()})
    return out


def _jax_sharded_step(spec, monkeypatch):
    """__graft_entry__._sharded_step on a 4-device mesh, with jax.jit
    wrapped to keep the step's outputs: (loss, updated params, the weights
    and tokens it drew, the step's gradient)."""
    cfg = jt.TransformerConfig(**spec["model"], dtype=jnp.float32)
    mesh = create_mesh(MeshConfig(**spec["mesh"]), devices=jax.devices()[:N])
    real_jit, outs = jax.jit, []

    def keeping_jit(fn, *a, **kw):
        jitted = real_jit(fn, *a, **kw)
        return lambda *args: outs.append(jitted(*args)) or outs[-1]

    monkeypatch.setattr(jax, "jit", keeping_jit)
    loss = __graft_entry__._sharded_step(mesh, cfg, attn_impl=spec["attn_impl"], batch=spec["batch"],
                                         seq=spec["seq"])
    monkeypatch.undo()
    params0 = jt.init_params(jax.random.PRNGKey(0), cfg)  # the draws _sharded_step makes
    tokens = jax.random.randint(jax.random.PRNGKey(1), (spec["batch"], spec["seq"] + 1), 0, cfg.vocab_size)
    grads = jax.jit(jax.grad(jt.loss_fn), static_argnums=2)(params0, {"tokens": tokens}, cfg)
    return loss, _flat(outs[-1][0]), jax.tree.map(np.asarray, params0), np.asarray(tokens), _flat(grads)


@pytest.mark.parametrize("which,fused", [(0, True), (0, False), (1, True)],
                         ids=["dp2xtp2", "dp2xtp2-unfused", "sp2xep2-ring-moe"])
def test_sharded_step_matches_jax(pool, monkeypatch, which, fused):
    """The dryrun's two passes, and the first with the unfused loss
    (log_softmax over the tp-sharded vocabulary)."""
    spec = pass_configs(N)[which]
    spec = dict(spec, model=dict(spec["model"], fused_loss=fused))
    assert spec["mesh"] == ({"dp": 2, "tp": 2, "pp": 1}, {"sp": 2, "ep": 2})[which]
    loss_j, want, params0, tokens, grads = _jax_sharded_step(spec, monkeypatch)
    results = pool.run(ranks.sharded_step, spec, params0, tokens)
    for loss_t, got in results:
        np.testing.assert_allclose(loss_t, loss_j, rtol=1e-5, atol=1e-5)
        assert sorted(got) == sorted(want)
        for name in want:
            g = np.abs(grads[name])
            settled = (g <= 1e-10) | (g >= 1e-6)
            assert settled.mean() > 0.9, name
            np.testing.assert_allclose(got[name][settled], want[name][settled], rtol=1e-6, atol=1e-6, err_msg=name)
    assert len({r[0] for r in results}) == 1, "ranks disagree on the loss"


def test_dryrun_multichip_runs_both_passes(capsys):
    line = dryrun_multichip(N, device="cpu")
    assert capsys.readouterr().out.strip() == line
    assert line.startswith("dryrun_multichip(4): pass1(dp=2,tp=2,pp=1) loss=")
    assert "; pass2(sp=2,ep=2,moe) loss=" in line
    losses = [float(part.split("loss=")[1]) for part in line.split(";")]
    assert all(np.isfinite(losses)) and all(4.0 < x < 7.0 for x in losses), losses  # ~ln(256) at random weights


def test_reshard_on_restore(pool, tmp_path):
    """Flagship params sharded tp 2 x dp 2 survive a round trip onto a
    reshaped mesh (tp 4): values equal, and the new placements."""
    model = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=4, d_ff=128, remat=False)
    cfg = jt.TransformerConfig(**model, dtype=jnp.float32)
    params = jax.tree.map(np.asarray, jt.init_params(jax.random.PRNGKey(0), cfg))
    results = pool.run(ranks.reshard_checkpoint, str(tmp_path / "ck"), params, model, {"tp": 2, "dp": 2}, {"tp": 4})
    for got, (names, placements) in results:
        for name, arr in _flat(params).items():
            np.testing.assert_array_equal(got[name], arr, err_msg=name)
        assert names == ("tp",) and placements == ("Shard(dim=2)",)


def test_train_checkpointer_retention(tmp_path):
    ck = TrainCheckpointer(str(tmp_path / "run"), keep=2)
    tree = {"w": torch.arange(8.0), "step": torch.tensor(0, dtype=torch.int32)}
    for step in (1, 5, 9, 12):
        ck.save(step, {**tree, "step": torch.tensor(step, dtype=torch.int32)})
    assert ck.latest_step() == 12
    assert ck._steps() == [9, 12]  # keep=2 reaped 1 and 5
    got = ck.restore()
    assert int(got["step"]) == 12 and torch.equal(got["w"], tree["w"])
    assert int(ck.restore(step=9)["step"]) == 9
    with pytest.raises(FileNotFoundError):
        TrainCheckpointer(str(tmp_path / "empty")).restore()


def test_rollback_save_is_not_self_deleting(tmp_path):
    """Retention and latest rank by save recency: after a rollback, saving a
    lower step must not delete itself, and resume picks the rollback
    lineage, not a stale higher-numbered future step."""
    ck = TrainCheckpointer(str(tmp_path / "run"), keep=2)
    for step in (9, 12):
        ck.save(step, {"step": torch.tensor(step)})
    ck.save(10, {"step": torch.tensor(10)})  # rollback to 9, continue from 10
    assert 10 in ck._steps()
    assert ck.latest_step() == 10
    assert int(ck.restore()["step"]) == 10
    ck.save(11, {"step": torch.tensor(11)})
    assert sorted(ck._steps()) == [10, 11]  # stale step_12 finally reaped


def test_interrupted_swap_recovers_on_read(tmp_path):
    """A crash between save_sharded's two renames leaves only path + '.old';
    the next read finishes the swap instead of losing the checkpoint."""
    path = str(tmp_path / "ck")
    save_sharded(path, {"w": torch.arange(4.0)})
    os.rename(path, path + ".old")
    got = restore_sharded(path)
    np.testing.assert_array_equal(got["w"].numpy(), np.arange(4.0))
    assert os.path.exists(path) and not os.path.exists(path + ".old")


def test_overwrite_is_durable_swap(tmp_path):
    """Re-saving the same path keeps data consistent and leaves no tmp
    residue; ``like`` restores into its own layout (dtype and shape as
    saved, the values the new ones)."""
    path = str(tmp_path / "ck")
    save_sharded(path, {"w": torch.zeros(4)})
    save_sharded(path, {"w": torch.ones(4)})
    np.testing.assert_array_equal(restore_sharded(path)["w"].numpy(), np.ones(4))
    np.testing.assert_array_equal(restore_sharded(path, like={"w": torch.empty(4)})["w"].numpy(), np.ones(4))
    assert sorted(os.listdir(tmp_path)) == ["ck"]
