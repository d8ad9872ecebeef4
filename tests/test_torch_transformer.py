"""ray_tpu_torch's flagship transformer against the JAX package's.

One set of weights (the JAX ``init_params``, carried over by
``params_from_jax``) and one seeded token batch go through both packages, f32
on the CPU: logits, the loss (fused and unfused), every gradient leaf, and the
parameters after two AdamW steps (``optax.adamw(1e-3)`` against the port's
``adamw``).

Tolerances: 1e-5 absolute (plus 1e-5 relative) on logits and losses, where
only the summation order differs; 1e-4 relative to each leaf's largest
element on gradients, the JAX package's own bar; 1e-6 absolute plus 1e-6
relative on parameters after two steps, which is ~1e-3 of one AdamW step of
lr 1e-3. Adam's first step is lr * g / (|g| + eps) with eps 1e-8, so for an
element whose gradient is within 100x of eps either way, a rounding-level
difference in g moves the step by up to ~1e-2 of lr: those few elements are
left out of the parameter comparison, and their gradients are held to the
bar above.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.models import transformer as jt
from ray_tpu_torch.models import transformer as tt

B, T = 2, 64
SMALL = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4, d_ff=128, max_seq_len=T)


def _configs(kv_heads, window, remat, tie):
    kw = dict(SMALL, n_kv_heads=kv_heads, sliding_window=window, remat=remat, tie_embeddings=tie)
    return (
        jt.TransformerConfig(dtype=jnp.float32, **kw),
        tt.TransformerConfig(dtype=torch.float32, **kw),
    )


def _flat(tree) -> dict:
    """{"embed": a, "layers/wq": b, ...} for a params dict of either package."""
    out = {}
    for name, leaf in tree.items():
        if isinstance(leaf, dict):
            out.update({f"{name}/{n}": v for n, v in leaf.items()})
        else:
            out[name] = leaf
    return out


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _assert_leaves_close(got: dict, want: dict, what: str):
    got, want = _flat(got), _flat(want)
    assert set(got) == set(want)
    for name in want:
        a, b = _np(got[name]), _np(want[name])
        rel = float(np.abs(a - b).max() / (np.abs(b).max() + 1e-12))
        assert rel < 1e-4, f"{what} {name}: relative error {rel}"


@pytest.mark.parametrize(
    "kv_heads,window,remat,tie",
    [
        (4, 0, False, False),  # MHA
        (2, 0, True, False),  # GQA, remat
        (4, 16, True, True),  # sliding window, tied embeddings
        (2, 16, False, True),
    ],
    ids=["mha", "gqa-remat", "window-remat-tied", "gqa-window-tied"],
)
def test_transformer_matches_jax(kv_heads, window, remat, tie):
    cfg_j, cfg_t = _configs(kv_heads, window, remat, tie)
    params_j = jt.init_params(jax.random.PRNGKey(0), cfg_j)
    np_params = jax.tree.map(np.asarray, params_j)
    tokens = np.random.default_rng(0).integers(0, cfg_j.vocab_size, size=(B, T + 1)).astype(np.int32)
    batch_j, batch_t = {"tokens": jnp.asarray(tokens)}, {"tokens": torch.tensor(tokens)}

    # forward logits
    params_t = tt.params_from_jax(np_params, cfg_t, device="cpu")
    logits_j, _ = jt.forward(params_j, batch_j["tokens"][:, :-1], cfg_j)
    with torch.no_grad():
        logits_t, _ = tt.forward(params_t, batch_t["tokens"][:, :-1], cfg_t)
    np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j), rtol=1e-5, atol=1e-5)

    # loss and every gradient leaf, fused and unfused
    grads0 = None
    for fused in (True, False):
        cj, ct = (dataclasses.replace(c, fused_loss=fused) for c in (cfg_j, cfg_t))
        loss_j, grads_j = jax.value_and_grad(jt.loss_fn)(params_j, batch_j, cj)
        params_t = tt.params_from_jax(np_params, ct, device="cpu")
        loss_t = tt.loss_fn(params_t, batch_t, ct)
        loss_t.backward()
        np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-5, atol=1e-5)
        grads_t = {n: p.grad for n, p in _flat(params_t).items()}
        _assert_leaves_close(grads_t, _flat(grads_j), f"fused={fused} grad")
        if fused == cfg_j.fused_loss:
            grads0 = _flat(grads_j)

    # two AdamW steps
    opt = optax.adamw(1e-3)
    step_j = jax.jit(jt.make_train_step(cfg_j, opt))
    pj, opt_state = params_j, opt.init(params_j)
    params_t = tt.params_from_jax(np_params, cfg_t, device="cpu")
    step_t = tt.make_train_step(cfg_t, tt.adamw(params_t), device="cpu")
    for _ in range(2):
        pj, opt_state, loss_j = step_j(pj, opt_state, batch_j)
        loss_t = step_t(params_t, batch_t)
        np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5, atol=1e-5)
    got, want = _flat(params_t), _flat(pj)
    for name in want:
        g = np.abs(np.asarray(grads0[name]))
        settled = (g <= 1e-10) | (g >= 1e-6)
        assert settled.mean() > 0.9, name
        np.testing.assert_allclose(_np(got[name])[settled], _np(want[name])[settled], rtol=1e-6, atol=1e-6, err_msg=name)


def test_entry_points_refuse_what_is_not_ported():
    """Without a mesh, ``attn_impl="ring"`` (or ``"ulysses"``) is the flash
    path, as in the JAX package (its ring branch needs ``sp`` > 1): the same
    logits as ``"auto"``, bit for bit; sliding-window attention under a ring
    over sp > 1 still refuses. (tests/test_torch_parallel.py and
    test_torch_sharded_step.py hold the mesh paths.)"""
    cfg = tt.TransformerConfig(**dict(SMALL, n_kv_heads=2))
    params = tt.init_params(cfg, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (1, 8), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        want, _ = tt.forward(params, tokens, cfg)
        for impl in ("ring", "ulysses"):
            got, _ = tt.forward(params, tokens, cfg, attn_impl=impl)
            assert torch.equal(got, want), impl

    class SpMesh:
        shape = {"pp": 1, "dp": 1, "fsdp": 1, "sp": 2, "ep": 1, "tp": 1}

    q = torch.zeros(1, 8, 2, 16)
    with pytest.raises(NotImplementedError, match="sliding_window"):
        tt._attend(q, q, q, dataclasses.replace(cfg, sliding_window=4), SpMesh(), "ring")


def test_moe_forward_and_loss_match_jax():
    """The mixture-of-experts branch (4 experts, top-1, capacity factor
    1.25): logits, the aux summed over layers, and the loss with 0.01 aux,
    at the bars above. tests/test_torch_moe.py holds its gradients and
    AdamW steps."""
    kw = dict(SMALL, n_layers=1, n_kv_heads=2, num_experts=4)
    cfg_j, cfg_t = jt.TransformerConfig(dtype=jnp.float32, **kw), tt.TransformerConfig(dtype=torch.float32, **kw)
    params_j = jt.init_params(jax.random.PRNGKey(3), cfg_j)
    params_t = tt.params_from_jax(jax.tree.map(np.asarray, params_j), cfg_t, device="cpu")
    tokens = np.random.default_rng(3).integers(0, cfg_j.vocab_size, size=(B, T + 1)).astype(np.int32)
    logits_j, aux_j = jax.jit(jt.forward, static_argnums=2)(params_j, jnp.asarray(tokens[:, :-1]), cfg_j)
    loss_j = jax.jit(jt.loss_fn, static_argnums=2)(params_j, {"tokens": jnp.asarray(tokens)}, cfg_j)
    with torch.no_grad():
        logits_t, aux_t = tt.forward(params_t, torch.tensor(tokens[:, :-1]), cfg_t)
        loss_t = tt.loss_fn(params_t, {"tokens": torch.tensor(tokens)}, cfg_t)
    np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(aux_t.item(), float(aux_j), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-5, atol=1e-5)


def test_init_params_layout_and_count():
    """init_params gives the JAX package's layout, shapes and parameter count."""
    for tie in (False, True):
        cfg_j, cfg_t = _configs(2, 0, True, tie)
        pj = jt.init_params(jax.random.PRNGKey(0), cfg_j)
        pt = tt.init_params(cfg_t, seed=0, device="cpu")
        shapes_j = {n: tuple(v.shape) for n, v in _flat(pj).items()}
        shapes_t = {n: tuple(v.shape) for n, v in _flat(pt).items()}
        assert shapes_t == shapes_j
        assert tt.num_params(pt) == jt.num_params(pj)
        assert all(p.dtype == torch.float32 and p.requires_grad for p in tt.param_leaves(pt))
