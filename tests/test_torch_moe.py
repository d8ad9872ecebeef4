"""ray_tpu_torch's mixture-of-experts against the JAX package's.

The same inputs, made with numpy from a seed, go through
``ray_tpu.parallel.moe`` and ``ray_tpu_torch.parallel.moe``, and one set of
weights (the JAX ``init_params``, through ``params_from_jax``) through both
MoE transformers, f32 on the CPU (~35 s, most of it the JAX package's
compiles).

Tolerances: routing is decided by comparisons, so dispatch must be equal;
combine weights within 1e-6 (a softmax's rounding); layer output and aux
within 1e-5; the transformer's logits and losses 1e-5 and its gradients and
parameters after two AdamW steps as in ``tests/test_torch_transformer.py``
(1e-4 of each leaf's largest gradient; 1e-6 on parameters). The queue count
past 256 tokens is the one documented difference from the reference (its
bf16 count collides there): the port's bf16 routing must equal the f32
reference's, slot for slot.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.models import transformer as jt
from ray_tpu.parallel import moe as jm
from ray_tpu_torch.models import transformer as tt
from ray_tpu_torch.parallel import moe as tm

B, T, D, F, E = 2, 24, 16, 32, 4


def _layer_inputs(seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    params = {
        "gate": (rng.standard_normal((D, E)) * D**-0.5).astype(np.float32),
        "wi": (rng.standard_normal((E, D, F)) * D**-0.5).astype(np.float32),
        "wo": (rng.standard_normal((E, F, D)) * F**-0.5).astype(np.float32),
    }
    return x, params


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("capacity_factor", [0.5, float(E)], ids=["drops", "lossless"])
def test_routing_and_layer_match_jax(k, capacity_factor):
    x, params = _layer_inputs(k)
    capacity = max(1, int(capacity_factor * T * k / E))
    logits = x @ params["gate"]
    disp_j, comb_j = jm.top_k_routing(jnp.asarray(logits), E, capacity, k)
    disp_t, comb_t = tm.top_k_routing(torch.tensor(logits), E, capacity, k)
    np.testing.assert_array_equal(disp_t.numpy(), np.asarray(disp_j))
    np.testing.assert_allclose(comb_t.numpy(), np.asarray(comb_j), rtol=0, atol=1e-6)
    routed = disp_t.sum().item()
    if capacity_factor == E:
        assert routed == B * T * k, "lossless capacity dropped a token"
    else:
        assert routed < B * T * k, "the small capacity dropped nothing: the drop path went untested"

    out_j, aux_j = jm.moe_layer({n: jnp.asarray(v) for n, v in params.items()}, jnp.asarray(x),
                                capacity_factor=capacity_factor, k=k)
    out_t, aux_t = tm.moe_layer({n: torch.tensor(v) for n, v in params.items()}, torch.tensor(x),
                                capacity_factor=capacity_factor, k=k)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(aux_t.item(), float(aux_j), rtol=1e-5, atol=1e-5)


def test_queue_position_is_exact_past_256_tokens():
    """300 tokens of one row all choose expert 0, with capacity = T (the
    inference setting). The reference's bf16 cumsum cannot count past 256,
    so it gives two tokens one slot; the port counts in integers and its
    bf16 routing is the f32 reference's, slot for slot."""
    n = 300
    rng = np.random.default_rng(7)
    logits = rng.standard_normal((1, n, E)).astype(np.float32)
    logits[..., 0] += 20.0  # every token's first choice is expert 0
    want, _ = jm.top_k_routing(jnp.asarray(logits), E, n, 1)
    got, _ = tm.top_k_routing(torch.tensor(logits, dtype=torch.bfloat16), E, n, 1)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want))
    assert (got.float().sum(dim=1) <= 1).all(), "two tokens share a slot"
    # The documented difference: the JAX package's own bf16 routing collides.
    ref_bf16, _ = jm.top_k_routing(jnp.asarray(logits, jnp.bfloat16), E, n, 1)
    per_slot = np.asarray(ref_bf16.astype(jnp.float32)).sum(axis=1)  # [1, E, C]
    assert per_slot.max() > 1, "the reference's bf16 count no longer collides: update ROADMAP C"


SMALL = dict(vocab_size=128, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=48, max_seq_len=32,
             num_experts=E, expert_capacity_factor=1.25)


def _flat(tree) -> dict:
    out = {}
    for name, leaf in tree.items():
        if isinstance(leaf, dict):
            out.update({f"{name}/{n}": v for n, v in leaf.items()})
        else:
            out[name] = leaf
    return out


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@pytest.fixture(scope="module")
def jax_moe_run():
    """The JAX package's side, computed once: logits and aux, the fused and
    unfused loss with every gradient, and two ``optax.adamw`` steps."""
    cfg = jt.TransformerConfig(dtype=jnp.float32, remat=False, **SMALL)
    params = jt.init_params(jax.random.PRNGKey(0), cfg)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, size=(2, 33)).astype(np.int32)
    batch = {"tokens": jnp.asarray(tokens)}
    logits, aux = jax.jit(jt.forward, static_argnums=2)(params, batch["tokens"][:, :-1], cfg)
    grads = {}
    for fused in (True, False):
        c = dataclasses.replace(cfg, fused_loss=fused)
        grads[fused] = jax.jit(jax.value_and_grad(jt.loss_fn), static_argnums=2)(params, batch, c)
    opt = optax.adamw(1e-3)
    step = jax.jit(jt.make_train_step(cfg, opt))
    p, state, losses = params, opt.init(params), []
    for _ in range(2):
        p, state, loss = step(p, state, batch)
        losses.append(float(loss))
    return dict(np_params=jax.tree.map(np.asarray, params), tokens=tokens, logits=np.asarray(logits),
                aux=float(aux), grads=grads, losses=losses, stepped=_flat(p))


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_moe_transformer_loss_grads_and_adamw_match_jax(jax_moe_run, remat):
    """Logits and aux, the fused and unfused loss (each + 0.01 aux) and every
    gradient, then the parameters after two AdamW steps against
    ``optax.adamw``: ``wg_e``, which no path reads, gets a zero gradient in
    both and only weight decay moves it. ``remat`` (the port's per-layer
    checkpoint, which carries the aux out of each layer) changes no value."""
    ref = jax_moe_run
    np_params = ref["np_params"]
    cfg = tt.TransformerConfig(dtype=torch.float32, remat=remat, **SMALL)
    batch = {"tokens": torch.tensor(ref["tokens"])}

    params = tt.params_from_jax(np_params, cfg, device="cpu")
    with torch.no_grad():
        logits, aux = tt.forward(params, batch["tokens"][:, :-1], cfg)
    np.testing.assert_allclose(logits.numpy(), ref["logits"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(aux.item(), ref["aux"], rtol=1e-5, atol=1e-5)
    assert ref["aux"] > 0

    for fused in (True, False):
        loss_j, grads_j = ref["grads"][fused]
        params = tt.params_from_jax(np_params, cfg, device="cpu")
        loss = tt.loss_fn(params, batch, dataclasses.replace(cfg, fused_loss=fused))
        loss.backward()
        np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-5, atol=1e-5)
        grads_j = _flat(grads_j)
        for name, p in _flat(params).items():
            want = np.asarray(grads_j[name])
            scale = np.abs(want).max()
            if scale == 0:  # wg_e: no path reads it
                assert name == "layers/wg_e" and p.grad is None
                continue
            assert np.abs(p.grad.numpy() - want).max() / scale < 1e-4, f"fused={fused} grad {name}"

    params = tt.params_from_jax(np_params, cfg, device="cpu")
    step = tt.make_train_step(cfg, tt.adamw(params), device="cpu")
    for want_loss in ref["losses"]:
        np.testing.assert_allclose(float(step(params, batch)), want_loss, rtol=1e-5, atol=1e-5)
    got, want = _flat(params), ref["stepped"]
    # wg_e moved by weight decay alone, the same in both.
    assert not np.array_equal(_np(got["layers/wg_e"]), np_params["layers"]["wg_e"])
    grads0 = _flat(ref["grads"][cfg.fused_loss][1])
    for name in want:
        g = np.abs(np.asarray(grads0[name]))
        settled = (g <= 1e-10) | (g >= 1e-6)  # see tests/test_torch_transformer.py
        assert settled.mean() > 0.9, name
        np.testing.assert_allclose(_np(got[name])[settled], _np(want[name])[settled], rtol=1e-6, atol=1e-6,
                                   err_msg=name)


def test_init_params_moe_layout_matches_jax():
    cfg_j = jt.TransformerConfig(dtype=jnp.float32, **SMALL)
    cfg_t = tt.TransformerConfig(dtype=torch.float32, **SMALL)
    pj = jt.init_params(jax.random.PRNGKey(0), cfg_j)
    pt = tt.init_params(cfg_t, seed=0, device="cpu")
    assert {n: tuple(v.shape) for n, v in _flat(pt).items()} == {n: tuple(v.shape) for n, v in _flat(pj).items()}
    assert tt.num_params(pt) == jt.num_params(pj)
    # The reference's scales, to a few percent at these sizes.
    for name in ("gate", "wi_e", "wg_e", "wo_e"):
        std_j, std_t = float(np.asarray(pj["layers"][name]).std()), pt["layers"][name].std().item()
        assert abs(std_t / std_j - 1) < 0.05, name
    params = tm.init_moe_params(D, F, E, device="cpu")
    assert {n: tuple(v.shape) for n, v in params.items()} == {"gate": (D, E), "wi": (E, D, F), "wo": (E, F, D)}
