"""V-trace targets (Espeholt et al. 2018) — shared by IMPALA and APPO.

Reference: rllib/algorithms/impala/vtrace_torch.py:
    rho_t = min(rho_bar, pi(a|s)/mu(a|s));  c_t = min(c_bar, rho_t)
    delta_t = rho_t (r_t + gamma V(s_{t+1}) - V(s_t))
    vs_t = V(s_t) + delta_t + gamma c_t (vs_{t+1} - V(s_{t+1}))
    pg_adv_t = rho_t (r_t + gamma vs_{t+1} - V(s_t))
over a flat batch of concatenated rollout fragments; episode ends (dones)
and fragment cuts reset the recursion, with bootstrap values riding in the
batch (NEXT_VF_PREDS).

The JAX package runs the backward recursion ``acc_t = delta_t + gamma c_t
mask_t acc_{t+1}`` as a ``lax.scan`` over rows. A row at a time would be
thousands of launches an update on the card, so here the linear recurrence
is a log-depth associative scan (Hillis-Steele): each of the ceil(log2 n)
steps composes every row's affine map ``acc -> a acc + b`` with the one
``2^k`` rows later. It reorders the f32 sums against the sequential scan,
so the two agree to rounding, not bit for bit.
"""

from __future__ import annotations

import torch


def discounted_scan(deltas: torch.Tensor, decay: torch.Tensor) -> torch.Tensor:
    """``acc_t = deltas_t + decay_t * acc_{t+1}`` with ``acc_n = 0``, for
    every t, in ceil(log2 n) vector steps."""
    a, b = decay.flip(0), deltas.flip(0)  # reversed: y_i = a_i y_{i-1} + b_i
    n, d = b.shape[0], 1
    while d < n:
        b = torch.cat([b[:d], a[d:] * b[:-d] + b[d:]])
        a = torch.cat([a[:d], a[d:] * a[:-d]])
        d *= 2
    return b.flip(0)


def vtrace(values_sg, next_values, logp, behavior_logp, rewards, nonterminal, cuts,
           gamma: float, rho_bar: float, c_bar: float):
    """Returns (vs, pg_adv, rho), none carrying a gradient (the reference
    stop-gradients rho, vs and pg_adv; pass detached values)."""
    with torch.no_grad():
        carry_mask = nonterminal * (1.0 - cuts)
        rho = torch.clamp(torch.exp(logp - behavior_logp), max=rho_bar)
        c = torch.clamp(rho, max=c_bar)
        deltas = rho * (rewards + gamma * next_values - values_sg)
        vs = values_sg + discounted_scan(deltas, gamma * c * carry_mask)
        # vs_{t+1}: next row's vs inside a fragment; the bootstrap value at a
        # fragment cut; 0 past a terminal.
        vs_shift = torch.cat([vs[1:], vs[-1:]])
        vs_next = torch.where(cuts > 0, next_values, vs_shift) * nonterminal
        pg_adv = rho * (rewards + gamma * vs_next - values_sg)
    return vs, pg_adv, rho
