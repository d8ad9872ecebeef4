"""KV-cache inference for the flagship transformer: prefill, decode, sample.

Counterpart of ``ray_tpu/models/generate.py`` on the same parameters
(``models/transformer.py``): the same layer math, masks, cache layouts and
sampling rules, so one set of weights (``params_from_jax``) gives both
packages the same logits and the same greedy tokens.

- The cache is preallocated at ``max_len`` (dense: ``[L, B, S, KV, Dh]``;
  paged: a block pool ``[L, num_blocks, block_size, KV, Dh]`` read through
  per-sequence block tables) and masked by position, as in the JAX package.
- Prefill attends densely over the prompt rows only; decode attends its
  rows against the cache with a position mask. GQA caches are read at KV
  width through grouped matmuls, never repeated to H heads.
- Attention is ``_cache_attention``: plain PyTorch matmuls with f32 scores,
  an f32 softmax and P cast to the cache dtype. The JAX package runs no
  Pallas kernel on this path either.

Where the JAX functions return a new cache, these write K/V IN PLACE into
the cache tensors they are given and return the same dict: a caller that
feeds one initial cache to two paths clones it first. Every entry point runs
under ``torch.no_grad()`` (grad mode is per thread, so a caller's context is
not relied on), and the loops are Python loops of eager PyTorch where the
JAX package has ``lax.scan`` and ``lax.while_loop`` under ``jit``.
Randomness comes from a ``torch.Generator`` on the parameters' device in
place of a JAX ``key``: ``key`` is a seed, a generator, or None (seed 0).

A mixture-of-experts model (``num_experts > 0``) routes LOSSLESSLY here:
capacity equals the tokens fed per row, so every token gets a slot, routing
is per token and independent of padding, ragged rows behave as solo rows,
and prefill agrees with one-token decode. Training's capacity drops are an
efficiency trade that inference does not make. Not in this package yet:
tensor-parallel parameters.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ray_tpu_torch.models.transformer import (
    TransformerConfig,
    _device,
    _head,
    _moe_mlp,
    _rms_norm,
    _rope_apply,
    _rope_tables,
)


def _zeros_cache(cfg: TransformerConfig, shape, device) -> dict:
    dev = _device(device)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=dev)}


def init_cache(cfg: TransformerConfig, batch: int, max_len: int, *, device="cuda") -> dict:
    """Preallocated KV cache: k/v of shape [L, B, max_len, KV, Dh] in the
    activation dtype (bf16 by default: cache reads are the decode bill)."""
    return _zeros_cache(cfg, (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim), device)


def init_paged_cache(cfg: TransformerConfig, num_blocks: int, block_size: int, *, device="cuda") -> dict:
    """Block-pool KV cache for continuous-batching serving: k/v of shape
    [L, num_blocks, block_size, KV, Dh]. Physical block 0 is RESERVED as the
    null block: allocators never hand it out. Inactive decode slots and
    write-masked prefill padding rows are routed there."""
    return _zeros_cache(cfg, (cfg.n_layers, num_blocks, block_size, cfg.n_kv_heads, cfg.head_dim), device)


def _layer_params(params: dict, i: int) -> dict:
    return {n: w[i] for n, w in params["layers"].items()}


def _embed(params: dict, tokens, cfg: TransformerConfig):
    # Gather then cast: the same values as casting the whole table first.
    return params["embed"][tokens].to(cfg.dtype)


def _project_qkv(lp, x, rope, cfg: TransformerConfig):
    """Q, K, V of one layer, Q and K rotated by ``rope`` = (cos, sin): the
    tables of the fed rows' positions, built once per call for every layer
    (the JAX package builds the same tables per projection)."""
    B, T, _ = x.shape
    H, KV, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    h = _rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    q = (h @ lp["wq"].to(h.dtype)).reshape(B, T, H, Dh)
    k = (h @ lp["wk"].to(h.dtype)).reshape(B, T, KV, Dh)
    v = (h @ lp["wv"].to(h.dtype)).reshape(B, T, KV, Dh)
    return _rope_apply(q, *rope), _rope_apply(k, *rope), v


def _mlp(lp, x, cfg: TransformerConfig):
    h = _rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
    if cfg.num_experts > 0:
        # capacity_factor E gives capacity T: lossless. The aux loss is unused.
        return x + _moe_mlp(lp, h, float(cfg.num_experts))[0]
    gate = F.silu(h @ lp["wg"].to(h.dtype))
    up = h @ lp["wi"].to(h.dtype)
    return x + (gate * up) @ lp["wo_mlp"].to(h.dtype)


def _cache_attention(q, ck, cv, pos_mask, cfg: TransformerConfig):
    """q [B, T, H, Dh] against cache rows ck/cv [B, S, KV, Dh], masked by
    pos_mask [B, T, S] (True = attend). Each of the KV heads serves H/KV
    consecutive query heads through one grouped matmul, so K/V are read at
    KV width. Scores in f32 (the products of the inputs, summed in f32),
    -inf where masked, f32 softmax, P cast to the cache dtype for P V."""
    B, T, H, Dh = q.shape
    S, KV = ck.shape[1], ck.shape[2]
    rep = H // KV
    qg = q.reshape(B, T, KV, rep, Dh).permute(0, 2, 3, 1, 4).reshape(B, KV, rep * T, Dh)
    s = torch.matmul(qg.float(), ck.permute(0, 2, 3, 1).float()).reshape(B, KV, rep, T, S)
    s = torch.where(pos_mask[:, None, None], s * cfg.head_dim**-0.5, float("-inf"))
    p = torch.softmax(s, dim=-1).to(cv.dtype).reshape(B, KV, rep * T, S)
    o = torch.matmul(p, cv.permute(0, 2, 1, 3))  # [B, KV, rep * T, Dh]
    return o.reshape(B, KV, rep, T, Dh).permute(0, 3, 1, 2, 4).reshape(B, T, H, Dh).to(q.dtype)


def _window(mask, positions, k_pos, cfg: TransformerConfig):
    if cfg.sliding_window:
        mask = mask & (positions[:, :, None] - k_pos[None, None, :] < cfg.sliding_window)
    return mask


def _attend_and_mlp(lp, x, o, cfg: TransformerConfig):
    B, T = x.shape[:2]
    x = x + o.reshape(B, T, -1) @ lp["wo"].to(o.dtype)
    return _mlp(lp, x, cfg)


def _logits(params, x):
    return (x @ _head(params).to(x.dtype)).float()


def _positions(pos, B: int, q: int, device):
    """Per-row start positions [B] and the fed rows' positions [B, q] (int64)
    from ``pos``: a scalar (aligned batch) or [B]."""
    pos_b = torch.as_tensor(pos, device=device).long().expand(B)
    return pos_b, pos_b[:, None] + torch.arange(q, device=device)[None, :]


@torch.no_grad()
def prefill(params, tokens, cache, cfg: TransformerConfig, prompt_lens=None):
    """Run the prompt through the model, writing cache[:, :, :T] in place.

    tokens: [B, T] integer. ``prompt_lens`` [B] enables RAGGED batches: row
    b's prompt is tokens[b, :prompt_lens[b]] (padding at the end, any
    values); padded key rows are masked out and the logits come from each
    row's LAST real token. A length of 0 is taken as 1. Returns
    (logits_last [B, V] f32, cache, next_pos [B] int32).
    """
    dev = cache["k"].device
    tokens = torch.as_tensor(tokens, device=dev)
    B, T = tokens.shape
    if prompt_lens is None:
        prompt_lens = torch.full((B,), T, dtype=torch.int32, device=dev)
    else:
        # An empty row would be an all-masked softmax (NaN) and a gather at
        # -1: it behaves as "prompt is tokens[b, :1]" instead.
        prompt_lens = torch.as_tensor(prompt_lens, device=dev).to(torch.int32).clamp(min=1)
    x = _embed(params, tokens, cfg)
    k_pos = torch.arange(T, device=dev)
    positions = k_pos[None, :].expand(B, T)
    rope = _rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    # Attend only over the prompt's T rows: causal, padding invisible.
    mask = (k_pos[None, None, :] <= positions[:, :, None]) & (k_pos[None, None, :] < prompt_lens[:, None, None])
    mask = _window(mask, positions, k_pos, cfg)
    for i in range(cfg.n_layers):
        lp = _layer_params(params, i)
        q, k, v = _project_qkv(lp, x, rope, cfg)
        cache["k"][i, :, :T] = k
        cache["v"][i, :, :T] = v
        x = _attend_and_mlp(lp, x, _cache_attention(q, k, v, mask, cfg), cfg)
    x = _rms_norm(x, params["norm_f"], cfg.norm_eps)
    last = x[torch.arange(B, device=dev), prompt_lens.long() - 1]
    return _logits(params, last), cache, prompt_lens


@torch.no_grad()
def _decode_chunk_hidden(params, tokens, cache, pos, cfg: TransformerConfig):
    """decode_chunk without the head projection: the final normed hidden
    states [B, q, D] and the cache. Callers that need logits for only some
    rows (chunked prefill needs the final one) project those themselves."""
    dev = cache["k"].device
    tokens = torch.as_tensor(tokens, device=dev)
    B, q = tokens.shape
    S = cache["k"].shape[2]
    pos_b, positions = _positions(pos, B, q, dev)
    # The JAX package writes with lax.dynamic_update_slice, which clamps the
    # start so that all q rows land inside the cache: so does this.
    rows = pos_b.clamp(0, S - q)[:, None] + torch.arange(q, device=dev)[None, :]
    b_idx = torch.arange(B, device=dev)[:, None]
    k_pos = torch.arange(S, device=dev)
    # Causal against the cache: row j of the chunk sees positions <= pos[b] + j.
    mask = _window(k_pos[None, None, :] <= positions[:, :, None], positions, k_pos, cfg)
    rope = _rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    x = _embed(params, tokens, cfg)
    for i in range(cfg.n_layers):
        lp = _layer_params(params, i)
        qh, k, v = _project_qkv(lp, x, rope, cfg)
        cache["k"][i, b_idx, rows] = k
        cache["v"][i, b_idx, rows] = v
        x = _attend_and_mlp(lp, x, _cache_attention(qh, cache["k"][i], cache["v"][i], mask, cfg), cfg)
    return _rms_norm(x, params["norm_f"], cfg.norm_eps), cache


@torch.no_grad()
def decode_chunk(params, tokens, cache, pos, cfg: TransformerConfig):
    """q tokens per row against the cache: tokens [B, q] written at per-row
    positions pos[b]..pos[b]+q-1 (pos [B], or a scalar for aligned batches).

    Returns (logits [B, q, V] f32, one next-token distribution per fed
    token, and the cache). The position mask hides stale rows beyond pos, so
    callers may re-write positions (speculative rejects, chunked prefill)
    without a rewind.
    """
    x, cache = _decode_chunk_hidden(params, tokens, cache, pos, cfg)
    return _logits(params, x), cache


@torch.no_grad()
def prefill_chunked(params, tokens, cache, cfg: TransformerConfig, chunk: int = 512):
    """Prefill long prompts in fixed-size chunks: peak score memory is
    [B, H, chunk, S] instead of [B, H, T, T]. Aligned prompts only; T must be
    a multiple of ``chunk``. Returns (logits_last [B, V], cache, next_pos [B])
    like prefill()."""
    tokens = torch.as_tensor(tokens, device=cache["k"].device)
    B, T = tokens.shape
    if T % chunk:
        raise ValueError(f"prompt length {T} not divisible by chunk {chunk}")
    for start in range(0, T, chunk):
        x, cache = _decode_chunk_hidden(params, tokens[:, start:start + chunk], cache, start, cfg)
    return _logits(params, x[:, -1]), cache, torch.full((B,), T, dtype=torch.int32, device=tokens.device)


@torch.no_grad()
def decode_step(params, token, cache, pos, cfg: TransformerConfig):
    """One token per row: token [B] written at per-row position ``pos`` ([B],
    or a scalar for aligned batches). The q=1 case of decode_chunk. Returns
    (logits [B, V] f32, cache)."""
    logits, cache = decode_chunk(params, torch.as_tensor(token)[:, None], cache, pos, cfg)
    return logits[:, 0], cache


@torch.no_grad()
def _paged_decode_chunk_hidden(params, tokens, cache, block_tables, pos, cfg: TransformerConfig, valid_to=None):
    """``paged_decode_chunk`` without the head projection: the final normed
    hidden states [B, q, D] and the cache. Chunked prefill needs logits for
    at most ONE row per prompt and projects that row itself."""
    dev = cache["k"].device
    tokens = torch.as_tensor(tokens, device=dev)
    block_tables = torch.as_tensor(block_tables, device=dev).long()
    B, q = tokens.shape
    n_max = block_tables.shape[1]
    block_size = cache["k"].shape[2]
    S = n_max * block_size
    KV, Dh = cfg.n_kv_heads, cfg.head_dim
    _, positions = _positions(pos, B, q, dev)
    # Physical write coordinates of every fed row, once for all layers.
    # Out-of-table positions clamp to the last entry; engines validate
    # lengths, so this only bounds the index.
    blk_phys = block_tables.gather(1, (positions // block_size).clamp(max=n_max - 1))
    row_off = positions % block_size
    if valid_to is not None:
        writable = positions < torch.as_tensor(valid_to, device=dev)[:, None]
        blk_phys = torch.where(writable, blk_phys, 0)
    k_pos = torch.arange(S, device=dev)
    mask = _window(k_pos[None, None, :] <= positions[:, :, None], positions, k_pos, cfg)
    rope = _rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    x = _embed(params, tokens, cfg)
    for i in range(cfg.n_layers):
        lp = _layer_params(params, i)
        qh, k, v = _project_qkv(lp, x, rope, cfg)
        # Rows routed to the null block may collide (one of them wins); block
        # 0 is only ever read behind the mask, or by an inactive slot, which
        # attends null-block row 0 alone: finite garbage, never NaN.
        cache["k"][i, blk_phys, row_off] = k
        cache["v"][i, blk_phys, row_off] = v
        # Each row's logical cache view, gathered through its block table,
        # then the dense path's attention.
        ck = cache["k"][i][block_tables].reshape(B, S, KV, Dh)
        cv = cache["v"][i][block_tables].reshape(B, S, KV, Dh)
        x = _attend_and_mlp(lp, x, _cache_attention(qh, ck, cv, mask, cfg), cfg)
    return _rms_norm(x, params["norm_f"], cfg.norm_eps), cache


@torch.no_grad()
def paged_decode_chunk(params, tokens, cache, block_tables, pos, cfg: TransformerConfig, valid_to=None):
    """``decode_chunk`` over a PAGED cache: tokens [B, q] written at per-row
    positions pos[b]..pos[b]+q-1, where logical position p of row b lives in
    physical block ``block_tables[b, p // block_size]`` at row
    ``p % block_size``.

    - ``block_tables`` [B, n_max] integer: physical block ids in logical
      order; entries beyond a sequence's allocation are 0 (the null block)
      and stay behind the position mask.
    - ``valid_to`` [B] (optional): rows at positions >= valid_to[b] write to
      the null block (a padded final prefill chunk never touches unallocated
      blocks); their logits are garbage and must be ignored.
    - An INACTIVE slot is (token 0, pos 0, all-zero block table): it writes
      and attends only null-block row 0.

    Returns (logits [B, q, V] f32, cache). Attention is the dense path's
    ``_cache_attention`` over the gathered logical view, so outputs match the
    dense cache row for row.
    """
    x, cache = _paged_decode_chunk_hidden(params, tokens, cache, block_tables, pos, cfg, valid_to=valid_to)
    return _logits(params, x), cache


@torch.no_grad()
def paged_decode_step(params, token, cache, block_tables, pos, cfg: TransformerConfig):
    """One token per slot against the paged cache: token [B] at per-slot
    positions ``pos`` [B]. The q=1 case of ``paged_decode_chunk``: the
    continuous-batching decode step. Returns (logits [B, V] f32, cache)."""
    logits, cache = paged_decode_chunk(params, torch.as_tensor(token)[:, None], cache, block_tables, pos, cfg)
    return logits[:, 0], cache


def _generator(key, device) -> torch.Generator:
    if isinstance(key, torch.Generator):
        return key
    return torch.Generator(device=device).manual_seed(0 if key is None else int(key))


def _categorical(probs, gen):
    """One draw per row of ``probs`` [B, V]. Every random draw of this module
    goes through this function or ``_uniform``."""
    return torch.multinomial(probs, 1, generator=gen)[:, 0]


def _uniform(shape, gen, device):
    return torch.rand(shape, generator=gen, device=device)


def _truncated_logits(logits, temperature: float, top_k: int):
    """Temperature-scaled logits with everything below the k-th largest set
    to -inf (ties at the k-th value are kept); top_k=0 keeps all."""
    logits = logits / temperature
    if top_k > 0:
        kth = torch.sort(logits, dim=-1).values[:, -top_k][:, None]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    return logits


def _sample(logits, gen, temperature: float, top_k: int):
    if temperature == 0.0:
        return logits.argmax(dim=-1)
    return _categorical(torch.softmax(_truncated_logits(logits, temperature, top_k), dim=-1), gen)


@torch.no_grad()
def generate(params, prompt, cfg: TransformerConfig, max_new_tokens: int = 32, temperature: float = 0.0,
             top_k: int = 0, key=None, prompt_lens=None):
    """prompt [B, T] integer -> generated [B, max_new_tokens] int32, on the
    parameters' device.

    Prefill, then one decode step per token. temperature=0 is greedy;
    top_k=0 disables truncation. ``prompt_lens`` [B] batches RAGGED prompts
    (rows padded at the end to T).
    """
    dev = params["embed"].device
    prompt = torch.as_tensor(prompt, device=dev)
    gen = _generator(key, dev)
    B, T = prompt.shape
    cache = init_cache(cfg, B, T + max_new_tokens, device=dev)
    logits, cache, pos = prefill(params, prompt, cache, cfg, prompt_lens=prompt_lens)
    if prompt_lens is None:
        pos = T  # aligned batch: one start position for every row
    toks = []
    for i in range(max_new_tokens):
        toks.append(_sample(logits, gen, temperature, top_k))
        if i + 1 < max_new_tokens:  # the last token's logits are not needed
            logits, cache = decode_step(params, toks[-1], cache, pos, cfg)
            pos = pos + 1
    return torch.stack(toks, dim=1).to(torch.int32)


def _processed_probs(logits, temperature: float, top_p: float):
    """Temperature + nucleus (top-p) processed distribution [..., V] (f32).
    Speculative exactness is defined against this distribution: the same
    processing applies to target and draft."""
    probs = torch.softmax(logits.float() / max(temperature, 1e-6), dim=-1)
    if top_p < 1.0:
        sorted_probs = torch.sort(probs, dim=-1, descending=True).values
        cum = torch.cumsum(sorted_probs, dim=-1)
        # keep the smallest prefix with mass >= top_p (ties at the cutoff all kept)
        n_keep = (cum - sorted_probs < top_p).sum(-1)
        cutoff = sorted_probs.gather(-1, (n_keep - 1).clamp(min=0)[..., None])
        probs = torch.where(probs >= cutoff, probs, 0.0)
        probs = probs / probs.sum(-1, keepdim=True).clamp(min=1e-30)
    return probs


def _accept_reject(ps, qs, drafts, u):
    """One speculative round's verdict. ps [B, k+1, V] target and qs [B, k, V]
    draft distributions, drafts [B, k] the proposals, u [B, k] uniforms.

    Returns (accepted [B]: the proposals kept, resid [B, V]: the distribution
    of the token that follows them). Proposal i is accepted iff u_i < p_i(x_i)
    / q_i(x_i) and every earlier one was; the first rejection, at r =
    accepted, resamples from norm(max(p_r - q_r, 0)); full acceptance
    samples from p_k.
    """
    k = drafts.shape[1]
    rows = torch.arange(drafts.shape[0], device=drafts.device)
    p_at = ps[:, :k].gather(-1, drafts[..., None])[..., 0]
    q_at = qs.gather(-1, drafts[..., None])[..., 0]
    # u * q < p: no division by a zero q
    accepted = (u * q_at < p_at).long().cumprod(dim=1).sum(dim=1)
    p_r = ps[rows, accepted]
    q_r = torch.where((accepted < k)[:, None], qs[rows, accepted.clamp(max=k - 1)], 0.0)
    resid = (p_r - q_r).clamp(min=0.0)
    z = resid.sum(-1, keepdim=True)
    # A degenerate residual (p <= q everywhere, numerically) -> p_r.
    return accepted, torch.where(z > 1e-30, resid / z.clamp(min=1e-30), p_r)


@torch.no_grad()
def speculative_generate(params, draft_params, prompt, cfg: TransformerConfig, draft_cfg: TransformerConfig,
                         max_new_tokens: int = 32, k: int = 4, temperature: float = 0.0, top_p: float = 1.0,
                         key=None):
    """Speculative decoding: the draft model proposes ``k`` tokens per round
    from its own cache; the target verifies them in ONE ``decode_chunk`` and
    commits the accepted prefix plus one more token.

    ``temperature == 0`` is greedy-exact: a draft token is accepted iff it
    equals the target's argmax, so the output is ``generate(...,
    temperature=0.0)``'s. ``temperature > 0`` follows the accept/reject
    scheme (Leviathan et al. 2023; Chen et al. 2023): accept x_i with
    probability min(1, p_i(x_i) / q_i(x_i)); the first rejection resamples
    from norm(max(p_i - q_i, 0)); a fully accepted round samples its bonus
    token from p_{k+1}. Both models share the vocabulary. Rejected rows past
    the committed position stay behind the position mask and are
    overwritten next round.

    Returns (tokens [B, max_new_tokens] int32, rounds: target passes spent).
    """
    sampling = temperature > 0.0
    dev = params["embed"].device
    prompt = torch.as_tensor(prompt, device=dev)
    gen = _generator(key, dev)
    B, T = prompt.shape
    S = T + max_new_tokens + k + 1
    t_logits, t_cache, pos = prefill(params, prompt, init_cache(cfg, B, S, device=dev), cfg)
    _, d_cache, _ = prefill(draft_params, prompt, init_cache(draft_cfg, B, S, device=dev), draft_cfg)
    pos = pos.long()  # one position drives both caches: they commit the same tokens
    if sampling:
        cur = _categorical(_processed_probs(t_logits, temperature, top_p), gen)
    else:
        cur = t_logits.argmax(dim=-1)
    out = torch.zeros((B, max_new_tokens), dtype=torch.long, device=dev)
    out[:, 0] = cur
    n = torch.ones((B,), dtype=torch.long, device=dev)  # tokens emitted so far
    rows = torch.arange(B, device=dev)
    rounds = 0
    while bool((n < max_new_tokens).any()):
        # k+1 draft steps, so the draft cache holds rows for cur AND all k
        # proposals: a fully accepted round advances k+1 rows. The (k+1)-th
        # proposal is discarded.
        tok, d_pos, drafts, qs = cur, pos, [], []
        for _ in range(k + 1):
            logits, d_cache = decode_step(draft_params, tok, d_cache, d_pos, draft_cfg)
            if sampling:
                qs.append(_processed_probs(logits, temperature, top_p))
                tok = _categorical(qs[-1], gen)
            else:
                tok = logits.argmax(dim=-1)
            drafts.append(tok)
            d_pos = d_pos + 1
        drafts = torch.stack(drafts[:k], dim=1)  # [B, k]
        logits, t_cache = decode_chunk(params, torch.cat([cur[:, None], drafts], dim=1), t_cache, pos, cfg)
        if sampling:
            ps = _processed_probs(logits, temperature, top_p)  # [B, k+1, V]
            u = _uniform((B, k), gen, dev)
            accepted, resid = _accept_reject(ps, torch.stack(qs[:k], dim=1), drafts, u)
            bonus = _categorical(resid, gen)
        else:
            preds = logits.argmax(dim=-1)  # [B, k+1]
            # accepted[b]: the longest prefix of drafts equal to the target's argmax
            accepted = (drafts == preds[:, :k]).long().cumprod(dim=1).sum(dim=1)
            bonus = preds[rows, accepted]
        # Emit d_1..d_accepted, then the bonus token at slot `accepted`.
        slots = torch.arange(k + 1, device=dev)[None, :]
        emit = torch.where(slots < accepted[:, None], torch.cat([drafts, torch.zeros_like(drafts[:, :1])], 1), 0)
        emit[rows, accepted] = bonus
        room = (max_new_tokens - n).clamp(min=0)
        n_emit = torch.minimum(accepted + 1, room)
        for i in range(k + 1):
            idx = (n + i).clamp(0, max_new_tokens - 1)
            out[rows, idx] = torch.where(i < n_emit, emit[:, i], out[rows, idx])
        # Committed rows are cur + the accepted drafts; rows at capacity stay.
        pos = pos + torch.where(room > 0, accepted + 1, 0)
        cur = torch.where(n_emit > 0, emit[rows, (n_emit - 1).clamp(min=0)], cur)
        n = n + n_emit
        rounds += 1
    return out.to(torch.int32), rounds
