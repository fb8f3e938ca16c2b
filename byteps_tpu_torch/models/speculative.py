"""Greedy speculative decoding — exact by construction.

Counterpart of ``byteps_tpu/models/speculative.py``. A cheap draft
proposes ``spec_len`` tokens a round; the target model verifies all of
them in one cached forward of ``spec_len`` fed tokens, keeps the longest
agreeing prefix and emits its own correction at the first mismatch. The
greedy output is therefore token for token plain greedy decoding of the
target: the draft moves speed (accepted tokens per target forward), never
content.

Mechanics, as the reference's, with its ``lax.while_loop`` a Python
loop:

* One round = ``spec_len`` draft steps + one target forward over
  ``spec_len`` fed tokens. The batch-min accepted count ``m`` crosses to
  the host once a round (:func:`_verify_commit`); the rest stays on the
  device.
* Rollback is a fill-level rewind: both caches append every fed token,
  then ``length`` goes back to the committed prefix. The port's caches
  are written in place (``generate._cache_write``), so the rows past the
  fill level keep the rejected tokens' keys until the next round writes
  over them; the causal offset masks them meanwhile (a key past a query's
  position gets weight exactly 0), which holds for an int8 cache too:
  its per-position scales are written and masked with their rows.
* Batched: rows accept independently and the round advances by the
  batch-min accepted count.

Two draft strategies: :func:`make_speculative_generate_fn` (a draft
model sharing the target's vocabulary; with draft == target it measures
the verify overhead) and :func:`make_lookup_generate_fn` (prompt-lookup:
propose the tokens that followed the latest earlier occurrence of the
current bigram in the committed context).

On the card a verify forward of ``spec_len`` rows takes the flash
forward's split path and each draft step the decode kernel, while plain
greedy decodes every token through the decode kernel: in bf16 the two
round differently, so a near-tie can pick another token. Exactness
holds where the two agree on each logit's argmax: on the CPU, and in f32
on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from byteps_tpu_torch.models.generate import gpt_apply_cached, init_cache
from byteps_tpu_torch.models.gpt import GPTConfig
from byteps_tpu_torch.ops.backend import resolve_device


def _verify_commit(d: torch.Tensor, logits: torch.Tensor, out: torch.Tensor,
                   n_emitted: int, K: int):
    """The accept/commit arithmetic both samplers and the scheduler's
    speculative lane share: compare proposals ``d`` (B, K) with the
    target's greedy picks from ``logits`` (B, K, V), commit the batch-min
    agreeing prefix (plus the correction at the first mismatch) into
    ``out`` (B, W) at column ``n_emitted``, in place.

    Returns ``(out, n_emitted, next_tok (B,), committed)``: the new
    emitted count and ``committed``, the cache entries newly valid past
    the round's starting fill level (``[next_tok, d_1..d_{min(m, K-1)}]``),
    as host integers."""
    B = d.shape[0]
    preds = torch.argmax(logits, dim=-1).to(torch.int32)      # (B, K)
    acc = (d == preds).to(torch.int32)
    m = int(torch.cumprod(acc, dim=1).sum(dim=1).min())      # batch-min
    rows = torch.arange(B, device=d.device)
    correction = preds[rows, min(m, K - 1)]
    full = m == K
    # emit d_1..d_m, plus the correction when a mismatch happened; the
    # stray write at slot m when m == K lands at the next round's offset
    # and is overwritten there
    block = torch.cat([d, torch.zeros_like(d[:, :1])], dim=1)
    block[:, m] = correction
    out[:, n_emitted:n_emitted + K + 1] = block
    n_emitted += K if full else m + 1
    next_tok = d[:, K - 1].clone() if full else correction
    return out, n_emitted, next_tok, 1 + min(m, K - 1)


def _as_prompt(prompt, dev) -> torch.Tensor:
    if isinstance(prompt, torch.Tensor):
        return prompt.to(device=dev, dtype=torch.int32)
    return torch.as_tensor(np.array(prompt, np.int32), device=dev)


def _kv_heads(params, cfg: GPTConfig) -> int:
    """The cache's kv heads: this rank's ``wk`` shard under tp."""
    return params["blocks"][0]["wk"].shape[-1] // cfg.head_dim


def make_speculative_generate_fn(cfg: GPTConfig, draft_cfg: GPTConfig,
                                 max_new: int, spec_len: int = 4,
                                 tp_axis=None, device=None):
    """Build the greedy speculative sampler with a draft model.

    ``gen(params, draft_params, prompt) -> (tokens (B, T0 + max_new) int32,
    rounds)`` on ``device`` (the card unless told otherwise): ``rounds``
    is the number of verify forwards the run took (plain greedy takes
    ``max_new`` forwards after the prefill). ``tp_axis`` (a mesh
    ``Axis``) runs both models over tp, each rank holding its shards, as
    ``make_generate_fn`` does."""
    if spec_len < 1:
        raise ValueError(f"spec_len must be >= 1; got {spec_len}")
    if draft_cfg.vocab_size != cfg.vocab_size:
        raise ValueError(
            f"draft vocab {draft_cfg.vocab_size} != target vocab "
            f"{cfg.vocab_size} — speculation compares token ids")
    K = spec_len
    dev = resolve_device(device)

    @torch.no_grad()
    def gen(params, draft_params, prompt):
        prompt = _as_prompt(prompt, dev)
        B, T0 = prompt.shape
        if T0 + max_new + K > cfg.max_seq:
            raise ValueError(
                f"prompt ({T0}) + max_new ({max_new}) + spec_len ({K}) "
                f"exceeds cfg.max_seq ({cfg.max_seq})")
        if T0 + max_new + K > draft_cfg.max_seq:
            raise ValueError(
                f"draft max_seq ({draft_cfg.max_seq}) too small for "
                f"prompt ({T0}) + max_new ({max_new}) + spec_len ({K})")
        cache_t = init_cache(cfg, B, h_loc=_kv_heads(params, cfg),
                             device=dev)
        cache_d = init_cache(draft_cfg, B,
                             h_loc=_kv_heads(draft_params, draft_cfg),
                             device=dev)
        logits_t, cache_t = gpt_apply_cached(params, prompt, cache_t, cfg,
                                             tp_axis)
        _, cache_d = gpt_apply_cached(draft_params, prompt, cache_d,
                                      draft_cfg, tp_axis, readout=False)
        # the first committed token: the target's pick after the prompt
        # (emitted, not yet in either cache)
        next_tok = torch.argmax(logits_t[:, -1], dim=-1).to(torch.int32)
        out = torch.zeros((B, max_new + K + 1), dtype=torch.int32,
                          device=dev)
        out[:, 0] = next_tok
        n_emitted, rounds = 1, 0
        while n_emitted < max_new:
            len0 = cache_t.length
            # the draft proposes K tokens, one cached step each
            tok, d = next_tok, []
            for _ in range(K):
                lg, cache_d = gpt_apply_cached(draft_params, tok[:, None],
                                               cache_d, draft_cfg, tp_axis)
                tok = torch.argmax(lg[:, -1], dim=-1).to(torch.int32)
                d.append(tok)
            d = torch.stack(d, dim=1)                         # (B, K)
            # the target verifies them in one forward of K fed tokens
            feed = torch.cat([next_tok[:, None], d[:, :K - 1]], dim=1)
            logits, cache_t = gpt_apply_cached(params, feed, cache_t, cfg,
                                               tp_axis)
            out, n_emitted, next_tok, committed = _verify_commit(
                d, logits, out, n_emitted, K)
            # fill-level rewind of both caches (each appended the same K
            # fed positions)
            cache_t = cache_t._replace(length=len0 + committed)
            cache_d = cache_d._replace(length=len0 + committed)
            rounds += 1
        return torch.cat([prompt, out[:, :max_new]], dim=1), rounds

    return gen


def make_lookup_generate_fn(cfg: GPTConfig, max_new: int,
                            spec_len: int = 4, tp_axis=None, device=None):
    """Build the prompt-lookup speculative greedy sampler (no draft
    model).

    ``gen(params, prompt) -> (tokens (B, T0 + max_new) int32, rounds)`` on
    ``device`` (the card unless told otherwise). Each round proposes, per
    batch row, the ``spec_len`` tokens that followed the latest earlier
    occurrence of the current (prev, last) bigram in the committed
    context, then verifies them with one target forward as the draft
    sampler does; a row without a match proposes what the clamped gather
    finds, and accepts nothing of it. ``tp_axis`` as in
    :func:`make_speculative_generate_fn`."""
    if spec_len < 1:
        raise ValueError(f"spec_len must be >= 1; got {spec_len}")
    K = spec_len
    dev = resolve_device(device)

    @torch.no_grad()
    def gen(params, prompt):
        prompt = _as_prompt(prompt, dev)
        B, T0 = prompt.shape
        if T0 < 2:
            raise ValueError("prompt must hold at least the seed bigram "
                             f"(2 tokens); got {T0}")
        if T0 + max_new + K > cfg.max_seq:
            raise ValueError(
                f"prompt ({T0}) + max_new ({max_new}) + spec_len ({K}) "
                f"exceeds cfg.max_seq ({cfg.max_seq})")
        cache_t = init_cache(cfg, B, h_loc=_kv_heads(params, cfg),
                             device=dev)
        logits_t, cache_t = gpt_apply_cached(params, prompt, cache_t, cfg,
                                             tp_axis)
        next_tok = torch.argmax(logits_t[:, -1], dim=-1).to(torch.int32)
        W = T0 + max_new + K + 1
        out = torch.zeros((B, max_new + K + 1), dtype=torch.int32,
                          device=dev)
        out[:, 0] = next_tok
        pos = torch.arange(W - 1, device=dev)
        steps = torch.arange(K, device=dev)

        def propose(n_emitted, next_tok):
            """The latest bigram's continuation in the committed context
            (the whole buffer, as the reference reads it)."""
            ctx = torch.cat([prompt, out], dim=1)
            pos_last = T0 + n_emitted - 1        # next_tok's position
            prev = ctx[:, pos_last - 1]
            match = ((ctx[:, :-1] == prev[:, None])
                     & (ctx[:, 1:] == next_tok[:, None])
                     & (pos[None, :] <= pos_last - 2))
            p_star = torch.argmax(
                torch.where(match, pos[None, :], -1), dim=1)
            idx = torch.clamp(p_star[:, None] + 2 + steps[None, :], 0, W - 1)
            return torch.gather(ctx, 1, idx)                 # (B, K)

        n_emitted, rounds = 1, 0
        while n_emitted < max_new:
            len0 = cache_t.length
            d = propose(n_emitted, next_tok)
            feed = torch.cat([next_tok[:, None], d[:, :K - 1]], dim=1)
            logits, cache_t = gpt_apply_cached(params, feed, cache_t, cfg,
                                               tp_axis)
            out, n_emitted, next_tok, committed = _verify_commit(
                d, logits, out, n_emitted, K)
            cache_t = cache_t._replace(length=len0 + committed)
            rounds += 1
        return torch.cat([prompt, out[:, :max_new]], dim=1), rounds

    return gen
