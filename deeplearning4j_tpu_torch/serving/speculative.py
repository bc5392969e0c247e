"""Speculative decoding: draft-model propose, span-verified accept
(counterpart of ``deeplearning4j_tpu/serving/speculative.py``).

Decode is latency-bound: every generated token costs one target step.
A cheap DRAFT model guesses k tokens ahead and the target scores all k
guesses in one span; whenever the draft guesses right, k sequential
target steps collapse into one call, and a wrong guess degrades to one
committed token per round (Leviathan et al. 2023; Chen et al. 2023).

This module builds the device functions the engine
(:mod:`.generation`) schedules; the engine owns the bookkeeping
(eligibility, cursor commit, copy-on-write, the fault ladder):

- **prime**: a draft prefill, writing the draft's K/V for a lane's
  committed prefix into its dense cache, once per admission and per
  recovery re-admission (prefix sharing may have skipped most of the
  target's prefill, but the draft shares nothing);
- **propose**: k greedy draft decode steps over the FULL slot batch in
  one call (one CUDA graph on the card). Every lane, eligible or not,
  gets the draft's K/V written at its ``pos``: that keeps the draft
  cache in step with lanes that plain-decode a round;
- **verify**: the target scores ``[current_token, d_1..d_k]`` in one
  causal span (plain PyTorch, as JAX's verify is plain jnp), samples a
  target token at EVERY row with the engine's decode sampling and
  counts the accepted run.

**The identity contract.** Row ``i`` of a verify span sees exactly the
keys plain decode step ``i`` would see and samples with the uniform of
``fold_in(PRNGKey(seed), step0 + i)``, so its target sample IS the
token plain decode would emit. Draft token ``d_{i+1}`` is accepted iff
it equals that sample; the first mismatching row's own sample is the
correction token, and an all-accepted round's last row a bonus token.
Every emitted token is a target sample from the request's own stream:
output equals ``speculation_k=0`` output at every temperature.

**Rollback is cursor-only.** A rejected tail's K/V stays written past
the accepted length; the engine commits ``pos``/``step`` by the
accepted run only, and every reader masks what lies past the cursor.

The paged verify is the chunked-prefill path (``forward_prefill_chunk``)
plus the sampling tail; the slots verify is its dense sibling
``forward_verify``. Both write the target's cache IN PLACE, as the prime
and the propose write the draft's. Every function here takes its
per-call values (positions, lengths, slots, uniforms, sampling
parameters) as device tensors and reads none on the host, so the
engine captures each bucket of the prime and the verify as one CUDA
graph, as it does the propose.
"""
from __future__ import annotations

import numpy as np
import torch

from ..kernels.kv_quant import kv_update_slice
from .paging import pow2_bucket


def verify_bucket(k: int) -> int:
    """Width of a verify span: the current token plus k proposals,
    padded to a power of two (padded rows write masked junk, as a
    prefill chunk's padded tail does)."""
    return pow2_bucket(int(k) + 1)


def make_prime_fn(draft):
    """Draft prefill into the draft's dense slot cache: the engine's
    prefill without sampling (the draft never emits). Returns
    ``prime(params, kcs, vcs, tokens [1, B], length, slot) -> ok``, the
    finite-logits guard over the ``length`` valid rows (a device bool).
    ``length`` is a host int or a 0-d device tensor, ``slot`` a host int
    or a 1-element device tensor: the guard masks the rows past
    ``length`` instead of slicing them, so one graph serves every
    length of a bucket."""

    def prime(params, kcs, vcs, tokens, length, slot):
        bucket = tokens.shape[1]
        rows = torch.arange(bucket, device=tokens.device)
        key_mask = (rows[None] < length).to(torch.float32)
        logits, ks, vs = draft.forward_prefill(params, tokens, key_mask)
        ok = torch.where((rows < length)[:, None],
                         torch.isfinite(logits[0]), True).all()
        for kc, k in zip(kcs, ks):
            kv_update_slice(kc, k, (slot, 0, 0, 0))
        for vc, v in zip(vcs, vs):
            kv_update_slice(vc, v, (slot, 0, 0, 0))
        return ok
    return prime


def make_propose_fn(draft, k: int):
    """k greedy draft decode steps over the slot batch. Greedy because
    proposals only seed verification: the target's own sampling decides
    what is emitted, and argmax maximises the chance of matching it at
    the low temperatures where speculation pays. Returns
    ``propose(params, kcs, vcs, tokens [S], pos [S]) -> (proposals
    [S, k], ok [S])``, ``ok`` the per-lane finite-logits guard over all
    k steps (a NaN anywhere disqualifies the lane's round; the engine
    then plain-decodes it). The static shapes and the absence of host
    syncs let the engine capture the whole call as one CUDA graph.

    Positions are clamped to the cache's last one: a lane within k of
    the end writes its overflow there (JAX's scatter drops it). Only an
    ineligible lane gets that far, since eligibility leaves k + 1
    positions, and its proposals and that position are never read."""
    k = int(k)

    def propose(params, kcs, vcs, tokens, pos):
        last = kcs[0].shape[2] - 1
        t, p = tokens, pos
        ok = torch.ones(tokens.shape[0], dtype=torch.bool,
                        device=tokens.device)
        props = []
        for _ in range(k):
            logits, _, _ = draft.forward_decode(params, t, p.clamp(max=last),
                                                kcs, vcs)
            ok = ok & torch.isfinite(logits).all(dim=-1)
            t = torch.argmax(logits, dim=-1)
            p = p + 1
            props.append(t)
        return torch.stack(props, dim=1), ok
    return propose


def verify_uniforms(seed: int, step0: int, temp: float,
                    C: int) -> torch.Tensor:
    """The [C] uniforms of a verify span on the host: row ``i`` draws
    from ``fold_in(PRNGKey(seed), step0 + i)``, as plain decode step
    ``step0 + i`` would; zeros for a greedy lane, whose rows ignore
    them (as in the decode step)."""
    from .generation import _uniforms
    if temp > 0:
        return _uniforms(np.full(C, seed, np.uint32),
                         step0 + np.arange(C, dtype=np.int64))
    return torch.zeros(C)


def verify_accept(logits, tokens, vlen, us, temp, top_k):
    """The accept/sample tail shared by both verifies, on device
    tensors: sample every row with the engine's decode sampling
    (``_sample_from_logits`` at the row's uniform ``us[i]``), then count
    the leading run of draft rows that MATCH the target's sample,
    limited to the ``vlen - 1`` real draft rows (the cumprod-sum).
    ``logits`` [C, V], ``tokens`` [1, C], ``us`` [C], ``temp`` and
    ``top_k`` [1] live on one device; ``vlen`` is a host int or a 0-d
    device tensor (the finite guard masks the padded rows). Returns
    (tgt [C], n_accepted, ok) as device tensors."""
    from .generation import _sample_from_logits
    C = tokens.shape[1]
    rows = torch.arange(C, device=logits.device)
    ok = torch.where((rows < vlen)[:, None], torch.isfinite(logits),
                     True).all()
    tgt = _sample_from_logits(logits, temp.expand(C), top_k.expand(C), us)
    match = (tgt[:-1] == tokens[0, 1:]) & (rows[:-1] < vlen - 1)
    n_acc = torch.cumprod(match.to(torch.int64), dim=0).sum()
    return tgt, n_acc, ok


def _verify_tail(logits, tokens, vlen, seed, step0, temp, top_k):
    """:func:`verify_accept` from host scalars (the seed, the first
    row's PRNG fold, the temperature and top-k of one lane): its
    uniforms from :func:`verify_uniforms`. The host-argument form the
    engine's buffer-driven verify is held to. Returns (tgt [C],
    n_accepted, ok) as device tensors."""
    dev = logits.device
    C = tokens.shape[1]
    return verify_accept(
        logits, tokens, vlen,
        verify_uniforms(seed, step0, temp, C).to(dev),
        torch.full((1,), float(temp), device=dev),
        torch.full((1,), int(top_k), device=dev))


def make_verify_paged_fn(model):
    """Paged verification: ``forward_prefill_chunk`` (the chunk path,
    unchanged) plus :func:`verify_accept`. Returns ``verify(params, kcs,
    vcs, tokens [1, C], p0, vlen, table, us [C], temp [1], top_k [1]) ->
    (tgt [C], n_accepted, ok)``."""

    def verify(params, kcs, vcs, tokens, p0, vlen, table, us, temp,
               top_k):
        logits, _, _ = model.forward_prefill_chunk(params, tokens, p0, vlen,
                                                   kcs, vcs, table)
        return verify_accept(logits, tokens, vlen, us, temp, top_k)
    return verify


def make_verify_slots_fn(model):
    """Dense-backend verification: ``forward_verify`` plus
    :func:`verify_accept`. Returns ``verify(params, kcs, vcs,
    tokens [1, C], p0, vlen, slot, us [C], temp [1], top_k [1]) ->
    (tgt [C], n_accepted, ok)``."""

    def verify(params, kcs, vcs, tokens, p0, vlen, slot, us, temp, top_k):
        logits, _, _ = model.forward_verify(params, tokens, p0, vlen, kcs,
                                            vcs, slot)
        return verify_accept(logits, tokens, vlen, us, temp, top_k)
    return verify
