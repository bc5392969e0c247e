#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run when it fails:

1. device: the card's name and power limit;
2. build: every kernel under deeplearning4j_tpu_torch/csrc/ with nvcc
   for sm_90a, one process per source, all at once;
3. kernels: each kernel against its plain PyTorch version on the card
   at the served path's shapes, with its time, the plain version's,
   one PyTorch library call's (a yardstick only; the port never calls
   it) and the least time the card could take (bound). The paged
   kernel runs over non-contiguous pool blocks with NaN in the null
   block and in every stale block tail;
4. end to end on the slot backend: the causal LM at the width
   documented in docs/generation.md (vocab 32000, d_model 512, 8
   layers, 8 heads, max_seq_len 1024, random weights from a seed)
   served by GenerationEngine(num_slots=32): ~32 concurrent requests,
   both kernels' launch counters must move, and a teacher-forced check
   against a CPU copy of the model holds each greedy token;
5. end to end on the paged backend: the same model served by the
   paged configuration of docs/generation.md (64 slots, 4096 blocks of
   16, chunks of 512, prefix sharing on): a primer that registers a
   320-token system prompt, 48 concurrent requests (32 of them behind
   that prompt) and 8 two-turn sessions. The paged kernel must launch
   once per layer and decode step, prefixes and sessions must hit,
   copy-on-write must run, the teacher-forced check must hold, and
   every block must come back to the pool.

A "details:" line carries every measured number as JSON; then come
the kernels line, the card's name and power limit, and last
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import subprocess
import sys
import threading
import time

import numpy as np

# tolerances, each with its reason
DECODE_TOL_F32 = 1e-4   # f32, sums over up to 1024 keys in another order
DECODE_TOL_BF16 = 5e-3  # p rounded to bf16 before (kernel, as the
#                         Pallas kernel) or after (plain, as
#                         decode_attention_xla) normalisation; 1.9e-3
#                         measured on an H100 at these shapes
FLASH_TOL = 1e-4        # f32, sums over up to 1024 keys in another order
TEACHER_TOL = 1e-3      # logit gap allowed between a served greedy token
#                         and the CPU maximum at that position

#: the served model (docs/generation.md), random weights from seed 0;
#: eos_id=None so every request runs its full length
SERVE_CFG = dict(vocab_size=32000, d_model=512, n_layers=8, n_heads=8,
                 max_seq_len=1024, eos_id=None, seed=0)
#: the paged configuration of docs/generation.md
PAGED_ENGINE = dict(num_slots=64, cache="paged", block_size=16,
                    num_blocks=4096, prefill_chunk_tokens=512)

H100_BYTES_PER_S = 3.35e12  # HBM3, NVIDIA data sheet (SXM)
H100_F32_FLOPS = 67e12      # f32 outside the tensor cores


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def check_decode(dev):
    import torch
    import torch.nn.functional as F
    from deeplearning4j_tpu_torch.kernels import decode_attention as da
    S, H, T, D = 32, 8, 1024, 64
    g = torch.Generator(device="cpu").manual_seed(1)
    results = {}
    for dtype, tol in ((torch.float32, DECODE_TOL_F32),
                       (torch.bfloat16, DECODE_TOL_BF16)):
        q = torch.randn((S, H, D), generator=g).to(dev)
        k = torch.randn((S, H, T, D), generator=g).to(dev, dtype)
        v = torch.randn((S, H, T, D), generator=g).to(dev, dtype)
        lens = torch.randint(1, T + 1, (S,), generator=g)
        lens[0], lens[1], lens[2] = 0, T, 1
        for s in range(0, S, 2):  # stale non-finite tails must not leak
            k[s, :, int(lens[s]):] = float("nan")
            v[s, :, int(lens[s]):] = float("nan")
        lens = lens.to(dev, torch.int32)
        got = da.decode_attention(q, k, v, lens)
        want = da.decode_attention_torch(q, k, v, lens)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        finite = bool(torch.isfinite(got).all())
        zero_row = got[0].abs().max().item()
        print(f"decode_attention {str(dtype)[6:]}: max_abs_err {err:.3e} "
              f"(tol {tol:g}), finite {finite}, len-0 row max {zero_row}")
        if not (finite and err <= tol and zero_row == 0.0):
            raise AssertionError(f"decode_attention {dtype} disagrees "
                                 f"with its plain version")
        # timed at the served width with every slot full (lengths = T):
        # the cache read is the whole work, and one library call
        # computes the same function
        full = torch.full((S,), T, dtype=torch.int32, device=dev)
        k.nan_to_num_(0.0)
        v.nan_to_num_(0.0)
        ms = time_ms(lambda: da.decode_attention(q, k, v, full))
        plain_ms = time_ms(lambda: da.decode_attention_torch(q, k, v, full))
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            q[:, :, None].to(dtype), k, v))
        item = k.element_size()
        nbytes = q.numel() * 4 + 2 * S * H * T * D * item + S * 4 \
            + S * H * D * 4
        flops = 4 * D * H * S * T
        bound_ms = max(nbytes / H100_BYTES_PER_S,
                       flops / H100_F32_FLOPS) * 1e3
        results[str(dtype)[6:]] = dict(
            max_abs_err=err, tol=tol, ms=ms, plain_ms=plain_ms,
            library_ms=lib_ms, bound_ms=bound_ms,
            bound_by="bytes" if nbytes / H100_BYTES_PER_S
            >= flops / H100_F32_FLOPS else "operations")
        print(f"decode_attention {str(dtype)[6:]} S={S} H={H} T={T} D={D}: "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
              f"{lib_ms:.4f} ms, bound {bound_ms:.4f} ms")
    return results


def check_flash(dev):
    import torch
    import torch.nn.functional as F
    from deeplearning4j_tpu_torch.kernels import flash_attention as fa
    B, H, D = 1, 8, 64
    g = torch.Generator(device="cpu").manual_seed(2)
    worst = 0.0
    per_bucket = {}
    T = 8
    while T <= 1024:
        q, k, v = (torch.randn((B, T, H, D), generator=g).to(dev)
                   for _ in range(3))
        L = max(1, (3 * T) // 4 + 1)  # a padded prompt of length L
        km = (torch.arange(T) < L).to(torch.float32)[None].to(dev)
        o, lse = fa.flash_attention(q, k, v, True, km)
        o_ref, lse_ref = fa.flash_attention_torch(q, k, v, True, km)
        torch.cuda.synchronize()
        err = max((o - o_ref).abs().max().item(),
                  (lse - lse_ref).abs().max().item())
        per_bucket[T] = err
        worst = max(worst, err)
        if not (err <= FLASH_TOL and bool(torch.isfinite(o).all())):
            raise AssertionError(f"flash_attention T={T} disagrees with "
                                 f"its plain version: {err:.3e}")
        T *= 2
    print(f"flash_attention buckets 8..1024: max_abs_err {worst:.3e} "
          f"(tol {FLASH_TOL:g}) per bucket {per_bucket}")
    # timed at the largest prefill bucket, causal, every key live
    T = 1024
    q, k, v = (torch.randn((B, T, H, D), generator=g).to(dev)
               for _ in range(3))
    km = torch.ones((B, T), device=dev)
    ms = time_ms(lambda: fa.flash_attention(q, k, v, True, km))
    plain_ms = time_ms(lambda: fa.flash_attention_torch(q, k, v, True, km))
    mask = torch.ones((T, T), dtype=torch.bool, device=dev).tril()[None,
                                                                    None]
    mask = mask & (km > 0)[:, None, None, :]
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask))
    pairs = T * (T + 1) // 2
    flops = 4 * D * H * B * pairs
    nbytes = 4 * B * T * H * D * 4 + B * T * 4 + B * H * T * 4
    bound_ms = max(nbytes / H100_BYTES_PER_S, flops / H100_F32_FLOPS) * 1e3
    print(f"flash_attention B={B} H={H} T={T} D={D} causal: kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, library {lib_ms:.4f} ms, "
          f"bound {bound_ms:.4f} ms")
    return dict(max_abs_err=worst, tol=FLASH_TOL, per_bucket=per_bucket,
                ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=bound_ms,
                bound_by="bytes" if nbytes / H100_BYTES_PER_S
                >= flops / H100_F32_FLOPS else "operations")


def check_paged(dev):
    """The paged kernel against its plain version at the served shapes
    (64 slots, 8 heads, blocks of 16, head dim 64, 64-entry tables, a
    4096-block pool), then timed with every slot at length 1024."""
    import torch
    import torch.nn.functional as F
    from deeplearning4j_tpu_torch.kernels import decode_attention as da
    from deeplearning4j_tpu_torch.kernels import paged_attention as pa
    S, H, Bs, D, B, N = 64, 8, 16, 64, 64, 4096
    T = B * Bs
    rs = np.random.RandomState(4)
    g = torch.Generator(device="cpu").manual_seed(4)
    results = {}
    # the same function as decode attention, read through a table: the
    # decode tolerances and their reasons hold
    for dtype, tol in ((torch.float32, DECODE_TOL_F32),
                       (torch.bfloat16, DECODE_TOL_BF16)):
        q = torch.randn((S, H, D), generator=g).to(dev)
        k = torch.randn((N, H, Bs, D), generator=g).to(dev, dtype)
        v = torch.randn((N, H, Bs, D), generator=g).to(dev, dtype)
        lens = rs.randint(1, T + 1, S)
        lens[:6] = [0, 1, 15, 16, 17, T]
        # each slot's live blocks are distinct pool blocks, in random
        # order, NULL-padded past ceil(len / Bs); no two slots share a
        # block, so one slot's stale tail is no other slot's live key
        perm = rs.permutation(np.arange(1, N))
        tbl = np.zeros((S, B), np.int32)
        used = 0
        for s, n in enumerate(lens):
            nb = -(-int(n) // Bs)
            tbl[s, :nb] = perm[used:used + nb]
            used += nb
            if n % Bs:  # the stale tail of the last live block
                k[int(tbl[s, nb - 1]), :, int(n % Bs):] = float("nan")
                v[int(tbl[s, nb - 1]), :, int(n % Bs):] = float("nan")
        k[0] = float("nan")  # the null block, where padded lanes write
        v[0] = float("nan")
        tbl_d = torch.from_numpy(tbl).to(dev)
        lens_d = torch.from_numpy(lens.astype(np.int32)).to(dev)
        got = pa.paged_attention(q, k, v, tbl_d, lens_d)
        want = pa.paged_attention_torch(q, k, v, tbl_d, lens_d)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        finite = bool(torch.isfinite(got).all())
        zero_row = got[0].abs().max().item()
        name = str(dtype)[6:]
        print(f"paged_attention {name}: max_abs_err {err:.3e} (tol "
              f"{tol:g}), finite {finite}, len-0 row max {zero_row}, "
              f"{used} live blocks")
        if not (finite and err <= tol and zero_row == 0.0):
            raise AssertionError(f"paged_attention {dtype} disagrees "
                                 f"with its plain version")
        # timed with every slot at length T through a full table of
        # distinct blocks per slot (63 x 64 + 64 entries over 4095
        # blocks: the last slot repeats one block of the first)
        k.nan_to_num_(0.0)
        v.nan_to_num_(0.0)
        full_tbl = torch.from_numpy(np.resize(
            rs.permutation(np.arange(1, N)), S * B).reshape(S, B)
            .astype(np.int32)).to(dev)
        full = torch.full((S,), T, dtype=torch.int32, device=dev)
        kd = pa.gather_blocks(k, full_tbl).contiguous()
        vd = pa.gather_blocks(v, full_tbl).contiguous()
        got = pa.paged_attention(q, k, v, full_tbl, full)
        dense = da.decode_attention(q, kd, vd, full)
        torch.cuda.synchronize()
        slot_err = (got - dense).abs().max().item()
        if not slot_err <= tol:
            raise AssertionError(f"paged_attention {dtype} disagrees with "
                                 f"the slot kernel on the gathered panel: "
                                 f"{slot_err:.3e}")
        ms = time_ms(lambda: pa.paged_attention(q, k, v, full_tbl, full))
        plain_ms = time_ms(lambda: pa.paged_attention_torch(
            q, k, v, full_tbl, full))
        slot_ms = time_ms(lambda: da.decode_attention(q, kd, vd, full))
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            q[:, :, None].to(dtype), kd, vd))
        item = k.element_size()
        nbytes = 2 * S * H * T * D * item + 2 * S * H * D * 4 \
            + S * B * 4 + S * 4
        flops = 4 * D * H * S * T
        bound_ms = max(nbytes / H100_BYTES_PER_S,
                       flops / H100_F32_FLOPS) * 1e3
        results[name] = dict(
            max_abs_err=err, tol=tol, slot_kernel_err=slot_err,
            live_blocks=used, ms=ms, plain_ms=plain_ms,
            slot_kernel_dense_ms=slot_ms, library_ms=lib_ms,
            bound_ms=bound_ms,
            bound_by="bytes" if nbytes / H100_BYTES_PER_S
            >= flops / H100_F32_FLOPS else "operations")
        print(f"paged_attention {name} S={S} H={H} Bs={Bs} D={D} B={B} "
              f"N={N}, every length {T}: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, slot kernel on the gathered panel "
              f"{slot_ms:.4f} ms, library (SDPA on the gathered panel, "
              f"gather not timed) {lib_ms:.4f} ms, bound {bound_ms:.4f} ms")
        del q, k, v, kd, vd
    return results


def cpu_copy(lm, cfg):
    """The same model with its weights copied to the CPU: the plain
    reference of the teacher-forced check."""
    from deeplearning4j_tpu_torch.zoo.transformer_lm import \
        CausalTransformerLM
    cpu = CausalTransformerLM(**cfg, device="cpu")
    cpu._params = {k: (v.cpu() if k != "blocks" else
                       [{n: w.cpu() for n, w in bp.items()} for bp in v])
                   for k, v in lm._params.items()}
    return cpu


def teacher_check(cpu, cases):
    """Every served greedy token must have a plain-CPU logit within
    TEACHER_TOL of the CPU maximum at its position. ``cases`` are
    (prompt, served tokens); returns (checked, exact, worst gap)."""
    checked = exact = 0
    worst_gap = 0.0
    for prompt, tokens in cases:
        logits = cpu.logits(np.asarray(list(prompt) + list(tokens))[None])[0]
        for j, t in enumerate(tokens):
            row = logits[len(prompt) - 1 + j]
            gap = float(row.max() - row[t])
            worst_gap = max(worst_gap, gap)
            exact += int(int(row.argmax()) == t)
            checked += 1
    if worst_gap > TEACHER_TOL:
        raise AssertionError(f"teacher-forced check: a served token is "
                             f"{worst_gap:.3e} below the CPU maximum")
    return checked, exact, worst_gap


def serve(card: str):
    from deeplearning4j_tpu_torch.kernels import decode_attention as da
    from deeplearning4j_tpu_torch.kernels import flash_attention as fa
    from deeplearning4j_tpu_torch.serving import GenerationEngine
    from deeplearning4j_tpu_torch.zoo.transformer_lm import \
        CausalTransformerLM
    cfg = SERVE_CFG
    lm = CausalTransformerLM(**cfg).init()
    eng = GenerationEngine(lm, num_slots=32)
    try:
        t0 = time.perf_counter()
        eng.warmup()
        warm_s = time.perf_counter() - t0
        rs = np.random.RandomState(0)
        reqs = []
        for i in range(32):
            plen = int(rs.randint(8, 601))
            sampled = i % 8 == 7
            reqs.append(dict(prompt=rs.randint(0, 32000, plen).tolist(),
                             max_tokens=int(rs.randint(32, 65)),
                             temperature=0.8 if sampled else 0.0,
                             top_k=40 if sampled else 0, seed=i))
        reset_launches()
        results, wall = run_requests(eng, reqs)
        launches = {"decode_attention": da.launches,
                    "flash_attention": fa.launches}
        check_lengths(results, reqs)
        if not all(launches.values()):
            raise AssertionError(f"a kernel of the path never launched: "
                                 f"{launches}")
        st = eng.stats()
        n_tok = sum(len(r["tokens"]) for r in results)
        prof = profile_window(eng)
    finally:
        eng.stop()

    # teacher-forced check: every greedy token the card emitted has a
    # plain-CPU logit within TEACHER_TOL of the CPU maximum there
    greedy = [i for i, q in enumerate(reqs) if q["temperature"] == 0.0][:4]
    checked, exact, worst_gap = teacher_check(
        cpu_copy(lm, cfg),
        [(reqs[i]["prompt"], results[i]["tokens"]) for i in greedy])
    e2e = dict(requests=len(reqs), tokens=n_tok, wall_s=wall,
               tokens_per_s=n_tok / wall,
               ttft_p50_ms=st["ttft_ms"]["p50"],
               ttft_p99_ms=st["ttft_ms"]["p99"],
               decode_step_p50_ms=st["decode_step_ms"]["p50"],
               decode_step_p99_ms=st["decode_step_ms"]["p99"],
               prefill_p50_ms=st["prefill_ms"]["p50"],
               decode_steps=st["decode_steps"], prefills=st["prefills"],
               mean_occupancy=st["slots"]["mean_occupancy"],
               warmup_s=warm_s, launches=launches,
               teacher_checked=checked, teacher_exact=exact,
               teacher_exact_rate=exact / max(checked, 1),
               teacher_worst_gap=worst_gap, profile=prof)
    print(f"e2e [{card}]: {n_tok} tokens from {len(reqs)} requests in "
          f"{wall:.3f} s = {e2e['tokens_per_s']:.1f} tokens/s, TTFT p50 "
          f"{e2e['ttft_p50_ms']:.1f} ms, decode step p50 "
          f"{e2e['decode_step_p50_ms']:.2f} ms, launches {launches}")
    print(f"teacher-forced: {checked} greedy tokens checked, exact-match "
          f"rate {e2e['teacher_exact_rate']:.4f}, worst gap "
          f"{worst_gap:.3e} (tol {TEACHER_TOL:g})")
    print_profile("profile window", card, prof)
    return e2e


def reset_launches():
    """Set every kernel's launch count to 0 (just before a path runs)."""
    from deeplearning4j_tpu_torch.kernels import decode_attention as da
    from deeplearning4j_tpu_torch.kernels import flash_attention as fa
    from deeplearning4j_tpu_torch.kernels import paged_attention as pa
    da.launches = fa.launches = pa.launches = 0


def paged_traffic(vocab: int):
    """The paged phase's requests, from a fixed seed: a primer (the
    320-token system prompt + 16 tokens), a burst of 48 (every third
    one unrelated, the rest the system prompt + an own suffix; every
    eighth one samples) and the first turns of 8 sessions, with the
    tails their second turns append."""
    rs = np.random.RandomState(3)
    system = rs.randint(0, vocab, 320).tolist()
    primer = dict(prompt=system + rs.randint(0, vocab, 16).tolist(),
                  max_tokens=16, seed=0)
    burst = []
    for i in range(48):
        if i % 3 == 2:
            prompt = rs.randint(0, vocab, rs.randint(8, 601)).tolist()
        else:
            prompt = system + rs.randint(0, vocab,
                                         rs.randint(8, 281)).tolist()
        sampled = i % 8 == 7
        burst.append(dict(prompt=prompt, max_tokens=int(rs.randint(32, 65)),
                          temperature=0.8 if sampled else 0.0,
                          top_k=40 if sampled else 0, seed=i))
    turn1 = []
    for j in range(8):
        sampled = j == 7
        turn1.append(dict(prompt=rs.randint(0, vocab,
                                            rs.randint(100, 401)).tolist(),
                          max_tokens=int(rs.randint(32, 65)),
                          temperature=0.8 if sampled else 0.0,
                          top_k=40 if sampled else 0, seed=100 + j,
                          session_id=f"conv-{j}"))
    tails = [dict(tail=rs.randint(0, vocab, rs.randint(8, 65)).tolist(),
                  max_tokens=int(rs.randint(32, 65))) for _ in range(8)]
    return primer, burst, turn1, tails


def serve_paged(card: str, cfg=SERVE_CFG, device=None):
    """Phase 5: the paged backend end to end (see the module doc)."""
    from deeplearning4j_tpu_torch.kernels import decode_attention as da
    from deeplearning4j_tpu_torch.kernels import flash_attention as fa
    from deeplearning4j_tpu_torch.kernels import paged_attention as pa
    from deeplearning4j_tpu_torch.serving import GenerationEngine
    from deeplearning4j_tpu_torch.zoo.transformer_lm import \
        CausalTransformerLM
    lm = CausalTransformerLM(**cfg, device=device).init()
    primer, burst, turn1, tails = paged_traffic(cfg["vocab_size"])
    bs = PAGED_ENGINE["block_size"]
    # a session's turn 2 matches the pinned prompt + tokens[:-1]
    mid_block = sum((len(t["prompt"]) + t["max_tokens"] - 1) % bs != 0
                    for t in turn1)
    if not mid_block:
        raise AssertionError("no session match ends mid-block: the "
                             "copy-on-write path would not run")
    eng = GenerationEngine(lm, **PAGED_ENGINE)
    try:
        t0 = time.perf_counter()
        eng.warmup()
        warm_s = time.perf_counter() - t0
        st0 = eng.stats()
        reset_launches()
        eng.generate(timeout_ms=600_000, **primer)
        results, wall = run_requests(eng, burst)
        res1, _ = run_requests(eng, turn1)
        turn2 = [dict(t, prompt=t["prompt"] + r["tokens"] + x["tail"],
                      max_tokens=x["max_tokens"])
                 for t, r, x in zip(turn1, res1, tails)]
        res2, _ = run_requests(eng, turn2)
        launches = {"decode_attention": da.launches,
                    "flash_attention": fa.launches,
                    "paged_attention": pa.launches}
        st = eng.stats()
        check_lengths(results + res1 + res2, burst + turn1 + turn2)
        steps = st["decode_steps"] - st0["decode_steps"]
        if not launches["paged_attention"] or \
                launches["paged_attention"] != cfg["n_layers"] * steps:
            raise AssertionError(f"paged kernel launches {launches} != "
                                 f"{cfg['n_layers']} x {steps} decode steps")
        pc = st["paged"]["prefix_cache"]
        if not (pc["prefix_hits"] >= 32 and pc["session_hits"] == 8
                and pc["cow_copies"] >= 1):
            raise AssertionError(f"prefix cache did not serve as "
                                 f"expected: {pc}")
        prof = profile_window(eng)
        eng.evict_sessions()
        eng.clear_prefix_cache()
        free = (eng._allocator.free_count, eng._allocator.capacity)
        if free[0] != free[1]:
            raise AssertionError(f"blocks leaked: {free[0]} of {free[1]} "
                                 f"free after the caches were cleared")
    finally:
        eng.stop()

    # the same burst on the slot engine: informative only, the two
    # kernels sum in different orders
    slot_eng = GenerationEngine(lm, num_slots=PAGED_ENGINE["num_slots"])
    try:
        slot_eng.warmup()
        slot_results, _ = run_requests(slot_eng, burst)
    finally:
        slot_eng.stop()
    greedy = [i for i, q in enumerate(burst) if q["temperature"] == 0.0]
    same = sum(slot_results[i]["tokens"] == results[i]["tokens"]
               for i in greedy)

    shared = [i for i in greedy if burst[i]["prompt"][:320]
              == primer["prompt"][:320]][:4]
    resumed = [j for j, t in enumerate(turn2) if t["temperature"] == 0.0][:2]
    checked, exact, worst_gap = teacher_check(
        cpu_copy(lm, cfg),
        [(burst[i]["prompt"], results[i]["tokens"]) for i in shared]
        + [(turn2[j]["prompt"], res2[j]["tokens"]) for j in resumed])
    n_tok = sum(len(r["tokens"]) for r in results)
    e2e = dict(requests=len(burst), tokens=n_tok, wall_s=wall,
               tokens_per_s=n_tok / wall,
               ttft_p50_ms=st["ttft_ms"]["p50"],
               ttft_p99_ms=st["ttft_ms"]["p99"],
               decode_step_p50_ms=st["decode_step_ms"]["p50"],
               decode_step_p99_ms=st["decode_step_ms"]["p99"],
               prefill_chunk_p50_ms=st["prefill_ms"]["p50"],
               decode_steps=steps, prefill_chunks=st["paged"]["prefill_chunks"],
               prefix_hits=pc["prefix_hits"],
               session_hits=pc["session_hits"],
               cow_copies=pc["cow_copies"],
               prefix_tokens_matched=pc["prefix_tokens_matched"],
               prefill_tokens=pc["prefill_tokens"],
               blocks_peak_used=st["paged"]["blocks_peak_used"],
               blocks_total=st["paged"]["blocks_total"],
               session_mid_block_matches=mid_block,
               warmup_s=warm_s, launches=launches,
               teacher_checked=checked, teacher_exact=exact,
               teacher_exact_rate=exact / max(checked, 1),
               teacher_worst_gap=worst_gap,
               slot_engine_greedy_identical=f"{same}/{len(greedy)}",
               profile=prof)
    print(f"e2e paged [{card}]: {n_tok} tokens from {len(burst)} requests "
          f"in {wall:.3f} s = {e2e['tokens_per_s']:.1f} tokens/s; phase "
          f"TTFT p50/p99 {e2e['ttft_p50_ms']:.1f}/{e2e['ttft_p99_ms']:.1f} "
          f"ms, decode step p50/p99 {e2e['decode_step_p50_ms']:.2f}/"
          f"{e2e['decode_step_p99_ms']:.2f} ms, prefill chunk p50 "
          f"{e2e['prefill_chunk_p50_ms']:.2f} ms, {pc['prefix_hits']} "
          f"prefix hits ({pc['session_hits']} sessions), "
          f"{pc['prefix_tokens_matched']} prompt tokens matched, "
          f"{pc['cow_copies']} COW copies, peak {e2e['blocks_peak_used']} "
          f"of {e2e['blocks_total']} blocks, launches {launches} over "
          f"{steps} decode steps")
    print(f"teacher-forced (paged): {checked} greedy tokens of "
          f"{len(shared)} shared-prefix and {len(resumed)} turn-2 requests, "
          f"exact-match rate {e2e['teacher_exact_rate']:.4f}, worst gap "
          f"{worst_gap:.3e} (tol {TEACHER_TOL:g}); slot engine on the same "
          f"burst: {same} of {len(greedy)} greedy requests identical")
    print_profile("profile window paged", card, prof)
    return e2e


def check_lengths(results, reqs):
    """Every request must run its full length (eos_id is None)."""
    for r, q in zip(results, reqs):
        if r["finish_reason"] != "length" or \
                len(r["tokens"]) != q["max_tokens"]:
            raise AssertionError(f"request did not run its length: {r}")


def print_profile(label: str, card: str, prof: dict):
    print(f"{label} [{card}] (8 requests, prompt 256, 16 tokens, "
          f"profiler on): device busy {prof['busy_share']:.3f} of "
          f"{prof['wall_ms']:.1f} ms, {prof['device_kernels']} device "
          f"kernels over {prof['prefills']} prefills and "
          f"{prof['decode_steps']} decode steps; top kernels (ms): "
          + ", ".join(f"{n[:60]} {t:.3f}" for n, t in prof["top"]))


def run_requests(eng, reqs):
    """Submit every request at once from its own thread; returns the
    results and the wall time. A failed request fails the run."""
    results = [None] * len(reqs)
    errors = [None] * len(reqs)

    def go(i):
        try:
            results[i] = eng.generate(timeout_ms=600_000, **reqs[i])
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors[i] = e

    t0 = time.perf_counter()
    threads = [threading.Thread(target=go, args=(i,))
               for i in range(len(reqs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    for i, e in enumerate(errors):
        if e is not None:
            raise RuntimeError(f"request {i} failed") from e
    return results, wall


def profile_window(eng):
    """Kernel time by name and the device's busy share over a short
    window of traffic on the warmed engine, from torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    reqs = [dict(prompt=list(range(1, 257)), max_tokens=16, seed=i)
            for i in range(8)]
    st0 = eng.stats()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as p:
        _, wall = run_requests(eng, reqs)
        torch.cuda.synchronize()
    st1 = eng.stats()
    kernels = {}
    n_kernels = 0
    for e in p.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        kernels[e.key] = kernels.get(e.key, 0.0) + us / 1e3
        n_kernels += e.count
    busy_ms = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    return dict(wall_ms=wall * 1e3, busy_ms=busy_ms,
                busy_share=busy_ms / (wall * 1e3), top=top,
                device_kernels=n_kernels,
                decode_steps=st1["decode_steps"] - st0["decode_steps"],
                prefills=st1["prefills"] - st0["prefills"])


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from deeplearning4j_tpu_torch.kernels import _build
    dev = torch.device("cuda")
    card = card_line()
    print(f"device: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.device_count()} device(s)")

    t0 = time.perf_counter()
    logs = _build.build()
    print(f"build: {sorted(logs)} in {time.perf_counter() - t0:.1f} s")
    for name, log in sorted(logs.items()):
        for line in log["ptxas"].splitlines():
            if "entry function" in line or "registers" in line \
                    or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")

    decode = check_decode(dev)
    flash = check_flash(dev)
    paged = check_paged(dev)
    e2e = serve(card)
    e2e_paged = serve_paged(card)

    kernels = [
        dict(name="decode_attention", route="cuda",
             source="deeplearning4j_tpu_torch/csrc/decode_attention.cu",
             replaces="deeplearning4j_tpu/kernels/decode_attention.py:100",
             launches=e2e["launches"]["decode_attention"],
             **{k: decode["float32"][k] for k in
                ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")},
             library_ms=decode["float32"]["library_ms"]),
        dict(name="flash_attention", route="cuda",
             source="deeplearning4j_tpu_torch/csrc/flash_attention.cu",
             replaces="deeplearning4j_tpu/kernels/flash_attention.py:65",
             launches=e2e["launches"]["flash_attention"],
             **{k: flash[k] for k in
                ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")},
             library_ms=flash["library_ms"]),
        dict(name="paged_attention", route="cuda",
             source="deeplearning4j_tpu_torch/csrc/paged_attention.cu",
             replaces="deeplearning4j_tpu/kernels/paged_attention.py:80",
             launches=e2e_paged["launches"]["paged_attention"],
             **{k: paged["float32"][k] for k in
                ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")},
             library_ms=paged["float32"]["library_ms"]),
    ]
    print("details: " + json.dumps(
        dict(card=card, decode=decode, flash=flash, paged=paged, e2e=e2e,
             e2e_paged=e2e_paged,
             build={n: l["seconds"] for n, l in logs.items()}),
        default=str))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
