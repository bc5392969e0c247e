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
   against a CPU copy of the model holds each greedy token. The same
   requests then run through the eager decode step, and every token
   must be the CUDA graph's;
5. end to end on the paged backend: the same model served by the
   paged configuration of docs/generation.md (64 slots, 4096 blocks of
   16, chunks of 512, prefix sharing on): a primer that registers a
   320-token system prompt, 48 concurrent requests (32 of them behind
   that prompt) and 8 two-turn sessions. The paged kernel must launch
   once per layer and decode step, prefixes and sessions must hit,
   copy-on-write must run, the teacher-forced check must hold, and
   every block must come back to the pool;
6. int8 on the slot backend: phase 4's 32 requests served by
   GenerationEngine(num_slots=32, kv_dtype="int8"); the int8 decode
   kernel must launch once per layer and decode step, the flash kernel
   must run the prefills, and a teacher-forced check against the port's
   own int8 path on a CPU copy holds each greedy token;
7. int8 on the paged backend: phase 5's configuration and traffic with
   kv_dtype="int8", on a model copy whose MLP weights went through
   quantize_mlp_weights; the int8 paged kernel must launch once per
   layer and decode step, prefixes, sessions and copy-on-write must
   run, the int8 teacher-forced check must hold, and every block must
   come back;
8. flash backward: the dQ and dK/dV kernels against their plain
   versions over the prefill buckets (B=4, a ragged key mask and a
   fully masked row, which must give exactly 0), two calls of each
   bit-identical, then timed at the training shapes beside SDPA's
   backward, with their share of the 3xTF32-rate and f32-rate bounds;
   Then the bf16 legs of the three flash kernels (f32 from the same
   bf16 values in their plain versions) at phase 10's shapes (B=4, H=8,
   T=1024, D=64) and at B=1, causal and not, with a ragged key mask and
   a fully masked row (O and gradients exactly 0), two calls of each
   bit-identical, then each timed beside its bound at the bf16 rate,
   its plain version and SDPA at bf16 (its backward for dQ and dK/dV).
   The forward is also timed beside SDPA's bf16 forward with is_causal,
   and, like the dQ and dK/dV pair and the whole bf16 backward (delta,
   dQ, dK/dV), beside SDPA (with the mask and with is_causal) at B = 1
   and 4 and T = 1024, 2048 and 4096;
9. training: the served width in the layer DSL fitted through
   MultiLayerNetwork.fit (one warmup and five timed Adam steps of
   4 x 1024 tokens); each flash kernel must launch once per layer and
   step, the loss must fall, and a 2-block copy's loss and gradients on
   the card must match a CPU copy;
10. bf16 training: phase 9 with data_type("bfloat16") (the bf16
   mixed-precision policy: every layer but the output layer computes in
   bf16, the masters and Adam state stay f32); each bf16 flash leg must
   launch once per layer and step and the f32 legs never, the loss must
   fall, the masters and Adam state must stay f32, and a 2-block copy's
   loss and gradients on the card must match a CPU copy at bf16. Its
   profiled step splits device time into bf16 GEMMs, f32 GEMMs (the
   output layer), flash and the rest;
11. the fault ladder, on the warmed engines of phase 4 (slots, f32)
   and phase 7 (paged, int8) after their fault-free runs, through
   set_fault_injector (no warmup or capture added): phase 4's 32
   requests, and phase 7's primer and 48-request burst, again, each
   under one seeded FaultInjector plan with one transient fault
   (retried) and one corrupting fault (recovered) that lands while
   several lanes decode and, on the paged engine, while a two-chunk
   prompt is mid-chunk. No request may be lost, retries and recoveries
   must be one each, nothing may be captured, the decode kernel must
   launch once per layer and step, the slot engine's flash kernel once
   per layer and prefill (each re-admitted request re-prefilled once),
   the paged engine's chunks must outnumber a fault-free run's, every
   block must come back, and every lane's tokens must equal the same
   engine's fault-free tokens unless their first difference is a
   near-tie of the CPU reference at the phase's teacher tolerance. It
   prints how many lanes differed and the recovery's wall time (the
   fault to the last re-admitted lane's next token).

Phases 4 to 7 serve with the engine's defaults on the card: the
pipelined decode loop, and the decode step captured at warmup as one
CUDA graph and replayed every step (a replay counts the launches the
capture recorded). Each phase must capture exactly once, at warmup.

Phase 3 also checks the two int8 kernels (decode and paged) against
their plain versions at the served shapes, with NaN in the scale rows
of the null block and of every stale tail, a length-0 lane, two calls
giving the same bits, and K/V of mixed quantisation refused, and
reports their registers, spills and blocks per SM. The flash forward
(3xTF32 on the tensor cores) is also checked on a fully masked row (O
0, LSE -1e30) and timed at B=1 and B=4 beside both its bounds; each
key-group count (one and two groups of warps a block) is held against
the plain version there and timed over a sweep of batch and length
(the measurement behind the rule that picks it); the flash forward
must give the same bits on two calls, and reports registers, spills
and blocks per SM.
Phase 2 counts HMMA (``mma.sync``) and HGMMA (``wgmma``) in every flash
kernel and I2F in the two int8 kernels from ``cuobjdump -sass`` where
the toolkit has it: the three bf16 flash kernels (forward, dQ, dK/dV)
must run bf16 HGMMA and no HMMA at each head-dim bucket (32, 64, 128),
the f32 flash kernels HMMA, and the int8 kernels must convert without
I2F.

A "details:" line carries every measured number as JSON; then come
the kernels line, the card's name and power limit, and last
{"ok": true, "device": {...}}.

    python3 chip_smoke.py --ab PARENT_CHECKOUT

compares the code of another checkout with this one on the card
instead: each checkout's own code in turns (parent, this, this,
parent), each turn a process of its own, timing the flash forward at
B=1 and B=4 and its backward kernels at B=4, the bf16 legs of all
three and the whole bf16 backward (delta included) at B=4, T=1024,
the decode and paged kernels, f32 and int8 (their phase-3 checks),
serving phases 4 to 7 with their profile windows, and phase 10 (step
p50, the host's enqueue p50, device time by kind); an "A/B runs:"
line carries every turn as JSON.
"""
from __future__ import annotations

import json
import os
import re
import shutil
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
INT8_TOL = 2e-2         # int8 kernels: the kernel rounds the unnormalised
#                         p * vscale to bf16 (as the Pallas kernel), the
#                         plain version the normalised one; each within
#                         2^-8 of its term, so an output may move by up to
#                         2^-7 of the largest |dequantised v| it averages.
#                         The JAX package's own Pallas-vs-xla int8
#                         tolerance; 1.0e-2 measured on an H100 here
FLASH_BWD_TOL = 1e-4    # relative to the largest gradient (at least
#                         1): f32, sums over up to 1024 keys in another
#                         order; dp = dO.V over D=64 has std 8 here, so
#                         gradients reach ~10
TRAIN_LOSS_RTOL = 1e-4  # card vs CPU loss of one step: f32 on both, a
#                         mean over 1024 tokens summed in another order
TRAIN_GRAD_TOL = 1e-3   # card vs CPU, each gradient leaf's max error over
#                         its max |value|: f32 on both, but GEMMs over
#                         512-2048 terms and attention over 1024 keys sum
#                         in another order, and a leaf's small entries
#                         (embedding rows, biases) carry that error
FLASH_BF16_O_TOL = 1e-2     # bf16 legs vs plain, times max(1, max|O|): P
#                             is rounded to bf16 before P V, and both
#                             sides round O to bf16 (one ulp is up to
#                             2^-7 of the largest value)
FLASH_BF16_GRAD_TOL = 2e-2  # times max(1, max|grad|): P and dS rounded to
#                             bf16 before the second products, then the
#                             gradients rounded to bf16 on both sides
FLASH_BF16_LSE_TOL = 1e-5   # f32 on both sides, from bf16-exact products;
#                             9.5e-7 measured on an H100 at these shapes
TRAIN_BF16_LOSS_RTOL = 1e-2  # phase 10, card vs CPU at bf16: both round
#                              activations to bf16 (~2^-9 an op), at other
#                              places and in another order
TRAIN_BF16_GRAD_TOL = 3e-2   # each leaf's max error over its max |value|:
#                              bf16 activations on both sides, and the
#                              small leaves (biases, norm gains) sum 1024
#                              tokens' bf16-rounded terms
INT8_TEACHER_TOL = 1e-2  # int8 teacher-forced gap: card and CPU both run
#                         int8, but sums in another order can move a K/V
#                         value across an int8 rounding boundary (one step
#                         is ~1% of its row's max) and the kernels round p
#                         before normalising; the whole int8-vs-f32 logit
#                         error is 6.4e-3 at this width (CPU), a wrong
#                         scale or a leaked tail moves logits by ~0.1 and up

#: the served model (docs/generation.md), random weights from seed 0;
#: eos_id=None so every request runs its full length
SERVE_CFG = dict(vocab_size=32000, d_model=512, n_layers=8, n_heads=8,
                 max_seq_len=1024, eos_id=None, seed=0)
#: the paged configuration of docs/generation.md
PAGED_ENGINE = dict(num_slots=64, cache="paged", block_size=16,
                    num_blocks=4096, prefill_chunk_tokens=512)

#: the training phase: SERVE_CFG's width in the layer DSL, batches of 4
#: sequences of 1024 tokens
TRAIN_CFG = dict(vocab_size=32000, d_model=512, n_layers=8, n_heads=8,
                 d_ff=2048, batch=4, seq_len=1024, lr=1e-3, seed=0)
TRAIN_STEPS = 5  # timed steps, after one warmup step

H100_BYTES_PER_S = 3.35e12  # HBM3, NVIDIA data sheet (SXM)
H100_F32_FLOPS = 67e12      # f32 outside the tensor cores
H100_TF32_FLOPS = 495e12    # TF32 tensor cores, dense
H100_BF16_FLOPS = 989e12    # bf16 tensor cores, dense

#: the device-side names of the port's kernels (csrc/*.cu)
PORT_KERNEL = re.compile(r"(decode_attention|paged_attention|flash_fwd|"
                         r"flash_bwd_dq|flash_bwd_dkv)\w*_kernel")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Device time per call of ``fn``. The timed calls queue up behind
    a device-side sleep that outlasts their enqueue, so the host's time
    between launches (Python, the wrappers' checks, ctypes) is not
    counted: a kernel shorter than its wrapper would otherwise be timed
    at the host's launch rate."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    once_s = time.perf_counter() - t0  # bounds one call's enqueue
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    # cycles at 2 GHz, above the H100's top SM clock: the sleep lasts
    # at least twice the whole loop's enqueue
    torch.cuda._sleep(int(2e9 * 2 * iters * once_s))
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
    """Phase 3's flash forward (B3): against its plain version over the
    prefill buckets (B=1, causal, a padded prompt), a fully masked row
    (O exactly 0, LSE exactly -1e30), two calls bit-identical, then
    timed at T=1024 with B=1 (a served prefill) and B=4 (a training
    batch) beside SDPA, with its share of the 3xTF32-rate and f32-rate
    bounds and either key-group count."""
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
    # a batch row whose keys are all masked, non-causal and causal
    q, k, v = (torch.randn((2, 257, H, D), generator=g).to(dev)
               for _ in range(3))
    km = torch.ones((2, 257), device=dev)
    km[1] = 0.0
    for causal in (False, True):
        ref = fa.flash_attention_torch(q, k, v, causal, km)
        # the chosen version, then each key-group count forced
        for kg in (None, 1, 2):
            o, lse = fa._flash_attention_cuda(q, k, v, causal, km, kg)
            err = _max_err((o, lse), ref)
            if not (err <= FLASH_TOL and o[1].abs().max().item() == 0.0
                    and bool((lse[1] == -1e30).all())):
                raise AssertionError(
                    f"flash_attention causal={causal} key groups {kg}: a "
                    f"fully masked row must give O = 0 and LSE = -1e30 "
                    f"(err {err:.3e})")
    print("flash_attention fully masked row (T=257, causal and not, one and "
          "two key groups): O 0, LSE -1e30")
    # timed at the largest prefill bucket, causal, every key live
    T = 1024
    rows = {}
    for B in (1, 4):
        q, k, v = (torch.randn((B, T, H, D), generator=g).to(dev)
                   for _ in range(3))
        km = torch.ones((B, T), device=dev)
        first = fa.flash_attention(q, k, v, True, km)
        again = fa.flash_attention(q, k, v, True, km)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(first, again)):
            raise AssertionError(f"flash_attention B={B}: two calls on the "
                                 f"same inputs differ")
        # the chosen version and each forced key-group count against plain
        ref = fa.flash_attention_torch(q, k, v, True, km)
        errs = {kg: _max_err(fa._flash_attention_cuda(q, k, v, True, km, kg),
                             ref) for kg in (1, 2)}
        errs["chosen"] = _max_err(first, ref)
        if not max(errs.values()) <= FLASH_TOL:
            raise AssertionError(f"flash_attention B={B} T={T} disagrees "
                                 f"with its plain version by key groups: "
                                 f"{errs}")
        worst = max(worst, errs["chosen"])
        ms = time_ms(lambda: fa.flash_attention(q, k, v, True, km))
        groups_ms = {kg: time_ms(lambda kg=kg: fa._flash_attention_cuda(
            q, k, v, True, km, kg)) for kg in (1, 2)}
        plain_ms = time_ms(lambda: fa.flash_attention_torch(q, k, v, True,
                                                            km))
        mask = torch.ones((T, T), dtype=torch.bool, device=dev).tril()[
            None, None] & (km > 0)[:, None, None, :]
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask))
        flops = 4 * D * H * B * (T * (T + 1) // 2)
        nbytes = 4 * B * T * H * D * 4 + B * T * 4 + B * H * T * 4
        # three TF32 products per f32 product (3xTF32)
        bound_ms, bound_by = _bound(nbytes, 3 * flops, H100_TF32_FLOPS)
        bound_f32_ms, _ = _bound(nbytes, flops)
        rows[B] = dict(ms=ms, key_groups_ms=groups_ms, err=errs,
                       plain_ms=plain_ms,
                       library_ms=lib_ms, bound_ms=bound_ms,
                       bound_by=bound_by, bound_f32_ms=bound_f32_ms,
                       share_of_bound=bound_ms / ms,
                       share_of_f32_bound=bound_f32_ms / ms,
                       gflop=flops / 1e9)
        print(f"flash_attention B={B} H={H} T={T} D={D} causal: kernel "
              f"{ms:.4f} ms (key groups 1: {groups_ms[1]:.4f}, 2: "
              f"{groups_ms[2]:.4f}), plain {plain_ms:.4f} ms, library "
              f"{lib_ms:.4f} ms, bound {bound_ms:.4f} ms at 3xTF32 (share "
              f"{bound_ms / ms:.3f}), {bound_f32_ms:.4f} ms at f32 (share "
              f"{bound_f32_ms / ms:.3f}); two calls bit-identical; "
              f"max_abs_err by key groups {errs} (tol {FLASH_TOL:g})")
    info = {d: {kg: fa.fwd_kernel_info(d, kg) for kg in (1, 2)}
            for d in (32, 64, 128)}
    print(f"flash_attention registers, spills, shared bytes, blocks per SM "
          f"by head dim and key groups: {info}")
    return dict(max_abs_err=worst, tol=FLASH_TOL, per_bucket=per_bucket,
                **rows[1], b4=rows[4], info=info,
                key_group_sweep=key_group_sweep(dev, g))


def _max_err(got, ref) -> float:
    """Largest |difference| over the forward's (O, LSE) pair."""
    return max((a - b).abs().max().item() for a, b in zip(got, ref))


#: (B, T) at H=8, D=64: served prefill buckets at B=1 (8 to 128 blocks of
#: 64 query rows) and batches from 192 to 512 blocks (training's is the
#: last), two at 384 blocks with different T
KEY_GROUP_SHAPES = ((1, 64), (1, 128), (1, 256), (1, 512), (1, 1024),
                    (2, 768), (2, 1024), (3, 768), (4, 640), (3, 896),
                    (3, 960), (3, 1024), (6, 512), (4, 1024))


def key_group_sweep(dev, g):
    """The forward with one and with two key groups per block, each held
    against its plain version (causal, every key live) and timed, over
    KEY_GROUP_SHAPES: the measurement behind key_groups_for's rule."""
    import torch
    from deeplearning4j_tpu_torch.kernels import flash_attention as fa
    H, D = 8, 64
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = []
    for B, T in KEY_GROUP_SHAPES:
        q, k, v = (torch.randn((B, T, H, D), generator=g).to(dev)
                   for _ in range(3))
        km = torch.ones((B, T), device=dev)
        ref = fa.flash_attention_torch(q, k, v, True, km)
        row = dict(B=B, T=T, blocks=B * H * -(-T // 64),
                   chosen=fa.key_groups_for(B, T, H, dev))
        for kg in (1, 2):
            err = _max_err(fa._flash_attention_cuda(q, k, v, True, km, kg),
                           ref)
            if not err <= FLASH_TOL:
                raise AssertionError(f"flash_attention B={B} T={T} key "
                                     f"groups {kg}: {err:.3e} from plain")
            row[f"err_{kg}"] = err
            row[f"ms_{kg}"] = time_ms(
                lambda kg=kg: fa._flash_attention_cuda(q, k, v, True, km, kg))
        out.append(row)
        print(f"flash_attention key groups B={B} T={T} ({row['blocks']} "
              f"blocks on {sms} SMs): 1 group {row['ms_1']:.4f} ms, 2 groups "
              f"{row['ms_2']:.4f} ms, chosen {row['chosen']}; max_abs_err "
              f"{row['err_1']:.2e}, {row['err_2']:.2e}")
    return out


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


def _bound(nbytes, flops, rate=H100_F32_FLOPS):
    """The least time on the card (ms) for ``nbytes`` moved and
    ``flops`` done at ``rate`` (default the f32 rate), and which of the
    two sets it."""
    b, f = nbytes / H100_BYTES_PER_S, flops / rate
    return max(b, f) * 1e3, "bytes" if b >= f else "operations"


def _refuses_mixed(fn, quant, plain):
    """Mixed quantisation must raise, either way round."""
    for a, b in ((quant, plain), (plain, quant)):
        try:
            fn(a, b)
        except ValueError:
            continue
        raise AssertionError("K/V of mixed quantisation was not refused")


def check_decode_int8(dev):
    """The int8 decode kernel against its plain version at the slot
    phase's shapes (32 slots, 8 heads, T=1024, D=64), NaN in every stale
    tail's scales, then timed with every slot full."""
    import torch
    import torch.nn.functional as F
    from deeplearning4j_tpu_torch.kernels import decode_attention as da
    from deeplearning4j_tpu_torch.kernels import kv_quant as kvq
    S, H, T, D = 32, 8, 1024, 64
    g = torch.Generator(device="cpu").manual_seed(5)
    q = torch.randn((S, H, D), generator=g).to(dev)
    k = kvq.quantize_rows(torch.randn((S, H, T, D), generator=g).to(dev))
    v = kvq.quantize_rows(torch.randn((S, H, T, D), generator=g).to(dev))
    lens = torch.randint(1, T + 1, (S,), generator=g)
    lens[0], lens[1], lens[2] = 0, T, 1
    clean_k, clean_v = k.scale.clone(), v.scale.clone()
    for s in range(S):  # a stale tail's scale may be NaN
        k.scale[s, :, int(lens[s]):] = float("nan")
        v.scale[s, :, int(lens[s]):] = float("nan")
    lens = lens.to(dev, torch.int32)
    got = da.decode_attention(q, k, v, lens)
    again = da.decode_attention(q, k, v, lens)
    want = da.decode_attention_torch(q, k, v, lens)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    finite = bool(torch.isfinite(got).all())
    zero_row = got[0].abs().max().item()
    same = torch.equal(got, again)
    print(f"decode_attention int8: max_abs_err {err:.3e} (tol {INT8_TOL:g}),"
          f" finite {finite}, len-0 row max {zero_row}, two calls "
          f"bit-identical {same}")
    if not (finite and err <= INT8_TOL and zero_row == 0.0 and same):
        raise AssertionError("decode_attention int8 disagrees with its "
                             "plain version or with itself")
    _refuses_mixed(lambda a, b: da.decode_attention(q, a, b, lens), k,
                   kvq.dequantize(v))
    k.scale.copy_(clean_k)
    v.scale.copy_(clean_v)
    full = torch.full((S,), T, dtype=torch.int32, device=dev)
    ms = time_ms(lambda: da.decode_attention(q, k, v, full))
    plain_ms = time_ms(lambda: da.decode_attention_torch(q, k, v, full))
    kd, vd = kvq.dequantize(k), kvq.dequantize(v)  # not timed
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        q[:, :, None], kd, vd))
    nbytes = 2 * S * H * T * D + 2 * S * H * T * 4 + 2 * S * H * D * 4 \
        + S * 4
    bound_ms, bound_by = _bound(nbytes, 4 * D * H * S * T)
    info = {d: da.int8_kernel_info(d) for d in (12, 32, 64, 128)}
    print(f"decode_attention int8 S={S} H={H} T={T} D={D}: kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, library (SDPA on the "
          f"dequantised f32 panel, dequantisation not timed) {lib_ms:.4f} "
          f"ms, bound {bound_ms:.4f} ms (share {bound_ms / ms:.3f}); "
          f"registers, spills, blocks per SM and load width by head dim: "
          f"{info}")
    return dict(max_abs_err=err, tol=INT8_TOL, ms=ms, plain_ms=plain_ms,
                library_ms=lib_ms, bound_ms=bound_ms, bound_by=bound_by,
                info=info)


def check_paged_int8(dev):
    """The int8 paged kernel against its plain version at the paged
    phase's shapes (64 slots, 8 heads, blocks of 16, D=64, 64-entry
    tables, a 4096-block pool) over non-contiguous blocks, NaN in the
    null block's and every stale tail's scale rows, then timed with
    every slot at length 1024."""
    import torch
    import torch.nn.functional as F
    from deeplearning4j_tpu_torch.kernels import decode_attention as da
    from deeplearning4j_tpu_torch.kernels import kv_quant as kvq
    from deeplearning4j_tpu_torch.kernels import paged_attention as pa
    S, H, Bs, D, B, N = 64, 8, 16, 64, 64, 4096
    T = B * Bs
    rs = np.random.RandomState(6)
    g = torch.Generator(device="cpu").manual_seed(6)
    q = torch.randn((S, H, D), generator=g).to(dev)
    k = kvq.quantize_rows(torch.randn((N, H, Bs, D), generator=g).to(dev))
    v = kvq.quantize_rows(torch.randn((N, H, Bs, D), generator=g).to(dev))
    clean_k, clean_v = k.scale.clone(), v.scale.clone()
    lens = rs.randint(1, T + 1, S)
    lens[:6] = [0, 1, 15, 16, 17, T]
    perm = rs.permutation(np.arange(1, N))
    tbl = np.zeros((S, B), np.int32)
    used = 0
    for s, n in enumerate(lens):
        nb = -(-int(n) // Bs)
        tbl[s, :nb] = perm[used:used + nb]
        used += nb
        if n % Bs:  # the stale tail of the last live block
            k.scale[int(tbl[s, nb - 1]), :, int(n % Bs):] = float("nan")
            v.scale[int(tbl[s, nb - 1]), :, int(n % Bs):] = float("nan")
    k.scale[0] = float("nan")  # the null block, where padded lanes write
    v.scale[0] = float("nan")
    tbl_d = torch.from_numpy(tbl).to(dev)
    lens_d = torch.from_numpy(lens.astype(np.int32)).to(dev)
    got = pa.paged_attention(q, k, v, tbl_d, lens_d)
    again = pa.paged_attention(q, k, v, tbl_d, lens_d)
    want = pa.paged_attention_torch(q, k, v, tbl_d, lens_d)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    finite = bool(torch.isfinite(got).all())
    zero_row = got[0].abs().max().item()
    same = torch.equal(got, again)
    print(f"paged_attention int8: max_abs_err {err:.3e} (tol {INT8_TOL:g}), "
          f"finite {finite}, len-0 row max {zero_row}, {used} live blocks, "
          f"two calls bit-identical {same}")
    if not (finite and err <= INT8_TOL and zero_row == 0.0 and same):
        raise AssertionError("paged_attention int8 disagrees with its plain "
                             "version or with itself")
    _refuses_mixed(lambda a, b: pa.paged_attention(q, a, b, tbl_d, lens_d),
                   k, kvq.dequantize(v))
    k.scale.copy_(clean_k)
    v.scale.copy_(clean_v)
    full_tbl = torch.from_numpy(np.resize(
        rs.permutation(np.arange(1, N)), S * B).reshape(S, B)
        .astype(np.int32)).to(dev)
    full = torch.full((S,), T, dtype=torch.int32, device=dev)
    gk, gv = pa.gather_blocks(k, full_tbl), pa.gather_blocks(v, full_tbl)
    kd = kvq.QuantArray(gk.q.contiguous(), gk.scale.contiguous())
    vd = kvq.QuantArray(gv.q.contiguous(), gv.scale.contiguous())
    got = pa.paged_attention(q, k, v, full_tbl, full)
    dense = da.decode_attention(q, kd, vd, full)
    torch.cuda.synchronize()
    slot_err = (got - dense).abs().max().item()
    if not slot_err <= DECODE_TOL_F32:
        raise AssertionError(f"paged_attention int8 disagrees with the int8 "
                             f"slot kernel on the gathered panel: "
                             f"{slot_err:.3e}")
    ms = time_ms(lambda: pa.paged_attention(q, k, v, full_tbl, full))
    plain_ms = time_ms(lambda: pa.paged_attention_torch(
        q, k, v, full_tbl, full))
    slot_ms = time_ms(lambda: da.decode_attention(q, kd, vd, full))
    kf, vf = kvq.dequantize(kd), kvq.dequantize(vd)  # not timed
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        q[:, :, None], kf, vf))
    nbytes = 2 * S * H * T * D + 2 * S * H * T * 4 + 2 * S * H * D * 4 \
        + S * B * 4 + S * 4
    bound_ms, bound_by = _bound(nbytes, 4 * D * H * S * T)
    print(f"paged_attention int8 S={S} H={H} Bs={Bs} D={D} B={B} N={N}, "
          f"every length {T}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"int8 slot kernel on the gathered panel {slot_ms:.4f} ms, "
          f"library (SDPA on the gathered dequantised f32 panel, gather and "
          f"dequantisation not timed) {lib_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms")
    info = {d: pa.int8_kernel_info(d) for d in (12, 32, 64, 128)}
    print(f"paged_attention int8 registers, spills, blocks per SM and load "
          f"width by head dim: {info}")
    return dict(max_abs_err=err, tol=INT8_TOL, slot_kernel_err=slot_err,
                live_blocks=used, ms=ms, plain_ms=plain_ms,
                slot_kernel_dense_ms=slot_ms, library_ms=lib_ms,
                bound_ms=bound_ms, bound_by=bound_by, info=info)


def cpu_copy(lm, cfg):
    """The same model with its weights (int8 MLP weights included)
    copied to the CPU: the plain reference of the teacher-forced
    checks."""
    from deeplearning4j_tpu_torch.zoo.transformer_lm import \
        CausalTransformerLM
    cpu = CausalTransformerLM(**cfg, device="cpu")
    cpu._params = {k: (v.to("cpu") if k != "blocks" else
                       [{n: w.to("cpu") for n, w in bp.items()} for bp in v])
                   for k, v in lm._params.items()}
    return cpu


def f32_rows(cpu, prompt, tokens):
    """Plain f32 logits rows predicting each served token."""
    import torch
    with torch.inference_mode():
        logits = cpu.logits(np.asarray(list(prompt) + list(tokens))[None])[0]
    return logits[len(prompt) - 1:len(prompt) - 1 + len(tokens)]


def int8_slot_rows(cpu, prompt, tokens):
    """The port's own int8 slot path on the CPU: the prompt attends its
    own f32 K/V, which go into an int8 cache; each later token is a
    decode step over that cache, fed the served tokens."""
    import torch
    from deeplearning4j_tpu_torch.kernels.kv_quant import kv_update_slice
    from deeplearning4j_tpu_torch.serving import KVCache
    cache = KVCache(cpu.cache_shapes(), 1, kv_dtype="int8", device="cpu")
    params = cpu._params
    with torch.inference_mode():
        logits, ks, vs = cpu.forward_prefill(params,
                                             torch.tensor([list(prompt)]))
        for pool, slab in zip(cache.ks + cache.vs, ks + vs):
            kv_update_slice(pool, slab, (0, 0, 0, 0))
        rows = [logits[0, -1]]
        for j, t in enumerate(tokens[:-1]):
            lg, _, _ = cpu.forward_decode(
                params, torch.tensor([t]), torch.tensor([len(prompt) + j]),
                cache.ks, cache.vs)
            rows.append(lg[0])
    return torch.stack(rows)


def int8_paged_rows(cpu, prompt, tokens):
    """The port's own int8 paged path on the CPU: every query attends
    over the quantised pool, so one chunk over the whole served sequence
    gives every position's logits, whatever the chunking was."""
    import torch
    from deeplearning4j_tpu_torch.serving import PagedKVCache
    from deeplearning4j_tpu_torch.serving.paging import blocks_for
    bs = PAGED_ENGINE["block_size"]
    seq = list(prompt) + list(tokens[:-1])
    nb = blocks_for(len(seq), bs)
    pool = PagedKVCache(cpu.cache_shapes(bs), nb + 1, kv_dtype="int8",
                        device="cpu")
    with torch.inference_mode():
        logits, _, _ = cpu.forward_prefill_chunk(
            cpu._params, torch.tensor([seq]), 0, len(seq), pool.ks, pool.vs,
            torch.arange(1, nb + 1, dtype=torch.int32))
    return logits[len(prompt) - 1:]


def teacher_check(rows_fn, cpu, cases, tol=TEACHER_TOL, label=""):
    """Every served greedy token must have a reference logit within
    ``tol`` of the reference maximum at its position; ``rows_fn(cpu,
    prompt, tokens)`` gives the reference rows. ``cases`` are (prompt,
    served tokens); returns (checked, exact, worst gap)."""
    checked = exact = 0
    worst_gap = 0.0
    for prompt, tokens in cases:
        rows = rows_fn(cpu, prompt, tokens)
        for t, row in zip(tokens, rows):
            gap = float(row.max() - row[t])
            worst_gap = max(worst_gap, gap)
            exact += int(int(row.argmax()) == t)
            checked += 1
    if worst_gap > tol:
        raise AssertionError(f"teacher-forced check{label}: a served token "
                             f"is {worst_gap:.3e} below the reference "
                             f"maximum (tol {tol:g})")
    return checked, exact, worst_gap


def int8_vs_f32(f32_cpu, int8_cpu, cases, rows_fn):
    """Max |int8 - f32| logit over the cases' positions, relative to the
    largest f32 logit: what the int8 setup costs at this width
    (informative)."""
    diff = peak = 0.0
    for prompt, tokens in cases:
        a = f32_rows(f32_cpu, prompt, tokens)
        b = rows_fn(int8_cpu, prompt, tokens)
        diff = max(diff, float((a - b).abs().max()))
        peak = max(peak, float(a.abs().max()))
    return diff / peak


def slot_traffic():
    """Phase 4's (and phase 6's) 32 requests, from a fixed seed."""
    rs = np.random.RandomState(0)
    reqs = []
    for i in range(32):
        plen = int(rs.randint(8, 601))
        sampled = i % 8 == 7
        reqs.append(dict(prompt=rs.randint(0, 32000, plen).tolist(),
                         max_tokens=int(rs.randint(32, 65)),
                         temperature=0.8 if sampled else 0.0,
                         top_k=40 if sampled else 0, seed=i))
    return reqs


def serve(card: str, kv_dtype: str = "f32", cfg=SERVE_CFG, device=None,
          eager_ab: bool = False, chaos: bool = False):
    """Phase 4 (f32) or 6 (int8): the slot backend end to end, the
    decode step replayed as the engine's CUDA graph on the card. With
    ``chaos``, phase 11 then reruns the traffic on the same warmed engine
    under :data:`SLOT_FAULT_PLAN` (:func:`fault_ladder`). With
    ``eager_ab`` the same traffic then runs through the eager step and
    must give the same tokens."""
    from deeplearning4j_tpu_torch.kernels import decode_attention as da
    from deeplearning4j_tpu_torch.kernels import flash_attention as fa
    from deeplearning4j_tpu_torch.serving import GenerationEngine
    from deeplearning4j_tpu_torch.zoo.transformer_lm import \
        CausalTransformerLM
    int8 = kv_dtype == "int8"
    lm = CausalTransformerLM(**cfg, device=device).init()
    engine_kw = dict(num_slots=32, kv_dtype=kv_dtype)
    eng = GenerationEngine(lm, **engine_kw)
    try:
        t0 = time.perf_counter()
        eng.warmup()
        warm_s = time.perf_counter() - t0
        captures = warmed_compiles(eng)
        reqs = slot_traffic()
        st0 = eng.stats()
        reset_launches()
        results, wall = run_requests(eng, reqs)
        launches = {"decode_attention": da.launches,
                    "decode_attention_int8": da.launches_int8,
                    "flash_attention": fa.launches}
        st = eng.stats()
        check_lengths(results, reqs)
        steps = st["decode_steps"] - st0["decode_steps"]
        decode = "decode_attention_int8" if int8 else "decode_attention"
        other = "decode_attention" if int8 else "decode_attention_int8"
        if launches[decode] != cfg["n_layers"] * steps or not steps \
                or launches[other] or not launches["flash_attention"]:
            raise AssertionError(f"launches {launches} over {steps} decode "
                                 f"steps: {decode} must run "
                                 f"{cfg['n_layers']} x steps, flash must run")
        n_tok = sum(len(r["tokens"]) for r in results)
        prof = profile_window(eng)
        no_capture_since(eng, captures)
        ladder = None
        if chaos:
            ladder = fault_ladder(
                eng, card, f"slots {kv_dtype} on phase {6 if int8 else 4}'s "
                f"engine", reqs, results, SLOT_FAULT_PLAN,
                lambda: cpu_copy(lm, cfg),
                int8_slot_rows if int8 else f32_rows,
                INT8_TEACHER_TOL if int8 else TEACHER_TOL, cfg["n_layers"])
    finally:
        eng.stop()
    eager = eager_run(lm, engine_kw, reqs, results) if eager_ab else None

    # teacher-forced check: every greedy token the card emitted has a
    # CPU logit within the tolerance of the CPU maximum there; at int8
    # the CPU reference is the port's own int8 path
    greedy = [i for i, q in enumerate(reqs) if q["temperature"] == 0.0][:4]
    cases = [(reqs[i]["prompt"], results[i]["tokens"]) for i in greedy]
    cpu = cpu_copy(lm, cfg)
    rows_fn, tol = ((int8_slot_rows, INT8_TEACHER_TOL) if int8
                    else (f32_rows, TEACHER_TOL))
    checked, exact, worst_gap = teacher_check(rows_fn, cpu, cases, tol)
    rel = int8_vs_f32(cpu, cpu, cases[:2], int8_slot_rows) if int8 else None
    e2e = dict(kv_dtype=kv_dtype, requests=len(reqs), tokens=n_tok,
               wall_s=wall, tokens_per_s=n_tok / wall,
               ttft_p50_ms=st["ttft_ms"]["p50"],
               ttft_p99_ms=st["ttft_ms"]["p99"],
               decode_step_p50_ms=st["decode_step_ms"]["p50"],
               decode_step_p99_ms=st["decode_step_ms"]["p99"],
               decode_sync_wait_p50_ms=st["decode_sync_wait_ms"]["p50"],
               decode_sync_wait_p99_ms=st["decode_sync_wait_ms"]["p99"],
               prefill_p50_ms=st["prefill_ms"]["p50"],
               decode_steps=steps, prefills=st["prefills"],
               cuda_graph=eng._cuda_graph, compiles_after_warmup=captures,
               eager=eager,
               mean_occupancy=st["slots"]["mean_occupancy"],
               kv_cache_bytes=st["kv_cache_bytes"],
               kv_bytes_per_token=st["kv_bytes_per_token"],
               quant=st["quant"], warmup_s=warm_s, launches=launches,
               teacher_checked=checked, teacher_exact=exact,
               teacher_exact_rate=exact / max(checked, 1),
               teacher_worst_gap=worst_gap, teacher_tol=tol,
               int8_vs_f32_logit_rel_err=rel, profile=prof,
               fault_ladder=ladder)
    tag = " int8" if int8 else ""
    print(f"e2e{tag} [{card}]: {n_tok} tokens from {len(reqs)} requests in "
          f"{wall:.3f} s = {e2e['tokens_per_s']:.1f} tokens/s, TTFT p50 "
          f"{e2e['ttft_p50_ms']:.1f} ms, decode step p50/p99 "
          f"{e2e['decode_step_p50_ms']:.2f}/{e2e['decode_step_p99_ms']:.2f} "
          f"ms, sync wait p50/p99 {e2e['decode_sync_wait_p50_ms']:.2f}/"
          f"{e2e['decode_sync_wait_p99_ms']:.2f} ms, launches {launches} "
          f"over {steps} decode steps ({captures} decode-step graph "
          f"captured at warmup, none after), cache {st['kv_cache_bytes']} "
          f"bytes, {st['kv_bytes_per_token']} bytes per token")
    if eager is not None:
        print(f"e2e{tag} eager step [{card}]: the same requests through the "
              f"eager decode step: {eager['identical']} requests' tokens "
              f"identical to the graph's, {eager['tokens_per_s']:.1f} "
              f"tokens/s, decode step p50/p99 "
              f"{eager['decode_step_p50_ms']:.2f}/"
              f"{eager['decode_step_p99_ms']:.2f} ms, sync wait p50 "
              f"{eager['decode_sync_wait_p50_ms']:.2f} ms")
    print(f"teacher-forced{tag}: {checked} greedy tokens checked, "
          f"exact-match rate {e2e['teacher_exact_rate']:.4f}, worst gap "
          f"{worst_gap:.3e} (tol {tol:g})"
          + (f"; int8-vs-f32 max logit rel err {rel:.4e} (informative)"
             if int8 else ""))
    print_profile(f"profile window{tag}", card, prof)
    return e2e


def check_flash_bwd(dev):
    """Phase 8: the dQ and dK/dV kernels against their plain versions
    across the prefill buckets, then timed at the training shapes."""
    import torch
    import torch.nn.functional as F
    from deeplearning4j_tpu_torch.kernels import flash_attention as fa
    B, H, D = 4, 8, 64
    g = torch.Generator(device="cpu").manual_seed(8)
    worst = {"dq": 0.0, "dkv": 0.0}
    per_bucket = {}
    T = 8
    while T <= 1024:
        q, k, v, do = (torch.randn((B, T, H, D), generator=g).to(dev)
                       for _ in range(4))
        # rows of length T, ~3T/4, ~T/3 and 0 (every key masked)
        lens = torch.tensor([T, (3 * T) // 4 + 1, T // 3 + 1, 0])
        km = (torch.arange(T)[None] < lens[:, None]).to(torch.float32)
        km = km.to(dev)
        out, lse = fa.flash_attention(q, k, v, True, km)
        delta = fa.backward_delta(do, out)
        dq = fa.flash_attention_bwd_dq(q, k, v, km, do, lse, delta, True)
        dk, dv = fa.flash_attention_bwd_dkv(q, k, v, km, do, lse, delta,
                                            True)
        _same_bits((dq, dk, dv), (q, k, v, km, do, lse, delta), f"T={T}")
        want_dq = fa.flash_attention_bwd_dq_torch(q, k, v, km, do, lse,
                                                  delta, True)
        want_dk, want_dv = fa.flash_attention_bwd_dkv_torch(
            q, k, v, km, do, lse, delta, True)
        torch.cuda.synchronize()
        errs = {}
        for name, pairs in (("dq", ((dq, want_dq),)),
                            ("dkv", ((dk, want_dk), (dv, want_dv)))):
            err = max((a - b).abs().max().item() for a, b in pairs)
            scale = max(max(b.abs().max().item() for _, b in pairs), 1.0)
            finite = all(bool(torch.isfinite(a).all()) for a, _ in pairs)
            masked_row = max(a[3].abs().max().item() for a, _ in pairs)
            if not (finite and err <= FLASH_BWD_TOL * scale
                    and masked_row == 0.0):
                raise AssertionError(
                    f"flash backward {name} T={T} disagrees with its plain "
                    f"version: {err:.3e} (scale {scale:.2f}), finite "
                    f"{finite}, fully masked row max {masked_row}")
            errs[name] = err
            worst[name] = max(worst[name], err)
        per_bucket[T] = errs
        T *= 2
    print(f"flash backward buckets 8..1024, B={B} H={H} D={D} causal, "
          f"ragged key mask, a fully masked row: max_abs_err dq "
          f"{worst['dq']:.3e}, dk/dv {worst['dkv']:.3e} (tol "
          f"{FLASH_BWD_TOL:g} x max(1, largest gradient)); per bucket "
          f"{per_bucket}")

    # timed at the training shapes: T=1024, causal, every key live
    T = 1024
    q, k, v, do = (torch.randn((B, T, H, D), generator=g).to(dev)
                   for _ in range(4))
    km = torch.ones((B, T), device=dev)
    out, lse = fa.flash_attention(q, k, v, True, km)
    delta = fa.backward_delta(do, out)
    args = (q, k, v, km, do, lse, delta)
    _same_bits((fa.flash_attention_bwd_dq(*args, True),
                *fa.flash_attention_bwd_dkv(*args, True)), args, f"T={T}")
    pairs = T * (T + 1) // 2
    tensor = B * T * H * D * 4
    rows = B * H * T * 4
    res = {}
    for name, fn, plain, flops, nbytes in (
            ("dq",
             lambda: fa.flash_attention_bwd_dq(q, k, v, km, do, lse, delta,
                                               True),
             lambda: fa.flash_attention_bwd_dq_torch(q, k, v, km, do, lse,
                                                     delta, True),
             6 * D * B * H * pairs, 5 * tensor + 2 * rows + B * T * 4),
            ("dkv",
             lambda: fa.flash_attention_bwd_dkv(q, k, v, km, do, lse, delta,
                                                True),
             lambda: fa.flash_attention_bwd_dkv_torch(q, k, v, km, do, lse,
                                                      delta, True),
             8 * D * B * H * pairs, 6 * tensor + 2 * rows + B * T * 4)):
        # the kernels run three TF32 products per f32 product (3xTF32)
        bound_ms, bound_by = _bound(nbytes, 3 * flops, H100_TF32_FLOPS)
        bound_f32_ms, _ = _bound(nbytes, flops)
        ms = time_ms(fn)
        res[name] = dict(max_abs_err=worst[name], tol=FLASH_BWD_TOL,
                         per_bucket={t: e[name]
                                     for t, e in per_bucket.items()},
                         ms=ms, plain_ms=time_ms(plain),
                         bound_ms=bound_ms, bound_by=bound_by,
                         bound_f32_ms=bound_f32_ms,
                         share_of_bound=bound_ms / ms,
                         share_of_f32_bound=bound_f32_ms / ms,
                         gflop=flops / 1e9)
    # the library yardstick: SDPA's backward (dq, dk and dv in one) on
    # the same f32 inputs and mask, timed on a retained graph
    mask = torch.ones((T, T), dtype=torch.bool, device=dev).tril()[None,
                                                                   None]
    mask = mask & (km > 0)[:, None, None, :]
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                  for x in (q, k, v))
    lib_out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
    dot = do.transpose(1, 2)

    def lib_bwd():
        return torch.autograd.grad(lib_out, (qt, kt, vt), dot,
                                   retain_graph=True)
    lib_ms = time_ms(lib_bwd)
    backend = _top_kernel(lib_bwd)
    for name in res:
        res[name]["library_ms"] = lib_ms
        res[name]["library_backend"] = backend
    pair_ms = res["dq"]["ms"] + res["dkv"]["ms"]
    res["pair"] = dict(ms=pair_ms, library_ms=lib_ms,
                       ratio_to_library=pair_ms / lib_ms)
    res["occupancy"] = {d: fa.bwd_kernel_info(d) for d in (32, 64, 128)}
    for name, label in (("dq", "dQ (B6)"), ("dkv", "dK/dV (B7)")):
        r = res[name]
        print(f"flash backward {label} B={B} H={H} T={T} D={D} causal: "
              f"kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"library (SDPA backward, dq+dk+dv, {backend}) "
              f"{lib_ms:.4f} ms, bound {r['bound_ms']:.4f} ms at 3xTF32 "
              f"(share {r['share_of_bound']:.3f}), {r['bound_f32_ms']:.4f} "
              f"ms at f32 (share {r['share_of_f32_bound']:.3f}) "
              f"({r['gflop']:.2f} GFLOP)")
    print(f"flash backward B6 + B7: {pair_ms:.4f} ms against SDPA's backward "
          f"{lib_ms:.4f} ms (ratio {pair_ms / lib_ms:.3f}); two calls of each "
          f"kernel bit-identical in every bucket; shared bytes and blocks "
          f"per SM by head dim {res['occupancy']}")
    return res


def _same_bits(got, args, where):
    """A second call of the dQ and dK/dV kernels on ``args`` (q, k, v,
    key mask, dO, lse, delta; causal) must give the bits of ``got`` (one
    owner per gradient row, no atomics)."""
    import torch
    from deeplearning4j_tpu_torch.kernels import flash_attention as fa
    again = (fa.flash_attention_bwd_dq(*args, True),
             *fa.flash_attention_bwd_dkv(*args, True))
    for name, a, b in zip(("dq", "dk", "dv"), got, again):
        if not torch.equal(a, b):
            raise AssertionError(f"flash backward {name} {where}: two calls "
                                 f"on the same inputs differ")


def check_flash_bf16(dev):
    """Phases 3 and 8 for the bf16 legs of B3, B6 and B7: each against
    its plain version (f32 from the same bf16 values) at phase 10's
    shapes (B=4, H=8, T=1024, D=64) and at B=1, causal and not, with a
    ragged key mask and (at B=4) a fully masked row (O and every
    gradient exactly 0, LSE -1e30), two calls of each bit-identical;
    then each timed at the training shapes (causal, every key live)
    beside its bound at the bf16 rate, its plain version and one library
    call (SDPA at bf16 for the forward, SDPA's backward at bf16 for the
    backward pair), with registers, spills, shared memory, blocks per SM
    and threads by head dim. The forward (see fwd_against_sdpa), the
    pair and the port's whole backward (delta included; see
    bwd_against_sdpa) are also held against SDPA at bf16, with the mask
    and with is_causal, there and at B = 1 and T = 2048 and 4096."""
    import torch
    import torch.nn.functional as F
    from deeplearning4j_tpu_torch.kernels import flash_attention as fa
    H, T, D = 8, 1024, 64
    g = torch.Generator(device="cpu").manual_seed(10)
    worst = {"fwd": 0.0, "lse": 0.0, "dq": 0.0, "dkv": 0.0}
    cases = {}

    def scaled(a, b):
        a, b = a.float(), b.float()
        return ((a - b).abs().max() / max(b.abs().max().item(), 1.0)).item()

    for B in (1, 4):
        q, k, v, do = (torch.randn((B, T, H, D), generator=g).to(dev)
                       .bfloat16() for _ in range(4))
        # rows of length T, ~3T/4, ~T/3 and 0 (every key masked)
        lens = torch.tensor([T, (3 * T) // 4 + 1, T // 3 + 1, 0][:B]
                            if B == 4 else [(3 * T) // 4 + 1])
        km = (torch.arange(T)[None] < lens[:, None]).to(torch.float32)
        km = km.to(dev)
        for causal in (False, True):
            out, lse = fa.flash_attention(q, k, v, causal, km)
            again = fa.flash_attention(q, k, v, causal, km)
            ro, rl = fa.flash_attention_torch(q, k, v, causal, km)
            delta = fa.backward_delta(do, ro)
            args = (q, k, v, km, do, rl, delta)
            dq = fa.flash_attention_bwd_dq(*args, causal)
            dk, dv = fa.flash_attention_bwd_dkv(*args, causal)
            dq2 = fa.flash_attention_bwd_dq(*args, causal)
            dk2, dv2 = fa.flash_attention_bwd_dkv(*args, causal)
            want_dq = fa.flash_attention_bwd_dq_torch(*args, causal)
            want_dk, want_dv = fa.flash_attention_bwd_dkv_torch(*args,
                                                                causal)
            torch.cuda.synchronize()
            same = (all(torch.equal(a, b) for a, b in zip((out, lse), again))
                    and torch.equal(dq, dq2) and torch.equal(dk, dk2)
                    and torch.equal(dv, dv2))
            errs = dict(fwd=scaled(out, ro),
                        lse=(lse - rl).abs().max().item(),
                        dq=scaled(dq, want_dq),
                        dkv=max(scaled(dk, want_dk), scaled(dv, want_dv)))
            masked = (max(x[3].abs().max().item()
                          for x in (out, dq, dk, dv)) == 0.0
                      and bool((lse[3] == -1e30).all())) if B == 4 else True
            finite = all(bool(torch.isfinite(x).all())
                         for x in (out, dq, dk, dv))
            ok = (errs["fwd"] <= FLASH_BF16_O_TOL
                  and errs["lse"] <= FLASH_BF16_LSE_TOL
                  and errs["dq"] <= FLASH_BF16_GRAD_TOL
                  and errs["dkv"] <= FLASH_BF16_GRAD_TOL)
            if not (ok and same and masked and finite
                    and out.dtype == dq.dtype == torch.bfloat16):
                raise AssertionError(
                    f"bf16 flash legs B={B} causal={causal}: errors {errs} "
                    f"(tol O {FLASH_BF16_O_TOL:g}, grads "
                    f"{FLASH_BF16_GRAD_TOL:g}, LSE {FLASH_BF16_LSE_TOL:g}), "
                    f"two calls identical {same}, fully masked row 0 "
                    f"{masked}, finite {finite}")
            cases[f"B={B} causal={causal}"] = errs
            for key in worst:
                worst[key] = max(worst[key], errs[key])
    print(f"flash bf16 legs at H={H} T={T} D={D}, B=1 and B=4, causal and "
          f"not, ragged key mask, a fully masked row at B=4 (O, LSE and "
          f"gradients exact): errors (O and gradients over max(1, max)) "
          f"{cases}; two calls of each leg bit-identical")

    # timed at the training shapes, causal, every key live
    B = 4
    q, k, v, do = (torch.randn((B, T, H, D), generator=g).to(dev).bfloat16()
                   for _ in range(4))
    km = torch.ones((B, T), device=dev)
    out, lse = fa.flash_attention(q, k, v, True, km)
    delta = fa.backward_delta(do, out)
    pairs = T * (T + 1) // 2
    tensor = B * T * H * D * 2          # one bf16 [B, T, H, D] tensor
    rows = B * H * T * 4                # one f32 [B, H, T] row vector
    mask_bytes = B * T * 4
    res = {}
    for name, fn, plain, flops, nbytes in (
            ("fwd", lambda: fa.flash_attention(q, k, v, True, km),
             lambda: fa.flash_attention_torch(q, k, v, True, km),
             4 * D * B * H * pairs, 4 * tensor + rows + mask_bytes),
            ("dq",
             lambda: fa.flash_attention_bwd_dq(q, k, v, km, do, lse, delta,
                                               True),
             lambda: fa.flash_attention_bwd_dq_torch(q, k, v, km, do, lse,
                                                     delta, True),
             6 * D * B * H * pairs, 5 * tensor + 2 * rows + mask_bytes),
            ("dkv",
             lambda: fa.flash_attention_bwd_dkv(q, k, v, km, do, lse, delta,
                                                True),
             lambda: fa.flash_attention_bwd_dkv_torch(q, k, v, km, do, lse,
                                                      delta, True),
             8 * D * B * H * pairs, 6 * tensor + 2 * rows + mask_bytes)):
        bound_ms, bound_by = _bound(nbytes, flops, H100_BF16_FLOPS)
        ms = time_ms(fn)
        res[name] = dict(max_abs_err=worst[name], tol=FLASH_BF16_O_TOL
                         if name == "fwd" else FLASH_BF16_GRAD_TOL,
                         ms=ms, plain_ms=time_ms(plain), bound_ms=bound_ms,
                         bound_by=bound_by, share_of_bound=bound_ms / ms,
                         gflop=flops / 1e9, mbytes=nbytes / 1e6)
    res["fwd"]["lse_err"] = worst["lse"]
    # the library yardsticks, on the same bf16 inputs and mask
    mask = torch.ones((T, T), dtype=torch.bool, device=dev).tril()[None,
                                                                   None]
    mask = mask & (km > 0)[:, None, None, :]
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                  for x in (q, k, v))

    def fwd_lib():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
    res["fwd"]["library_ms"] = time_ms(fwd_lib)
    res["fwd"]["library_backend"] = _top_kernel(fwd_lib)
    res["fwd"]["library_causal_ms"] = time_ms(
        lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True))
    lib_out = fwd_lib()
    dot = do.transpose(1, 2)
    backend = _top_kernel(lambda: torch.autograd.grad(
        lib_out, (qt, kt, vt), dot, retain_graph=True))
    res["pair"] = bwd_against_sdpa(dev, q, k, v, km, do, out, lse, mask)
    res["pair"]["library_backend"] = backend
    for name in ("dq", "dkv"):
        res[name]["library_ms"] = res["pair"]["library_ms"]
        res[name]["library_backend"] = backend
    # the forward and the pair at B = 1 and at longer sequences
    res["long"], res["fwd_long"] = {}, {}
    for Bl, Tl in ((1, 1024), (4, 2048), (1, 2048), (4, 4096), (1, 4096)):
        ql, kl, vl, dol = (torch.randn((Bl, Tl, H, D), generator=g).to(dev)
                           .bfloat16() for _ in range(4))
        kml = torch.ones((Bl, Tl), device=dev)
        outl, lsel = fa.flash_attention(ql, kl, vl, True, kml)
        maskl = torch.ones((Tl, Tl), dtype=torch.bool, device=dev).tril()[
            None, None] & (kml > 0)[:, None, None, :]
        res["fwd_long"][f"B={Bl} T={Tl}"] = fwd_against_sdpa(
            ql, kl, vl, kml, maskl)
        res["long"][f"B={Bl} T={Tl}"] = bwd_against_sdpa(
            dev, ql, kl, vl, kml, dol, outl, lsel, maskl)
    res["cases"] = cases
    res["info"] = {d: fa.bf16_kernel_info(d) for d in (32, 64, 128)}
    for name, label in (("fwd", "forward (B3)"), ("dq", "dQ (B6)"),
                        ("dkv", "dK/dV (B7)")):
        r = res[name]
        print(f"flash bf16 {label} B={B} H={H} T={T} D={D} causal: kernel "
              f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library "
              f"{r['library_ms']:.4f} ms ({r['library_backend']}), bound "
              f"{r['bound_ms']:.5f} ms at bf16 ({r['bound_by']}; share "
              f"{r['share_of_bound']:.3f}) ({r['gflop']:.3f} GFLOP, "
              f"{r['mbytes']:.2f} MB)")
    print(f"flash bf16 forward (B3) B={B} T={T} against SDPA's bf16 "
          f"forward with is_causal: {res['fwd']['ms']:.4f} ms against "
          f"{res['fwd']['library_causal_ms']:.4f} ms")
    for shape, r in res["fwd_long"].items():
        print(f"flash bf16 forward (B3) {shape} H={H} D={D} causal: "
              f"{r['ms']:.4f} ms, against SDPA's bf16 forward with the mask "
              f"{r['library_ms']:.4f} ms and with is_causal "
              f"{r['library_causal_ms']:.4f} ms")
    for shape, r in [(f"B={B} T={T}", res["pair"])] + list(
            res["long"].items()):
        print(f"flash bf16 backward {shape} H={H} D={D} causal: B6 + B7 "
              f"{r['ms']:.4f} ms, the whole backward (delta "
              f"{r['delta_ms']:.4f} + B6 + B7) {r['whole_ms']:.4f} ms, "
              f"against SDPA's bf16 backward with the mask "
              f"{r['library_ms']:.4f} ms (pair ratio "
              f"{r['ratio_to_library']:.3f}, whole "
              f"{r['whole_ratio_to_library']:.3f}) and with is_causal "
              f"{r['library_causal_ms']:.4f} ms (pair "
              f"{r['ms'] / r['library_causal_ms']:.3f}, whole "
              f"{r['whole_ms'] / r['library_causal_ms']:.3f})")
    print(f"flash bf16 registers, spills, shared bytes, blocks per SM and "
          f"threads by head dim {res['info']}")
    return res


def fwd_against_sdpa(q, k, v, km, mask):
    """The bf16 forward's device time on these inputs (causal) beside
    SDPA's bf16 forward on the same values, once with the boolean mask
    the kernel applies and once with ``is_causal`` (every key live here,
    so the same function). Library calls are yardsticks only."""
    import torch.nn.functional as F
    from deeplearning4j_tpu_torch.kernels import flash_attention as fa
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    return dict(
        ms=time_ms(lambda: fa.flash_attention(q, k, v, True, km)),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask)),
        library_causal_ms=time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True)))


def bwd_against_sdpa(dev, q, k, v, km, do, out, lse, mask):
    """The bf16 backward's device time on these inputs (causal): the dQ
    and dK/dV kernels alone (the pair) and the port's whole backward
    (``flash_attention_bwd``: delta, then both kernels), beside SDPA's
    bf16 backward on the same values, once with the boolean mask the
    kernels apply (causal and key mask) and once with ``is_causal``
    (every key live here, so the same function; SDPA picks its own
    kernel for each). Library calls are yardsticks only."""
    import torch
    import torch.nn.functional as F
    from deeplearning4j_tpu_torch.kernels import flash_attention as fa
    delta = fa.backward_delta(do, out)
    dq_ms = time_ms(lambda: fa.flash_attention_bwd_dq(q, k, v, km, do, lse,
                                                      delta, True))
    dkv_ms = time_ms(lambda: fa.flash_attention_bwd_dkv(q, k, v, km, do, lse,
                                                        delta, True))
    whole_ms = time_ms(lambda: fa.flash_attention_bwd(q, k, v, km, out, lse,
                                                      do, True))
    delta_ms = time_ms(lambda: fa.backward_delta(do, out))
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                  for x in (q, k, v))
    dot = do.transpose(1, 2)
    lib = {}
    for name, kw in (("mask", dict(attn_mask=mask)),
                     ("causal", dict(is_causal=True))):
        o = F.scaled_dot_product_attention(qt, kt, vt, **kw)
        lib[name] = time_ms(lambda: torch.autograd.grad(
            o, (qt, kt, vt), dot, retain_graph=True))
    pair_ms = dq_ms + dkv_ms
    return dict(ms=pair_ms, pair_dq_ms=dq_ms, pair_dkv_ms=dkv_ms,
                whole_ms=whole_ms, delta_ms=delta_ms,
                library_ms=lib["mask"], library_causal_ms=lib["causal"],
                ratio_to_library=pair_ms / lib["mask"],
                whole_ratio_to_library=whole_ms / lib["mask"])


def _top_kernel(fn) -> str:
    """Name of the longest device kernel of one call of ``fn``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as p:
        fn()
        torch.cuda.synchronize()
    best, best_us = "not traced", -1.0
    for e in p.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us > best_us:
            best, best_us = e.key, us
    return best[:100]


def train_conf(cfg):
    """The training phase's network in the layer DSL."""
    from deeplearning4j_tpu_torch.learning import Adam
    from deeplearning4j_tpu_torch.nn import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.layers.attention import \
        TransformerEncoderLayer
    from deeplearning4j_tpu_torch.nn.layers.recurrent import (
        EmbeddingSequenceLayer, RnnOutputLayer)
    b = (NeuralNetConfiguration.builder().seed(cfg["seed"])
         .updater(Adam(cfg["lr"])).weight_init("xavier")
         .data_type(cfg.get("dtype", "float")).list()
         .layer(EmbeddingSequenceLayer(n_in=cfg["vocab_size"],
                                       n_out=cfg["d_model"])))
    for _ in range(cfg["n_layers"]):
        b = b.layer(TransformerEncoderLayer(n_heads=cfg["n_heads"],
                                            d_ff=cfg["d_ff"], causal=True))
    return (b.layer(RnnOutputLayer(n_out=cfg["vocab_size"], loss="mcxent",
                                   activation="softmax"))
            .input_type_recurrent(1, timesteps=cfg["seq_len"]).build())


def recurrence_batch(cfg, batch, seed, device):
    """Token rows of t[i+1] = (a t[i] + b) mod vocab from seeded starts:
    the next token is a function of the current one, so the loss can
    fall. Returns tokens [batch, T] and one-hot labels [batch, T, vocab]
    made on ``device``."""
    import torch
    V, T = cfg["vocab_size"], cfg["seq_len"]
    rs = np.random.RandomState(seed)
    seq = np.empty((batch, T + 1), np.int64)
    seq[:, 0] = rs.randint(0, V, batch)
    for i in range(T):
        seq[:, i + 1] = (7919 * seq[:, i] + 12345) % V
    seq = torch.from_numpy(seq).to(device)
    y = torch.zeros((batch, T, V), device=device)
    y.scatter_(2, seq[:, 1:, None], 1.0)
    return seq[:, :T], y


def train(card: str, cfg=TRAIN_CFG, device=None, steps=TRAIN_STEPS):
    """Phase 9 (f32) and, with ``cfg["dtype"] = "bfloat16"``, phase 10
    (the bf16 mixed-precision policy): the training path end to end (see
    the module doc). The phase's flash legs (f32 or bf16) must each
    launch once per layer and step, and the other legs never."""
    import torch
    from deeplearning4j_tpu_torch.kernels import flash_attention as fa
    from deeplearning4j_tpu_torch.nn import MultiLayerNetwork
    bf16 = cfg.get("dtype", "float") == "bfloat16"
    net = MultiLayerNetwork(train_conf(cfg), device=device)
    t0 = time.perf_counter()
    net.init()
    init_s = time.perf_counter() - t0
    dev = net.device
    x, y = recurrence_batch(cfg, cfg["batch"], cfg["seed"], dev)
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    reset_launches()
    losses, step_ms, enqueue_ms = [], [], []
    for _ in range(1 + steps):   # one warmup step, then the timed ones
        t0 = time.perf_counter()
        net.fit(x, y)
        # fit returns once the step is queued: the host's share
        enqueue_ms.append((time.perf_counter() - t0) * 1e3)
        if on_card:
            torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(net.score_)
    f32_legs = {"flash_attention": fa.launches,
                "flash_attention_bwd_dq": fa.launches_dq,
                "flash_attention_bwd_dkv": fa.launches_dkv}
    bf16_legs = {"flash_attention_bf16": fa.launches_bf16,
                 "flash_attention_bwd_dq_bf16": fa.launches_dq_bf16,
                 "flash_attention_bwd_dkv_bf16": fa.launches_dkv_bf16}
    launches = dict(f32_legs, **bf16_legs)
    want = cfg["n_layers"] * (1 + steps)
    ran, idle = (bf16_legs, f32_legs) if bf16 else (f32_legs, bf16_legs)
    if any(n != want for n in ran.values()) or any(idle.values()):
        raise AssertionError(
            f"launches {launches}: each {'bf16' if bf16 else 'f32'} flash "
            f"leg must run {cfg['n_layers']} layers x {1 + steps} steps = "
            f"{want} times, the other legs never")
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"the loss did not fall: {losses}")
    dtypes = sorted({str(t.dtype) for p in net.params().values()
                     for t in p.values()} |
                    {str(t.dtype) for st in net.get_updater_state().values()
                     for part in st.values() if isinstance(part, dict)
                     for t in part.values()})
    if dtypes != ["torch.float32"]:
        raise AssertionError(f"master params and Adam state must stay f32: "
                             f"{dtypes}")
    peak = torch.cuda.max_memory_allocated() if on_card else None
    timed = sorted(step_ms[1:])
    p50 = timed[len(timed) // 2]
    enqueue_p50 = sorted(enqueue_ms[1:])[steps // 2]
    tokens = cfg["batch"] * cfg["seq_len"]
    prof = profile_train_step(net, x, y) if on_card else None
    grad = grad_check(cfg, device)
    phase = "train bf16" if bf16 else "train"
    res = dict(cfg=cfg, steps=steps, losses=losses, step_ms=step_ms,
               step_p50_ms=p50, enqueue_ms=enqueue_ms,
               enqueue_p50_ms=enqueue_p50, tokens_per_step=tokens,
               tokens_per_s=tokens / (p50 / 1e3), peak_bytes=peak,
               params=net.num_params(), init_s=init_s, launches=launches,
               master_dtypes=dtypes, grad_check=grad, profile=prof)
    print(f"{phase} [{card}]: {net.num_params()} params, {steps} timed "
          f"Adam steps of {tokens} tokens after one warmup: step p50 "
          f"{p50:.2f} ms (all {[round(t, 2) for t in step_ms]}; queued by "
          f"the host in p50 {enqueue_p50:.2f} ms), "
          f"{res['tokens_per_s']:.1f} tokens/s, loss "
          f"{[round(v, 4) for v in losses]}, peak "
          f"{'not measured' if peak is None else f'{peak / 2**30:.3f} GiB'}"
          f", launches {launches}, masters and Adam state {dtypes}")
    print(f"{phase} gradient check (2 blocks, B=1, card vs CPU): loss rel "
          f"err {grad['loss_rel_err']:.3e} (tol {grad['loss_tol']:g}), "
          f"worst leaf {grad['worst_leaf']} at {grad['worst_rel_err']:.3e} "
          f"of its max (tol {grad['grad_tol']:g}), {grad['leaves']} leaves")
    if prof is not None:
        print(f"{phase} profile [{card}] (one step, profiler on): device "
              f"busy {prof['busy_share']:.3f} of {prof['wall_ms']:.1f} ms, "
              f"{prof['device_kernels']} device kernels; by kind (ms) "
              f"{ {k: round(v, 3) for k, v in prof['by_kind'].items()} }; "
              f"top kernels (ms): "
              + ", ".join(f"{n[:60]} {t:.3f}" for n, t in prof["top"]))
        print(f"{phase} profile: host ops by self CPU ms (calls): "
              + ", ".join(f"{n[:40]} {t:.2f} ({c})"
                          for n, t, c in prof["host_top"]))
    return res


def profile_train_step(net, x, y):
    """Kernel time by name and the device's busy share over one train
    step, from torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as p:
        t0 = time.perf_counter()
        net.fit(x, y)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = {}
    n_kernels = 0
    host = []
    for e in p.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            host.append((e.key, e.self_cpu_time_total / 1e3, e.count))
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        kernels[e.key] = kernels.get(e.key, 0.0) + us / 1e3
        n_kernels += e.count
    busy_ms = sum(kernels.values())
    # device time by kind: the flash kernels, bf16 and f32 GEMMs (cuBLAS
    # names a GEMM's types, except its nvjet kernels, which run only
    # half-precision tensor-core products here: TF32 is off), everything
    # else (elementwise, reductions, copies, casts, the loss and Adam)
    by_kind = {"flash": 0.0, "gemm_bf16": 0.0, "gemm_f32": 0.0, "other": 0.0}
    gemms = {}
    for name, ms in kernels.items():
        low = name.lower()
        if "flash_" in name:
            kind = "flash"
        elif "gemm" in low or low.startswith("nvjet"):
            kind = "gemm_bf16" if "bf16" in low or low.startswith("nvjet") \
                else "gemm_f32"
            gemms[name[:120]] = (kind, ms)
        else:
            kind = "other"
        by_kind[kind] += ms
    return dict(wall_ms=wall * 1e3, busy_ms=busy_ms,
                busy_share=busy_ms / (wall * 1e3), device_kernels=n_kernels,
                by_kind=by_kind, gemms=gemms,
                top=sorted(kernels.items(), key=lambda kv: -kv[1])[:10],
                host_top=sorted(host, key=lambda h: -h[1])[:12])


def grad_check(cfg, device=None):
    """One step's loss and gradients of a reduced copy (2 blocks, the
    full width, B=1, T=1024) on the network's device (the flash
    kernels) against the same params on the CPU (plain attention), at
    the configuration's dtype (f32, or the bf16 policy on both sides)."""
    from deeplearning4j_tpu_torch.nn import MultiLayerNetwork
    small = dict(cfg, n_layers=2)
    net = MultiLayerNetwork(train_conf(small), device=device).init()
    cpu = MultiLayerNetwork(train_conf(small), device="cpu").init()
    cpu.set_params({k: {n: t.cpu() for n, t in p.items()}
                    for k, p in net.params().items()})
    x, y = recurrence_batch(small, 1, cfg["seed"] + 1, net.device)
    loss, grads = net.loss_and_gradients(x, y)
    ref_loss, ref = cpu.loss_and_gradients(x.cpu(), y.cpu())
    loss_rel = abs(float(loss) - float(ref_loss)) / abs(float(ref_loss))
    worst, worst_leaf = 0.0, None
    for key, p in ref.items():
        for name, t in p.items():
            err = float((grads[key][name].cpu() - t).abs().max()) / max(
                float(t.abs().max()), 1e-30)
            if err >= worst:
                worst, worst_leaf = err, f"{key}.{name}"
    n = sum(len(p) for p in ref.values())
    bf16 = cfg.get("dtype", "float") == "bfloat16"
    loss_tol = TRAIN_BF16_LOSS_RTOL if bf16 else TRAIN_LOSS_RTOL
    grad_tol = TRAIN_BF16_GRAD_TOL if bf16 else TRAIN_GRAD_TOL
    if not (loss_rel <= loss_tol and worst <= grad_tol):
        raise AssertionError(f"card vs CPU: loss rel err {loss_rel:.3e}, "
                             f"{worst_leaf} off by {worst:.3e} of its max")
    return dict(loss=float(loss), cpu_loss=float(ref_loss),
                loss_rel_err=loss_rel, worst_rel_err=worst,
                worst_leaf=worst_leaf, leaves=n, loss_tol=loss_tol,
                grad_tol=grad_tol)


def reset_launches():
    """Set every kernel's launch count to 0 (just before a path runs)."""
    from deeplearning4j_tpu_torch import kernels
    kernels.add_launches({k: -n for k, n in kernels.launch_counts().items()})


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


def serve_paged(card: str, cfg=SERVE_CFG, device=None, kv_dtype="f32",
                chaos: bool = False):
    """Phase 5 (f32) or 7 (int8, int8 MLP weights): the paged backend
    end to end (see the module doc). With ``chaos``, phase 11 then reruns
    the primer and the 48-request burst on the same warmed engine under
    :func:`paged_fault_plan`'s plan (:func:`fault_ladder`), and every
    block must come back again."""
    from deeplearning4j_tpu_torch.kernels import decode_attention as da
    from deeplearning4j_tpu_torch.kernels import flash_attention as fa
    from deeplearning4j_tpu_torch.kernels import paged_attention as pa
    from deeplearning4j_tpu_torch.serving import GenerationEngine
    from deeplearning4j_tpu_torch.zoo.transformer_lm import (
        CausalTransformerLM, quantize_mlp_weights)
    int8 = kv_dtype == "int8"
    lm = CausalTransformerLM(**cfg, device=device).init()
    if int8:
        quantize_mlp_weights(lm)
    primer, burst, turn1, tails = paged_traffic(cfg["vocab_size"])
    bs = PAGED_ENGINE["block_size"]
    # a session's turn 2 matches the pinned prompt + tokens[:-1]
    mid_block = sum((len(t["prompt"]) + t["max_tokens"] - 1) % bs != 0
                    for t in turn1)
    if not mid_block:
        raise AssertionError("no session match ends mid-block: the "
                             "copy-on-write path would not run")
    eng = GenerationEngine(lm, **PAGED_ENGINE, kv_dtype=kv_dtype)
    try:
        t0 = time.perf_counter()
        eng.warmup()
        warm_s = time.perf_counter() - t0
        captures = warmed_compiles(eng)
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
                    "decode_attention_int8": da.launches_int8,
                    "flash_attention": fa.launches,
                    "paged_attention": pa.launches,
                    "paged_attention_int8": pa.launches_int8}
        st = eng.stats()
        check_lengths(results + res1 + res2, burst + turn1 + turn2)
        steps = st["decode_steps"] - st0["decode_steps"]
        paged = "paged_attention_int8" if int8 else "paged_attention"
        if not steps or launches[paged] != cfg["n_layers"] * steps \
                or sum(launches.values()) != launches[paged]:
            raise AssertionError(f"launches {launches}: {paged} must run "
                                 f"{cfg['n_layers']} x {steps} decode steps "
                                 f"and nothing else")
        pc = st["paged"]["prefix_cache"]
        if not (pc["prefix_hits"] >= 32 and pc["session_hits"] == 8
                and pc["cow_copies"] >= 1):
            raise AssertionError(f"prefix cache did not serve as "
                                 f"expected: {pc}")
        prof = profile_window(eng)
        no_capture_since(eng, captures)
        all_blocks_back(eng)
        ladder = None
        if chaos:
            plan, target, planned = paged_fault_plan(eng, primer, burst)
            eng.generate(timeout_ms=600_000, **primer)
            ladder = fault_ladder(
                eng, card, f"paged {kv_dtype} on phase "
                f"{7 if int8 else 5}'s engine", burst, results, plan,
                lambda: cpu_copy(lm, cfg),
                int8_paged_rows if int8 else f32_rows,
                INT8_TEACHER_TOL if int8 else TEACHER_TOL, cfg["n_layers"],
                planned_chunks=planned, mid_chunk_target=target)
            ladder["blocks_free_after"] = all_blocks_back(eng, " under "
                                                          "faults")
    finally:
        eng.stop()

    greedy = [i for i, q in enumerate(burst) if q["temperature"] == 0.0]
    same = None
    if not int8:
        # the same burst on the slot engine: informative only, the two
        # kernels sum in different orders
        slot_eng = GenerationEngine(lm, num_slots=PAGED_ENGINE["num_slots"])
        try:
            slot_eng.warmup()
            slot_results, _ = run_requests(slot_eng, burst)
        finally:
            slot_eng.stop()
        same = sum(slot_results[i]["tokens"] == results[i]["tokens"]
                   for i in greedy)

    shared = [i for i in greedy if burst[i]["prompt"][:320]
              == primer["prompt"][:320]][:4]
    resumed = [j for j, t in enumerate(turn2) if t["temperature"] == 0.0][:2]
    cases = ([(burst[i]["prompt"], results[i]["tokens"]) for i in shared]
             + [(turn2[j]["prompt"], res2[j]["tokens"]) for j in resumed])
    cpu = cpu_copy(lm, cfg)
    rows_fn, tol = ((int8_paged_rows, INT8_TEACHER_TOL) if int8
                    else (f32_rows, TEACHER_TOL))
    checked, exact, worst_gap = teacher_check(rows_fn, cpu, cases, tol,
                                              " (paged)")
    rel = None
    if int8:  # the whole int8 setup (KV and MLP) against the f32 model
        rel = int8_vs_f32(CausalTransformerLM(**cfg, device="cpu").init(),
                          cpu, cases[:2], int8_paged_rows)
    n_tok = sum(len(r["tokens"]) for r in results)
    e2e = dict(kv_dtype=kv_dtype, requests=len(burst), tokens=n_tok,
               wall_s=wall,
               tokens_per_s=n_tok / wall,
               ttft_p50_ms=st["ttft_ms"]["p50"],
               ttft_p99_ms=st["ttft_ms"]["p99"],
               decode_step_p50_ms=st["decode_step_ms"]["p50"],
               decode_step_p99_ms=st["decode_step_ms"]["p99"],
               decode_sync_wait_p50_ms=st["decode_sync_wait_ms"]["p50"],
               decode_sync_wait_p99_ms=st["decode_sync_wait_ms"]["p99"],
               cuda_graph=eng._cuda_graph, compiles_after_warmup=captures,
               prefill_chunk_p50_ms=st["prefill_ms"]["p50"],
               decode_steps=steps,
               prefill_chunks=st["paged"]["prefill_chunks"],
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
               teacher_worst_gap=worst_gap, teacher_tol=tol,
               kv_cache_bytes=st["kv_cache_bytes"],
               kv_bytes_per_token=st["kv_bytes_per_token"],
               quant=st["quant"], int8_vs_f32_logit_rel_err=rel,
               slot_engine_greedy_identical=None if same is None
               else f"{same}/{len(greedy)}",
               profile=prof, fault_ladder=ladder)
    tag = " int8" if int8 else ""
    print(f"e2e paged{tag} [{card}]: {n_tok} tokens from {len(burst)} "
          f"requests "
          f"in {wall:.3f} s = {e2e['tokens_per_s']:.1f} tokens/s; phase "
          f"TTFT p50/p99 {e2e['ttft_p50_ms']:.1f}/{e2e['ttft_p99_ms']:.1f} "
          f"ms, decode step p50/p99 {e2e['decode_step_p50_ms']:.2f}/"
          f"{e2e['decode_step_p99_ms']:.2f} ms, sync wait p50/p99 "
          f"{e2e['decode_sync_wait_p50_ms']:.2f}/"
          f"{e2e['decode_sync_wait_p99_ms']:.2f} ms, prefill chunk p50 "
          f"{e2e['prefill_chunk_p50_ms']:.2f} ms, {pc['prefix_hits']} "
          f"prefix hits ({pc['session_hits']} sessions), "
          f"{pc['prefix_tokens_matched']} prompt tokens matched, "
          f"{pc['cow_copies']} COW copies, peak {e2e['blocks_peak_used']} "
          f"of {e2e['blocks_total']} blocks, launches {launches} over "
          f"{steps} decode steps; pool {st['kv_cache_bytes']} bytes "
          f"({st['kv_cache_bytes'] / 2**30:.3f} GiB), "
          f"{st['kv_bytes_per_token']} bytes per token, quant {st['quant']}")
    print(f"teacher-forced (paged{tag}): {checked} greedy tokens of "
          f"{len(shared)} shared-prefix and {len(resumed)} turn-2 requests, "
          f"exact-match rate {e2e['teacher_exact_rate']:.4f}, worst gap "
          f"{worst_gap:.3e} (tol {tol:g}); "
          + (f"int8 (KV and MLP) vs f32 max logit rel err {rel:.4e} "
             f"(informative)" if int8 else
             f"slot engine on the same burst: {same} of {len(greedy)} "
             f"greedy requests identical"))
    print_profile(f"profile window paged{tag}", card, prof)
    return e2e


#: phase 11 on phase 4's engine: a transient fault at the 3rd prefill
#: (retried), then a corrupting 6th decode step, while every lane
#: decodes (recovered)
SLOT_FAULT_PLAN = dict(seed=11, plan={"prefill": [3], "device_step": [6]},
                       corrupting=("device_step",))


def paged_fault_plan(eng, primer, burst):
    """Phase 11's plan on phase 7's engine: a transient fault at the 3rd
    decode step (retried), and a corrupting fault at the prefill seam
    call that runs the SECOND chunk of the first two-chunk prompt behind
    at least four fully prefilled requests, so the recovery
    lands while those lanes decode and that prompt is mid-chunk. Chunk
    calls follow the burst's submission order (admission and the chunk
    queue are FIFO), and with the primer's system prompt in the prefix
    index every shared prompt prefills its suffix in one chunk. Returns
    (plan, index of the mid-chunk request, chunk calls the burst needs
    fault-free)."""
    system = primer["prompt"][:320]   # paged_traffic's system prompt
    calls, done, target = 0, 0, None
    for i, r in enumerate(burst):
        match = len(system) if r["prompt"][:len(system)] == system else 0
        n = len(eng._chunk_plan(len(r["prompt"]), start=match))
        if target is None and n > 1 and done >= 4:
            target, k = i, calls + 2
        calls += n
        done += 1
    if target is None:
        raise AssertionError("no two-chunk prompt behind enough prefilled "
                             "requests in the paged burst")
    return (dict(seed=11, plan={"device_step": [3], "prefill": [k]},
                 corrupting=("prefill",)), target, calls)


def watched_injector(eng, **plan):
    """A FaultInjector with ``plan`` that also notes, at each corrupting
    fire, what the engine had in flight: the time, the decoding lanes,
    the requests holding slots with their emitted token counts, and
    whether the head of the chunk queue is mid-prompt (a chunk done and
    one to go)."""
    from deeplearning4j_tpu_torch.faults import (CorruptedStateFault,
                                                 FaultInjector)

    class Watched(FaultInjector):
        def __init__(self):
            super().__init__(**plan)
            self.at_fault = []

        def fire(self, seam, worker=None):
            try:
                return super().fire(seam, worker)
            except CorruptedStateFault:
                chunks = getattr(eng, "_prefilling", ())
                self.at_fault.append(dict(
                    seam=seam, t=time.perf_counter(),
                    decoding=len(eng._ready_slots()),
                    in_flight=[(r, len(r.tokens))
                               for r in eng._slots.requests
                               if r is not None],
                    mid_chunk=bool(chunks) and chunks[0].idx > 0,
                    head=chunks[0].req if chunks else None))
                raise

    return Watched()


def ordered_streams(eng, reqs):
    """Submit every request as a stream from this thread, in list order
    (so admission follows it), and read each from a thread of its own
    that stamps every token's arrival. Returns the results, the
    arrival times, the requests' engine objects and the wall time. A
    failed request fails the run."""
    streams = []
    t0 = time.perf_counter()
    for r in reqs:
        streams.append(eng.stream(timeout_ms=600_000, **r))
    results = [None] * len(reqs)
    stamps = [[] for _ in reqs]
    errors = [None] * len(reqs)

    def read(i):
        try:
            for chunk in streams[i]:
                if "token" in chunk:
                    stamps[i].append(time.perf_counter())
                else:
                    results[i] = chunk
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors[i] = e

    threads = [threading.Thread(target=read, args=(i,))
               for i in range(len(reqs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    for i, e in enumerate(errors):
        if e is not None:
            raise RuntimeError(f"request {i} failed under the fault "
                               f"plan") from e
    return results, stamps, [s._req for s in streams], wall


def _pick(row, temp: float, top_k: int, u: float) -> int:
    """The engine's sampler on one logits row, in float64: the top-k
    filter, then the inverse CDF (in vocabulary order) at ``u``."""
    import torch
    if 0 < top_k < row.numel():
        row = torch.where(row < torch.topk(row, top_k).values[-1],
                          float("-inf"), row)
    c = torch.cumsum(torch.softmax(row / temp, -1), -1)
    return int(torch.argmax((c > u * c[-1]).int()))


def _reachable(r, temp: float, top_k: int, u: float, t: int,
               d: float) -> bool:
    """Whether some change of the logits ``r``, no entry moved by more
    than ``d``, makes the sampler (:func:`_pick`) pick token ``t``.

    With weights w_i = exp(logit_i / temp) over the top-k set F, the
    sampler picks t iff A <= u (A + W + C) < A + W, where A and C sum
    the weights of F's tokens before and after t in vocabulary order
    and W is t's: with D = (1 - u) A - u C, iff -(1 - u) W < D <= u W.
    F is a top-k set of the changed logits iff for some threshold h
    every member can reach h (logit + d >= h) and every token above h
    + d is a member; a member's weight then ranges from exp(max(logit -
    d, h) / temp) to exp((logit + d) / temp). For each breakpoint h
    (a logit +- d between the (k+1)-th logit - d and the k-th + d) the
    free members are chosen greedily to move D down (tokens after t by
    largest weight, then those before by smallest) or up (the mirror),
    t weighted at its largest, and D's range is tested."""
    import torch
    n = r.numel()
    top = float(r.max()) + d
    w_hi = torch.exp((r + d - top) / temp)
    before = torch.arange(n) < t
    after = torch.arange(n) > t
    if 0 < top_k < n:
        vals = torch.topk(r, top_k + 1).values
        lo_h, hi_h = float(vals[top_k]) - d, float(vals[top_k - 1]) + d
        band = r[(r >= lo_h - d) & (r <= hi_h + d)]
        hs = torch.cat([band - d, band + d, torch.tensor([lo_h, hi_h],
                                                         dtype=r.dtype)])
        hs = sorted({float(h) for h in hs if lo_h <= float(h) <= hi_h})
    else:
        hs = [None]
    for h in hs:
        if h is None:
            member = torch.ones(n, dtype=torch.bool)
            w_lo = torch.exp((r - d - top) / temp)
        else:
            eligible = r + d >= h
            forced = r - d > h
            if not eligible[t]:
                continue
            w_lo = torch.exp((torch.clamp(r - d, min=h) - top) / temp)
            forced[t] = True
            need = top_k - int(forced.sum())
            free = eligible & ~forced
            if need < 0 or int(free.sum()) < need:
                continue
        for down in (True, False):
            if h is not None:
                first = after if down else before
                second = before if down else after
                # free tokens that move D the wanted way, largest weight
                # first, then the others, smallest weight first
                key = torch.where(free & first, 2.0 + w_hi,
                                  torch.where(free & second, 1.0 - w_lo,
                                              torch.zeros_like(w_hi)))
                member = forced.clone()
                if need:
                    member[torch.topk(key, need).indices] = True
            a_lo, a_hi = float(w_lo[member & before].sum()), \
                float(w_hi[member & before].sum())
            c_lo, c_hi = float(w_lo[member & after].sum()), \
                float(w_hi[member & after].sum())
            w = float(w_hi[t])
            if (1 - u) * a_lo - u * c_hi <= u * w and \
                    (1 - u) * a_hi - u * c_lo > -(1 - u) * w:
                return True
    return False


def sample_gap(row, temp: float, top_k: int, u: float, a: int,
               b: int) -> float:
    """The sampled counterpart of a greedy logit gap: twice the smallest
    change d of the logits ``row`` (no entry moved by more than d) under
    which the engine's sampler at the request's uniform ``u`` picks
    ``a`` (:func:`_reachable`), and likewise ``b``; the larger of the
    two. A greedy choice of the top-k set may overstate it, never
    understate it; inf when even d = 1 does not reach a token."""
    r = row.double()
    worst = 0.0
    for t in (a, b):
        if _pick(r, temp, top_k, u) == t:
            continue
        if not _reachable(r, temp, top_k, u, t, 1.0):
            return float("inf")
        lo, hi = 0.0, 1.0
        for _ in range(30):
            mid = (lo + hi) / 2
            lo, hi = (lo, mid) if _reachable(r, temp, top_k, u, t, mid) \
                else (mid, hi)
        worst = max(worst, hi)
    return 2 * worst


def near_tie(rows_fn, cpu, req, got, want, tol):
    """The first position where a lane's tokens under faults (``got``)
    and fault-free (``want``) differ must be a near-tie of the reference
    (``rows_fn`` on the CPU copy, teacher-forced on the common prefix):
    a greedy lane's two tokens both within ``tol`` of the maximum logit
    (the teacher-forced check on each), a sampled lane's
    :func:`sample_gap` within ``tol``. Returns (the position, the
    gap)."""
    from deeplearning4j_tpu_torch.serving.generation import _uniforms
    p = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
    row = rows_fn(cpu, req["prompt"], got[:p + 1])[p].double()
    a, b = got[p], want[p]
    if req["temperature"] <= 0:
        gap = float(row.max() - min(row[a], row[b]))
    else:
        u = float(_uniforms(np.array([req["seed"]], np.uint32),
                            np.array([p], np.int32))[0])
        gap = sample_gap(row, req["temperature"], req["top_k"], u, a, b)
    if gap > tol:
        raise AssertionError(f"a lane's tokens under faults differ from "
                             f"the fault-free run at position {p} "
                             f"({a} vs {b}) by more than a near-tie: gap "
                             f"{gap:.3e} (tol {tol:g})")
    return p, gap


def fault_ladder(eng, card, label, reqs, want, plan, cpu_fn, rows_fn, tol,
                 layers, planned_chunks=None, mid_chunk_target=None):
    """Phase 11 on a warmed engine of an earlier phase (through
    set_fault_injector, so no warmup or capture is added): ``reqs``
    again under the seeded ``plan``. No request may be lost, retries and
    recoveries must be what the plan fires (one each), nothing may be
    captured, the recovery must land while several lanes decode (and,
    with ``mid_chunk_target``, while that request is mid-chunk), and every
    lane's tokens must equal the fault-free ``want`` unless its first
    difference is a near-tie (:func:`near_tie`). The decode kernel must
    launch once per layer and decode step; on the slot backend the flash
    kernel once per layer and prefill, each request prefilled once and
    each re-admitted one once more; on the paged backend the chunks must
    outnumber the ``planned_chunks`` of a fault-free run. Prints the
    recovery's wall time, fault to the last re-admitted lane's next
    token."""
    from deeplearning4j_tpu_torch import kernels
    captures = eng.stats()["compile_cache"]["compiles"]
    st0 = eng.stats()
    inj = watched_injector(eng, **plan)
    eng.set_fault_injector(inj)
    try:
        reset_launches()
        results, stamps, objs, wall = ordered_streams(eng, reqs)
        launches = {k.split(".")[0] + k.split(".")[1][8:]: n
                    for k, n in kernels.launch_counts().items()
                    if n and "bf16" not in k}
    finally:
        eng.set_fault_injector(None)
    st = eng.stats()
    no_capture_since(eng, captures)
    check_lengths(results, reqs)
    faults = {k: st["faults"][k] - st0["faults"][k]
              for k in ("retries", "recoveries")}
    if faults != {"retries": 1, "recoveries": 1} or len(inj.at_fault) != 1:
        raise AssertionError(f"the plan fires one transient and one "
                             f"corrupting fault: {faults}, "
                             f"{len(inj.at_fault)} corrupting fires")
    snap = inj.at_fault[0]
    index = {id(r): i for i, r in enumerate(objs)}
    head = index.get(id(snap["head"]))
    if snap["decoding"] < 2 or (mid_chunk_target is not None and not (
            snap["mid_chunk"] and head == mid_chunk_target)):
        raise AssertionError(f"the recovery landed with {snap['decoding']} "
                             f"lanes decoding, request {head} at the head "
                             f"of the chunk queue (mid-chunk "
                             f"{snap['mid_chunk']}, aimed at "
                             f"{mid_chunk_target})")
    readmitted = [index[id(r)] for r, _ in snap["in_flight"]]
    # each re-admitted lane's next token is the first one it had not
    # emitted at the fault (its stamp is when its reader got it)
    nxt = [stamps[index[id(r)]][n] for r, n in snap["in_flight"]]
    recovery_ms = (max(nxt) - snap["t"]) * 1e3
    steps = st["decode_steps"] - st0["decode_steps"]
    prefills = st["prefills"] - st0["prefills"]
    chunks = (st["paged"]["prefill_chunks"]
              - st0["paged"]["prefill_chunks"]) if st["paged"] else None
    decode = [k for k in launches if "flash" not in k]
    if len(decode) != 1 or launches[decode[0]] != layers * steps \
            or not steps:
        raise AssertionError(f"launches {launches} over {steps} decode "
                             f"steps: one decode kernel, {layers} x steps")
    if chunks is None:
        if prefills != len(reqs) + len(readmitted) \
                or launches.get("flash_attention") != layers * prefills:
            raise AssertionError(
                f"{prefills} prefills for {len(reqs)} requests and "
                f"{len(readmitted)} re-admissions, launches {launches}")
    elif "flash_attention" in launches or chunks <= planned_chunks:
        raise AssertionError(f"{chunks} chunks (fault-free "
                             f"{planned_chunks}), launches {launches}")
    differ = [i for i, r in enumerate(results)
              if r["tokens"] != want[i]["tokens"]]
    ties, not_ties = [], []
    if differ:
        cpu = cpu_fn()
        for i in differ:
            try:
                ties.append((i,) + near_tie(rows_fn, cpu, reqs[i],
                                            results[i]["tokens"],
                                            want[i]["tokens"], tol))
            except AssertionError as e:
                not_ties.append(f"request {i}: {e}")
    out = dict(engine=label, requests=len(reqs), plan=plan["plan"],
               corrupting=list(plan["corrupting"]), **faults,
               decoding_at_fault=snap["decoding"],
               in_flight_at_fault=len(readmitted),
               mid_chunk_at_fault=snap["mid_chunk"],
               chunk_head_at_fault=head,
               recovery_ms=recovery_ms, wall_s=wall, decode_steps=steps,
               prefills=prefills, prefill_chunks=chunks, launches=launches,
               lanes_differing=len(differ), near_ties=ties,
               captures_after_warmup=captures)
    print(f"fault ladder [{card}] (phase 11, {label}): {len(reqs)} "
          f"requests under plan {plan['plan']} (corrupting "
          f"{list(plan['corrupting'])}): none lost, {faults['retries']} "
          f"retry, {faults['recoveries']} recovery with "
          f"{snap['decoding']} lanes decoding and {len(readmitted)} "
          f"requests re-admitted (mid-chunk: {snap['mid_chunk']}); "
          f"recovery {recovery_ms:.1f} ms from the fault to the last "
          f"re-admitted lane's next token; {len(differ)} lanes differ "
          f"from the fault-free run (near-ties as (request, position, "
          f"gap): {ties}); {prefills} "
          f"prefills, {chunks} chunks, {steps} decode steps, launches "
          f"{launches}; {captures} decode-step graph captured at warmup, "
          f"none after")
    if not_ties:
        raise AssertionError("; ".join(not_ties))
    return out


def all_blocks_back(eng, when: str = "") -> int:
    """Release the session pins and the prefix index; every block of
    the pool must then be free. Returns the free count."""
    eng.evict_sessions()
    eng.clear_prefix_cache()
    free, total = eng._allocator.free_count, eng._allocator.capacity
    if free != total:
        raise AssertionError(f"blocks leaked{when}: {free} of {total} free "
                             f"after the caches were cleared")
    return free


def warmed_compiles(eng) -> int:
    """Decode-step graph captures after warmup: one where the engine
    replays its CUDA graph (the card's default), none for the eager
    step."""
    n = eng.stats()["compile_cache"]["compiles"]
    if n != int(eng._cuda_graph):
        raise AssertionError(f"{n} decode-step captures after warmup "
                             f"(CUDA graph {eng._cuda_graph})")
    return n


def no_capture_since(eng, captures: int):
    """Nothing may be captured once the engine is warm."""
    n = eng.stats()["compile_cache"]["compiles"]
    if n != captures:
        raise AssertionError(f"{n - captures} decode-step captures after "
                             f"warmup")


def eager_run(lm, engine_kw, reqs, results):
    """``reqs`` again, through the eager decode step (the engine's private
    ``_cuda_graph`` switched off before warmup): every request's tokens
    must be those of the graphed run (``results``). Returns its step
    and throughput numbers."""
    from deeplearning4j_tpu_torch.serving import GenerationEngine
    eng = GenerationEngine(lm, **engine_kw)
    eng._cuda_graph = False
    try:
        eng.warmup()
        warmed_compiles(eng)
        got, wall = run_requests(eng, reqs)
        st = eng.stats()
    finally:
        eng.stop()
    same = sum(a["tokens"] == b["tokens"] for a, b in zip(got, results))
    if same != len(reqs):
        raise AssertionError(f"the eager step gave other tokens than the "
                             f"CUDA graph: {same} of {len(reqs)} identical")
    n_tok = sum(len(r["tokens"]) for r in got)
    return dict(identical=f"{same}/{len(reqs)}", wall_s=wall,
                tokens_per_s=n_tok / wall,
                decode_step_p50_ms=st["decode_step_ms"]["p50"],
                decode_step_p99_ms=st["decode_step_ms"]["p99"],
                decode_sync_wait_p50_ms=st["decode_sync_wait_ms"]["p50"],
                decode_sync_wait_p99_ms=st["decode_sync_wait_ms"]["p99"])


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
    host = []
    for e in p.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            host.append((e.key, e.self_cpu_time_total / 1e3, e.count))
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        kernels[e.key] = kernels.get(e.key, 0.0) + us / 1e3
        n_kernels += e.count
    busy_ms = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    # the port's own kernels, whether or not they are among the top
    ours = {n: t for n, t in kernels.items() if PORT_KERNEL.search(n)}
    return dict(wall_ms=wall * 1e3, busy_ms=busy_ms,
                busy_share=busy_ms / (wall * 1e3), top=top, ours=ours,
                device_kernels=n_kernels,
                decode_steps=st1["decode_steps"] - st0["decode_steps"],
                prefills=st1["prefills"] - st0["prefills"])


def sass_counts():
    """Tensor-core instructions per instantiation of the flash kernels
    (f32 and bf16 legs): HMMA (``mma.sync``) and HGMMA (``wgmma``), each
    with its bf16 form; and I2F (I2F, I2FP) in the two int8 kernels; in
    the built libraries, from ``cuobjdump -sass``; None where the
    toolkit has no cuobjdump."""
    from deeplearning4j_tpu_torch.kernels import _build
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    kernel = re.compile(r"(flash_fwd_kernel|flash_bwd_dq_kernel|"
                        r"flash_bwd_dkv_kernel|flash_fwd_bf16_kernel|"
                        r"flash_bwd_dq_bf16_kernel|flash_bwd_dkv_bf16_kernel|"
                        r"paged_attention_int8_kernel|"
                        r"decode_attention_int8_kernel)"
                        r"ILi(\d+)E(?:Li(\d+)E)?")
    opcode = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                        r"([A-Z][A-Z0-9]*)(\.[A-Za-z0-9.]*)?")
    counts = {}
    for lib in ("flash_attention", "paged_attention", "decode_attention"):
        text = subprocess.run([tool, "-sass", str(_build._lib_path(lib))],
                              capture_output=True, text=True, check=True,
                              timeout=300).stdout
        fn = None
        for line in text.splitlines():
            if "Function :" in line:
                m = kernel.search(line)
                fn = (f"{m[1]}<{m[2]}" + (f",{m[3]}>" if m[3] else ">")
                      if m else None)
                if fn:
                    counts[fn] = {"HMMA": 0, "HMMA_BF16": 0, "HGMMA": 0,
                                  "HGMMA_BF16": 0, "I2F": 0}
                continue
            op = opcode.search(line) if fn else None
            if op and op[1] in ("HMMA", "HGMMA"):
                counts[fn][op[1]] += 1
                if ".BF16" in (op[2] or ""):
                    counts[fn][op[1] + "_BF16"] += 1
            elif op and op[1] in ("I2F", "I2FP"):
                counts[fn]["I2F"] += 1
    return counts


#: the kernels on wgmma (bf16 HGMMA, no HMMA) at every head-dim bucket
WGMMA_KERNELS = ("flash_fwd_bf16_kernel", "flash_bwd_dq_bf16_kernel",
                 "flash_bwd_dkv_bf16_kernel")


def check_sass(counts):
    """The bf16 forward, dQ and dK/dV kernels must run on wgmma (bf16
    HGMMA, no HMMA) at each head-dim bucket (32, 64, 128); every other
    flash kernel on mma.sync (HMMA); both int8 kernels must convert int8
    without I2F (0)."""
    def bad(f, c):
        if f.split("<")[0] in WGMMA_KERNELS:
            return not c["HGMMA_BF16"] or c["HMMA"]
        return ((f.startswith("flash") and not c["HMMA"])
                or ("int8" in f and c["I2F"]))
    wrong = [f for f, c in counts.items() if bad(f, c)]
    missing = [f"{k}<{d}>" for k in WGMMA_KERNELS for d in (32, 64, 128)
               if f"{k}<{d}>" not in counts]
    kinds = {f.split("<")[0] for f in counts}
    if wrong or missing or len(kinds) != 8:
        raise AssertionError(f"SASS: the bf16 forward, dQ and dK/dV kernels "
                             f"must run bf16 HGMMA and no HMMA at D 32, 64, "
                             f"128 (missing {missing}), the f32 flash "
                             f"kernels HMMA, the int8 kernels no I2F: "
                             f"{wrong} in {counts}")


AB_CODE = r"""
import json, torch
import chip_smoke as cs
from deeplearning4j_tpu_torch.kernels import flash_attention as fa
dev = torch.device("cuda")
card = cs.card_line()
out = {"flash_ms": {}}
g = torch.Generator(device="cpu").manual_seed(2)
for B in (1, 4):
    q, k, v = (torch.randn((B, 1024, 8, 64), generator=g).to(dev)
               for _ in range(3))
    km = torch.ones((B, 1024), device=dev)
    out["flash_ms"][B] = cs.time_ms(lambda: fa.flash_attention(q, k, v, True,
                                                               km))
    if B == 4:  # the backward kernels at the training shape
        do = torch.randn((B, 1024, 8, 64), generator=g).to(dev)
        o, lse = fa.flash_attention(q, k, v, True, km)
        args = (q, k, v, km, do, lse, fa.backward_delta(do, o), True)
        out["dq_ms"] = cs.time_ms(lambda: fa.flash_attention_bwd_dq(*args))
        out["dkv_ms"] = cs.time_ms(lambda: fa.flash_attention_bwd_dkv(*args))
# the bf16 legs at the training shape, and the whole bf16 backward
qb, kb, vb, dob = (torch.randn((4, 1024, 8, 64), generator=g).to(dev)
                   .bfloat16() for _ in range(4))
km = torch.ones((4, 1024), device=dev)
ob, lseb = fa.flash_attention(qb, kb, vb, True, km)
args = (qb, kb, vb, km, dob, lseb, fa.backward_delta(dob, ob), True)
out["bf16_ms"] = dict(
    fwd=cs.time_ms(lambda: fa.flash_attention(qb, kb, vb, True, km)),
    dq=cs.time_ms(lambda: fa.flash_attention_bwd_dq(*args)),
    dkv=cs.time_ms(lambda: fa.flash_attention_bwd_dkv(*args)),
    whole_bwd=cs.time_ms(lambda: fa.flash_attention_bwd(qb, kb, vb, km, ob,
                                                        lseb, dob, True)))
out["bf16_ms"]["pair"] = out["bf16_ms"]["dq"] + out["bf16_ms"]["dkv"]
out["decode_ms"] = cs.check_decode(dev)["float32"]["ms"]
out["paged_ms"] = cs.check_paged(dev)["float32"]["ms"]
out["paged_int8_ms"] = cs.check_paged_int8(dev)["ms"]
out["decode_int8_ms"] = cs.check_decode_int8(dev)["ms"]
out["serving"] = {}
for phase, run in ((4, lambda: cs.serve(card)),
                   (5, lambda: cs.serve_paged(card)),
                   (6, lambda: cs.serve(card, kv_dtype="int8")),
                   (7, lambda: cs.serve_paged(card, kv_dtype="int8"))):
    e = run()
    prof = e["profile"]
    out["serving"][phase] = dict(
        {k: e.get(k) for k in ("tokens_per_s", "ttft_p50_ms", "ttft_p99_ms",
                               "decode_step_p50_ms", "decode_step_p99_ms",
                               "decode_sync_wait_p50_ms",
                               "decode_sync_wait_p99_ms")},
        window={k: prof[k] for k in ("busy_share", "busy_ms", "wall_ms",
                                     "device_kernels", "decode_steps",
                                     "ours")})
tr = cs.train(card, cfg=dict(cs.TRAIN_CFG, dtype="bfloat16"))  # phase 10
out["train_bf16"] = dict(
    {k: tr[k] for k in ("step_p50_ms", "enqueue_p50_ms", "step_ms",
                        "enqueue_ms")},
    device_ms_by_kind=tr["profile"]["by_kind"])
print("AB " + json.dumps(out))
"""


def run_ab(parent: str) -> int:
    """``--ab PARENT``: the parent checkout's and this checkout's own
    code in turns (parent, this, this, parent), each in a process of its
    own: B3 at B=1 and B=4, B6 and B7 at B=4, the bf16 legs of B3, B6
    and B7 and the whole bf16 backward at B=4, B1, B2, B4 and B5 (their
    phase-3 checks), phases 4 to 7 with their profile windows, and phase
    10's step p50, enqueue p50 and device time by kind; prints each turn
    as JSON, then all of them on one "A/B runs:" line."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    card = card_line()
    print(f"device: {card}")
    runs = []
    for label, root in (("parent", parent), ("change", here),
                        ("change", here), ("parent", parent)):
        proc = subprocess.run([sys.executable, "-c", AB_CODE], cwd=root,
                              capture_output=True, text=True, timeout=1200)
        if proc.returncode:
            print(proc.stdout[-3000:], proc.stderr[-6000:], file=sys.stderr)
            raise RuntimeError(f"A/B turn {label} failed")
        line = [x for x in proc.stdout.splitlines() if x.startswith("AB ")]
        runs.append(dict(label=label, **json.loads(line[-1][3:])))
        print(f"A/B {label}: {json.dumps(runs[-1])}")
    print("A/B runs: " + json.dumps(dict(card=card, runs=runs)))
    print(card)
    return 0


def main() -> int:
    import torch
    if sys.argv[1:2] == ["--ab"]:
        return run_ab(sys.argv[2])
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
    sass = sass_counts()
    if sass is not None:
        check_sass(sass)
    print(f"SASS HMMA, HGMMA and I2F counts per kernel instantiation: "
          f"{'not measured (no cuobjdump)' if sass is None else sass}")

    decode = check_decode(dev)
    flash = check_flash(dev)
    paged = check_paged(dev)
    decode8 = check_decode_int8(dev)
    paged8 = check_paged_int8(dev)
    # phases 4 to 7; phase 11 (the fault ladder) runs on the warmed
    # engines of phases 4 and 7 after their fault-free runs
    e2e = serve(card, eager_ab=True, chaos=True)
    e2e_paged = serve_paged(card)
    e2e_int8 = serve(card, kv_dtype="int8")
    e2e_paged_int8 = serve_paged(card, kv_dtype="int8", chaos=True)
    bwd = check_flash_bwd(dev)
    bf16 = check_flash_bf16(dev)
    trained = train(card)
    trained_bf16 = train(card, cfg=dict(TRAIN_CFG, dtype="bfloat16"))

    def row(name, src, replaces, launches, res):
        return dict(name=name, route="cuda",
                    source=f"deeplearning4j_tpu_torch/csrc/{src}",
                    replaces=f"deeplearning4j_tpu/kernels/{replaces}",
                    launches=launches,
                    **{k: res[k] for k in ("max_abs_err", "ms", "plain_ms",
                                           "bound_ms", "bound_by",
                                           "library_ms")})

    kernels = [
        row("decode_attention", "decode_attention.cu",
            "decode_attention.py:100",
            e2e["launches"]["decode_attention"], decode["float32"]),
        row("flash_attention", "flash_attention.cu", "flash_attention.py:65",
            e2e["launches"]["flash_attention"], flash),
        row("paged_attention", "paged_attention.cu", "paged_attention.py:80",
            e2e_paged["launches"]["paged_attention"], paged["float32"]),
        row("decode_attention_int8", "decode_attention.cu",
            "decode_attention.py:143",
            e2e_int8["launches"]["decode_attention_int8"], decode8),
        row("paged_attention_int8", "paged_attention.cu",
            "paged_attention.py:130",
            e2e_paged_int8["launches"]["paged_attention_int8"], paged8),
        row("flash_attention_bwd_dq", "flash_attention.cu",
            "flash_attention.py:169",
            trained["launches"]["flash_attention_bwd_dq"], bwd["dq"]),
        row("flash_attention_bwd_dkv", "flash_attention.cu",
            "flash_attention.py:214",
            trained["launches"]["flash_attention_bwd_dkv"], bwd["dkv"]),
        row("flash_attention_bf16", "flash_attention.cu",
            "flash_attention.py:65",
            trained_bf16["launches"]["flash_attention_bf16"], bf16["fwd"]),
        row("flash_attention_bwd_dq_bf16", "flash_attention.cu",
            "flash_attention.py:169",
            trained_bf16["launches"]["flash_attention_bwd_dq_bf16"],
            bf16["dq"]),
        row("flash_attention_bwd_dkv_bf16", "flash_attention.cu",
            "flash_attention.py:214",
            trained_bf16["launches"]["flash_attention_bwd_dkv_bf16"],
            bf16["dkv"]),
    ]
    print("details: " + json.dumps(
        dict(card=card, decode=decode, flash=flash, paged=paged,
             decode_int8=decode8, paged_int8=paged8, e2e=e2e,
             e2e_paged=e2e_paged, e2e_int8=e2e_int8,
             e2e_paged_int8=e2e_paged_int8, flash_bwd=bwd, flash_bf16=bf16,
             train=trained, train_bf16=trained_bf16,
             build={n: l["seconds"] for n, l in logs.items()}, sass=sass),
        default=str))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
