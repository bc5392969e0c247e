"""Evidence on the CPU for the f32/bf16 decode kernel (B1).

The kernel (``csrc/decode_attention.cu`` ``decode_attention_split_kernel``)
splits a (slot, head)'s keys into chunks of C = ``CHUNK_KEYS``, and the
chunks over the 8 blocks of one cluster: block r takes chunks r, r + 8,
... Within a block, warp w folds tiles w, w + 4, ... of each chunk (a
tile is 32 / L row groups of NL rows, L and NL from the head dim's
16-byte layout) under its own online softmax; the warps are merged in
warp order into the block's partial (m, l, acc), and rank 0 merges the
live blocks' partials in rank order, which is chunk order up to
T = 1024. bf16 caches round q, and p before the PV product, to bf16 and
sum in f32. The card cannot be asked here, so this file runs that
arithmetic in torch in the kernel's order and holds it to the port's
plain version (``decode_attention_torch``), to the JAX package's Pallas
kernel in interpret mode (as its own tests run it) and to its XLA path,
on inputs made with numpy from a seed.

Tolerances: 1e-5 in f32 (the same math in another summation order,
over up to 300 keys of O(1) terms); 5e-3 in bf16, the card test's
``TOL_BF16``: the kernel rounds the unnormalised p of each tile's
running max, the plain version and the XLA path the normalised p and
the Pallas kernel p of its 128-key blocks' max, each within 2^-9 of its
term.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.kernels.decode_attention import (
    decode_attention_pallas, decode_attention_xla)
from deeplearning4j_tpu_torch.kernels import decode_attention as da
from _torch_threads import one_torch_thread  # noqa: F401,E402

TOL_F32 = 1e-5
TOL_BF16 = 5e-3
NEG_INF = -1e30
C = da.CHUNK_KEYS
CLUSTER = 8   # blocks a (slot, head), kCluster in the source
WARPS = 4     # warps a block, kWarps
LANE_REGS = 8  # registers of K a lane holds per tile, kLaneRegs


def tile_rows(D: int, item: int) -> int:
    """Rows a warp tile holds at head dim D (the source's ``Split``),
    with 16-byte-aligned caches of ``item``-byte elements."""
    row = D * item
    vec = next((w for w in (16, 8, 4) if row % w == 0), item)
    nv = -(-D // (vec // item))
    L = 1
    while L < nv and L < 32:
        L *= 2
    J = 1
    while L * J < nv:
        J *= 2
    nl = max(1, min(LANE_REGS // (J * max(1, vec // 4)), L))
    return 32 // L * nl


def _bf16(x):
    return x.to(torch.bfloat16).float()


def split_decode(q, k, v, lengths):
    """The kernel's arithmetic on [S, H, T, D] caches, in its order."""
    S, H, T, D = k.shape
    bf16 = k.dtype == torch.bfloat16
    scale = torch.tensor(1.0 / math.sqrt(D), dtype=torch.float32)
    qf = _bf16(q) if bf16 else q.float()
    kf, vf = k.float(), v.float()
    tile = tile_rows(D, k.element_size())
    lens = lengths.long().clamp(0, T)[:, None, None]        # [S, 1, 1]
    chunks = -(-T // C)
    pm, pl, pacc = [], [], []
    for r in range(CLUSTER):
        wm = torch.full((WARPS, S, H, 1), NEG_INF)
        wl = torch.zeros((WARPS, S, H, 1))
        wacc = torch.zeros((WARPS, S, H, D))
        for ci in range(r, chunks, CLUSTER):
            for i in range(C // tile):
                w = i % WARPS
                t = ci * C + i * tile + torch.arange(tile)
                if t[0] >= T:
                    continue
                t = t[t < T]
                live = t[None, None, :] < lens                  # [S, 1, n]
                kt, vt = kf[:, :, t], vf[:, :, t]
                s = (qf[:, :, None, :] * kt).sum(-1) * scale    # [S, H, n]
                s = torch.where(live, s, NEG_INF)
                mx = torch.maximum(wm[w], s.amax(-1, keepdim=True))
                corr = torch.exp(wm[w] - mx)
                p = torch.where(live, torch.exp(s - mx), 0.0)
                pv = _bf16(p) if bf16 else p
                vt = torch.where(live[..., None], vt, 0.0)
                wl[w] = wl[w] * corr + p.sum(-1, keepdim=True)
                wacc[w] = wacc[w] * corr + (pv[..., None] * vt).sum(-2)
                wm[w] = mx
        # the block's partial: its warps in warp order
        bm = wm.amax(0)
        cw = torch.exp(wm - bm)
        bl, bacc = torch.zeros_like(bm), torch.zeros((S, H, D))
        for w in range(WARPS):
            bl = bl + wl[w] * cw[w]
            bacc = bacc + wacc[w] * cw[w]
        pm.append(bm)
        pl.append(bl)
        pacc.append(bacc)
    # rank 0's merge over the live blocks, in rank order
    nb = torch.clamp(-(-lens // C), max=CLUSTER)             # [S, 1, 1]
    mx = torch.full((S, H, 1), NEG_INF)
    for r in range(CLUSTER):
        mx = torch.where(r < nb, torch.maximum(mx, pm[r]), mx)
    lsum, acc = torch.zeros((S, H, 1)), torch.zeros((S, H, D))
    for r in range(CLUSTER):
        cr = torch.exp(pm[r] - mx)
        lsum = torch.where(r < nb, lsum + pl[r] * cr, lsum)
        acc = torch.where(r < nb, acc + pacc[r] * cr, acc)
    return acc / lsum.clamp_min(1e-30)


def _case(D, seed, lens=(0, 1, C - 1, C, C + 1, 300), H=2, T=300):
    """q, K/V [S, H, T, D] from a seed, NaN past every slot's length."""
    rs = np.random.RandomState(seed)
    S = len(lens)
    q = rs.randn(S, H, D).astype(np.float32)
    k = rs.randn(S, H, T, D).astype(np.float32)
    v = rs.randn(S, H, T, D).astype(np.float32)
    for s, n in enumerate(lens):
        k[s, :, n:] = np.nan
        v[s, :, n:] = np.nan
    return q, k, v, np.asarray(lens, np.int32)


def _torch(q, k, v, lens, dtype):
    return (torch.from_numpy(q), torch.from_numpy(k).to(dtype),
            torch.from_numpy(v).to(dtype), torch.from_numpy(lens))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, TOL_F32),
                                       (torch.bfloat16, TOL_BF16)])
@pytest.mark.parametrize("D", [1, 3, 16, 64, 160, 256])
def test_split_arithmetic_matches_plain_and_jax(D, dtype, tol):
    """Lengths 0, 1, C - 1, C, C + 1 and T (= 300, three chunks, the
    last partial) with NaN tails: within the tolerance of the port's
    plain version, the Pallas kernel (interpret mode) and the XLA path;
    the length-0 slot exactly 0."""
    q, k, v, lens = _case(D, 100 + D)
    tq, tk, tv, tl = _torch(q, k, v, lens, dtype)
    got = split_decode(tq, tk, tv, tl)
    assert torch.isfinite(got).all()
    assert got[0].abs().max().item() == 0.0
    want = da.decode_attention_torch(tq, tk, tv, tl)
    assert (got - want).abs().max().item() <= tol
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jk, jv = jnp.asarray(k, jdt), jnp.asarray(v, jdt)
    for ref in (decode_attention_pallas(q, jk, jv, lens, interpret=True),
                decode_attention_xla(q, jk, jv, lens)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                                   atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_arithmetic_past_eight_chunks(dtype):
    """Past 8 chunks each block folds chunks r and r + 8 before the
    merge, which is then no longer in chunk order: still within the
    tolerance of the plain version."""
    lens = (8 * C - 1, 8 * C, 8 * C + 1, 9 * C + 5, 11 * C)
    q, k, v, lens = _case(8, 7, lens=lens, H=1, T=11 * C)
    tq, tk, tv, tl = _torch(q, k, v, lens, dtype)
    got = split_decode(tq, tk, tv, tl)
    want = da.decode_attention_torch(tq, tk, tv, tl)
    tol = TOL_F32 if dtype == torch.float32 else TOL_BF16
    assert (got - want).abs().max().item() <= tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [16, 64])
def test_slot_bits_independent_of_batch_and_capacity(D, dtype):
    """A slot's result is the same bits alone (S = 1) as among 8 slots,
    and at T_cap 300 and 600: chunks sit at absolute positions and the
    merge takes only the live ones."""
    q, k, v, lens = _case(D, 200 + D, lens=(0, 1, 129, 255, 256, 257, 299,
                                            300), T=600)
    tq, tk, tv, tl = _torch(q, k, v, lens, dtype)
    wide = split_decode(tq, tk, tv, tl)
    narrow = split_decode(tq, tk[:, :, :300].contiguous(),
                          tv[:, :, :300].contiguous(), tl)
    assert torch.equal(wide, narrow)
    for s in range(len(lens)):
        alone = split_decode(tq[s:s + 1], tk[s:s + 1, :, :300],
                             tv[s:s + 1, :, :300], tl[s:s + 1])
        assert torch.equal(alone[0], narrow[s])


def test_tile_rows_follow_the_16_byte_layout():
    """16 rows at f32 D = 16 (4 lanes a row, 8 rows a warp load, two
    loads a lane), 4 at f32 D = 64 (16 lanes a row), 1 at f32 D = 256
    (two 16-byte vectors a lane), 8 at bf16 D = 64; every tile divides
    a warp's share of a chunk."""
    assert tile_rows(16, 4) == 16
    assert tile_rows(64, 4) == 4
    assert tile_rows(256, 4) == 1
    assert tile_rows(64, 2) == 8
    for D in range(1, 257):
        for item in (4, 2):
            assert (C // WARPS) % tile_rows(D, item) == 0
