"""Evidence on the CPU for the bf16 flash forward's tile arithmetic (B3's
bf16 leg).

The kernel (``csrc/flash_attention.cu`` ``flash_fwd_bf16_kernel``) runs
on ``wgmma`` and TMA and cannot run here. This file runs its arithmetic
in torch in the kernel's order and holds the result to the plain
version (``flash_attention_torch``) and to the JAX package's flash
forward at bf16 (Pallas in interpret mode, as its own tests run it):

- blocks of 128 query rows, split between two warpgroups of 64 rows;
- key tiles of 128; under the causal mask a warpgroup visits the tiles
  up to its diagonal only, and compares key and row positions on the
  diagonal tile only;
- the online softmax keeps each row's running max ``m`` of the raw
  scores, p = 2^(s c - m c) with c = scale log2(e), corrects O and the
  row sum by 2^((m_old - m_new) c) once a tile, and where-guards p to 0
  on masked keys;
- P is rounded to bf16 before O += P V (f32 accumulation; a product of
  two bf16 values is exact in f32); the row sum takes the f32 p;
- LSE = m scale + log(max(l, 1e-30)); O = O / max(l, 1e-30) rounded to
  bf16 once.

Tolerances, those of the card tests (``tests/test_torch_kernels_gpu.py``
``TOL_BF16_O`` and ``TOL_BF16_LSE``): O within 1e-2 of max(1, max|O|),
since P is rounded to bf16 (~2^-9 of each term) and O once more at the
end (one ulp is up to 2^-7 of the largest value); the LSE, f32 on both
sides from the same bf16 values, within 1e-5.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.kernels import flash_attention as jax_flash
from deeplearning4j_tpu_torch.kernels import flash_attention as fa
from _torch_threads import one_torch_thread  # noqa: F401,E402

TOL_O = 1e-2
TOL_LSE = 1e-5
NEG_INF = -1e30
BM = 128      # query rows a block
ROWS = 64     # query rows a warpgroup
BN = 128      # keys a streamed tile


def tile_forward(q, k, v, causal, key_mask):
    """The kernel's forward over bf16 [B, T, H, D] inputs, warpgroup by
    warpgroup and key tile by key tile. Returns (O in bf16, LSE
    [B, H, T] in f32) and the number of key tiles each warpgroup
    visited."""
    B, T, H, D = q.shape
    scale = 1.0 / math.sqrt(D)
    c = scale * math.log2(math.e)
    qh, kh, vh = (x.float().permute(0, 2, 1, 3) for x in (q, k, v))
    key_ok = torch.ones((B, T), dtype=torch.bool) if key_mask is None \
        else key_mask > 0
    out = torch.zeros((B, H, T, D))
    lse = torch.full((B, H, T), NEG_INF)
    n_kt = -(-T // BN)
    visited = []
    for q0 in range(0, T, BM):
        n = min(n_kt, (q0 + BM - 1) // BN + 1) if causal else n_kt
        for r0 in range(q0, min(q0 + BM, T), ROWS):
            rows = torch.arange(r0, min(r0 + ROWS, T))
            nw = min(n, (r0 + ROWS - 1) // BN + 1) if causal else n
            visited.append(nw)
            m = torch.full((B, H, len(rows), 1), NEG_INF)
            l = torch.zeros((B, H, len(rows), 1))
            acc = torch.zeros((B, H, len(rows), D))
            for i in range(nw):
                keys = torch.arange(i * BN, min(i * BN + BN, T))
                s = qh[:, :, rows] @ kh[:, :, keys].transpose(-1, -2)
                ok = key_ok[:, None, None, keys]
                if causal and i * BN + BN - 1 > r0:   # the diagonal tile
                    ok = ok & (keys[None, :] <= rows[:, None])
                s = torch.where(ok, s, NEG_INF)
                mx = torch.maximum(m, s.amax(-1, keepdim=True))
                corr = torch.exp2((m - mx) * c)
                p = torch.where(s > NEG_INF, torch.exp2(s * c - mx * c), 0.0)
                l = l * corr + p.sum(-1, keepdim=True)
                acc = acc * corr + p.bfloat16().float() @ vh[:, :, keys]
                m = mx
            if causal:  # the tiles it skips hold no live key of its rows
                assert nw * BN > rows[-1]
            lc = l.clamp_min(1e-30)
            out[:, :, rows] = acc / lc
            lse[:, :, rows] = torch.where(
                m > NEG_INF, m * scale + torch.log(lc), NEG_INF)[..., 0]
    return out.permute(0, 2, 1, 3).bfloat16(), lse, visited


def _case(T, D, seed):
    """bf16 q, k, v [3, T, 2, D] from a seed; batch row 1 masks its last
    third of keys (a padded prompt), row 2 every key."""
    rs = np.random.RandomState(seed)
    q, k, v = (torch.from_numpy(rs.randn(3, T, 2, D).astype(np.float32))
               .bfloat16() for _ in range(3))
    km = torch.ones((3, T))
    km[1, 2 * T // 3:] = 0.0
    km[2] = 0.0
    return q, k, v, km


def _scaled(got, want):
    got, want = got.float(), want.float()
    return ((got - want).abs().max() /
            max(want.abs().max().item(), 1.0)).item()


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("D", [36, 64])
@pytest.mark.parametrize("T", [8, 100, 129, 257])
def test_tile_forward_matches_the_plain_version(T, D, causal):
    q, k, v, km = _case(T, D, 11 * T + D + causal)
    out, lse, _ = tile_forward(q, k, v, causal, km)
    ref, lref = fa.flash_attention_torch(q, k, v, causal, km)
    assert out.dtype == ref.dtype == torch.bfloat16
    assert _scaled(out, ref) <= TOL_O
    assert (lse - lref).abs().max().item() <= TOL_LSE
    # the fully masked row: O exactly 0, LSE exactly -1e30
    assert out[2].float().abs().max().item() == 0.0
    assert bool((lse[2] == NEG_INF).all())


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("T", [100, 257])
def test_tile_forward_matches_jax_at_bf16(T, causal):
    """The same arithmetic held to the JAX package's flash forward on the
    same bf16 values (``_fwd_kernel`` casts each block to f32 and writes
    O in bf16)."""
    q, k, v, km = _case(T, 64, 13 * T + causal)
    want = jax_flash(*(jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
                       for x in (q, k, v)),
                     causal=causal, key_mask=jnp.asarray(km.numpy()),
                     block_q=64, block_k=64, interpret=True)
    want = torch.from_numpy(np.array(want.astype(jnp.float32)))
    out, _, _ = tile_forward(q, k, v, causal, km)
    assert _scaled(out, want) <= TOL_O


@pytest.mark.parametrize("T", [64, 129, 1024])
def test_causal_warpgroups_visit_tiles_up_to_their_diagonal(T):
    """Under the causal mask the warpgroup of rows r0 .. r0 + 63 visits
    key tiles 0 .. (r0 + 63) // 128: of a 128-row block the first
    warpgroup as many as the second, both ending on the diagonal tile,
    which the kernel's grid runs last query block first."""
    q, k, v, _ = _case(T, 32, T)
    _, _, visited = tile_forward(q, k, v, True, None)
    want = [r0 // BN + 1 for r0 in range(0, T, ROWS)]
    assert visited == want
    assert sum(visited) == sum(-(-min(r0 + ROWS, T) // BN)
                               for r0 in range(0, T, ROWS))
