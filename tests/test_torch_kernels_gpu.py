"""The Hopper kernels against their plain PyTorch versions on the card
(f32, bf16 and int8 caches).

Every test here carries the ``gpu`` marker and skips itself without a
CUDA device. The file imports neither JAX nor the JAX package, so it
also runs where JAX is not installed:

    python -m pytest --noconftest -q tests/test_torch_kernels_gpu.py

(``tests/conftest.py`` configures JAX, hence ``--noconftest`` there).
``chip_smoke.py`` checks the same kernels at the served shapes.
"""
import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.kernels import decode_attention as da
from deeplearning4j_tpu_torch.kernels import flash_attention as fa
from deeplearning4j_tpu_torch.kernels import kv_quant as kvq
from deeplearning4j_tpu_torch.kernels import paged_attention as pa

pytestmark = pytest.mark.gpu

# f32: the same math in another summation order, over up to 100 keys
TOL_F32 = 1e-4
# bf16 caches: p rounded to bf16 before (kernel, as the Pallas kernel)
# or after (plain, as decode_attention_xla) normalisation, ~2^-9 of
# each term; chip_smoke.py measures 1.9e-3 at S=32, T=1024
TOL_BF16 = 5e-3
# int8 caches: the kernel rounds the unnormalised p * vscale to bf16
# (as the Pallas kernel), the plain version the normalised one (as the
# xla path); each rounding is within 2^-8 of its term, so an output may
# move by up to 2^-7 of the largest |dequantised v| it averages, most
# where one key dominates. The JAX package holds its own int8 Pallas
# kernel to its xla path at 2e-2 (tests/test_kv_quant.py); 1.0e-2
# measured on an H100 at S=32 H=8 T=1024 D=64
TOL_INT8 = 2e-2


def _device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _randn(rs, *shape, dev):
    return torch.from_numpy(rs.randn(*shape).astype(np.float32)).to(dev)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, TOL_F32),
                                       (torch.bfloat16, TOL_BF16)])
def test_decode_kernel_matches_plain(dtype, tol):
    dev = _device()
    rs = np.random.RandomState(5)
    S, H, T, D = 4, 2, 100, 64
    q = _randn(rs, S, H, D, dev=dev)
    k = _randn(rs, S, H, T, D, dev=dev).to(dtype)
    v = _randn(rs, S, H, T, D, dev=dev).to(dtype)
    lens = torch.tensor([0, 1, 37, T], dtype=torch.int32, device=dev)
    k[0, :, 1:] = float("nan")   # stale tails must not leak
    v[2, :, 37:] = float("nan")
    n0 = da.launches
    got = da.decode_attention(q, k, v, lens)
    want = da.decode_attention_torch(q, k, v, lens)
    torch.cuda.synchronize()
    assert da.launches == n0 + 1
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= tol
    assert got[0].abs().max().item() == 0.0


def _decode_case(rs, S, H, T, D, dtype, dev, lens, offset=0):
    """q, and K/V caches that start ``offset`` elements into their
    storage (a narrower load width), NaN past every slot's length."""
    q = _randn(rs, S, H, D, dev=dev)
    k, v = (_randn(rs, offset + S * H * T * D, dev=dev).to(dtype)[offset:]
            .view(S, H, T, D) for _ in range(2))
    for s, n in enumerate(lens):
        k[s, :, n:] = float("nan")
        v[s, :, n:] = float("nan")
    return q, k, v, torch.tensor(lens, dtype=torch.int32, device=dev)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, TOL_F32),
                                       (torch.bfloat16, TOL_BF16)])
@pytest.mark.parametrize("D", [1, 3, 16, 36, 64, 128, 160, 256])
def test_decode_split_kernel_head_dims_and_chunk_edges(D, dtype, tol):
    """B1's split kernel at head dims 1..256 (odd, partial lane groups,
    two vectors a lane) with lengths 0, 1, C - 1, C, C + 1, 2C + 1 and
    T around its chunks of C keys (T = 300, not a multiple of C), NaN in
    every stale tail: within tol of plain, finite, the length-0 row
    exactly 0, two calls bit-identical, one launch counted a call."""
    dev = _device()
    rs = np.random.RandomState(60 + D)
    C, T = da.CHUNK_KEYS, 300
    lens = [0, 1, C - 1, C, C + 1, 2 * C + 1, T]
    q, k, v, lens = _decode_case(rs, len(lens), 2, T, D, dtype, dev, lens)
    n0 = da.launches
    got = da.decode_attention(q, k, v, lens)
    again = da.decode_attention(q, k, v, lens)
    want = da.decode_attention_torch(q, k, v, lens)
    torch.cuda.synchronize()
    assert da.launches == n0 + 2
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= tol
    assert got[0].abs().max().item() == 0.0
    assert torch.equal(got, again)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, TOL_F32),
                                       (torch.bfloat16, TOL_BF16)])
@pytest.mark.parametrize("offset", [1, 2, 3])
def test_decode_split_kernel_narrow_loads(offset, dtype, tol):
    """Caches 1-3 elements into their storage take the 8-, 4- or (bf16)
    2-byte loads; D = 64 and D = 6 (a bf16 row of 12 bytes)."""
    dev = _device()
    rs = np.random.RandomState(70 + offset)
    for D in (64, 6):
        q, k, v, lens = _decode_case(rs, 4, 2, 300, D, dtype, dev,
                                     [0, 129, 255, 300], offset=offset)
        assert k.data_ptr() % 16
        got = da.decode_attention(q, k, v, lens)
        want = da.decode_attention_torch(q, k, v, lens)
        torch.cuda.synchronize()
        assert torch.isfinite(got).all()
        assert (got - want).abs().max().item() <= tol


@pytest.mark.parametrize("dtype,tol", [(torch.float32, TOL_F32),
                                       (torch.bfloat16, TOL_BF16)])
def test_decode_split_kernel_long_cache(dtype, tol):
    """Past 8 chunks (T = 3000) each block of a cluster folds several
    chunks: lengths around 8 and 16 chunks of C keys, and T."""
    dev = _device()
    rs = np.random.RandomState(90)
    C = da.CHUNK_KEYS
    lens = [8 * C - 1, 8 * C, 8 * C + 1, 16 * C + 1, 3000]
    q, k, v, lens = _decode_case(rs, len(lens), 2, 3000, 64, dtype, dev, lens)
    got = da.decode_attention(q, k, v, lens)
    want = da.decode_attention_torch(q, k, v, lens)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [16, 64])
def test_decode_split_kernel_slot_bits_independent_of_batch_and_capacity(
        D, dtype):
    """A slot's output bits depend on its q, rows and length only: the
    same alone (S = 1) as among 64 slots, at T_cap 1024 and 2048."""
    dev = _device()
    rs = np.random.RandomState(80 + D)
    S, H = 64, 2
    q = _randn(rs, S, H, D, dev=dev)
    k, v = (_randn(rs, S, H, 2048, D, dev=dev).to(dtype) for _ in range(2))
    lens = rs.randint(1, 1025, S).astype(np.int32)
    lens[:4] = [0, 1, da.CHUNK_KEYS + 1, 1024]
    lens = torch.from_numpy(lens).to(dev)
    wide = da.decode_attention(q, k, v, lens)
    k1, v1 = (x[:, :, :1024].contiguous() for x in (k, v))
    narrow = da.decode_attention(q, k1, v1, lens)
    for s in (0, 1, 2, 3, 17, 63):
        alone = da.decode_attention(q[s:s + 1].contiguous(),
                                    k1[s:s + 1].contiguous(),
                                    v1[s:s + 1].contiguous(),
                                    lens[s:s + 1].contiguous())
        assert torch.equal(alone[0], narrow[s])
    torch.cuda.synchronize()
    assert torch.equal(wide, narrow)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_info_reports_the_split_kernel(dtype):
    """16-byte loads where the row allows them, chunks of CHUNK_KEYS
    keys, no spills, at least one block per SM."""
    _device()
    for D in (16, 64, 128, 160, 256):
        info = da.decode_kernel_info(D, dtype)
        assert info["chunk_keys"] == da.CHUNK_KEYS
        assert info["load_bytes"] == 16
        assert info["local_bytes"] == 0
        assert info["blocks_per_sm"] >= 1 and info["registers"] > 0
        assert info["cluster_blocks"] == 8


def test_decode_split_kernel_refuses_what_it_does_not_take():
    dev = _device()
    lens = torch.ones(2, dtype=torch.int32, device=dev)
    q = torch.zeros((2, 2, 257), device=dev)
    k = torch.zeros((2, 2, 8, 257), device=dev)
    with pytest.raises(ValueError):
        da.decode_attention(q, k, k, lens)
    h = torch.zeros((2, 2, 8, 16), dtype=torch.float16, device=dev)
    with pytest.raises(TypeError):
        da.decode_attention(q[..., :16].contiguous(), h, h, lens)


@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("T", [8, 100, 257])
def test_flash_kernel_matches_plain(D, T):
    dev = _device()
    rs = np.random.RandomState(T + D)
    q, k, v = (_randn(rs, 2, T, 2, D, dev=dev) for _ in range(3))
    km = torch.ones((2, T), device=dev)
    km[1, 2 * T // 3:] = 0.0
    n0 = fa.launches
    out, lse = fa.flash_attention(q, k, v, causal=True, key_mask=km)
    ref, lref = fa.flash_attention_torch(q, k, v, causal=True, key_mask=km)
    torch.cuda.synchronize()
    assert fa.launches == n0 + 1
    assert (out - ref).abs().max().item() <= TOL_F32
    assert (lse - lref).abs().max().item() <= TOL_F32


@pytest.mark.parametrize("key_groups", [1, 2])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("D", [12, 64])
@pytest.mark.parametrize("T", [8, 100, 257])
def test_flash_forward_kernel_cases(T, D, causal, key_groups):
    """The 3xTF32 forward (B3) with either key-group count, causal or
    not, at D=12 (a head dim under the 32 bucket: zero-padded fragments)
    and D=64, a ragged key mask and a batch row whose keys are all
    masked (O exactly 0, LSE exactly -1e30); two calls agree bit for
    bit."""
    dev = _device()
    rs = np.random.RandomState(5 * T + D + causal)
    q, k, v = (_randn(rs, 3, T, 2, D, dev=dev) for _ in range(3))
    km = torch.ones((3, T), device=dev)
    km[1, 2 * T // 3:] = 0.0
    km[2] = 0.0
    got = fa._flash_attention_cuda(q, k, v, causal, km, key_groups)
    again = fa._flash_attention_cuda(q, k, v, causal, km, key_groups)
    ref, lref = fa.flash_attention_torch(q, k, v, causal=causal, key_mask=km)
    torch.cuda.synchronize()
    out, lse = got
    assert torch.isfinite(out).all()
    assert (out - ref).abs().max().item() <= TOL_F32
    assert (lse - lref).abs().max().item() <= TOL_F32
    assert out[2].abs().max().item() == 0.0
    assert bool((lse[2] == -1e30).all())
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_flash_forward_kernel_takes_the_4_byte_copy_path():
    """A view that starts 4 bytes into its storage is not 16-byte
    aligned, so the kernel copies 4 bytes at a time; D=5 (not a
    multiple of 4) takes the same path."""
    dev = _device()
    rs = np.random.RandomState(13)
    for D in (64, 5):
        flat = _randn(rs, 3, 1 + 2 * 100 * 2 * D, dev=dev)
        q, k, v = (x[1:].view(2, 100, 2, D) for x in flat)
        assert q.data_ptr() % 16 or D % 4
        out, lse = fa.flash_attention(q, k, v, True, None)
        ref, lref = fa.flash_attention_torch(q, k, v, True, None)
        torch.cuda.synchronize()
        assert (out - ref).abs().max().item() <= TOL_F32
        assert (lse - lref).abs().max().item() <= TOL_F32


def _paged_case(rs, dtype, dev, S=6, H=2, Bs=16, D=64, N=64, B=8):
    """Pools with NaN in the null block and in every sequence's stale
    tail; each table is a random set of distinct blocks, NULL-padded
    past the length."""
    q = _randn(rs, S, H, D, dev=dev)
    k = _randn(rs, N, H, Bs, D, dev=dev).to(dtype)
    v = _randn(rs, N, H, Bs, D, dev=dev).to(dtype)
    lens = np.array([0, 1, 15, 16, 17, B * Bs], np.int32)[:S]
    perm = rs.permutation(np.arange(1, N))
    tbl = np.zeros((S, B), np.int32)
    used = 0
    for s, n in enumerate(lens):
        nb = -(-int(n) // Bs)
        tbl[s, :nb] = perm[used:used + nb]
        used += nb
        if n % Bs:   # the stale tail of the last live block
            k[tbl[s, nb - 1], :, n % Bs:] = float("nan")
            v[tbl[s, nb - 1], :, n % Bs:] = float("nan")
    k[0] = float("nan")
    v[0] = float("nan")
    return (q, k, v, torch.from_numpy(tbl).to(dev),
            torch.from_numpy(lens).to(dev))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, TOL_F32),
                                       (torch.bfloat16, TOL_BF16)])
def test_paged_kernel_matches_plain(dtype, tol):
    dev = _device()
    q, k, v, tbl, lens = _paged_case(np.random.RandomState(6), dtype, dev)
    n0 = pa.launches
    got = pa.paged_attention(q, k, v, tbl, lens)
    want = pa.paged_attention_torch(q, k, v, tbl, lens)
    torch.cuda.synchronize()
    assert pa.launches == n0 + 1
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= tol
    assert got[0].abs().max().item() == 0.0


def test_paged_kernel_matches_slot_kernel_on_gathered_panel():
    dev = _device()
    q, k, v, tbl, lens = _paged_case(np.random.RandomState(7),
                                     torch.float32, dev)
    got = pa.paged_attention(q, k, v, tbl, lens)
    dense = da.decode_attention(q, pa.gather_blocks(k, tbl).contiguous(),
                                pa.gather_blocks(v, tbl).contiguous(), lens)
    torch.cuda.synchronize()
    assert (got - dense).abs().max().item() <= TOL_F32


def test_cuda_tensor_the_kernel_does_not_take_raises():
    dev = _device()
    q = torch.zeros((2, 2, 8), device=dev)
    k = torch.zeros((2, 2, 16, 8), device=dev)
    with pytest.raises(TypeError):
        da.decode_attention(q, k, k, torch.ones(2, dtype=torch.int64,
                                                device=dev))
    with pytest.raises(ValueError):
        da.decode_attention(q, k.transpose(2, 3), k,
                            torch.ones(2, dtype=torch.int32, device=dev))
    x = torch.zeros((1, 8, 2, 8), dtype=torch.float64, device=dev)
    with pytest.raises(TypeError):
        fa.flash_attention(x, x, x)
    pool = torch.zeros((4, 2, 16, 8), device=dev)
    tbl = torch.zeros((2, 3), dtype=torch.int32, device=dev)
    lens32 = torch.ones(2, dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        pa.paged_attention(q, pool, pool, tbl.long(), lens32)
    with pytest.raises(ValueError):
        pa.paged_attention(q, pool, pool, tbl.t(), lens32)


def _quantized(rs, *shape, dev):
    return kvq.quantize_rows(_randn(rs, *shape, dev=dev))


@pytest.mark.parametrize("S,H,T,D", [(4, 2, 100, 64), (4, 2, 100, 128),
                                     (4, 3, 57, 12), (4, 2, 40, 8),
                                     (32, 8, 1024, 64)])
def test_int8_decode_kernel_matches_plain(S, H, T, D):
    """Ragged lengths (0, 1, 37 and T among them), NaN in the scales of
    every stale tail, head dims whose lane groups are partly idle."""
    dev = _device()
    rs = np.random.RandomState(S + T + D)
    q = _randn(rs, S, H, D, dev=dev)
    k = _quantized(rs, S, H, T, D, dev=dev)
    v = _quantized(rs, S, H, T, D, dev=dev)
    lens = rs.randint(1, T + 1, S).astype(np.int32)
    lens[:4] = [0, 1, min(37, T), T]
    for s, n in enumerate(lens):
        k.scale[s, :, n:] = float("nan")
        v.scale[s, :, n:] = float("nan")
    lens = torch.from_numpy(lens).to(dev)
    n0, f0 = da.launches_int8, da.launches
    got = da.decode_attention(q, k, v, lens)
    want = da.decode_attention_torch(q, k, v, lens)
    torch.cuda.synchronize()
    assert (da.launches_int8, da.launches) == (n0 + 1, f0)
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= TOL_INT8
    assert got[0].abs().max().item() == 0.0


@pytest.mark.parametrize("D", [12, 32, 64, 128])
def test_int8_decode_kernel_edges_and_repeatable(D):
    """The int8 decode kernel (B4) at every load width (16 bytes at
    D = 32, 64, 128; 4 at D = 12) with lengths at and around its tile
    edges (0, 1, 15, 16, 17, T), NaN in every stale tail's scales and
    a length-0 row: within TOL_INT8 of plain, finite, the length-0 row
    exactly 0, and two calls bit-identical."""
    dev = _device()
    rs = np.random.RandomState(40 + D)
    S, H, T = 6, 3, 100
    q = _randn(rs, S, H, D, dev=dev)
    k = _quantized(rs, S, H, T, D, dev=dev)
    v = _quantized(rs, S, H, T, D, dev=dev)
    lens = np.array([0, 1, 15, 16, 17, T], np.int32)
    for s, n in enumerate(lens):
        k.scale[s, :, n:] = float("nan")
        v.scale[s, :, n:] = float("nan")
    lens = torch.from_numpy(lens).to(dev)
    got = da.decode_attention(q, k, v, lens)
    again = da.decode_attention(q, k, v, lens)
    want = da.decode_attention_torch(q, k, v, lens)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= TOL_INT8
    assert got[0].abs().max().item() == 0.0
    assert torch.equal(got, again)


def _int8_paged_case(rs, dev, S=6, H=2, Bs=16, D=64, N=64, B=8):
    """int8 pools with NaN in the null block's scales and in every
    sequence's stale tail's scales; each table a random set of distinct
    blocks (non-contiguous, in no order), NULL-padded past the
    length."""
    q = _randn(rs, S, H, D, dev=dev)
    k = _quantized(rs, N, H, Bs, D, dev=dev)
    v = _quantized(rs, N, H, Bs, D, dev=dev)
    lens = rs.randint(1, B * Bs + 1, S).astype(np.int32)
    lens[:6] = [0, 1, 15, 16, 17, B * Bs]
    perm = rs.permutation(np.arange(1, N))
    tbl = np.zeros((S, B), np.int32)
    used = 0
    for s, n in enumerate(lens):
        nb = -(-int(n) // Bs)
        tbl[s, :nb] = perm[used:used + nb]
        used += nb
        if n % Bs:
            k.scale[tbl[s, nb - 1], :, n % Bs:] = float("nan")
            v.scale[tbl[s, nb - 1], :, n % Bs:] = float("nan")
    k.scale[0] = float("nan")
    v.scale[0] = float("nan")
    return (q, k, v, torch.from_numpy(tbl).to(dev),
            torch.from_numpy(lens).to(dev))


@pytest.mark.parametrize("shape", [dict(), dict(Bs=8, D=32),
                                   dict(H=3, Bs=5, D=12),
                                   dict(S=64, H=8, N=4096, B=64)])
def test_int8_paged_kernel_matches_plain(shape):
    dev = _device()
    q, k, v, tbl, lens = _int8_paged_case(np.random.RandomState(8), dev,
                                          **shape)
    n0, f0 = pa.launches_int8, pa.launches
    got = pa.paged_attention(q, k, v, tbl, lens)
    want = pa.paged_attention_torch(q, k, v, tbl, lens)
    torch.cuda.synchronize()
    assert (pa.launches_int8, pa.launches) == (n0 + 1, f0)
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= TOL_INT8
    assert got[0].abs().max().item() == 0.0


@pytest.mark.parametrize("D", [12, 32, 64, 128])
@pytest.mark.parametrize("Bs", [8, 16, 32])
def test_int8_paged_kernel_block_and_head_sizes(Bs, D):
    """The redesigned int8 paged kernel (B5) at every load width (16
    bytes at D = 32, 64, 128; 4 at D = 12) and at blocks shorter than,
    equal to and longer than its tile, against the plain version; NaN
    in the null block's and every stale tail's scales; two calls agree
    bit for bit."""
    dev = _device()
    q, k, v, tbl, lens = _int8_paged_case(np.random.RandomState(Bs + D), dev,
                                          Bs=Bs, D=D)
    got = pa.paged_attention(q, k, v, tbl, lens)
    again = pa.paged_attention(q, k, v, tbl, lens)
    want = pa.paged_attention_torch(q, k, v, tbl, lens)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= TOL_INT8
    assert got[0].abs().max().item() == 0.0
    assert torch.equal(got, again)


def test_int8_paged_kernel_matches_int8_slot_kernel_on_gathered_panel():
    """Blocks of 16 at D=64 are the slot kernel's tiles, so both fold
    the same keys in the same order: only the table indirection
    differs."""
    dev = _device()
    q, k, v, tbl, lens = _int8_paged_case(np.random.RandomState(9), dev)
    got = pa.paged_attention(q, k, v, tbl, lens)
    gk, gv = pa.gather_blocks(k, tbl), pa.gather_blocks(v, tbl)
    dense = da.decode_attention(
        q, kvq.QuantArray(gk.q.contiguous(), gk.scale.contiguous()),
        kvq.QuantArray(gv.q.contiguous(), gv.scale.contiguous()), lens)
    torch.cuda.synchronize()
    assert (got - dense).abs().max().item() <= TOL_F32


@pytest.mark.parametrize("D,Bs", [(32, 32), (128, 8)])
def test_int8_paged_and_slot_kernels_agree_where_a_block_is_a_tile(D, Bs):
    """Both int8 kernels fold through one layout (int8_attention.cuh):
    where a pool block is one tile (kTile = 8 * 32 / G rows: 32 at
    D = 32, 8 at D = 128) the paged kernel folds the gathered panel's
    rows as the slot kernel does, so only f32 rounding may differ."""
    dev = _device()
    q, k, v, tbl, lens = _int8_paged_case(np.random.RandomState(D), dev,
                                          Bs=Bs, D=D)
    got = pa.paged_attention(q, k, v, tbl, lens)
    gk, gv = pa.gather_blocks(k, tbl), pa.gather_blocks(v, tbl)
    dense = da.decode_attention(
        q, kvq.QuantArray(gk.q.contiguous(), gk.scale.contiguous()),
        kvq.QuantArray(gv.q.contiguous(), gv.scale.contiguous()), lens)
    torch.cuda.synchronize()
    assert (got - dense).abs().max().item() <= TOL_F32


def test_int8_tensors_the_kernels_do_not_take_raise():
    dev = _device()
    rs = np.random.RandomState(10)
    q = _randn(rs, 2, 2, 8, dev=dev)
    k = _quantized(rs, 2, 2, 16, 8, dev=dev)
    lens = torch.ones(2, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="quantized together"):
        da.decode_attention(q, k, kvq.dequantize(k), lens)
    with pytest.raises(TypeError):   # values without their scales
        da.decode_attention(q, k.q, k.q, lens)
    bad = kvq.QuantArray(k.q, k.scale.double())
    with pytest.raises(TypeError):
        da.decode_attention(q, bad, bad, lens)
    odd = _quantized(rs, 2, 2, 16, 6, dev=dev)
    with pytest.raises(ValueError, match="multiples of 4"):
        da.decode_attention(_randn(rs, 2, 2, 6, dev=dev), odd, odd, lens)
    pool = _quantized(rs, 4, 2, 16, 8, dev=dev)
    tbl = torch.zeros((2, 3), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="quantized together"):
        pa.paged_attention(q, pool, kvq.dequantize(pool), tbl, lens)
    with pytest.raises(TypeError):
        pa.paged_attention(q, pool, pool, tbl.long(), lens)
    strided = kvq.QuantArray(pool.q, pool.scale.transpose(1, 2))
    with pytest.raises(ValueError):
        pa.paged_attention(q, strided, strided, tbl, lens)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("T", [8, 100, 257])
def test_flash_backward_kernels_match_plain(T, D, causal):
    """dQ (B6) and dK/dV (B7) against the plain backward, with a ragged
    key mask and a batch row whose keys are all masked."""
    dev = _device()
    rs = np.random.RandomState(3 * T + D + causal)
    q, k, v, g = (_randn(rs, 3, T, 2, D, dev=dev) for _ in range(4))
    km = torch.ones((3, T), device=dev)
    km[1, 2 * T // 3:] = 0.0
    km[2] = 0.0
    out, lse = fa.flash_attention(q, k, v, causal=causal, key_mask=km)
    n = (fa.launches_dq, fa.launches_dkv)
    got = fa.flash_attention_bwd(q, k, v, km, out, lse, g, causal)
    want = fa.flash_attention_bwd_torch(q, k, v, km, out, lse, g, causal)
    torch.cuda.synchronize()
    assert (fa.launches_dq, fa.launches_dkv) == (n[0] + 1, n[1] + 1)
    for a, b in zip(got, want):
        assert torch.isfinite(a).all()
        assert (a - b).abs().max().item() <= TOL_F32
        assert a[2].abs().max().item() == 0.0   # the fully masked row


def _bwd_inputs(rs, B, T, H, D, dev, causal, km):
    q, k, v, g = (_randn(rs, B, T, H, D, dev=dev) for _ in range(4))
    out, lse = fa.flash_attention(q, k, v, causal=causal, key_mask=km)
    return q, k, v, km, g, lse, fa.backward_delta(g, out)


def _bwd_kernels(q, k, v, km, g, lse, delta, causal):
    return (fa.flash_attention_bwd_dq(q, k, v, km, g, lse, delta, causal),
            *fa.flash_attention_bwd_dkv(q, k, v, km, g, lse, delta, causal))


@pytest.mark.parametrize("D", [32, 64, 128])
def test_flash_backward_kernels_are_deterministic(D):
    """Every dQ, dK and dV row has one owner block that sums in a fixed
    order (no atomics): two calls on the same inputs agree bit for
    bit."""
    dev = _device()
    km = torch.ones((3, 257), device=dev)
    km[1, 100:] = 0.0
    args = _bwd_inputs(np.random.RandomState(D), 3, 257, 2, D, dev, True, km)
    first = _bwd_kernels(*args, True)
    second = _bwd_kernels(*args, True)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_flash_backward_kernels_at_the_training_shape():
    """B=4, H=8, T=1024, D=64, causal, every key live: the shape the
    training path (chip_smoke.py phase 9) gives the kernels. Tolerance:
    1e-4 of the largest gradient (at least 1), chip_smoke.py's
    FLASH_BWD_TOL: f32-accurate products over up to 1024 keys summed in
    another order, and dp = dO.V over D=64 has std 8, so gradients reach
    ~10 here."""
    dev = _device()
    km = torch.ones((4, 1024), device=dev)
    q, k, v, km, g, lse, delta = _bwd_inputs(np.random.RandomState(1024), 4,
                                             1024, 8, 64, dev, True, km)
    got = _bwd_kernels(q, k, v, km, g, lse, delta, True)
    want = (fa.flash_attention_bwd_dq_torch(q, k, v, km, g, lse, delta, True),
            *fa.flash_attention_bwd_dkv_torch(q, k, v, km, g, lse, delta,
                                              True))
    torch.cuda.synchronize()
    scale = max(max(w.abs().max().item() for w in want), 1.0)
    for a, b in zip(got, want):
        assert torch.isfinite(a).all()
        assert (a - b).abs().max().item() <= TOL_F32 * scale


def test_flash_autograd_function_on_the_card():
    """Gradients of the Function on the card equal those of the same
    Function on a CPU copy (plain versions), and each kernel ran once."""
    dev = _device()
    rs = np.random.RandomState(11)
    host = [torch.from_numpy(rs.randn(2, 130, 4, 64).astype(np.float32))
            for _ in range(4)]
    km = torch.ones((2, 130))
    km[0, 90:] = 0.0
    grads = {}
    for where in ("cpu", dev):
        q, k, v = (x.detach().to(where).requires_grad_(True)
                   for x in host[:3])
        n = (fa.launches, fa.launches_dq, fa.launches_dkv)
        out = fa.flash_attention_autograd(q, k, v, True, km.to(where))
        out.backward(host[3].to(where).transpose(1, 2).contiguous()
                     .transpose(1, 2))   # a strided cotangent
        ran = tuple(a - b for a, b in zip(
            (fa.launches, fa.launches_dq, fa.launches_dkv), n))
        assert ran == ((0, 0, 0) if where == "cpu" else (1, 1, 1))
        grads[str(where)] = [t.grad.cpu() for t in (q, k, v)]
    for a, b in zip(grads["cpu"], grads[str(dev)]):
        assert (a - b).abs().max().item() <= TOL_F32


def test_flash_backward_refuses_what_it_does_not_take():
    dev = _device()
    x = torch.zeros((1, 8, 2, 8), device=dev)
    lse = torch.zeros((1, 2, 8), device=dev)
    delta = torch.zeros((1, 2, 8), device=dev)
    # mixed dtypes (f32 q with a bf16 g) and fp16 operands (not ported)
    with pytest.raises(TypeError, match="one dtype"):
        fa.flash_attention_bwd(x, x, x, None, x, lse, x.bfloat16())
    h = x.half()
    with pytest.raises(TypeError, match="B8"):
        fa.flash_attention_bwd_dq(h, h, h, None, h, lse, delta)
    with pytest.raises(TypeError, match="B8"):
        fa.flash_attention_bwd_dkv(h, h, h, None, h, lse, delta)
    with pytest.raises(ValueError):
        fa.flash_attention_bwd(x, x, x, None, x, lse,
                               x.transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(ValueError):
        fa.flash_attention_bwd(x, x, x, None, x, lse.transpose(1, 2), x)
    wide = torch.zeros((1, 8, 1, 160), device=dev)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention_bwd(wide, wide, wide, None, wide,
                               torch.zeros((1, 1, 8), device=dev), wide)


@pytest.mark.parametrize("dtype", ["float", "bfloat16"])
def test_network_step_on_the_card_matches_the_cpu(dtype):
    """One loss and gradient of a small causal LM through
    MultiLayerNetwork on the card (flash kernels) against a CPU copy
    (plain attention). f32: loss within 1e-4 relative, each gradient
    leaf within 1e-3 of its max-norm. bf16 policy (the bf16 legs, bf16
    cuBLAS GEMMs; the CPU copy in bf16 too, rounding at other places in
    another order): 1e-2 and 3e-2, and the f32 legs never launch.
    Gradients reach the f32 masters as f32 either way."""
    from deeplearning4j_tpu_torch.learning import Adam
    from deeplearning4j_tpu_torch.nn import (MultiLayerNetwork,
                                             NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.layers.attention import \
        TransformerEncoderLayer
    from deeplearning4j_tpu_torch.nn.layers.recurrent import (
        EmbeddingSequenceLayer, RnnOutputLayer)
    dev = _device()
    bf16 = dtype == "bfloat16"
    loss_tol, grad_tol = (1e-2, 3e-2) if bf16 else (1e-4, 1e-3)

    def conf():
        return (NeuralNetConfiguration.builder().seed(0).updater(Adam(1e-3))
                .data_type(dtype).list()
                .layer(EmbeddingSequenceLayer(n_in=50, n_out=64))
                .layer(TransformerEncoderLayer(n_heads=2, causal=True))
                .layer(TransformerEncoderLayer(n_heads=2, causal=True))
                .layer(RnnOutputLayer(n_out=50))
                .input_type_recurrent(1, timesteps=96).build())
    card = MultiLayerNetwork(conf()).init()
    cpu = MultiLayerNetwork(conf(), device="cpu").init()
    cpu.set_params({k: {n: t.cpu() for n, t in p.items()}
                    for k, p in card.params().items()})
    rs = np.random.RandomState(2)
    x = rs.randint(0, 50, (3, 96))
    y = np.eye(50, dtype=np.float32)[(3 * x + 1) % 50]
    # a ragged row; under the bf16 policy the f32 mask would promote
    # the layers after the first attention to f32, so no mask there
    m = None
    if not bf16:
        m = np.ones((3, 96), np.float32)
        m[1, 60:] = 0.0
    names = ("launches", "launches_dq", "launches_dkv", "launches_bf16",
             "launches_dq_bf16", "launches_dkv_bf16")
    n = [getattr(fa, c) for c in names]
    loss, grads = card.loss_and_gradients(x, y, m)
    ran = tuple(getattr(fa, c) - b for c, b in zip(names, n))
    assert ran == ((0, 0, 0, 2, 2, 2) if bf16 else (2, 2, 2, 0, 0, 0))
    ref_loss, ref = cpu.loss_and_gradients(x, y, m)
    assert abs(float(loss) - float(ref_loss)) <= \
        loss_tol * abs(float(ref_loss))
    for key, p in ref.items():
        for name, t in p.items():
            got = grads[key][name]
            assert got.dtype == torch.float32
            err = (got.cpu() - t).abs().max().item()
            assert err <= grad_tol * max(t.abs().max().item(), 1e-12), \
                f"{key}.{name}"


# -- the bf16 legs of B3, B6 and B7 -------------------------------------
# bf16 legs against their plain versions (f32 from the same bf16
# values): P and dS are rounded to bf16 before the second products, and
# both sides round O, dQ, dK and dV to bf16 once (one ulp is up to 2^-7
# of the largest value), so O within 1e-2 x max(1, max|O|), each
# gradient within 2e-2 x max(1, its max); the LSE is f32 on both sides
TOL_BF16_O = 1e-2
TOL_BF16_GRAD = 2e-2
TOL_BF16_LSE = 1e-5


def _bf16_case(rs, B, T, H, D, dev):
    q, k, v, g = (_randn(rs, B, T, H, D, dev=dev).bfloat16()
                  for _ in range(4))
    km = torch.ones((B, T), device=dev)
    km[0, (2 * T) // 3:] = 0.0   # a ragged row
    km[-1] = 0.0                 # every key masked
    return q, k, v, g, km


def _scaled_err(got, want):
    """max |got - want| over max(1, max |want|)."""
    got, want = got.float(), want.float()
    return ((got - want).abs().max() /
            max(want.abs().max().item(), 1.0)).item()


#: (H, D) of the bf16 cases: each head-dim bucket, D = 40 (not a power
#: of two: TMA zero-fills the columns past D), and H = 1, D = 36, whose
#: 72-byte row stride TMA cannot take (the producer warp of each bf16
#: leg fills the same swizzled tiles itself)
BF16_HEADS = [(2, 32), (2, 40), (2, 64), (2, 128), (1, 36)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("H,D", BF16_HEADS)
@pytest.mark.parametrize("T", [8, 100, 129, 257, 1024])
def test_bf16_legs_match_plain(T, H, D, causal):
    """The three bf16 legs against their plain versions: a ragged key
    mask, a batch row whose keys are all masked (O 0, LSE -1e30,
    gradients exactly 0), T not a multiple of 64 (129 straddles a
    128-row query block by one row) and T = 1024 (eight blocks, the
    causal diagonal in every one); each leg counts its own launch and
    the f32 legs' counters stay."""
    dev = _device()
    rs = np.random.RandomState(7 * T + D + causal)
    q, k, v, g, km = _bf16_case(rs, 3, T, H, D, dev)
    f32 = (fa.launches, fa.launches_dq, fa.launches_dkv)
    n = (fa.launches_bf16, fa.launches_dq_bf16, fa.launches_dkv_bf16)
    out, lse = fa.flash_attention(q, k, v, causal, km)
    ro, rl = fa.flash_attention_torch(q, k, v, causal, km)
    delta = fa.backward_delta(g, ro)
    got = (fa.flash_attention_bwd_dq(q, k, v, km, g, rl, delta, causal),
           *fa.flash_attention_bwd_dkv(q, k, v, km, g, rl, delta, causal))
    want = (fa.flash_attention_bwd_dq_torch(q, k, v, km, g, rl, delta,
                                            causal),
            *fa.flash_attention_bwd_dkv_torch(q, k, v, km, g, rl, delta,
                                              causal))
    torch.cuda.synchronize()
    assert (fa.launches_bf16, fa.launches_dq_bf16, fa.launches_dkv_bf16) \
        == (n[0] + 1, n[1] + 1, n[2] + 1)
    assert (fa.launches, fa.launches_dq, fa.launches_dkv) == f32
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    assert _scaled_err(out, ro) <= TOL_BF16_O
    assert (lse - rl).abs().max().item() <= TOL_BF16_LSE
    assert out[2].abs().max().item() == 0.0 and bool((lse[2] == -1e30).all())
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16 and bool(torch.isfinite(a).all())
        assert _scaled_err(a, b) <= TOL_BF16_GRAD
        assert a[2].abs().max().item() == 0.0


@pytest.mark.parametrize("H,D", BF16_HEADS)
def test_bf16_legs_are_deterministic(H, D):
    """One owner block per output row, no atomics: two calls of each
    bf16 leg give the same bits, on the TMA path and on the producer's
    own fill (H = 1, D = 36)."""
    dev = _device()
    q, k, v, g, km = _bf16_case(np.random.RandomState(D), 3, 257, H, D, dev)
    first = fa.flash_attention(q, k, v, True, km)
    assert all(torch.equal(a, b) for a, b in
               zip(first, fa.flash_attention(q, k, v, True, km)))
    args = (q, k, v, km, g, first[1], fa.backward_delta(g, first[0]))
    a = _bwd_kernels(*args, True)
    b = _bwd_kernels(*args, True)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_bf16_legs_at_the_training_shape():
    """B=4, H=8, T=1024, D=64, causal, every key live: the bf16 training
    path's shape (chip_smoke.py phase 10)."""
    dev = _device()
    rs = np.random.RandomState(2048)
    q, k, v, g = (_randn(rs, 4, 1024, 8, 64, dev=dev).bfloat16()
                  for _ in range(4))
    km = torch.ones((4, 1024), device=dev)
    out, lse = fa.flash_attention(q, k, v, True, km)
    ro, rl = fa.flash_attention_torch(q, k, v, True, km)
    delta = fa.backward_delta(g, ro)
    got = _bwd_kernels(q, k, v, km, g, rl, delta, True)
    want = (fa.flash_attention_bwd_dq_torch(q, k, v, km, g, rl, delta, True),
            *fa.flash_attention_bwd_dkv_torch(q, k, v, km, g, rl, delta,
                                              True))
    torch.cuda.synchronize()
    assert _scaled_err(out, ro) <= TOL_BF16_O
    assert (lse - rl).abs().max().item() <= TOL_BF16_LSE
    for a, b in zip(got, want):
        assert _scaled_err(a, b) <= TOL_BF16_GRAD


def test_bf16_backward_at_t2048_with_a_ragged_key_mask():
    """The dQ and dK/dV pair against plain at T = 2048 (32 query and 32
    key tiles of 64, 16 blocks of 128 rows a head), causal, with a key
    mask that cuts each batch row at another place (mid-tile and on a
    tile edge) and one row with every key masked."""
    dev = _device()
    rs = np.random.RandomState(2049)
    B, T, H, D = 3, 2048, 2, 64
    q, k, v, g = (_randn(rs, B, T, H, D, dev=dev).bfloat16()
                  for _ in range(4))
    km = torch.ones((B, T), device=dev)
    km[0, 1333:] = 0.0
    km[1, 1024:] = 0.0
    km[2] = 0.0
    ro, rl = fa.flash_attention_torch(q, k, v, True, km)
    delta = fa.backward_delta(g, ro)
    got = _bwd_kernels(q, k, v, km, g, rl, delta, True)
    want = (fa.flash_attention_bwd_dq_torch(q, k, v, km, g, rl, delta, True),
            *fa.flash_attention_bwd_dkv_torch(q, k, v, km, g, rl, delta,
                                              True))
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16 and bool(torch.isfinite(a).all())
        assert _scaled_err(a, b) <= TOL_BF16_GRAD
        assert a[2].abs().max().item() == 0.0
    for masked_key_rows in (got[1][0, 1333:], got[2][0, 1333:]):  # dK, dV
        assert masked_key_rows.abs().max().item() == 0.0


def test_bf16_kernel_info_reports_the_launched_block():
    """bf16_kernel_info reports each leg's real block: 384 threads (two
    consumer warpgroups and a producer) for the forward, dQ and dK/dV,
    at least one resident block per SM, and registers that fit the
    register file for that block."""
    _device()
    for D in (32, 64, 128):
        info = fa.bf16_kernel_info(D)
        assert info["fwd"]["threads"] == info["dq"]["threads"] \
            == info["dkv"]["threads"] == 384
        for leg in info.values():
            assert leg["blocks_per_sm"] >= 1
            assert (leg["registers"] * leg["threads"] * leg["blocks_per_sm"]
                    <= 65536)


def test_bf16_autograd_function_on_the_card():
    """bf16 leaves through the Function on the card get bf16 gradients
    that match the same Function on a CPU copy (plain versions), and
    each bf16 leg ran once."""
    dev = _device()
    rs = np.random.RandomState(12)
    host = [torch.from_numpy(rs.randn(2, 130, 4, 64).astype(np.float32))
            .bfloat16() for _ in range(4)]
    km = torch.ones((2, 130))
    km[0, 90:] = 0.0
    grads = {}
    for where in ("cpu", dev):
        q, k, v = (x.detach().to(where).requires_grad_(True)
                   for x in host[:3])
        n = (fa.launches_bf16, fa.launches_dq_bf16, fa.launches_dkv_bf16)
        out = fa.flash_attention_autograd(q, k, v, True, km.to(where))
        assert out.dtype == torch.bfloat16
        out.backward(host[3].to(where))
        ran = tuple(a - b for a, b in zip(
            (fa.launches_bf16, fa.launches_dq_bf16, fa.launches_dkv_bf16),
            n))
        assert ran == ((0, 0, 0) if where == "cpu" else (1, 1, 1))
        grads[str(where)] = [t.grad.cpu() for t in (q, k, v)]
    for a, b in zip(grads[str(dev)], grads["cpu"]):
        assert a.dtype == torch.bfloat16
        assert _scaled_err(a, b) <= TOL_BF16_GRAD


def test_bf16_cuda_operands_the_legs_do_not_take_raise():
    """fp16 operands, mixed dtypes and D > 128 raise on the card; no
    bf16 CUDA tensor reaches a plain version."""
    dev = _device()
    x = torch.zeros((1, 8, 2, 8), device=dev, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="B8"):
        fa.flash_attention(x.half(), x.half(), x.half())
    with pytest.raises(TypeError, match="one dtype"):
        fa.flash_attention(x, x.float(), x)
    wide = torch.zeros((1, 8, 1, 160), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(wide, wide, wide)
    lse = torch.zeros((1, 1, 8), device=dev)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention_bwd(wide, wide, wide, None, wide, lse, wide)
    with pytest.raises(ValueError, match="out must be"):
        fa.flash_attention_bwd(x, x, x, None, x.float(),
                               torch.zeros((1, 2, 8), device=dev), x)


#: the engine tests' model: head dim 32, so the int8 kernels take
#: 16-byte loads
LM_CFG = dict(vocab_size=512, d_model=64, n_layers=2, n_heads=2,
              max_seq_len=64, seed=0)


def _serve_all(eng, reqs):
    """Every request at once, from its own thread; their tokens."""
    import threading
    out = [None] * len(reqs)

    def go(i):
        out[i] = eng.generate(timeout_ms=120_000, **reqs[i])["tokens"]

    threads = [threading.Thread(target=go, args=(i,))
               for i in range(len(reqs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    return out


def _counting_calls(eng):
    """Count the engine's per-bucket device calls by key (its decode
    steps count in ``metrics.decode_steps``)."""
    calls = {}
    call = eng._device_call

    def counted(key, *a, **k):
        calls[key] = calls.get(key, 0) + 1
        return call(key, *a, **k)
    eng._device_call = counted
    return calls


@pytest.mark.parametrize("kv_dtype", ["f32", "int8"])
@pytest.mark.parametrize("cache", ["slots", "paged"])
def test_decode_step_graph_replay_matches_eager(cache, kv_dtype):
    """The engine's graphs captured at warmup (the decode step and every
    bucket of graph_plan: prefill or chunk, copy-on-write) and replayed
    (the card's default) give the eager engine's tokens, greedy and
    sampled, with more requests than slots; so does an engine never
    warmed, which captures the decode step after its first (eager) step
    and each bucket at its second call. Nothing else is captured, and
    each step counts its attention kernel once per layer, replays
    included."""
    from deeplearning4j_tpu_torch import kernels
    from deeplearning4j_tpu_torch.serving import GenerationEngine
    from deeplearning4j_tpu_torch.zoo.transformer_lm import \
        CausalTransformerLM
    dev = _device()
    lm = CausalTransformerLM(**LM_CFG, device=dev).init()
    rs = np.random.RandomState(3)
    reqs = [dict(prompt=rs.randint(0, 512, rs.randint(1, 40)).tolist(),
                 max_tokens=int(rs.randint(4, 20)),
                 temperature=0.8 if i % 3 == 2 else 0.0,
                 top_k=16 if i % 2 else 0, seed=i) for i in range(12)]
    kw = dict(num_slots=4, min_prompt_bucket=8, kv_dtype=kv_dtype)
    if cache == "paged":
        kw.update(cache="paged", block_size=16, prefill_chunk_tokens=16)
    counter = (f"{'paged' if cache == 'paged' else 'decode'}_attention."
               f"launches{'_int8' if kv_dtype == 'int8' else ''}")
    tokens = {}
    for mode in ("graph", "eager", "lazy"):
        eng = GenerationEngine(lm, **kw)
        eng._cuda_graph = mode != "eager"
        calls = _counting_calls(eng)
        try:
            plan = eng.graph_plan()
            if mode != "lazy":
                eng.warmup()
            warm = len(plan) if mode == "graph" else 0
            assert eng.metrics.compiles == warm
            before, steps = kernels.launch_counts(), eng.metrics.decode_steps
            tokens[mode] = _serve_all(eng, reqs)
            torch.cuda.synchronize()
            steps = eng.metrics.decode_steps - steps
            launched = kernels.launch_counts()[counter] - before[counter]
            assert steps and launched == LM_CFG["n_layers"] * steps
            # lazy: the decode step and the buckets called twice or more
            lazy = 1 + sum(n >= 2 for n in calls.values())
            assert eng.metrics.compiles == {"graph": warm, "eager": 0,
                                            "lazy": lazy}[mode]
            assert set(eng._graphs) <= set(plan)
        finally:
            eng.stop()
    assert tokens["graph"] == tokens["eager"] == tokens["lazy"]


@pytest.mark.parametrize("kv_dtype", ["f32", "int8"])
@pytest.mark.parametrize("cache", ["slots", "paged"])
def test_bucket_graphs_give_eager_tokens_and_count_flash(cache, kv_dtype):
    """Prefill (slots) and chunk (paged) graphs: a warmed engine's
    tokens are those of the engine with no graph, and the flash forward
    (B3) counts once per layer and prefill, replays included (the paged
    chunks attend in plain PyTorch, so none there)."""
    from deeplearning4j_tpu_torch import kernels
    from deeplearning4j_tpu_torch.serving import GenerationEngine
    from deeplearning4j_tpu_torch.zoo.transformer_lm import \
        CausalTransformerLM
    dev = _device()
    lm = CausalTransformerLM(**LM_CFG, device=dev).init()
    rs = np.random.RandomState(8)
    reqs = [dict(prompt=rs.randint(0, 512, rs.randint(1, 60)).tolist(),
                 max_tokens=int(rs.randint(2, 6)),
                 temperature=0.8 if i % 4 == 3 else 0.0, top_k=0, seed=i)
            for i in range(10)]
    kw = dict(num_slots=4, min_prompt_bucket=8, kv_dtype=kv_dtype)
    if cache == "paged":
        kw.update(cache="paged", block_size=16, prefill_chunk_tokens=16)
    tokens = {}
    for graphed in (True, False):
        eng = GenerationEngine(lm, **kw)
        eng._cuda_graph = graphed
        try:
            eng.warmup()
            before, prefills = kernels.launch_counts(), eng.metrics.prefills
            tokens[graphed] = _serve_all(eng, reqs)
            torch.cuda.synchronize()
            b3 = (kernels.launch_counts()["flash_attention.launches"]
                  - before["flash_attention.launches"])
            prefills = eng.metrics.prefills - prefills
            assert prefills == len(reqs)
            assert b3 == (0 if cache == "paged"
                          else LM_CFG["n_layers"] * prefills)
            assert eng.metrics.compiles == (len(eng.graph_plan())
                                            if graphed else 0)
        finally:
            eng.stop()
    assert tokens[True] == tokens[False]


@pytest.mark.parametrize("draft_kind", ["same", "default"])
@pytest.mark.parametrize("cache", ["slots", "paged"])
def test_speculating_engine_captures_two_graphs(cache, draft_kind):
    """A speculating engine (k=3) captures its graph_plan at warmup (the
    decode step, the draft's proposal, the prefill or chunk buckets,
    copy-on-write, the draft primes and the verify spans) and nothing
    after, a corrupting verify recovery included (the caches are zeroed
    in place, on the same storage); its tokens are the k=0 engine's,
    greedy and sampled; and the draft's B1 launches are its layers x k
    x the proposal calls, replays included (the paged target decodes on
    B2)."""
    from deeplearning4j_tpu_torch import kernels
    from deeplearning4j_tpu_torch.serving import (FaultInjector,
                                                  GenerationEngine)
    from deeplearning4j_tpu_torch.zoo.transformer_lm import (
        CausalTransformerLM, make_draft_lm)
    dev = _device()
    lm = CausalTransformerLM(**LM_CFG, device=dev).init()
    draft = (CausalTransformerLM(**LM_CFG, device=dev).init()
             if draft_kind == "same" else make_draft_lm(lm))
    rs = np.random.RandomState(4)
    reqs = [dict(prompt=rs.randint(0, 512, rs.randint(1, 30)).tolist(),
                 max_tokens=int(rs.randint(4, 24)),
                 temperature=0.8 if i % 3 == 2 else 0.0,
                 top_k=16 if i % 2 else 0, seed=i) for i in range(8)]
    kw = dict(num_slots=4, min_prompt_bucket=8)
    if cache == "paged":
        kw.update(cache="paged", block_size=16, prefill_chunk_tokens=16)
    base = GenerationEngine(lm, **kw)
    eng = GenerationEngine(lm, **kw, speculation_k=3, draft_model=draft)
    try:
        base.warmup()
        want = _serve_all(base, reqs)
        eng.warmup()
        plan = eng.graph_plan()
        assert eng.metrics.compiles == len(plan)
        assert set(eng._graphs) == {k for k in plan
                                    if k[0] not in ("decode", "propose")}
        where = [c.data_ptr() for c in eng._draft_cache.ks
                 + eng._draft_cache.vs]
        calls = []
        propose = eng._propose_call
        eng._propose_call = lambda: calls.append(1) or propose()
        before, steps = kernels.launch_counts(), eng.metrics.decode_steps
        assert _serve_all(eng, reqs) == want
        torch.cuda.synchronize()
        n_calls, steps = len(calls), eng.metrics.decode_steps - steps
        b1 = (kernels.launch_counts()["decode_attention.launches"]
              - before["decode_attention.launches"])
        target = 0 if cache == "paged" else LM_CFG["n_layers"] * steps
        assert n_calls and b1 == target + draft.n_layers * 3 * n_calls
        assert eng.stats()["spec"]["verify_batches"] > 0
        eng.set_fault_injector(FaultInjector(plan={"verify": [4]},
                                             corrupting=("verify",)))
        assert _serve_all(eng, reqs) == want
        eng.set_fault_injector(None)
        assert eng.metrics.recoveries == 1
        assert eng.metrics.compiles == len(plan)
        assert where == [c.data_ptr() for c in eng._draft_cache.ks
                         + eng._draft_cache.vs]
    finally:
        base.stop()
        eng.stop()


def _host_pool(kv_dtype, rs, n=12, shape=(8, 16, 64)):
    """A seeded CPU pool of ``n`` blocks at ``kv_dtype``."""
    x = torch.from_numpy(rs.randn(n, *shape).astype(np.float32))
    if kv_dtype == "int8":
        return kvq.quantize_rows(x)
    return x.to(kvq._storage(kv_dtype))


def _pool_parts(pool):
    return (pool.q, pool.scale) if kvq.is_quantized(pool) else (pool,)


@pytest.mark.parametrize("kv_dtype", ["f32", "bf16", "int8"])
def test_block_run_helpers_on_the_card_match_the_cpu(kv_dtype):
    """The KV tier's gather (into a static row buffer), pack, unpack and
    scatter on pools on the card give the CPU path's bits, with
    NULL-padded indices; the scatter writes in place (every pool keeps
    its data_ptr) and the padding lands on the null block alone."""
    dev = _device()
    rs = np.random.RandomState(11)
    src, dst = _host_pool(kv_dtype, rs), _host_pool(kv_dtype, rs)
    n, bucket = 5, 8
    idx = torch.full((bucket,), 0, dtype=torch.int64)
    idx[:n] = torch.tensor([9, 2, 7, 3, 11])
    got = {}
    for label, where in (("cpu", torch.device("cpu")), ("card", dev)):
        s, d = src.to(where), dst.to(where)
        buf = kvq.kv_zeros((16,) + tuple(src.shape[1:]), kv_dtype, where)
        rows = kvq.kv_gather_rows(s, idx.to(where), out=buf)
        packed = kvq.kv_pack_host(rows, n)
        ops = kvq.kv_unpack_host(packed, bucket, device=where)
        ptrs = [t.data_ptr() for t in _pool_parts(d)]
        kvq.kv_scatter_rows(d, ops, idx.to(where))
        assert [t.data_ptr() for t in _pool_parts(d)] == ptrs
        got[label] = (packed, [t.cpu() for t in _pool_parts(d)])
    torch.cuda.synchronize()
    (pc, dc), (pg, dg) = got["cpu"], got["card"]
    for a, b in zip(pc, pg):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for a, b in zip(dc, dg):
        assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16
                           else a, b.view(torch.int16)
                           if b.dtype == torch.bfloat16 else b)
    for a, s in zip(dg, _pool_parts(src)):
        assert torch.equal(a[idx[:n]], s[idx[:n]])
        assert not a[0].any()


def test_offload_engine_on_the_card_matches_eager_and_captures_nothing():
    """The paged engine with the host KV tier (f32, and int8 with its
    scale rows) on the card: 6 two-turn sessions on a pool that pins
    ~2, with a disk ring under a host budget that spills. The offload
    gather and scatter graphs are captured at warmup with the rest of
    the plan and nothing after; demotions, spills and restores happen,
    none fails or drops; the tokens are those of the engine with no
    graph and of an engine that never offloads; the paged kernel counts
    once per layer and step; every block comes back."""
    from deeplearning4j_tpu_torch import kernels
    from deeplearning4j_tpu_torch.serving import GenerationEngine
    from deeplearning4j_tpu_torch.zoo.transformer_lm import \
        CausalTransformerLM
    dev = _device()
    lm = CausalTransformerLM(**LM_CFG, device=dev).init()
    rs = np.random.RandomState(5)
    prompts = [rs.randint(0, 512, rs.randint(17, 30)).tolist()
               for _ in range(6)]
    for kv_dtype in ("f32", "int8"):
        kw = dict(num_slots=2, min_prompt_bucket=8, cache="paged",
                  block_size=16, prefill_chunk_tokens=16, num_blocks=9,
                  kv_dtype=kv_dtype)
        tokens = {}
        for mode in ("graph", "eager", "hot"):
            eng = GenerationEngine(lm, **dict(
                kw, num_blocks=64 if mode == "hot" else 9,
                offload_host_bytes=0 if mode == "hot" else 40_000,
                offload_disk_bytes=0 if mode == "hot" else 1 << 22))
            eng._cuda_graph = mode != "eager"
            try:
                eng.warmup()
                warm = eng.metrics.compiles
                assert warm == (len(eng.graph_plan())
                                if mode != "eager" else 0)
                before, steps = kernels.launch_counts(), \
                    eng.metrics.decode_steps
                outs = [eng.generate(p, max_tokens=6, session_id=f"s{i}",
                                     timeout_ms=120_000)["tokens"]
                        for i, p in enumerate(prompts)]
                outs += [eng.generate(p + o + [1, 2, 3], max_tokens=5,
                                      session_id=f"s{i}",
                                      timeout_ms=120_000)["tokens"]
                         for i, (p, o) in enumerate(zip(prompts, outs))]
                torch.cuda.synchronize()
                key = ("paged_attention.launches"
                       + ("_int8" if kv_dtype == "int8" else ""))
                steps = eng.metrics.decode_steps - steps
                assert kernels.launch_counts()[key] - before[key] == \
                    LM_CFG["n_layers"] * steps
                assert eng.metrics.compiles == warm
                off = eng.stats()["paged"]["offload"]
                if mode != "hot":
                    assert off["demotions"] > 0 and off["restores"] > 0
                    assert off["spills"] > 0 and off["drops"] == 0
                    assert off["demote_failures"] == 0
                    assert off["restore_failures"] == 0
                    eng.offload_sessions()
                    eng.clear_offload()
                eng.evict_sessions()
                eng.clear_prefix_cache()
                assert eng._allocator.free_count == eng._allocator.capacity
                tokens[mode] = outs
            finally:
                eng.stop()
        assert tokens["graph"] == tokens["eager"] == tokens["hot"]


@pytest.mark.parametrize("which", ["decode", "draft", "prefill", "offload"])
def test_failed_capture_raises_from_warmup(which):
    """A decode step that syncs the host cannot be captured: warmup
    raises, naming the CUDA graph, and the engine has no graph; nor can
    a speculating engine's proposal whose draft syncs, nor a prefill
    bucket whose model syncs in its prompt pass, nor a KV-tier gather
    that syncs (no eager fallback).
    Last in the file: the card's state after a failed capture is not
    the other tests' business."""
    from deeplearning4j_tpu_torch.serving import GenerationEngine, ServingError
    from deeplearning4j_tpu_torch.zoo.transformer_lm import \
        CausalTransformerLM

    class SyncingLM(CausalTransformerLM):
        def forward_decode(self, *args, **kw):
            out = super().forward_decode(*args, **kw)
            if not bool(torch.isfinite(out[0]).all()):  # a host sync
                raise AssertionError("non-finite logits")
            return out

    class SyncingPrefillLM(CausalTransformerLM):
        def forward_prefill(self, *args, **kw):
            out = super().forward_prefill(*args, **kw)
            if not bool(torch.isfinite(out[0]).all()):  # a host sync
                raise AssertionError("non-finite logits")
            return out

    _device()
    if which == "decode":
        eng = GenerationEngine(SyncingLM(**LM_CFG).init(), num_slots=2,
                               min_prompt_bucket=8)
    elif which == "prefill":
        eng = GenerationEngine(SyncingPrefillLM(**LM_CFG).init(),
                               num_slots=2, min_prompt_bucket=8)
    elif which == "offload":
        eng = GenerationEngine(CausalTransformerLM(**LM_CFG).init(),
                               num_slots=2, min_prompt_bucket=8,
                               cache="paged", block_size=16,
                               prefill_chunk_tokens=16,
                               offload_host_bytes=1 << 20)
        save = eng._offload_save_fn

        def syncing_save(kcs, vcs, bucket):
            save(kcs, vcs, bucket)
            if not bool(torch.isfinite(eng._off_rows[0][0]).all()):
                raise AssertionError("non-finite rows")  # a host sync
        eng._offload_save_fn = syncing_save
    else:
        eng = GenerationEngine(CausalTransformerLM(**LM_CFG).init(),
                               num_slots=2, min_prompt_bucket=8,
                               speculation_k=2,
                               draft_model=SyncingLM(**LM_CFG).init())
    try:
        with pytest.raises(ServingError, match="CUDA graph"):
            eng.warmup()
        if which == "decode":
            assert eng._graph is None and eng.metrics.compiles == 0
        elif which == "prefill":
            # the decode step went first; no prefill bucket has a graph
            assert not eng._graphs and eng.metrics.compiles == 1
        elif which == "offload":
            # the decode step and the larger buckets went first
            assert not any(k[0] == "offload_save" for k in eng._graphs)
            assert eng.metrics.compiles == 1 + len(eng._graphs)
        else:
            assert eng._draft_graph is None and eng.metrics.compiles == 1
    finally:
        eng.stop()
