"""Evidence on the CPU for the int8 kernels' shared design
(``csrc/int8_attention.cuh``, used by the int8 decode kernel B4 and the
int8 paged kernel B5).

``int8x4_to_f32`` turns int8
into f32 without the quarter-rate I2F conversion: each 32-bit word of
four int8 is XORed with 0x80808080 (int8 b becomes the byte b + 128), a
byte permute (PRMT) puts one byte into the low byte of 0x4B000000,
which is the f32 2^23 + b + 128, and one subtraction of 2^23 + 128
leaves b. The first tests emulate that with torch integer ops and hold
it exactly equal to float(int8) for all 256 values in all four byte
positions.

The kernels read their tiles in a layout of their own (VEC-byte loads,
L lanes per row, R rows per warp load) while they keep the folds the
int8 decode kernel had before it took this layout: stream g of a warp
takes rows g, g + 32/G, ... of each tile of 8 * 32/G rows, G =
``group_width(D)``. The last test rebuilds both index maps for every
head dim the kernels take and every load width, and checks that each
lane's rows belong to one stream and that each stream gets exactly
those rows.
"""
import numpy as np
import pytest
import torch

MAGIC = 0x4B000000          # the f32 2^23
OFFSET = 8388608.0 + 128.0  # 2^23 + 128, exact in f32
UNROLL = 8                  # int8_attention::kUnroll: rows of a stream per tile


def int8x4_to_f32(words, e):
    """Byte ``e`` of each int32 word as the kernel converts it: XOR with
    0x80808080, the byte into the low byte of 0x4B000000 (PRMT), the
    bits as f32, minus 2^23 + 128."""
    u = words ^ torch.tensor(-0x7F7F7F80, dtype=torch.int32)  # 0x80808080
    byte = (u >> (8 * e)) & 0xFF
    return (byte | MAGIC).view(torch.float32) - OFFSET


def _words_with(values, e, seed):
    """int32 words whose byte ``e`` holds ``values`` (int8) and whose
    other bytes are random."""
    rs = np.random.RandomState(seed)
    raw = rs.randint(-128, 128, (values.size, 4)).astype(np.int8)
    raw[:, e] = values
    return torch.from_numpy(raw.view(np.int32).reshape(-1))  # little end


@pytest.mark.parametrize("e", [0, 1, 2, 3])
def test_every_int8_value_in_every_byte_position_is_exact(e):
    values = np.arange(-128, 128, dtype=np.int8)
    got = int8x4_to_f32(_words_with(values, e, seed=e), e)
    want = torch.from_numpy(values.astype(np.float32))
    assert got.dtype == torch.float32
    assert torch.equal(got, want)


def test_random_words_convert_byte_for_byte():
    rs = np.random.RandomState(7)
    raw = rs.randint(-128, 128, (4096, 4)).astype(np.int8)
    words = torch.from_numpy(raw.view(np.int32).reshape(-1))
    got = torch.stack([int8x4_to_f32(words, e) for e in range(4)], 1)
    assert torch.equal(got, torch.from_numpy(raw.astype(np.float32)))


def test_products_with_bf16_queries_stay_exact():
    """q is rounded to bf16 (8 significant bits) and |b| <= 128 (8
    bits), so every product is exact in f32: the dot is an f32 sum of
    exact products, as the numeric contract says."""
    rs = np.random.RandomState(3)
    q = torch.from_numpy(rs.randn(4096).astype(np.float32)).bfloat16()
    b = int8x4_to_f32(torch.from_numpy(
        rs.randint(-2 ** 31, 2 ** 31, 4096).astype(np.int32)), 2)
    assert torch.equal((q.float() * b).double(), q.double() * b.double())


def group_width(D):
    """int8_attention::group_width."""
    g = 1
    while g < D // 4:
        g <<= 1
    return g


@pytest.mark.parametrize("D", list(range(4, 129, 4)))
def test_lane_layout_keeps_b4_streams(D):
    G = group_width(D)
    streams = 32 // G
    tile = streams * UNROLL
    b4 = {g: set(range(g, tile, streams)) for g in range(streams)}
    for vec in (4, 8, 16):
        if D % vec or G * 4 < vec:
            continue
        L = G * 4 // vec            # lanes per row
        R = 32 // L                 # rows per warp load
        NL = tile // R              # rows per lane per tile
        assert NL == 32 // vec and R % streams == 0
        got = {g: set() for g in range(streams)}
        for lane in range(32):
            rg = lane // L
            rows = {rg + R * i for i in range(NL)}
            assert {r % streams for r in rows} == {rg % streams}
            got[rg % streams] |= rows
            # the lane's bytes of a row lie inside the row or past D
            d0 = vec * (lane % L)
            assert d0 + vec <= D or d0 >= D
        assert got == b4
