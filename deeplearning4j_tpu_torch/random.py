"""The threefry-2x32 generator of ``jax.random``, in torch integer ops.

The engine samples with one uniform per request and step, drawn from
``fold_in(PRNGKey(seed), step)`` as the JAX engine does
(``generation.py::_sample_batch``). Reproducing JAX's bits here makes a
sampled token depend only on the logits, so temperature/top-k outputs
match the reference exactly. Covers JAX's defaults (threefry,
``jax_threefry_partitionable=True``) for seeds in [0, 2**32).

Training keeps JAX's key chain with :func:`split`, and dropout draws
its masks with the shaped :func:`uniform`, :func:`bernoulli` and
:func:`normal`. Under the partitionable layout element ``i`` of a draw
hashes the counter ``(i >> 32, i & 0xFFFFFFFF)`` under the key, so a
draw is a pure elementwise function of the flat index: the same bits
on the card and on the CPU. On the card the hash is plain PyTorch
integer arithmetic, about 130 elementwise launches a draw (20 rounds
of add, rotate and xor on int32 tensors whose adds wrap).

A key is a pair of uint32 values: Python ints for one key, or int64
tensors for keys vectorized over any shape. The training chain (one
key split and folded every step) stays in Python ints, so it costs no
tensor op; only a draw of a shape hashes on tensors.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import torch

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

Key = Tuple[Union[int, torch.Tensor], Union[int, torch.Tensor]]


def _u32(x):
    if isinstance(x, int):
        return x & _M32
    return torch.as_tensor(x, dtype=torch.int64) & _M32


def threefry2x32(k1, k2, x1, x2) -> Key:
    """Threefry-2x32 with 20 rounds: the hash behind ``jax.random``.
    Ints in, ints out; any tensor among the inputs makes it elementwise
    on tensors (int64 values in [0, 2**32), of the inputs' broadcast
    shape)."""
    k1, k2, x1, x2 = _u32(k1), _u32(k2), _u32(x1), _u32(x2)
    if any(torch.is_tensor(v) for v in (k1, k2, x1, x2)):
        return _threefry_tensors(k1, k2, x1, x2)
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & _M32
    x2 = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _M32
            x2 = (((x2 << r) | (x2 >> (32 - r))) & _M32) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _M32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x1, x2


#: elements one CPU thread hashes at a time: its two int32 words and
#: the shift temporary (768 KiB) stay in its cache through the 20 rounds
_CPU_CHUNK = 1 << 16


def _i32(v):
    """A uint32 value (int or int64 tensor) as the int32 with its bits."""
    if torch.is_tensor(v):
        return v.to(torch.int32)   # keeps the low 32 bits
    return v - (1 << 32) if v >= 1 << 31 else v


def _threefry_tensors(k1, k2, x1, x2) -> Key:
    """The rounds on int32 tensors (adds wrap, the right shift of a
    rotation masked to a logical one): half the bytes of int64 words
    and no mask a step. On a CPU running one intra-op thread the
    elements go in chunks of ``_CPU_CHUNK``, so each round works in
    cache; with a thread pool, and on the card, in one pass, which
    keeps the op count (the pool's barriers, the card's launches) at
    ~130 a draw."""
    dev = next(v.device for v in (x1, x2, k1, k2) if torch.is_tensor(v))
    shape = torch.broadcast_shapes(*(v.shape for v in (k1, k2, x1, x2)
                                     if torch.is_tensor(v)))
    words = [torch.as_tensor(v, device=dev).broadcast_to(shape).reshape(-1)
             if torch.is_tensor(v) else v for v in (k1, k2, x1, x2)]
    n = math.prod(shape)
    out1 = torch.empty(n, dtype=torch.int64, device=dev)
    out2 = torch.empty(n, dtype=torch.int64, device=dev)
    step = _CPU_CHUNK if dev.type == "cpu" and \
        torch.get_num_threads() == 1 else n
    for a in range(0, n, max(step, 1)):
        b = min(n, a + step)
        k1c, k2c, x1c, x2c = (v[a:b] if torch.is_tensor(v) else v
                              for v in words)
        y1, y2 = _rounds(k1c, k2c, x1c, x2c, b - a, dev)
        for y, out in ((y1, out1[a:b]), (y2, out2[a:b])):
            out.copy_(y)   # sign-extends; the mask keeps the 32 bits
            out &= _M32
    return out1.reshape(shape), out2.reshape(shape)


def _rounds(k1, k2, x1, x2, n: int, dev):
    """The 20 rounds over ``n`` elements; int32 results."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)

    def word(x, k):
        """x + k as int32 words of n elements."""
        if not torch.is_tensor(x) and not torch.is_tensor(k):
            return torch.full((n,), _i32((x + k) & _M32), dtype=torch.int32,
                              device=dev)
        y = torch.empty(n, dtype=torch.int32, device=dev)
        y.copy_(torch.as_tensor(_i32(x), dtype=torch.int32, device=dev)
                .expand(n))
        y += _i32(k)
        return y

    def inject(y, k, extra=0):
        if torch.is_tensor(k):
            y += _i32(k)
            if extra:
                y += extra
        else:
            y += _i32((k + extra) & _M32)

    y1, y2 = word(x1, ks[0]), word(x2, ks[1])
    tmp = torch.empty_like(y2)
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            y1 += y2
            torch.bitwise_left_shift(y2, r, out=tmp)
            y2 >>= 32 - r
            y2 &= (1 << r) - 1
            y2 |= tmp
            y2 ^= y1
        inject(y1, ks[(i + 1) % 3])
        inject(y2, ks[(i + 2) % 3], i + 1)
    return y1, y2


def PRNGKey(seed) -> Key:
    """``jax.random.PRNGKey(seed)`` for seeds in [0, 2**32): an int
    seed gives an int key, a tensor of seeds a tensor of keys."""
    seed = _u32(seed)
    return (0 if isinstance(seed, int) else torch.zeros_like(seed)), seed


def fold_in(key: Key, data) -> Key:
    """``jax.random.fold_in(key, data)``."""
    return threefry2x32(key[0], key[1], 0, data)


def split(key: Key, num: int = 2) -> Key:
    """``jax.random.split(key, num)`` of one key: a key whose halves
    hold ``num`` values, tuples of ints for an int key and [num]
    tensors otherwise (row ``i`` is :func:`key_at` ``(keys, i)``)."""
    num = int(num)
    if isinstance(key[0], int) and isinstance(key[1], int):
        rows = [threefry2x32(key[0], key[1], i >> 32, i & _M32)
                for i in range(num)]
        return tuple(r[0] for r in rows), tuple(r[1] for r in rows)
    hi, lo = _counters(num, key[0].device if torch.is_tensor(key[0])
                       else None)
    return threefry2x32(key[0], key[1], hi, lo)


def key_at(keys: Key, i: int) -> Key:
    """Key ``i`` of a :func:`split`."""
    return keys[0][i], keys[1][i]


def _counters(n: int, device):
    """The flat iota of an n-element draw as JAX's (hi, lo) words."""
    idx = torch.arange(n, dtype=torch.int64, device=device)
    return idx >> 32, idx & _M32


def random_bits(key: Key, shape: Sequence[int], device=None
                ) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` as int64 values on
    ``device``: ``x1 ^ x2`` of threefry over the flat counter."""
    shape = tuple(int(d) for d in shape)
    hi, lo = _counters(math.prod(shape), device)
    b1, b2 = threefry2x32(key[0], key[1], hi, lo)
    return (b1 ^ b2).reshape(shape)


def _float_layout(dtype):
    """(bits, mantissa bits, signed int dtype of that width)."""
    fi = torch.finfo(dtype)
    nmant = int(round(-math.log2(fi.eps)))
    return fi.bits, nmant, {32: torch.int32, 16: torch.int16}[fi.bits]


def uniform(key: Key, shape: Optional[Sequence[int]] = None,
            dtype=torch.float32, minval=0.0, maxval=1.0,
            device=None) -> torch.Tensor:
    """``jax.random.uniform``. With ``shape`` None, one f32 draw in
    [0, 1) per key of a vector of keys (the engine's sampling uniform).
    Otherwise one key's draw of ``shape`` in [minval, maxval) on
    ``device``: f32, bf16 or f16 as JAX builds them (the mantissa bits
    of ``1.0``'s exponent, minus 1, scaled and shifted in ``dtype``)."""
    if shape is None:
        b1, b2 = threefry2x32(key[0], key[1], torch.zeros_like(key[0]),
                              torch.zeros_like(key[0]))
        bits = ((b1 ^ b2) >> 9) | 0x3F800000
        return (bits.to(torch.int32).view(torch.float32) - 1.0
                ).clamp_min(0.0)
    nbits, nmant, itype = _float_layout(dtype)
    rng_bits = 8 if nmant < 8 else nbits
    bits = random_bits(key, shape, device)
    if rng_bits != 32:
        bits = bits & ((1 << rng_bits) - 1)
    one = int(torch.ones(1, dtype=dtype).view(itype)[0])
    fbits = (bits >> (rng_bits - nmant)) | one
    floats = fbits.to(itype).view(dtype) - 1.0
    # the range in ``dtype``, as host floats (no copy to the device)
    lo = torch.tensor(minval, dtype=dtype)
    scale, lo = float(torch.tensor(maxval, dtype=dtype) - lo), float(lo)
    if lo == 0.0 and scale == 1.0:
        return floats   # floats * 1 + 0 and max(0, .) change no bit
    return torch.clamp_min(_fma(floats, scale, lo), lo)


def _fma(a, b, c):
    """``a * b + c`` rounded once to ``a``'s dtype, as XLA's CPU backend
    contracts a multiply and an add: the f64 product of two f32 values
    is exact, so only the sum rounds (twice, to f64 and then to f32,
    which differs from one rounding only on an exact f32 tie). ``b``
    and ``c`` are tensors or floats exact in ``a``'s dtype."""
    def f64(t):
        return t.double() if torch.is_tensor(t) else t
    return (a.double() * f64(b) + f64(c)).to(a.dtype)


def bernoulli(key: Key, p: float, shape: Sequence[int], device=None
              ) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)`` for a float ``p``: a
    bool mask, ``uniform < p`` in f32."""
    return uniform(key, shape, torch.float32, device=device) < \
        float(torch.tensor(p, dtype=torch.float32))


# XLA's f32 inverse error function (Giles, "Approximating the erfinv
# function"): a degree-8 polynomial in w = -log1p(-x^2), one branch
# each side of w = 5, in Horner form with fused multiply-adds as XLA's
# CPU backend evaluates it. XLA's log1p is its own approximation, so w
# (and the normal draw) can differ from JAX's in the last bits.
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erfinv_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 ``erf_inv`` (what ``jax.random.normal`` applies)."""
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(lt, _ERFINV_LT5[0], _ERFINV_GE5[0]).to(x.dtype)
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = _fma(p, w, torch.where(lt, a, b).to(x.dtype))
    return torch.where(x.abs() == 1.0, x * torch.finfo(x.dtype).max, p * x)


def normal(key: Key, shape: Sequence[int], dtype=torch.float32,
           device=None) -> torch.Tensor:
    """``jax.random.normal(key, shape, dtype)``: ``sqrt(2) *
    erf_inv(u)`` with u uniform in (-1, 1) in ``dtype`` (the inverse
    taken in f32, as XLA widens a half-precision ``erf_inv``). The
    uniform is JAX's bit for bit; the result is within a few f32 ulp of
    JAX's (:func:`erfinv_f32`)."""
    lo = -(1.0 - torch.finfo(dtype).eps / 2)   # nextafter(-1, 0)
    u = uniform(key, shape, dtype, lo, 1.0, device)
    e = erfinv_f32(u.float()).to(dtype)
    return e * float(torch.tensor(math.sqrt(2.0), dtype=dtype))


def truncated_normal(key: Key, lower: float, upper: float,
                     shape: Sequence[int], dtype=torch.float32,
                     device=None) -> torch.Tensor:
    """``jax.random.truncated_normal(key, lower, upper, shape, dtype)``:
    ``sqrt(2) * erf_inv(u)`` with u uniform in [erf(lower / sqrt(2)),
    erf(upper / sqrt(2))), clipped to the open interval (lower, upper).
    The bounds' ``erf`` is PyTorch's, within an ulp of XLA's, so a draw
    is within a few f32 ulp of JAX's."""
    sqrt2 = torch.tensor(math.sqrt(2.0), dtype=dtype)
    lo = torch.tensor(lower, dtype=dtype)
    hi = torch.tensor(upper, dtype=dtype)
    a = float(torch.erf((lo / sqrt2).float()).to(dtype))
    b = float(torch.erf((hi / sqrt2).float()).to(dtype))
    u = uniform(key, shape, dtype, a, b, device)
    out = erfinv_f32(u.float()).to(dtype) * float(sqrt2)
    inf = torch.tensor(float("inf"), dtype=dtype)
    return torch.clamp(out, float(torch.nextafter(lo, inf)),
                       float(torch.nextafter(hi, -inf)))
