"""JAX's default random generator (threefry2x32) in numpy.

The JAX package draws its random initial weights from `jax.random`:
`models/ast.py:_trunc_normal` (`normal`, or `truncated_normal` where the
bounds lie inside 10 sigma) under `init_params`' `split(key, 8)`, and
`train/loop.py:init_model` and `analysis/drift_bench.py` make the key with
`PRNGKey(seed)`. This module reproduces those draws without JAX, so the
port's trainer starts from the JAX trainer's tree:

- `key(seed)`: `jax.random.PRNGKey(seed)` as JAX makes it with 64-bit types
  off (the JAX package's setting): the seed wraps to 32 bits, so the key is
  (0, seed mod 2**32);
- `split(key, n)`: threefry2x32(key, (0, i)) for i < n, stacked (the
  partitionable layout, `jax_threefry_partitionable`, JAX's default);
- `bits(key, shape)`: 32-bit words x0 ^ x1 of threefry2x32(key, (hi, lo))
  over the flat 64-bit index of each element;
- `uniform`, `normal` and `truncated_normal` in float32, bitwise what
  XLA's CPU backend computes for `jax.random.uniform`, `normal` and
  `truncated_normal`: the mantissa trick for the uniform, then XLA's f32
  `ErfInv` (Giles' polynomial on w = -log1p(-u^2)) with XLA-CPU's own
  `log1p` and `log` polynomials, each product and sum rounded where the
  compiled code rounds it: LLVM contracts a product that feeds one sum into
  a fused multiply-add (`_fma`), and the order of the steps is that of the
  compiled loop. Inside a jitted function XLA also folds constants
  (`normal`'s `scale`, `truncated_normal`'s `jit`). `tests/test_torch_prng.py`
  holds every function to `jax.random`, and the port's `init_params` to the
  JAX package's, bit for bit.

A key is a (2,) uint32 array. Everything is numpy: the port never imports
JAX.
"""

from __future__ import annotations

import math
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

_U32 = np.uint32
_F32 = np.float32
_CHUNK = 1 << 20  # elements drawn at a time, to bound the temporaries

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def is_key(x) -> bool:
    """Whether `x` is a key of this module: a (2,) uint32 array."""
    return (isinstance(x, np.ndarray) and x.dtype == _U32
            and x.shape == (2,))


def key(seed: int) -> np.ndarray:
    """`jax.random.PRNGKey(seed)` with 64-bit types off: the seed is taken
    as an int64 (raising beyond its range, as JAX does), wrapped to 32
    bits, and the key is (0, seed mod 2**32)."""
    seed = int(np.int64(seed))  # OverflowError beyond int64, as in JAX
    return np.array([0, seed & 0xFFFFFFFF], dtype=_U32)


def _rotl(x: np.ndarray, d: int) -> np.ndarray:
    return (x << _U32(d)) | (x >> _U32(32 - d))


def threefry2x32(k: np.ndarray, x0: np.ndarray,
                 x1: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The Threefry-2x32 hash (20 rounds) of counter words (x0, x1) under
    key k, as `jax._src.prng._threefry2x32_lowering` computes it."""
    k0, k1 = _U32(k[0]), _U32(k[1])
    ks = (k0, k1, k0 ^ k1 ^ _U32(0x1BD11BDA))
    x0 = x0.astype(_U32) + ks[0]
    x1 = x1.astype(_U32) + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + _U32(i + 1)
    return x0, x1


def split(k: np.ndarray, n: int = 2) -> np.ndarray:
    """`jax.random.split(key, n)`: (n, 2) uint32, key i the hash of the
    counter (0, i)."""
    lo = np.arange(n, dtype=np.uint64)
    x0, x1 = threefry2x32(k, (lo >> np.uint64(32)).astype(_U32),
                          lo.astype(_U32))
    return np.stack([x0, x1], axis=-1)


def bits(k: np.ndarray, shape) -> np.ndarray:
    """`jax.random.bits(key, shape)` (uint32): x0 ^ x1 of the hash of each
    element's flat index, as (high, low) 32-bit counter words."""
    return _draw(k, shape, lambda b: b, _U32)


def _draw(k: np.ndarray, shape, fn, dtype=_F32) -> np.ndarray:
    """fn applied to `bits(k, shape)`, chunk by chunk of the flat indices on
    a pool of threads (numpy's loops release the interpreter lock): every
    step is elementwise, so the chunks bound the temporaries and give the
    same values in any order."""
    shape = tuple(int(d) for d in shape)
    n = math.prod(shape)
    out = np.empty(n, dtype=dtype)

    def chunk(start: int) -> None:
        idx = np.arange(start, min(n, start + _CHUNK), dtype=np.uint64)
        x0, x1 = threefry2x32(k, (idx >> np.uint64(32)).astype(_U32),
                              idx.astype(_U32))
        out[start:start + idx.size] = fn(x0 ^ x1)

    starts = range(0, n, _CHUNK)
    if len(starts) <= 1:
        for start in starts:
            chunk(start)
    else:
        with ThreadPoolExecutor(min(len(starts), os.cpu_count() or 1)) as pool:
            for _ in pool.map(chunk, starts):
                pass
    return out.reshape(shape)


# ------------------------------------------------------------ f32 arithmetic
def _fma(a, b, c) -> np.ndarray:
    """a * b + c in float32 with one rounding. The product of two float32
    values is exact in float64 and the float64 sum rounds once. Where that
    sum lies on a midpoint between two float32 values (the low 29 bits of
    its float64 mantissa are 1 followed by zeros) and was itself rounded,
    it moves one float64 step toward the exact sum before the float32
    rounding, so that nothing is rounded twice the wrong way."""
    p = np.multiply(a, b, dtype=np.float64)
    s = p + np.asarray(c, dtype=np.float64)
    mid = (s.view(np.uint64) & np.uint64(0x1FFFFFFF)) == np.uint64(1 << 28)
    if np.any(mid):
        c64 = np.broadcast_to(np.asarray(c, dtype=np.float64), s.shape)
        t = s - p  # TwoSum: err is the exact sum minus s
        err = (p - (s - t)) + (c64 - t)
        s = np.where(mid & (err != 0), np.nextafter(s, s + err), s)
    return s.astype(_F32)


def _f32(*xs):
    return tuple(np.asarray(x, dtype=_F32) for x in xs)


# XLA-CPU's f32 log (a Cephes polynomial) as compiled: three chains in xx,
# joined by powers of xx^3
_LOG_P = tuple(_F32(c) for c in (
    "0.070376836", "-0.1151461", "-0.12420141", "0.14249323", "0.20000714",
    "-0.24999994", "0.116769984", "-0.16668057", "0.3333333"))
_LOG_Q1, _LOG_Q2 = _F32("-0.00021219444"), _F32("0.6933594")
_SQRTHF = _F32("0.70710677")
_MIN_NORMAL = _F32("1.1754944e-38")


def _log(y: np.ndarray) -> np.ndarray:
    """XLA-CPU's float32 natural log of y, step by step."""
    (y,) = _f32(y)
    m = np.where(y > _MIN_NORMAL, y, _MIN_NORMAL)
    b = m.view(np.int32)
    e = ((b >> 23) - 127).astype(_F32) + _F32(1)
    mant = ((b & 0x7FFFFF) | 0x3F000000).view(_F32)
    small = mant < _SQRTHF
    e = e - np.where(small, _F32(1), _F32(0))
    x = (mant + _F32(-1)) + np.where(small, mant, _F32(0))
    z = x * x
    x3 = z * x
    p = _LOG_P
    a = _fma(_fma(x, p[0], p[1]), x, p[6])
    bb = _fma(_fma(x, p[2], p[3]), x, p[7])
    c = _fma(_fma(x, p[4], p[5]), x, p[8])
    t = _fma(_fma(_fma(a, x3, bb), x3, c), x3, e * _LOG_Q1)
    r = _fma(e, _LOG_Q2, (x - z * _F32(0.5)) + t)
    with np.errstate(invalid="ignore"):
        r = np.where(np.isnan(y) | (y < 0), _F32(np.nan), r)
    r = np.where(y == 0, _F32(-np.inf), r)
    return np.where(y == _F32(np.inf), _F32(np.inf), r)


# XLA's log1p: a Cephes rational function where |x| < sqrt(2) - 1, else
# log(1 + x)
_LOG1P_DEN = tuple(_F32(c) for c in (
    "15.062909", "83.04757", "221.7624", "309.09872", "216.42789",
    "60.11866"))
_LOG1P_NUM = tuple(_F32(c) for c in (
    "4.527e-05", "0.49854103", "6.5787325", "29.911919", "60.94967",
    "57.112965", "20.039553"))
_LOG1P_SMALL = _F32("0.41421357")


def _log1p(x: np.ndarray) -> np.ndarray:
    """XLA-CPU's float32 log1p of x, step by step (each branch computed
    where it is selected)."""
    (x,) = _f32(x)
    out = np.empty_like(x)
    small = np.abs(x) < _LOG1P_SMALL
    xs = x[small]
    x2 = xs * xs
    zero = xs * _F32(0)
    den = zero + _F32(1)
    for c in _LOG1P_DEN:
        den = _fma(den, xs, c)
    num = zero + _LOG1P_NUM[0]
    for c in _LOG1P_NUM[1:]:
        num = _fma(num, xs, c)
    out[small] = xs + _fma(x2, _F32(-0.5), (xs * x2) * (num / den))
    large = ~small
    out[large] = _log(x[large] + _F32(1))
    return out


# XLA's f32 ErfInv (M. Giles' single-precision approximation): coefficient
# pairs (w < 5, w >= 5), highest degree first
_ERFINV = tuple((_F32(a), _F32(b)) for a, b in (
    ("2.8102264e-08", "-0.00020021426"), ("3.4327394e-07", "0.00010095056"),
    ("-3.5233877e-06", "0.0013493432"), ("-4.3915065e-06", "-0.0036734284"),
    ("0.00021858087", "0.0057395077"), ("-0.001253725", "-0.0076224613"),
    ("-0.0041776816", "0.0094388705"), ("0.24664073", "1.001674"),
    ("1.5014094", "2.8329768")))


def _erfinv(u: np.ndarray) -> np.ndarray:
    """XLA-CPU's float32 erf_inv of u, step by step (each coefficient set
    where it is selected)."""
    (u,) = _f32(u)
    lg = _log1p(u * -u)
    p = np.empty_like(u)
    lt = lg > _F32(-5)  # w = -lg < 5
    for sel, side in ((lt, 0), (~lt, 1)):
        if not sel.any():
            continue
        with np.errstate(invalid="ignore"):
            w = (_F32(-2.5) - lg[sel] if side == 0
                 else np.sqrt(-lg[sel]) + _F32(-3))
        c = [pair[side] for pair in _ERFINV]
        q = _fma(c[0], w, c[1])
        for ci in c[2:]:
            q = _fma(w, q, ci)
        p[sel] = q
    return u * np.where(np.abs(u) == _F32(1), _F32(np.inf), p)


# XLA's f32 erf: a rational function on x clamped to +-3.7439213
_ERF_NUM = tuple(_F32(c) for c in (
    "0.00022905065", "0.003408291", "0.050955694", "0.18520832",
    "1.1283791"))
_ERF_DEN = tuple(_F32(c) for c in (
    "-1.1791603e-07", "2.3547966e-05", "0.0010179626", "0.01407047",
    "0.11098505", "0.49746925", "1"))
_ERF_CLAMP = _F32("3.7439213")


def _erf(x: np.ndarray) -> np.ndarray:
    """XLA-CPU's float32 erf of x, step by step."""
    (x,) = _f32(x)
    x = np.minimum(np.maximum(x, -_ERF_CLAMP), _ERF_CLAMP)
    x2 = x * x
    num = _fma(x2, _ERF_NUM[0], _ERF_NUM[1])
    for c in _ERF_NUM[2:]:
        num = _fma(num, x2, c)
    den = _fma(x2, _ERF_DEN[0], _ERF_DEN[1])
    for c in _ERF_DEN[2:]:
        den = _fma(den, x2, c)
    return (x * num) / den


_SQRT2 = _F32(np.sqrt(2))
_INV_SQRT2 = _F32("0.70710677")  # XLA multiplies by 1 / sqrt(2) for / sqrt(2)


# ------------------------------------------------------------------ draws
def _uniform(b: np.ndarray, lo, hi) -> np.ndarray:
    lo, hi = _F32(lo), _F32(hi)
    f = (b >> _U32(9) | _U32(0x3F800000)).view(_F32) - _F32(1)
    return np.maximum(lo, _fma(f, hi - lo, lo))


def uniform(k: np.ndarray, shape, minval=0.0, maxval=1.0) -> np.ndarray:
    """`jax.random.uniform(key, shape, float32, minval, maxval)`: the top 23
    bits as a mantissa in [1, 2), minus 1, times (maxval - minval) plus
    minval in one rounding, and at least minval."""
    return _draw(k, shape, lambda b: _uniform(b, minval, maxval))


_NORMAL_LO = np.nextafter(_F32(-1), _F32(0))


def normal(k: np.ndarray, shape, scale: float = 1.0) -> np.ndarray:
    """`jax.random.normal(key, shape, float32)`: sqrt(2) erf_inv(u), u
    uniform on (nextafter(-1, 0), 1). With `scale`, `scale * normal` as XLA
    computes it inside a jitted function where scale is a constant (the JAX
    package's `init_params`): the constant factors fold into one, erf_inv(u)
    times f32(sqrt(2) * scale). Outside jit JAX rounds twice instead:
    `np.float32(scale) * normal(k, shape)`."""
    factor = _SQRT2 * _F32(scale)
    return _draw(k, shape, lambda b: _erfinv(
        _uniform(b, _NORMAL_LO, _F32(1))) * factor)


def truncated_normal(k: np.ndarray, lower: float, upper: float, shape,
                     jit: bool = False) -> np.ndarray:
    """`jax.random.truncated_normal(key, lower, upper, shape, float32)`: u
    uniform between erf(lower / sqrt 2) and erf(upper / sqrt 2), sqrt(2)
    erf_inv(u), clipped to the open interval (lower, upper). The bounds'
    erf is XLA-CPU's compiled polynomial where they are values passed in;
    with `jit`, the bounds are constants of a jitted function (the JAX
    package's `init_params`), which XLA folds to the correctly rounded
    erf."""
    lower, upper = _F32(lower), _F32(upper)
    if jit:
        a, b = (_F32(math.erf(float(x / _SQRT2))) for x in (lower, upper))
    else:
        a, b = _erf(lower * _INV_SQRT2), _erf(upper * _INV_SQRT2)
    out = _draw(k, shape, lambda b_: _SQRT2 * _erfinv(_uniform(b_, a, b)))
    return np.clip(out, np.nextafter(lower, _F32(np.inf)),
                   np.nextafter(upper, _F32(-np.inf)))
