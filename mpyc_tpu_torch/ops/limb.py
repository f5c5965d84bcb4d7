"""Multi-limb modular arithmetic on torch tensors (the plain versions).

Port of ``mpyc_tpu/ops/limb.py``. A field element is a little-endian
vector of 32-bit limbs, shape ``(..., L)``. Stored limb tensors are
``int32`` holding each limb's uint32 bit pattern: 4 bytes a limb, as the
CUDA kernels read them. The arithmetic here works on lists of ``int64``
tensors, one per limb, with values in [0, 2^32): torch's CPU ``uint32``
has no add, shift or compare. Every intermediate fits in int64, since a
32x32-bit product is assembled from two 48-bit partial products
(``mul32``). The TPU's 16-bit-half multiply has no counterpart: the CUDA
kernels use the card's 32x32->64-bit multiply (``csrc/limb.cuh``).

Constants (p's limbs, n0inv, Montgomery constants) are Python ints and
broadcast against the tensors. All results are canonical (< p), so they
equal the JAX package's limb for limb.

From seven limbs on (the wide fields, ``_VEC_MIN_L``) the limb-by-limb
product would take thousands of small tensor operations (about 22,000 at
33 limbs), so ``mont_mul`` computes the same canonical value there as
whole-vector operations on 16-bit digits (``_mont_mul_vec``): each
product of multi-digit numbers one outer product and one ``index_add_``,
the Montgomery reduction by the full constant -p^-1 mod R, carries
propagated in parallel passes.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

M32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# host conversions (numpy / Python ints)
# ---------------------------------------------------------------------------

def ints_to_limbs(xs, L: int) -> np.ndarray:
    """Array of nonnegative ints (object ndarray or list) -> (..., L) uint32,
    in L vectorized passes (no per-element Python loop)."""
    cur = np.asarray(xs, dtype=object)
    shape = cur.shape
    cur = cur.reshape(-1)          # a 0-d object array's ops give ints
    limbs = []
    for i in range(L):
        limbs.append((cur & M32).astype(np.uint32))
        if i < L - 1:
            cur = cur >> 32
    return np.stack(limbs, axis=-1).reshape(shape + (L,))


def limbs_to_ints(v) -> np.ndarray:
    """(..., L) uint32 -> object ndarray of ints."""
    v = np.asarray(v)
    L = v.shape[-1]
    acc = v[..., L - 1].astype(object)
    for i in range(L - 2, -1, -1):
        acc = (acc << 32) | v[..., i].astype(object)
    return np.asarray(acc, dtype=object)


# ---------------------------------------------------------------------------
# storage <-> limb lists
# ---------------------------------------------------------------------------

def unstack(x: torch.Tensor) -> list:
    """Stored (..., L) int32 limbs -> list of L int64 tensors in [0, 2^32)."""
    return list((x.to(torch.int64) & M32).unbind(-1))


def stack(limbs) -> torch.Tensor:
    """List of L int64 limb tensors -> stored (..., L) int32 limbs."""
    return torch.stack(limbs, dim=-1).to(torch.int32)


def const_limbs(x: int, L: int) -> list:
    """Python-int limbs of a constant (broadcast against tensors)."""
    return [(x >> (32 * i)) & M32 for i in range(L)]


# ---------------------------------------------------------------------------
# 32-bit primitives on int64 tensors holding uint32 values
# ---------------------------------------------------------------------------

def mul32(a, b):
    """Full 32x32 -> 64-bit product of a (tensor) and b (tensor or int) as a
    (lo, hi) pair; no intermediate exceeds 2^49."""
    p0 = (a & 0xFFFF) * b
    p1 = (a >> 16) * b
    t = p0 + ((p1 & 0xFFFF) << 16)
    return t & M32, (t >> 32) + (p1 >> 16)


def mac(x, y, acc, carry):
    """x*y + acc + carry as a 64-bit (lo, hi) pair; never overflows 64 bits."""
    lo, hi = mul32(x, y)
    s = lo + acc + carry
    return s & M32, hi + (s >> 32)


def _sub_ll(a, b):
    """Multi-limb a - b: (limbs, borrow 0/1). b may hold Python ints."""
    out = []
    brw = 0
    for x, y in zip(a, b):
        d = x - y - brw
        out.append(d & M32)
        brw = (d >> 63) & 1
    return out, brw


def _select(mask, a, b):
    return [torch.where(mask, x, y) for x, y in zip(a, b)]


def iszero_ll(a):
    """Boolean tensor: the multi-limb value a is 0."""
    acc = a[0]
    for x in a[1:]:
        acc = acc | x
    return acc == 0


# ---------------------------------------------------------------------------
# modular add/sub/neg (inputs < p, standard or Montgomery form alike)
# ---------------------------------------------------------------------------

def add_mod(a, b, p_limbs):
    """(a + b) mod p for a, b < p; p_limbs: L Python ints; b may hold
    Python ints."""
    s = []
    c = 0
    for x, y in zip(a, b):
        v = x + y + c
        s.append(v & M32)
        c = v >> 32
    d, brw = _sub_ll(s, p_limbs)
    return _select((c == 1) | (brw == 0), d, s)


def sub_mod(a, b, p_limbs):
    """(a - b) mod p for a, b < p; either may hold Python ints."""
    d, brw = _sub_ll(a, b)
    dp = []
    c = 0
    for x, y in zip(d, p_limbs):
        v = x + y + c
        dp.append(v & M32)
        c = v >> 32
    return _select(brw == 1, dp, d)


def neg_mod(a, p_limbs):
    """(-a) mod p for a < p (0 stays 0)."""
    d, _ = _sub_ll(list(p_limbs), a)
    return _select(iszero_ll(a), a, d)


# ---------------------------------------------------------------------------
# Montgomery multiplication (CIOS), R = 2^(32 L)
# ---------------------------------------------------------------------------

def mont_mul(a, b, p_limbs, n0inv):
    """Montgomery product a*b*R^-1 mod p; CIOS as ``mpyc_tpu/ops/limb.py``
    (from ``_VEC_MIN_L`` limbs on the same value by ``_mont_mul_vec``).

    a: L limb tensors (< R); b: L limb tensors or Python ints (< p when a
    may exceed p, as in reduce_wide). p_limbs: L Python ints; n0inv:
    -p^-1 mod 2^32. Result < p."""
    L = len(a)
    if L >= _VEC_MIN_L:
        return _mont_mul_vec(a, b, p_limbs)
    zero = torch.zeros_like(a[0])
    t = [zero] * (L + 2)
    for i in range(L):
        c = 0
        for j in range(L):
            t[j], c = mac(a[j], b[i], t[j], c)
        v = t[L] + c
        t[L] = v & M32
        t[L + 1] = t[L + 1] + (v >> 32)
        m = mul32(t[0], n0inv)[0]
        _, c = mac(m, p_limbs[0], t[0], 0)
        for j in range(1, L):
            t[j - 1], c = mac(m, p_limbs[j], t[j], c)
        v = t[L] + c
        t[L - 1] = v & M32
        t[L] = t[L + 1] + (v >> 32)
        t[L + 1] = zero
    res = t[:L]
    d, brw = _sub_ll(res, p_limbs)
    return _select((t[L] == 1) | (brw == 0), d, res)


_VEC_MIN_L = 7          # limbs from which mont_mul takes _mont_mul_vec
_DIGIT = 0xFFFF


def _digits(x: torch.Tensor) -> torch.Tensor:
    """(..., L) int64 limbs in [0, 2^32) -> (..., 2 L) 16-bit digits."""
    return torch.stack((x & _DIGIT, x >> 16), -1).flatten(-2)


def _carry(c: torch.Tensor):
    """(..., K) int64 digit sums of any sign -> (digits in [0, 2^16), the
    carry out of digit K - 1), value(c) = value(digits) + carry 2^(16 K):
    passes that keep each digit's low 16 bits and move the rest one digit
    up, until nothing moves."""
    out = torch.zeros(c.shape[:-1], dtype=torch.int64, device=c.device)
    while True:
        hi = c >> 16
        if not bool(hi.any()):
            return c, out
        out = out + hi[..., -1]
        c = (c & _DIGIT) + torch.cat(
            (torch.zeros_like(hi[..., :1]), hi[..., :-1]), -1)


@functools.lru_cache(maxsize=64)
def _conv_index(k1: int, k2: int, keep: int, device) -> torch.Tensor:
    """Digit position i + j of each pair (i < k1, j < k2), those at or
    past ``keep`` sent to the spare slot ``keep``."""
    i = torch.arange(k1)[:, None] + torch.arange(k2)[None, :]
    return i.clamp(max=keep).flatten().to(device)


def _conv(x: torch.Tensor, y: torch.Tensor, keep: int) -> torch.Tensor:
    """Digit products of x (..., k1) and y (..., k2) summed by position,
    positions below ``keep`` (each sum below 2^39 for k1, k2 <= 72)."""
    prod = (x[..., :, None] * y[..., None, :]).flatten(-2)
    idx = _conv_index(x.shape[-1], y.shape[-1], keep, prod.device)
    out = torch.zeros(prod.shape[:-1] + (keep + 1,), dtype=torch.int64,
                      device=prod.device)
    return out.index_add_(out.dim() - 1, idx, prod)[..., :keep]


@functools.lru_cache(maxsize=64)
def _vec_consts(p_limbs: tuple) -> tuple:
    """The 16-bit digits of p and of n' = -p^-1 mod R (Python ints)."""
    L = len(p_limbs)
    p = sum(v << 32 * i for i, v in enumerate(p_limbs))
    R = 1 << 32 * L
    n_full = -pow(p, -1, R) % R
    return ([p >> 16 * k & _DIGIT for k in range(2 * L)],
            [n_full >> 16 * k & _DIGIT for k in range(2 * L)])


def _mont_mul_vec(a, b, p_limbs):
    """mont_mul's value by whole-vector operations (a < R, b < p or both
    < p): T = a b, m = (T mod R) n' mod R, t = (T + m p) / R < 2p, then t
    - p where that is not negative."""
    L = len(a)
    K = 2 * L
    A = _digits(torch.stack(torch.broadcast_tensors(*a), -1))
    dev = A.device
    if isinstance(b[0], torch.Tensor):
        B = _digits(torch.stack(torch.broadcast_tensors(*b), -1))
    else:
        B = _digits(torch.tensor([int(v) for v in b], dtype=torch.int64,
                                 device=dev))
    pd, nd = _vec_consts(tuple(int(v) for v in p_limbs))
    P = torch.tensor(pd, dtype=torch.int64, device=dev)
    N = torch.tensor(nd, dtype=torch.int64, device=dev)
    T, _ = _carry(_conv(A, B, 2 * K))
    M, _ = _carry(_conv(T[..., :K], N, K))
    U, top = _carry(T + _conv(M, P, 2 * K))
    t = U[..., K:]                     # (T + m p) / R = t + top R
    D, borrow = _carry(t - P)          # t - p = D + borrow R
    res = torch.where(((top + borrow) >= 0)[..., None], D, t)
    res = res.unflatten(-1, (L, 2))
    return list((res[..., 0] | res[..., 1] << 16).unbind(-1))


def mont_pow_const(a, e: int, p_limbs, n0inv, one_mont):
    """a^e R mod p for Montgomery-form a and a public exponent e >= 0
    (``mpyc_tpu/ops/limb.py`` mont_pow_const): left-to-right square and
    multiply over e's bits, a product only where a bit is set. one_mont:
    the limbs of R mod p, the result for e = 0 (also for a = 0)."""
    if e == 0:
        return [torch.full_like(a[0], x) for x in one_mont]
    res = list(a)
    for bit in bin(e)[3:]:
        res = mont_mul(res, res, p_limbs, n0inv)
        if bit == '1':
            res = mont_mul(res, a, p_limbs, n0inv)
    return res


def reduce_wide(chunks, radix_pows_mont, p_limbs, n0inv):
    """Reduce a wide little-endian value mod p into Montgomery form.

    chunks: n_chunk limb lists (value = sum_i chunk_i 2^(32 L i), each
    chunk any L-limb value); radix_pows_mont[i]: the limbs of
    2^(32 L i) R^2 mod p, so mont_mul(chunk_i, radix_i) is chunk_i's
    contribution in Montgomery form."""
    acc = None
    for ch, rad in zip(chunks, radix_pows_mont):
        term = mont_mul(ch, rad, p_limbs, n0inv)
        acc = term if acc is None else add_mod(acc, term, p_limbs)
    return acc
