"""Shamir secret sharing over GF(p) and GF(2^d) on field arrays.

Port of the part of ``mpyc_tpu/thresha.py`` that secure multiplication
and pseudorandom secret sharing (PRSS) use: ``_recombination_vector``,
``np_random_split`` and ``np_recombine``, and for PRSS ``_f_S_i`` and
``DevicePRF`` (with its host integer stream ``host_integers``), with the JAX package's randomness conventions, so the same
generator state and keys give the same shares. Over GF(2^d) the party
points 1, 2, 3, ... are read as polynomials (3 is x + 1), as the JAX
package reads them.
"""

from __future__ import annotations

import functools
import hashlib
import math

import numpy as np
import torch

from mpyc_tpu_torch.ops import keccak, limb
from mpyc_tpu_torch.ops import rng as rng_mod
from mpyc_tpu_torch.ops.fieldops import limbs_from_numpy, prime_field_ctx

# Host-int split for arrays the JAX package keeps on the host: at most this
# many limbs (finfields.py "tiny arrays stay host-side") and values.
_HOST_LIMBS = 256
_HOST_PRF_N = 256


def _recombination_vector(field, xs, x_r) -> list:
    """Lagrange coefficients (ints mod p, or the ints of GF(2^d) elements)
    for interpolation at x_r from xs."""
    if field.characteristic == 2:
        xs_v = [field(x) for x in xs]
        x_rv = field(x_r)
        vec = []
        for i, x_i in enumerate(xs_v):
            num = den = field(1)
            for j, x_j in enumerate(xs_v):
                if i != j:
                    num = num * (x_rv - x_j)
                    den = den * (x_i - x_j)
            vec.append((num / den).value)
        return vec
    p = field.modulus
    xs = [int(x) % p for x in xs]
    x_r = int(x_r) % p
    vec = []
    for i, x_i in enumerate(xs):
        num = den = 1
        for j, x_j in enumerate(xs):
            if i != j:
                num = num * (x_r - x_j) % p
                den = den * (x_i - x_j) % p
        vec.append(num * pow(den, -1, p) % p)
    return vec


def np_random_split(field, s, t, m, rng):
    """Shamir-split a field array s of shape (...) into (m, ...) shares.

    Share i (party i+1) is Horner(c, i+1) + s with t coefficient arrays
    drawn from ``rng``. Arrays small enough that the JAX package keeps them
    on the host draw their coefficients as host ints
    (``field_uniform_mont_ints``), as it does; all others through
    ``rng.field_uniform`` on the array's device."""
    acls = field.array
    if t == 0:
        return acls.from_data(s.data.unsqueeze(0).expand(
            (m,) + tuple(s.data.shape)).contiguous())
    shape = s.shape if s.shape else (1,)
    n = math.prod(shape)
    ctx = s.ctx
    if (field.characteristic != 2 and 0 < n <= _HOST_PRF_N
            and n * ctx.L <= _HOST_LIMBS
            and n * t * ((field.modulus.bit_length() + 7 >> 3) + 16)
            <= 65536):
        p = ctx.p
        s_mont = limb.limbs_to_ints(
            s.data.reshape(n, ctx.L).cpu().numpy().view(np.uint32))
        coefs = rng.field_uniform_mont_ints(ctx, t * n).reshape(t, n)
        rows = []
        for i in range(1, m + 1):
            y = 0
            for k in range(t):
                y = (y + coefs[k]) * i
            rows.append((y + s_mont) % p)
        mont = limb.ints_to_limbs(np.concatenate(rows), ctx.L)
        data = limbs_from_numpy(mont, s.device)
        return acls.from_data(data.reshape((m,) + tuple(s.shape) + (ctx.L,)))
    coefs = rng.field_uniform(field, (t,) + shape)
    rows = []
    for i in range(1, m + 1):
        y = None
        for j in range(t):
            c_j = coefs[j]
            y = c_j if y is None else y + c_j
            y = y * i
        rows.append(y + s)
    return acls.from_data(torch.stack([r.data for r in rows], dim=0))


def np_recombine(field, points, x_rs=0):
    """Recombine field-array shares at x_rs (default 0).

    points: list of (x_i, field.array)."""
    xs = tuple(x for x, _ in points)
    shares = [sh for _, sh in points]
    single = not isinstance(x_rs, list)
    if single:
        x_rs = (x_rs,)
    outs = []
    for x_r in x_rs:
        vec = _recombination_vector(field, xs, x_r)
        acc = None
        for c_i, sh in zip(vec, shares):
            term = sh * c_i
            acc = term if acc is None else acc + term
        outs.append(acc)
    return outs[0] if single else outs


@functools.cache
def _f_S_i(field, m: int, i: int, S: tuple) -> int:
    """f_S(i + 1) for the polynomial f_S of degree m - |S| that is 1 at 0
    and 0 at the parties outside S (``mpyc_tpu/thresha.py:126``)."""
    xs = [0] + [x + 1 for x in range(m) if x not in S]
    return _recombination_vector(field, xs, i + 1)[0]


class DevicePRF:
    """Counter-mode SHAKE128 PRF with codomain range(bound), giving field
    arrays (``mpyc_tpu/thresha.py:298``, prime fields): value j of input s
    is byte_length little-endian bytes of the stream of ``key || s``, a
    draw never straddling two 168-byte blocks, masked to its bits for a
    power-of-two bound and reduced mod p. A bound that is no power of two
    takes 16 more bytes a value (statistical distance < 2^-128); it must
    then be the field's modulus. Parties with the same key and input get
    the same values.

    The JAX package draws up to 256 values on the host (hashlib and
    Python ints) and more on its device, with the same bits; here the
    stream's blocks come from hashlib up to 256 blocks and from K1 above
    (``keccak.shake128_ctr_blocks``), the same bits again."""

    def __init__(self, key: bytes, bound: int):
        self.key = bytes(key)
        self.max = bound
        self.byte_length = ((bound - 1).bit_length() + 7) // 8
        self.is_pow2 = not (bound & (bound - 1))
        if not self.is_pow2:
            self.byte_length += rng_mod._WIDEN_BYTES

    def field_array(self, field, s: bytes, shape, device):
        """The values of input s as a ``field.array`` of the given shape on
        ``device``. Over GF(2^d) the bound is a power of two at most 2^d,
        and the k-bit values are the elements (``bits_uint32``)."""
        if field.characteristic == 2:
            if not self.is_pow2 or self.max > field.order:
                raise ValueError('a PRF over GF(2^d) needs a power-of-two '
                                 'bound at most 2^d')
            vals = self.bits_uint32(s, shape, device)
            return field.array.from_data(vals.unsqueeze(-1))
        if not (self.max == field.modulus or self.is_pow2):
            raise ValueError('a PRF bound must be the modulus or a power '
                             'of two')
        ctx = prime_field_ctx(field.modulus)
        n = math.prod(shape)
        l = max(self.byte_length, 1)
        blocks = keccak.shake128_ctr_blocks(
            self.key + s, max(rng_mod.blocks_needed(n, l), 1), device)
        wide = rng_mod.words_to_elements(blocks, n, l, ctx.L)
        if self.is_pow2:
            wide = _mask_bits(wide, (self.max - 1).bit_length())
        mont = ctx.reduce_chunks(wide)
        return field.array.from_data(mont.reshape(tuple(shape) + (ctx.L,)))

    def host_integers(self, s: bytes, shape) -> np.ndarray:
        """The values of input s as plain integers below the bound, an
        object array of the given shape (``mpyc_tpu/thresha.py:315``):
        byte_length little-endian bytes a value from the sequential
        SHAKE128 stream of ``key || s`` (hashlib), each reduced mod the
        bound. No field enters, so the same integers embed into any field:
        the masks of a conversion from a secure field (``convert``)."""
        n = math.prod(shape) if shape else 1
        l = self.byte_length
        if n == 0 or l == 0:
            vals = [0] * n
        else:
            stream = hashlib.shake_128(self.key + s).digest(n * l)
            vals = [int.from_bytes(stream[i:i + l], 'little') % self.max
                    for i in range(0, n * l, l)]
        return np.array(vals, dtype=object).reshape(shape)

    def bits_uint32(self, s: bytes, shape, device) -> torch.Tensor:
        """The values of input s as raw k-bit values, k = log2(bound) <= 32,
        in an int32 tensor of the given shape (``mpyc_tpu/thresha.py:408``):
        ceil(k / 8) little-endian bytes a value, never straddling two
        blocks, masked to k bits."""
        k = (self.max - 1).bit_length()
        n = math.prod(shape)
        l = max(self.byte_length, 1)
        blocks = keccak.shake128_ctr_blocks(
            self.key + s, max(rng_mod.blocks_needed(n, l), 1), device)
        vals = rng_mod.words_to_elements(blocks, n, l, 1)[:, 0, 0]
        if k < 32:
            vals = vals & ((1 << k) - 1)
        return vals.reshape(tuple(shape))


def _mask_bits(wide: torch.Tensor, k: int) -> torch.Tensor:
    """(..., n_chunks, L) wide values masked to their low k bits
    (``mpyc_tpu/thresha.py:422``)."""
    flat = wide.reshape(wide.shape[:-2] + (-1,))
    w, rem = divmod(k, 32)
    cols = [flat[..., i] if i < w else flat[..., i] & ((1 << rem) - 1)
            if i == w else torch.zeros_like(flat[..., i])
            for i in range(flat.shape[-1])]
    return torch.stack(cols, dim=-1).reshape(wide.shape)
