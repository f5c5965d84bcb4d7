"""GF(p) context: Montgomery constants, encode/decode and elementwise ops.

Port of the part of ``mpyc_tpu/ops/fieldops.py`` (``PrimeFieldCtx``) that
secure multiplication and comparison use. Field data are stored limb tensors:
``(..., L)`` int32 holding uint32 Montgomery limbs (R = 2^(32 L)), on the
CPU or the card. The ops here are plain PyTorch (``ops/limb.py``); the
JAX package runs them as XLA, not as Pallas kernels.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from mpyc_tpu_torch.ops import limb


@functools.cache
def prime_field_ctx(p: int) -> 'PrimeFieldCtx':
    return PrimeFieldCtx(p)


def limbs_from_numpy(arr, device) -> torch.Tensor:
    """(..., L) uint32 limb array (e.g. the JAX package's Montgomery data)
    -> stored int32 limb tensor on ``device``, bit for bit."""
    arr = np.ascontiguousarray(np.asarray(arr, dtype=np.uint32))
    return torch.from_numpy(arr.view(np.int32).copy()).to(device)


def limbs_to_numpy(t: torch.Tensor) -> np.ndarray:
    """Stored int32 limb tensor -> (..., L) uint32 numpy array, bit for bit."""
    return t.detach().cpu().contiguous().numpy().view(np.uint32)


class PrimeFieldCtx:
    """Montgomery context for GF(p), p an odd prime."""

    def __init__(self, p: int):
        if p <= 2 or p % 2 == 0:
            raise ValueError('PrimeFieldCtx requires an odd prime')
        self.p = p
        self.L = L = (p.bit_length() + 31) // 32
        self.R = R = 1 << (32 * L)
        self.R2 = R * R % p
        self.n0inv = (-pow(p, -1, 1 << 32)) % (1 << 32)
        self.p_limbs = limb.const_limbs(p, L)
        self.one_limbs = limb.const_limbs(1, L)
        self.one_mont = tuple(limb.const_limbs(R % p, L))
        self.r2_limbs = tuple(limb.const_limbs(self.R2, L))

    # -- host encode / decode ----------------------------------------------

    def _standard_limbs(self, xs) -> np.ndarray:
        """Values (int64/uint64/bool numpy, or ints) -> (..., L) uint32 limbs
        of x mod p in standard form; numeric arrays without a Python loop."""
        p, L = self.p, self.L
        arr = np.asarray(xs)
        if arr.dtype.kind in 'iub' and L <= 2:
            if arr.dtype.kind == 'i':
                neg = arr < 0
                u = arr.astype(np.int64).view(np.uint64) % np.uint64(p)
                # a negative x reads as 2^64 + x: subtract 2^64 mod p
                c = np.uint64((1 << 64) % p)
                with np.errstate(over='ignore'):   # unselected branches
                    u = np.where(neg & (u >= c), u - c,
                                 np.where(neg, u + (np.uint64(p) - c), u))
            else:
                u = arr.astype(np.uint64) % np.uint64(p)
            u = np.asarray(u, dtype=np.uint64)
            out = np.empty(u.shape + (L,), np.uint32)
            out[..., 0] = (u & np.uint64(limb.M32)).astype(np.uint32)
            if L == 2:
                out[..., 1] = (u >> np.uint64(32)).astype(np.uint32)
            return out
        vals = np.asarray(xs, dtype=object) % p
        return limb.ints_to_limbs(vals, L)

    def encode(self, xs, device) -> torch.Tensor:
        """Values -> Montgomery limb tensor on ``device``: limbs of x mod p
        are moved once, then multiplied by R^2 there."""
        std = limbs_from_numpy(self._standard_limbs(xs), device)
        return self.mul_limbs_const(std, self.R2)

    def to_standard(self, data: torch.Tensor) -> torch.Tensor:
        """Montgomery limbs -> standard-form limbs (x R^-1), same device."""
        return limb.stack(limb.mont_mul(limb.unstack(data), self.one_limbs,
                                        self.p_limbs, self.n0inv))

    def decode(self, data: torch.Tensor) -> np.ndarray:
        """Montgomery limb tensor -> values in [0, p): uint64 for L <= 2,
        else object ints."""
        std = limbs_to_numpy(self.to_standard(data))
        if self.L == 1:
            return std[..., 0].astype(np.uint64)
        if self.L == 2:
            return (std[..., 0].astype(np.uint64)
                    | (std[..., 1].astype(np.uint64) << np.uint64(32)))
        return limb.limbs_to_ints(std)

    def encode_const(self, x: int) -> tuple:
        """One int -> its Montgomery limbs as Python ints."""
        return tuple(limb.const_limbs(int(x) % self.p * self.R % self.p,
                                      self.L))

    # -- elementwise ops on stored limb tensors ------------------------------
    # add and sub also take a public constant for either operand, as the
    # tuple of its Montgomery limbs (encode_const); shapes broadcast.

    @staticmethod
    def _limbs(x) -> list:
        return list(x) if isinstance(x, tuple) else limb.unstack(x)

    def add(self, a, b):
        return limb.stack(limb.add_mod(self._limbs(a), self._limbs(b),
                                       self.p_limbs))

    def sub(self, a, b):
        return limb.stack(limb.sub_mod(self._limbs(a), self._limbs(b),
                                       self.p_limbs))

    def neg(self, a):
        return limb.stack(limb.neg_mod(limb.unstack(a), self.p_limbs))

    def is_zero(self, a) -> torch.Tensor:
        """Boolean tensor of the elements equal to 0."""
        return limb.iszero_ll(limb.unstack(a))

    def mul(self, a, b):
        return limb.stack(limb.mont_mul(limb.unstack(a), limb.unstack(b),
                                        self.p_limbs, self.n0inv))

    def mul_limbs_const(self, a, c: int):
        """Montgomery product of a with the constant whose limbs are c."""
        return limb.stack(limb.mont_mul(
            limb.unstack(a), limb.const_limbs(c % self.p, self.L),
            self.p_limbs, self.n0inv))

    def mul_int(self, a, x: int):
        """a * x for a public integer x (a in Montgomery form)."""
        return self.mul_limbs_const(a, int(x) % self.p * self.R)

    def radix_limbs(self, n_chunks: int) -> list:
        """Per chunk c the limbs of 2^(32 L c) R^2 mod p (reduce_wide)."""
        return [limb.const_limbs(pow(2, 32 * self.L * c, self.p) * self.R2
                                 % self.p, self.L)
                for c in range(n_chunks)]

    def reduce_chunks(self, wide: torch.Tensor) -> torch.Tensor:
        """(..., n_chunks, L) wide little-endian values -> Montgomery form of
        (value mod p), value = sum_c chunk_c 2^(32 L c)."""
        n_chunks = wide.shape[-2]
        chunks = [limb.unstack(wide[..., c, :]) for c in range(n_chunks)]
        return limb.stack(limb.reduce_wide(
            chunks, self.radix_limbs(n_chunks), self.p_limbs, self.n0inv))
