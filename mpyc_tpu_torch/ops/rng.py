"""Randomness: counter-mode SHAKE128 streams mapped into GF(p).

Port of the part of ``mpyc_tpu/ops/rng.py`` that the secure-multiplication
path uses. Draws follow the JAX package's conventions byte for byte, so a
``KeccakRNG`` loaded with the JAX generator's key and nonce yields the same
field elements:

* protocol randomness (``field_uniform``) takes byte_length(p-1) + 16
  bytes a value and reduces it mod p (statistical distance < 2^-128);
  draws that are not a whole number of words (SecInt(14)'s 22 bytes) are
  split out of the squeezed blocks byte by byte;
* fused reshare streams (``squeeze_mont``) take word-aligned draws of
  ``fused_draw_bytes(p)`` bytes (64-bit widening).
"""

from __future__ import annotations

import collections
import ctypes
import math
import secrets

import numpy as np
import torch

from mpyc_tpu_torch import resolve_device
from mpyc_tpu_torch.ops import keccak, limb
from mpyc_tpu_torch.ops.fieldops import prime_field_ctx

_WIDEN_BYTES = 16        # statistical widening of field_uniform draws
_WIDEN_BYTES_FUSED = 8   # widening of the fused reshare stream's draws


def fused_draw_bytes(p: int) -> int:
    """Word-aligned per-draw byte width for fused reshare streams."""
    b = ((p - 1).bit_length() + 7 >> 3) + _WIDEN_BYTES_FUSED
    return -(-b // 4) * 4


def blocks_needed(n: int, l: int) -> int:
    """168-byte blocks that n draws of l bytes consume (l <= 168: a draw
    never straddles two blocks)."""
    if l > keccak.RATE:
        return n * -(-l // keccak.RATE)
    return -(-n // (keccak.RATE // l))


def words_to_elements(blocks: torch.Tensor, n: int, l: int, L: int):
    """(n_blocks, 42) int32 words -> (n, n_chunks, L) wide values,
    n_chunks = ceil(ceil(l / 4) / L).

    A draw of l <= 168 bytes takes bytes (i % epb) l .. of block i // epb,
    epb = 168 // l, and never straddles two blocks (block tails are
    discarded); a larger draw owns ceil(l / 168) whole consecutive blocks.
    Each draw is read as little-endian words, its last word zero-padded
    (``mpyc_tpu/ops/rng.py`` ``words_to_elements``)."""
    W = -(-l // 4)
    n_chunks = -(-W // L)
    if l % 4 == 0 and l <= keccak.RATE:
        # whole words: draw i is words (i % epb) W .. of block i // epb,
        # with no dtype view, which torch.func.vmap may not batch
        # (pipelines._sgn_chunks_plain runs the comparison's draws so)
        usable = blocks[:, :keccak.RATE // l * W].reshape(-1, W)[:n]
    else:
        rows = blocks.contiguous().view(torch.uint8)
        if l > keccak.RATE:
            rows = rows.reshape(-1, -(-l // keccak.RATE) * keccak.RATE)
        else:
            rows = rows[:, :keccak.RATE // l * l].reshape(-1, l)
        rows = torch.nn.functional.pad(rows[:n, :l], (0, 4 * W - l))
        usable = rows.contiguous().view(torch.int32)
    pad_w = n_chunks * L - W
    if pad_w:
        usable = torch.nn.functional.pad(usable, (0, pad_w))
    return usable.reshape(n, n_chunks, L)


def _squeeze_mont_plain(state: torch.Tensor, n_draws: int, l_bytes: int,
                        p: int, ctr_lane: int = 19, base: int = 0):
    """Plain version of K2: squeeze, split into draws, reduce into GF(p)."""
    ctx = prime_field_ctx(p)
    n_blocks = max(blocks_needed(n_draws, l_bytes), 1)
    blocks = keccak._keccak_ctr_plain(state, n_blocks, ctr_lane, base)
    wide = words_to_elements(blocks, n_draws, l_bytes, ctx.L)
    chunks = [limb.unstack(wide[..., c, :]) for c in range(wide.shape[-2])]
    return limb.stack(limb.reduce_wide(chunks, ctx.radix_limbs(len(chunks)),
                                       ctx.p_limbs, ctx.n0inv))


def squeeze_mont(state: torch.Tensor, n_draws: int, l_bytes: int, p: int,
                 ctr_lane: int = 19, base: int = 0) -> torch.Tensor:
    """K2: (n_draws, L) uniform GF(p) draws in Montgomery form from the
    counter-mode stream of ``state`` (blocks base, base + 1, ...).

    Replaces ``mpyc_tpu/ops/rng.py:_squeeze_mont_kernel``. A CPU state takes
    the plain version; a CUDA state launches the kernel
    (``csrc/kernels.cu``, ``squeeze_mont_kernel``)."""
    if state.shape != (2, 25) or state.dtype != torch.int32:
        raise ValueError('state must be a (2, 25) int32 tensor')
    if l_bytes % 4 or l_bytes > keccak.RATE:
        raise ValueError('squeeze_mont takes word-aligned draws')
    if state.device.type == 'cpu':
        return _squeeze_mont_plain(state, n_draws, l_bytes, p, ctr_lane,
                                   base)
    from mpyc_tpu_torch import _build
    ctx = prime_field_ctx(p)
    W = l_bytes // 4
    params = _build.draw_params(ctx, -(-W // ctx.L))
    state = state.contiguous()
    out = torch.empty((n_draws, ctx.L), dtype=torch.int32,
                      device=state.device)
    if n_draws:
        _build.call('mtt_squeeze_mont', state.data_ptr(), out.data_ptr(),
                    n_draws, W, ctr_lane, base,
                    ctypes.addressof(params),
                    _build.stream_of(state.device))
        squeeze_mont.launches += 1
        squeeze_mont.by_key[(ctx.L, W)] += 1
    return out


squeeze_mont.launches = 0
squeeze_mont.by_key = collections.Counter()   # launches by (L, words)

_POOL_BLOCKS = 512    # pooled refill for small draws, as in the JAX package
_POOL_MAX_DRAW = 64   # draws of more blocks than this skip the pool


class KeccakRNG:
    """Counter-mode SHAKE128 generator with a session key and call nonce.

    Every draw is a set of distinct (key, nonce, counter) single-block
    sponge instances. Draws of up to ``_POOL_MAX_DRAW`` blocks come from a
    pooled refill of ``_POOL_BLOCKS`` blocks per nonce (K1 on the card), as
    in the JAX package. Larger draws take a nonce of their own; word-aligned
    ones of up to four chunks squeeze straight into the field (K2 on the
    card), the same
    elements as the JAX package's squeeze of the blocks followed by their
    reduction, and the others squeeze the blocks (K1) and split them. Not
    thread-safe: the pool offsets and nonce are updated without a lock.

    ``device``: where draws land (default: the card).
    """

    def __init__(self, key: bytes | None = None, device=None):
        self.key = key if key is not None else secrets.token_bytes(32)
        self.device = resolve_device(device)
        self._nonce = 0
        self._pool = None
        self._pool_off = 0
        self._byte_pool = None
        self._byte_off = 0

    def load(self, key: bytes, nonce: int) -> None:
        """Continue the stream of another generator (e.g. the JAX
        package's KeccakRNG ``key`` and ``_nonce``) from a clean point."""
        self.key = bytes(key)
        self._nonce = int(nonce)
        self._pool = self._byte_pool = None
        self._pool_off = self._byte_off = 0

    def _next_prefix(self) -> bytes:
        n = self._nonce
        self._nonce += 1
        return self.key + n.to_bytes(8, 'little')

    def _pool_blocks(self, n_blocks: int) -> torch.Tensor:
        """n_blocks (<= _POOL_MAX_DRAW) fresh 168-byte blocks from the pool
        on the device."""
        pool = self._pool
        if pool is None or self._pool_off + n_blocks > pool.shape[0]:
            pool = keccak.shake128_ctr_blocks(self._next_prefix(),
                                              _POOL_BLOCKS, self.device)
            self._pool = pool
            self._pool_off = 0
        off = self._pool_off
        self._pool_off = off + n_blocks
        return pool[off:off + n_blocks].clone()

    def _draw_blocks(self, n_blocks: int) -> torch.Tensor:
        """n_blocks fresh 168-byte blocks: from the pool up to
        ``_POOL_MAX_DRAW``, else under a nonce of their own
        (``mpyc_tpu/ops/rng.py`` ``KeccakRNG._draw_blocks``)."""
        if n_blocks <= _POOL_MAX_DRAW:
            return self._pool_blocks(n_blocks)
        return keccak.shake128_ctr_blocks(self._next_prefix(), n_blocks,
                                          self.device)

    def randbits(self, shape, k: int) -> torch.Tensor:
        """Uniform k-bit values (0 < k <= 32) in an int32 tensor of the
        given shape (``mpyc_tpu/ops/rng.py`` ``randbits_uint32``):
        ceil(k / 8) little-endian bytes a value, from the pooled host byte
        stream up to a quarter of a pool's bytes, else from fresh blocks
        (a value never straddling two)."""
        if not 0 < k <= 32:
            raise ValueError('randbits takes 1 to 32 bits')
        n = math.prod(shape)
        l = (k + 7) // 8
        if 0 < n * l <= _POOL_BLOCKS * keccak.RATE // 4:
            b = self._draw_host_bytes(n * l).reshape(n, l).astype(np.int64)
            host = np.zeros(n, np.int64)
            for j in range(l):
                host |= b[:, j] << (8 * j)
            host &= (1 << k) - 1
            vals = torch.from_numpy(host.astype(np.uint32).view(np.int32)
                                    .copy()).to(self.device)
        else:
            blocks = self._draw_blocks(max(blocks_needed(n, l), 1))
            vals = words_to_elements(blocks, n, l, 1)[:, 0, 0]
            if k < 32:
                vals = vals & ((1 << k) - 1)
        return vals.reshape(tuple(shape))

    def field_uniform(self, field, shape):
        """Uniform random ``field.array`` of the given shape: GF(p), or
        GF(2^d) as d random bits an element."""
        if field.characteristic == 2:
            bits = self.randbits(shape, field.ext_deg)
            return field.array.from_data(bits.unsqueeze(-1))
        p = field.modulus
        ctx = prime_field_ctx(p)
        n = math.prod(shape)
        l = (p - 1).bit_length() + 7 >> 3
        if p & (p - 1):
            l += _WIDEN_BYTES
        n_blocks = max(blocks_needed(n, l), 1)
        from mpyc_tpu_torch._build import SQUEEZE_BUILT
        # K2 is built for the (limbs, words) of the draws a path takes (a
        # one-limb field's 20-byte draws are five chunks, past its radix
        # table; a wide field's, e.g. 62 bytes at SecInt(335), are no
        # whole words): the others are squeezed by K1 and split
        if n_blocks > _POOL_MAX_DRAW and l % 4 == 0 and \
                l <= keccak.RATE and (ctx.L, l // 4) in SQUEEZE_BUILT:
            state, lane = keccak.ctr_state(self._next_prefix())
            mont = squeeze_mont(keccak.state_tensor(state, self.device), n,
                                l, p, ctr_lane=lane)
        else:
            if n_blocks <= _POOL_MAX_DRAW:
                blocks = self._pool_blocks(n_blocks)
            else:   # K2 takes word-aligned draws of up to 4 chunks only:
                    # squeeze, then split
                blocks = keccak.shake128_ctr_blocks(self._next_prefix(),
                                                    n_blocks, self.device)
            mont = ctx.reduce_chunks(words_to_elements(blocks, n, l, ctx.L))
        return field.array.from_data(
            mont.reshape(tuple(shape) + (ctx.L,)))

    def _draw_host_bytes(self, nbytes: int) -> np.ndarray:
        """nbytes of the SHAKE stream as a host uint8 array (pooled)."""
        pool = self._byte_pool
        if pool is None or self._byte_off + nbytes > pool.size:
            blocks = keccak.shake128_ctr_blocks(self._next_prefix(),
                                                _POOL_BLOCKS, 'cpu')
            self._byte_pool = pool = blocks.numpy().view(np.uint8).reshape(-1)
            self._byte_off = 0
        off = self._byte_off
        self._byte_off = off + nbytes
        return pool[off:off + nbytes]

    def field_uniform_mont_ints(self, ctx, n: int) -> np.ndarray:
        """n uniform GF(p) values as Montgomery-domain Python ints, from the
        pooled host byte stream (the JAX package's small-draw path)."""
        p, R = ctx.p, ctx.R
        l = ((p - 1).bit_length() + 7 >> 3) + _WIDEN_BYTES
        cap = max(_POOL_BLOCKS * keccak.RATE // (2 * l), 1)
        vals = np.empty(n, dtype=object)
        j0 = 0
        while j0 < n:
            k = min(n - j0, cap)
            raw = self._draw_host_bytes(k * l).tobytes()
            for j in range(k):
                vals[j0 + j] = int.from_bytes(raw[j * l:(j + 1) * l],
                                              'little')
            j0 += k
        return vals % p * R % p
