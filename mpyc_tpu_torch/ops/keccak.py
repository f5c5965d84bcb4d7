"""Counter-mode SHAKE128 on the card, bit-exact with hashlib.

Port of ``mpyc_tpu/ops/keccak.py``. The counter-mode convention is the
JAX package's (``shake128_ctr_blocks``): instance j is the first
168-byte block of ``shake_128(prefix || pad8 || ctr_j)``, the prefix
zero-padded to an 8-byte boundary and followed by the 8-byte
little-endian counter. Every instance is one single-block sponge, so all
instances run in parallel: instance j XORs j into the message lane that
holds the counter, in one shared absorbed state.

Three paths give the same bits: hashlib per instance for small draws,
and for larger ones the kernel K1 (``keccak_ctr``) on the card or its
plain PyTorch version on the CPU.

A sponge state is a ``(2, 25)`` int32 tensor: row 0 the high and row 1
the low 32 bits of the 25 lanes, as the JAX package lays it out.
"""

from __future__ import annotations

from hashlib import shake_128

import numpy as np
import torch

RATE = 168  # shake128 rate in bytes: 21 lanes
N_LANES = 25

_RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]

# rho rotation offsets r[x][y] for lane x + 5y
_ROT = [
    [0, 36, 3, 41, 18],
    [1, 44, 10, 45, 2],
    [62, 6, 43, 15, 61],
    [28, 55, 25, 21, 56],
    [27, 20, 39, 8, 14],
]


def _signed64(v: int) -> int:
    """A 64-bit pattern as the int64 value torch stores for it."""
    return v - (1 << 64) if v >= 1 << 63 else v


def _tables():
    """Index tables for the vectorized permutation (lane index x + 5y)."""
    pi_src = [0] * 25
    rot = [0] * 25
    for x in range(5):
        for y in range(5):
            dst = y + 5 * ((2 * x + 3 * y) % 5)
            pi_src[dst] = x + 5 * y
            rot[dst] = _ROT[x][y]
    chi1 = [(k % 5 + 1) % 5 + 5 * (k // 5) for k in range(25)]
    chi2 = [(k % 5 + 2) % 5 + 5 * (k // 5) for k in range(25)]
    th1 = [(x + 1) % 5 for x in range(5)]
    th4 = [(x + 4) % 5 for x in range(5)]
    return pi_src, rot, chi1, chi2, th1, th4


_PI_SRC, _ROT_DST, _CHI1, _CHI2, _TH1, _TH4 = _tables()


def keccak_f(A: torch.Tensor) -> torch.Tensor:
    """Keccak-f[1600] on (n, 25) int64 lanes (the plain permutation).

    int64 shifts are arithmetic, so a right shift is masked to its low
    bits to act as a logical one."""
    dev = A.device
    idx = lambda v: torch.tensor(v, dtype=torch.int64, device=dev)  # noqa
    pi_src, chi1, chi2 = idx(_PI_SRC), idx(_CHI1), idx(_CHI2)
    th1, th4 = idx(_TH1), idx(_TH4)
    rotl = idx(_ROT_DST)
    rotr = idx([(64 - r) % 64 for r in _ROT_DST])
    rmask = idx([(1 << r) - 1 for r in _ROT_DST])    # 0 where r == 0
    for rc in _RC:
        C = A[:, 0:5] ^ A[:, 5:10] ^ A[:, 10:15] ^ A[:, 15:20] ^ A[:, 20:25]
        t = C[:, th1]
        D = C[:, th4] ^ ((t << 1) | ((t >> 63) & 1))
        A = A ^ D.repeat(1, 5)
        v = A[:, pi_src]
        B = (v << rotl) | ((v >> rotr) & rmask)
        A = B ^ (~B[:, chi1] & B[:, chi2])
        A[:, 0] ^= _signed64(rc)
    return A


def _pad_shake128(data: bytes) -> bytes:
    """Multi-rate padding for shake128 (domain 0x1F)."""
    q = RATE - (len(data) % RATE)
    pad = bytearray(q)
    pad[0] = 0x1F
    pad[-1] |= 0x80
    return data + bytes(pad)


def _absorb_host(data: bytes) -> np.ndarray:
    """Absorb padded input on the host -> (2, 25) uint32 state (hi; lo)."""
    padded = _pad_shake128(data)
    lanes = torch.zeros((1, 25), dtype=torch.int64)
    n_blocks = len(padded) // RATE
    for b in range(n_blocks):
        blk = np.frombuffer(padded[b * RATE:(b + 1) * RATE], '<u8')
        lanes[0, :RATE // 8] ^= torch.from_numpy(blk.view(np.int64).copy())
        if b < n_blocks - 1:
            lanes = keccak_f(lanes)
    u = lanes[0].numpy().view(np.uint64)
    return np.stack([(u >> np.uint64(32)).astype(np.uint32),
                     (u & np.uint64(0xFFFFFFFF)).astype(np.uint32)])


def state_tensor(state: np.ndarray, device) -> torch.Tensor:
    """(2, 25) uint32 host state -> the int32 state tensor on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(state, np.uint32)
                            .view(np.int32).copy()).to(device)


def ctr_state(prefix: bytes):
    """Absorbed state of ``prefix || pad8 || 0^8`` and the index of the lane
    that holds the counter."""
    if len(prefix) > 144:
        raise ValueError('prefix must leave room for the counter lane')
    ctr_off = -(-len(prefix) // 8) * 8
    msg0 = prefix + bytes(ctr_off - len(prefix)) + bytes(8)
    return _absorb_host(msg0), ctr_off // 8


def _lanes(state: torch.Tensor) -> torch.Tensor:
    """(2, 25) int32 state -> (25,) int64 lanes (hi << 32 | lo)."""
    s = state.to(torch.int64) & 0xFFFFFFFF
    return (s[0] << 32) | s[1]


def _rate_words(A: torch.Tensor) -> torch.Tensor:
    """(n, 25) int64 lanes -> (n, 42) int32 rate words [lo0, hi0, lo1, ...]."""
    rate = A[:, :RATE // 8]
    return torch.stack([rate & 0xFFFFFFFF, (rate >> 32) & 0xFFFFFFFF],
                       dim=-1).reshape(A.shape[0], RATE // 4).to(torch.int32)


def _keccak_ctr_plain(state: torch.Tensor, n: int, ctr_lane: int,
                      base: int = 0) -> torch.Tensor:
    """Plain version of K1: instances base..base+n-1 of the counter-mode
    squeeze, as (n, 42) int32 rate words, on the state's device."""
    A = _lanes(state).repeat(n, 1)
    A[:, ctr_lane] ^= torch.arange(base, base + n, dtype=torch.int64,
                                   device=state.device)
    return _rate_words(keccak_f(A))


def keccak_ctr(state: torch.Tensor, n: int, ctr_lane: int,
               base: int = 0) -> torch.Tensor:
    """K1: counter-mode SHAKE128 squeeze, n single-block sponges.

    Replaces ``mpyc_tpu/ops/keccak.py:_squeeze_ctr_pallas``. state: (2, 25)
    int32 absorbed state; returns (n, 42) int32 rate words on the state's
    device. A CPU state takes the plain version; a CUDA state launches the
    kernel (``csrc/kernels.cu``, ``keccak_ctr_kernel``: its CTA width
    follows n, and it writes the output, which torch allocates on a
    16-byte boundary, 16 bytes at a time)."""
    if state.shape != (2, 25) or state.dtype != torch.int32:
        raise ValueError('state must be a (2, 25) int32 tensor')
    if not 0 <= ctr_lane < RATE // 8:
        raise ValueError('counter lane outside the rate')
    if state.device.type == 'cpu':
        return _keccak_ctr_plain(state, n, ctr_lane, base)
    from mpyc_tpu_torch import _build
    state = state.contiguous()
    out = torch.empty((n, RATE // 4), dtype=torch.int32, device=state.device)
    if n:
        _build.call('mtt_keccak_ctr', state.data_ptr(), out.data_ptr(), n,
                    ctr_lane, base, _build.stream_of(state.device))
        keccak_ctr.launches += 1
    return out


keccak_ctr.launches = 0


def _squeeze_ctr_hashlib(msg0: bytes, n: int, ctr_off: int) -> np.ndarray:
    """Small-draw path: one hashlib call per instance -> (n, 42) uint32."""
    head, tail = msg0[:ctr_off], msg0[ctr_off + 8:]
    raw = b''.join(
        shake_128(head + j.to_bytes(8, 'little') + tail).digest(RATE)
        for j in range(n))
    return np.frombuffer(raw, '<u4').reshape(n, RATE // 4)


_HASHLIB_N = 256  # hashlib below this count, as in the JAX package


def shake128_ctr_blocks(prefix: bytes, n_instances: int,
                        device) -> torch.Tensor:
    """n_instances independent 168-byte SHAKE128 blocks, counter-separated:
    instance j equals ``shake_128(prefix || pad8 || ctr_j)``. Returns (n, 42)
    int32 words (uint32 bit patterns) on ``device``."""
    if 0 < n_instances <= _HASHLIB_N:
        ctr_off = -(-len(prefix) // 8) * 8
        msg0 = prefix + bytes(ctr_off - len(prefix)) + bytes(8)
        words = _squeeze_ctr_hashlib(msg0, int(n_instances), ctr_off)
        return torch.from_numpy(words.view(np.int32).copy()).to(device)
    state, lane = ctr_state(prefix)
    return keccak_ctr(state_tensor(state, device), int(n_instances), lane)
