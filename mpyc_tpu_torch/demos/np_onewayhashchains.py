"""Demo: threshold one-way hash chains, vectorized, on the port.

    python -m mpyc_tpu_torch.demos.np_onewayhashchains [-k K] [--eager]
        [--sha3] [--no-one-way] [--no-random-seed] [--device cuda|cpu]

The co-located path of ``demos/np_onewayhashchains.py`` on
``SimRuntime(3)`` (t = 1), line for line. The one-way function is, by
default, Matyas-Meyer-Oseas over threshold AES: f(x) = AES_K(x) + x on one
secure (4, 4) state over GF(2^8), K the IV of threes (the port's AES
runner, ``np_aes.AES``: secure powers x^254 and bits, K8 on the card);
with --sha3 it is f(x) = SHAKE128(x, 128) on 128 secure bits (the port's
SHA3 runner, ``np_sha3.np_shake``: 24 batched secure products a hash over
GF(4)). The seed x0 is 128 random secret bits (``np_random_bits``; over
GF(2^8) packed into bytes by ``np_from_bits``), or with --no-random-seed
the IV of threes. The chain x0, f(x0), ..., f^(n-1)(x0) of length
n = 2^k is built forward and revealed in reverse by binary pebbling
(``pebbling.reverse_chain``, at most ceil(k / 2) hashes an output round,
or with --eager the speed-1 schedule), k 2^(k-1) hashes in all.

Self-check: x0 is opened and the plain chain computed from it (a plain
AES-128, FIPS-197, in this module; ``hashlib.shake_128``); every
revealed value must equal it, else the runner exits 1.
"""

from __future__ import annotations

import argparse
import hashlib
import sys
import time

import numpy as np

from mpyc_tpu_torch.demos import pebbling
from mpyc_tpu_torch.demos.np_aes import AES
from mpyc_tpu_torch.demos.np_sha3 import (bits_to_bytes, bytes_to_bits,
                                          card_label, np_shake, sync)
from mpyc_tpu_torch.demos import parties


# -- a plain AES-128 (FIPS-197) and the plain one-way functions ---------------

def _xtime(a: int) -> int:
    return ((a << 1) ^ 0x11B) & 0xFF if a & 0x80 else a << 1


def _gmul(a: int, b: int) -> int:
    """Product in GF(2^8) modulo x^8 + x^4 + x^3 + x + 1."""
    r = 0
    while b:
        if b & 1:
            r ^= a
        a, b = _xtime(a), b >> 1
    return r


def _sbox_table() -> list:
    """FIPS-197's S-box: the inverse (0 to 0), then the affine map."""
    inv = [0] * 256
    for a in range(1, 256):
        inv[a] = next(b for b in range(1, 256) if _gmul(a, b) == 1)
    out = []
    for a in inv:
        s = a
        for i in range(1, 5):
            s ^= ((a << i) | (a >> (8 - i))) & 0xFF
        out.append(s ^ 0x63)
    return out


_SBOX = _sbox_table()


def plain_aes128(key: bytes, block: bytes) -> bytes:
    """AES-128 encryption of one 16-byte block (FIPS-197, the state
    column-major: byte 4 c + r at row r, column c)."""
    w = [list(key[4 * i:4 * i + 4]) for i in range(4)]
    rcon = 1
    for i in range(4, 44):
        t = list(w[-1])
        if i % 4 == 0:
            t = [_SBOX[v] for v in t[1:] + t[:1]]
            t[0] ^= rcon
            rcon = _xtime(rcon)
        w.append([a ^ b for a, b in zip(w[-4], t)])
    s = [b ^ k for b, k in zip(block, sum(w[0:4], []))]
    for rnd in range(1, 11):
        s = [_SBOX[v] for v in s]
        s = [s[(4 * (c + r) + r) % 16] for c in range(4) for r in range(4)]
        if rnd < 10:
            cols = [s[4 * c:4 * c + 4] for c in range(4)]
            s = [_gmul(col[r], 2) ^ _gmul(col[(r + 1) % 4], 3)
                 ^ col[(r + 2) % 4] ^ col[(r + 3) % 4]
                 for col in cols for r in range(4)]
        s = [b ^ k for b, k in zip(s, sum(w[4 * rnd:4 * rnd + 4], []))]
    return bytes(s)


def plain_f(sha3: bool, one_way: bool):
    """The runner's one-way function on the value's bytes, as its secure
    counterpart prints them: AES-128 under the key of threes plus x;
    SHAKE128 to 128 bits; or the dummy functions of --no-one-way."""
    if sha3:
        if one_way:
            return lambda x: hashlib.shake_128(x).digest(16)
        # np.roll of the 128 bits by one
        return lambda x: bits_to_bytes(np.roll(np.array(
            list(bytes_to_bits(x)), dtype=object), 1))
    if one_way:
        key = bytes([3] * 16)
        return lambda x: bytes(a ^ b for a, b in
                               zip(plain_aes128(key, x), x))

    def roll3(x):
        # rows rolled by one (axis 0 of the state), each byte times 3
        s = [[_gmul(x[4 * c + r], 3) for c in range(4)] for r in range(4)]
        s = s[-1:] + s[:-1]
        return bytes(s[r][c] for c in range(4) for r in range(4))
    return roll3


# -- the secure chain ----------------------------------------------------------

class Chain:
    """The demo's secure one-way function, seed and opening on a
    runtime: an AES state is (1, 4, 4) (a batch of one, as the port's AES
    runner takes it), a SHA3 value (1, 128) bits."""

    def __init__(self, mpc, sha3=False, one_way=True):
        self.mpc, self.sha3, self.one_way = mpc, sha3, one_way
        if sha3:
            self.secfld = mpc.SecFld(2)
        else:
            self.aes = AES(mpc)
            self.secfld = self.aes.secfld
            if one_way:
                iv = mpc.np_fromlist([self.secfld(3)] * 16).reshape(1, 4, 4)
                self.round_keys = self.aes.key_expansion(iv[0])

    def f(self, x):
        mpc = self.mpc
        if not self.one_way:
            if self.sha3:
                return np.roll(x, 1)
            return mpc.np_roll(x * 3, 1, axis=1)
        if self.sha3:
            return np_shake(mpc, self.secfld, x, 128)
        return self.aes.encrypt(self.round_keys, x) + x

    def seed(self, random_seed=True):
        """128 jointly random secret bits, or the IV of threes."""
        mpc, secfld = self.mpc, self.secfld
        if not random_seed:
            if self.sha3:
                bits = bytes_to_bits(bytes([3] * 16)).reshape(1, 128)
                return mpc.input(secfld.array(bits), senders=0)
            return mpc.np_fromlist([secfld(3)] * 16).reshape(1, 4, 4)
        bits = mpc.np_random_bits(secfld, 128)
        if self.sha3:
            return bits.reshape(1, 128)
        return mpc.np_from_bits(bits.reshape(4, 4, 8)).reshape(1, 4, 4)

    def open_bytes(self, x) -> bytes:
        """The value opened, as the demo prints it (hex of these bytes)."""
        out = self.mpc.output(x, raw=True).value
        if self.sha3:
            return bits_to_bytes(np.asarray(out, dtype=object).reshape(-1))
        return bytes(int(v) for v in np.asarray(out)[0].T.reshape(-1))


def run(mpc, k=1, eager=False, sha3=False, one_way=True, random_seed=True,
        out=print) -> dict:
    """The demo's main: build the chain of length 2^k and reveal it in
    reverse, printing its lines through ``out``; then hold every revealed
    value against the plain chain from the opened x0. Returns the hash
    count, the round peak, the seconds of the reversal and ``ok``."""
    chain = Chain(mpc, sha3, one_way)
    x0 = chain.seed(random_seed)
    n = 1 << k
    make = pebbling.reverse_chain_eager if eager else pebbling.reverse_chain
    out(f'Hash chain of length {n}:')
    revealed = []
    sync(mpc)
    t0 = time.perf_counter()
    reversal = make(k, x0, chain.f)
    for rnd, value in enumerate(reversal, start=1):
        if value is None:
            out(f'{rnd:4} -')
        else:
            v = chain.open_bytes(value)
            revealed.append(v)
            out(f'{rnd:4} x{2 * n - 1 - rnd:<4} = {v.hex()}')
    sync(mpc)
    seconds = time.perf_counter() - t0
    stats = reversal.stats
    out(f'Performed {stats.total} hashes in total '
        f'(peak {stats.round_peak} in one round).')
    f = plain_f(sha3, one_way)
    plain = [chain.open_bytes(x0)]
    for _ in range(n - 1):
        plain.append(f(plain[-1]))
    ok = revealed == plain[::-1]
    return dict(hashes=stats.total, peak=stats.round_peak, s=seconds, ok=ok)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('-k', '--order', type=int, metavar='K', default=1,
                        help='order K of the hash chain, length n = 2**K')
    parser.add_argument('--eager', '--recursive', action='store_true',
                        dest='eager',
                        help='use the simple speed-1 pebbling schedule')
    parser.add_argument('--sha3', action='store_true',
                        help='use SHAKE128 as one-way function')
    parser.add_argument('--no-one-way', action='store_true',
                        help='use a dummy one-way function')
    parser.add_argument('--no-random-seed', action='store_true',
                        help='use a fixed seed')
    parser.add_argument('--device', default='cuda',
                        help='device of the shares (default: the card)')
    args = parties.parse_args(parser, argv)
    mpc = parties.runtime(args)
    mpc.run(mpc.start())
    res = run(mpc, args.order, args.eager, args.sha3, not args.no_one_way,
              not args.no_random_seed)
    mpc.run(mpc.shutdown())
    print(f'{res["s"] / max(res["hashes"], 1):.4f} s a hash on '
          f'{card_label(mpc.device)}; every value equal to the plain '
          f'chain\'s: {res["ok"]}')
    return 0 if res['ok'] else 1


if __name__ == '__main__':
    sys.exit(main())
