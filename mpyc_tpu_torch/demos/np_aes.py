"""Demo: threshold AES, vectorized and batched, on the port.

    python -m mpyc_tpu_torch.demos.np_aes [-b BLOCKS] [-1]
        [--device cuda|cpu]

The co-located path of ``demos/np_aes.py`` on ``SimRuntime(3)`` (t = 1),
line for line: AES-128 and AES-256 over ``SecFld(2^8)`` (modulus
x^8 + x^4 + x^3 + x + 1) on a secure state of shape (b, 4, 4), b blocks
at once. Every S-box of a round is the secure power x^254 (AES's
addition chain: 11 secure products, each one fused reshare round, K1's
stream and one launch of K8 on the card) followed by a public GF(2)
affine map on the secure bits (``np_to_bits``: PRSS random bits, one
opening, the public bits extracted on the device); MixColumns is a public
4 x 4 circulant matrix product over GF(2^8). The key schedule runs the
same S-box on (4,) words.

Self-checks, the demo's own: FIPS-197 Appendix C.1 (AES-128) and C.3
(AES-256) on block 0, and every block decrypts back to its plaintext.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from mpyc_tpu_torch.demos.np_sha3 import card_label, sync
from mpyc_tpu_torch.demos import parties

C1_CT = '69c4e0d86a7b0430d8cdb78070b4c55a'   # FIPS-197 C.1
C3_CT = '8ea2b7ca516745bfeafc49904b496089'   # FIPS-197 C.3


class AES:
    """The demo's public constants on a runtime's device, and its
    functions (module-level in ``demos/np_aes.py``) on that runtime."""

    def __init__(self, mpc):
        self.mpc = mpc
        self.secfld = secfld = mpc.SecFld(2**8)
        self.f256 = f256 = secfld.field
        self.A = self.circulant([1, 0, 0, 0, 1, 1, 1, 1])  # S-box affine
        self.A1 = np.linalg.inv(self.A)
        self.B = f256.array([1, 1, 0, 0, 0, 1, 1, 0], mpc.device)   # 0x63
        self.C = self.circulant([2, 3, 1, 1])     # MixColumns
        self.C1 = np.linalg.inv(self.C)

    def circulant(self, r):
        """Circulant GF(2^8) matrix with first row r."""
        r = np.array(r, dtype=object)
        return self.f256.array(np.stack([np.roll(r, j)
                                         for j in range(len(r))]),
                               self.mpc.device)

    def sbox(self, x):
        """AES S-box on every entry of secure array x at once."""
        mpc = self.mpc
        b = mpc.np_to_bits(x**254)
        b = (self.A @ b[..., np.newaxis]).reshape(*b.shape) + self.B
        return mpc.np_from_bits(b)

    def sbox1(self, x):
        """AES inverse S-box on every entry of secure array x at once."""
        mpc = self.mpc
        b = mpc.np_to_bits(x) + self.B
        b = (self.A1 @ b[..., np.newaxis]).reshape(*b.shape)
        return mpc.np_from_bits(b)**254

    def key_expansion(self, k):
        """Key schedule for AES-128 (k: (4, 4)) or AES-256 (k: (4, 8))."""
        mpc, f256 = self.mpc, self.f256
        w = k
        Nk = k.shape[1]
        Nr = 10 if Nk == 4 else 14
        for i in range(Nk, 4 * (Nr + 1)):
            t = w[:, -1]
            if i % Nk in (0, 4):
                t = self.sbox(t)
            if i % Nk == 0:
                t = np.roll(t, -1, axis=0)
                t = mpc.np_update(t, 0, t[0] + (f256(1) << i // Nk - 1))
            t = t + w[:, -Nk]
            w = np.append(w, t.reshape(4, 1), axis=1)
        return np.hsplit(w, Nr + 1)

    @staticmethod
    def shift_rows(s, inverse=False):
        """(Inverse) ShiftRows on batched state s of shape (b, 4, 4)."""
        sign = 1 if inverse else -1
        return np.stack([np.roll(s[:, j], sign * j, axis=-1)
                         for j in range(4)], axis=1)

    def encrypt(self, K, s):
        """AES encryption of batched states s (b, 4, 4) under key schedule
        K."""
        Nr = len(K) - 1
        s = s + K[0]
        for i in range(1, Nr + 1):
            s = self.sbox(s)
            s = self.shift_rows(s)
            if i < Nr:
                s = self.C @ s
            s = s + K[i]
        return s

    def decrypt(self, K, s):
        """AES decryption of batched states s (b, 4, 4) under key schedule
        K."""
        Nr = len(K) - 1
        for i in range(Nr, 0, -1):
            s = s + K[i]
            if i < Nr:
                s = self.C1 @ s
            s = self.shift_rows(s, inverse=True)
            s = self.sbox1(s)
        return s + K[0]

    def open_hex(self, s):
        out = self.mpc.output(s, raw=True)
        return [bytes(b).hex() for b in from_states(out.value)]


def to_states(blocks):
    """List of 16-byte blocks -> (b, 4, 4) column-major state array."""
    a = np.array(blocks, dtype=object).reshape(len(blocks), 4, 4)
    return np.swapaxes(a, 1, 2)


def from_states(a):
    """(b, 4, 4) state array -> list of 16-byte lists."""
    a = np.swapaxes(np.asarray(a, dtype=object), 1, 2)
    return [[int(v) for v in blk.reshape(-1)] for blk in a]


def plaintexts(nb: int) -> list:
    """FIPS-197 appendix C's plaintext 00112233445566778899aabbccddeeff,
    batched: block j is it with every byte XORed by j mod 256 (block 0 the
    test vector)."""
    base_pt = list(bytes.fromhex('00112233445566778899aabbccddeeff'))
    return [[v ^ (j & 0xFF) for v in base_pt] for j in range(nb)]


def run(mpc, nb: int, only128: bool = False) -> dict:
    """The demo's main without its printing: input the plaintexts and the
    keys, AES-128 (and unless ``only128`` its decryption and AES-256 both
    ways), each stage opened and timed (seconds, synchronized), the
    checks as booleans."""
    aes = AES(mpc)
    secfld, f256 = aes.secfld, aes.f256
    pts = plaintexts(nb)
    want = [bytes(b).hex() for b in pts]
    p = mpc.input(secfld.array(f256.array(to_states(pts), mpc.device)),
                  senders=0)
    k128 = mpc.input(secfld.array(f256.array(
        to_states([list(range(16))])[0], mpc.device)), senders=0)
    mpc.barrier()
    res = {}
    sync(mpc)
    t0 = time.perf_counter()
    K = aes.key_expansion(k128)
    c = aes.encrypt(K, p)
    cts = aes.open_hex(c)
    res['aes128_s'] = _lap(mpc, t0)
    res['aes128_ct0'] = cts[0]
    res['aes128_ok'] = cts[0] == C1_CT
    if only128:
        return res
    t0 = time.perf_counter()
    p2 = aes.decrypt(K, c)
    pts2 = aes.open_hex(p2)
    res['aes128_dec_s'] = _lap(mpc, t0)
    res['aes128_dec_ok'] = pts2 == want
    k256 = mpc.input(secfld.array(f256.array(
        np.swapaxes(np.array(list(range(32)), dtype=object).reshape(8, 4),
                    0, 1), mpc.device)), senders=0)
    t0 = time.perf_counter()
    K = aes.key_expansion(k256)
    c = aes.encrypt(K, p)
    cts = aes.open_hex(c)
    res['aes256_s'] = _lap(mpc, t0)
    res['aes256_ct0'] = cts[0]
    res['aes256_ok'] = cts[0] == C3_CT
    t0 = time.perf_counter()
    p2 = aes.decrypt(K, c)
    res['aes256_dec_ok'] = aes.open_hex(p2) == want
    res['aes256_dec_s'] = _lap(mpc, t0)
    return res


def _lap(mpc, t0: float) -> float:
    sync(mpc)
    return time.perf_counter() - t0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('-b', '--blocks', type=int, default=1,
                        help='number of blocks en/decrypted in one batch')
    parser.add_argument('-1', dest='only128', action='store_true',
                        help='AES-128 encryption only')
    parser.add_argument('--device', default='cuda',
                        help='device of the shares (default: the card)')
    args = parties.parse_args(parser, argv)
    mpc = parties.runtime(args)
    mpc.start()
    nb = max(1, args.blocks)
    res = run(mpc, nb, args.only128)
    card = card_label(mpc.device)
    print(f'AES-128 x{nb} blocks in {res["aes128_s"]:.4f} s '
          f'({1e3 * res["aes128_s"] / nb:.4f} ms a block) on {card}')
    print('AES-128 ciphertext:', res['aes128_ct0'])
    ok = res['aes128_ok']
    if not args.only128:
        print(f'AES-128 decrypt x{nb} in {res["aes128_dec_s"]:.4f} s: '
              f'{"OK" if res["aes128_dec_ok"] else "FAILED"}')
        print(f'AES-256 x{nb} blocks in {res["aes256_s"]:.4f} s '
              f'({1e3 * res["aes256_s"] / nb:.4f} ms a block) on {card}')
        print('AES-256 ciphertext:', res['aes256_ct0'])
        print(f'AES-256 decrypt x{nb} in {res["aes256_dec_s"]:.4f} s: '
              f'{"OK" if res["aes256_dec_ok"] else "FAILED"}')
        ok = ok and res['aes128_dec_ok'] and res['aes256_ok'] and \
            res['aes256_dec_ok']
    mpc.shutdown()
    return 0 if ok else 1


if __name__ == '__main__':
    sys.exit(main())
