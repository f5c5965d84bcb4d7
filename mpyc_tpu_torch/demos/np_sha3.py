"""Demo: batched SHA3 / SHAKE on secret-shared bits, on the port.

    python -m mpyc_tpu_torch.demos.np_sha3 [-b B] [-d D] [--shake]
        [--device cuda|cpu]

The co-located path of ``demos/np_sha3.py`` on ``SimRuntime(3)`` (t = 1),
line for line: b messages absorb, permute and squeeze at once in a
Keccak-f[1600] state of shape (b, 5, 5, 64) of secure bits. Theta, rho,
pi and iota are local (XORs and rolls); chi is one batched secure product
a round, which over ``SecFld(2)`` at m = 3 lives in GF(4) (GF(2) has no
three Shamir points): one fused reshare round, K1's stream and one launch
of K8 on the card, at (3, 2^k) elements, the state padded to its bucket.
Everything stays secret-shared; the digests are opened only for the
check against hashlib.

The round constants and rotation offsets are FIPS 202's (``ops/keccak``'s
``_RC``, ``_ROT``, as ``demos/sha3.py`` has them).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
import time

import numpy as np

from mpyc_tpu_torch.ops.keccak import _RC as RC, _ROT as ROT
from mpyc_tpu_torch.demos import parties


def bytes_to_bits(data: bytes) -> np.ndarray:
    """Bytes to an LSB-first bit array (FIPS 202's string to bits)."""
    return np.array([(b >> i) & 1 for b in data for i in range(8)],
                    dtype=object)


def bits_to_bytes(bits) -> bytes:
    """An LSB-first bit list or array back to bytes."""
    bits = [int(b) for b in np.asarray(bits, dtype=object).reshape(-1)]
    return bytes(sum(bits[i + j] << j for j in range(8))
                 for i in range(0, len(bits), 8))


def keccak_rounds_batch(mpc, secfld, A):
    """Keccak-f[1600] on a secure bit array A of shape (b, 5, 5, 64), axes
    (batch, x, y, z): 24 rounds, one secure product each (chi)."""
    for rnd in range(24):
        # theta: column parities, all the batch at once (sum over y)
        C = A.sum(axis=2)                              # (b, 5, 64)
        D = mpc.np_stack(
            [C[:, (x + 4) % 5] + mpc.np_roll(C[:, (x + 1) % 5], 1, axis=-1)
             for x in range(5)], axis=1)               # (b, 5, 64)
        A = A + mpc.np_reshape(D, D.shape[:2] + (1, 64))
        # rho + pi: fixed rotations and lane permutation (local)
        B_cols = [[None] * 5 for _ in range(5)]
        for x in range(5):
            for y in range(5):
                B_cols[y][(2 * x + 3 * y) % 5] = mpc.np_roll(
                    A[:, x, y], ROT[x][y], axis=-1)
        B = mpc.np_stack([mpc.np_stack(row, axis=1) for row in B_cols],
                         axis=1)
        # chi: one batched secure product of the whole state
        B1 = mpc.np_roll(B, -1, axis=1)
        B2 = mpc.np_roll(B, -2, axis=1)
        A = B + (B1 + 1) * B2
        # iota: the public round constant into lane (0, 0)
        rc = np.zeros((5, 5, 64), dtype=object)
        rc[0, 0] = [(RC[rnd] >> z) & 1 for z in range(64)]
        A = A + secfld.array(rc)
    return A


def keccak_f1600_batch(mpc, secfld, S):
    """Keccak-f[1600] on flat secure bit arrays S of shape (b, 1600)."""
    b = S.shape[0]
    A = mpc.np_transpose(mpc.np_reshape(S, (b, 5, 5, 64)), (0, 2, 1, 3))
    A = keccak_rounds_batch(mpc, secfld, A)
    return mpc.np_reshape(mpc.np_transpose(A, (0, 2, 1, 3)), (b, 1600))


def sponge_batch(mpc, secfld, r, N, d):
    """Sponge of rate r over a batch of equal-length bit arrays (b, n)."""
    b, n = N.shape
    pad = np.tile(np.array([1] + [0] * ((-(n + 2)) % r) + [1],
                           dtype=object), (b, 1))
    P = mpc.np_concatenate((N, secfld.array(pad)), axis=1)
    blocks = P.shape[1] // r

    # the first block XORs into the all-zero state directly
    cap0 = secfld.array(np.zeros((b, 1600 - r), dtype=object))
    S = keccak_f1600_batch(mpc, secfld,
                           mpc.np_concatenate((P[:, :r], cap0), axis=1))
    for i in range(1, blocks):
        U = P[:, i * r:(i + 1) * r] + S[:, :r]
        S = keccak_f1600_batch(mpc, secfld,
                               mpc.np_concatenate((U, S[:, r:]), axis=1))

    Z = S[:, :r]
    while Z.shape[1] < d:
        S = keccak_f1600_batch(mpc, secfld, S)
        Z = mpc.np_concatenate((Z, S[:, :r]), axis=1)
    return Z[:, :d]


def np_sha3(mpc, secfld, M, d=256, c=None):
    """SHA3-d over a batch of equal-length secure bit arrays (b, n)."""
    if c is None:
        c = 2 * d
    b = M.shape[0]
    dom = secfld.array(np.tile(np.array([0, 1], dtype=object), (b, 1)))
    return sponge_batch(mpc, secfld, 1600 - c,
                        mpc.np_concatenate((M, dom), axis=1), d)


def np_shake(mpc, secfld, M, d, c=256):
    """SHAKE[c / 2] over a batch of equal-length secure bit arrays."""
    b = M.shape[0]
    dom = secfld.array(np.tile(np.array([1, 1, 1, 1], dtype=object),
                               (b, 1)))
    return sponge_batch(mpc, secfld, 1600 - c,
                        mpc.np_concatenate((M, dom), axis=1), d)


def messages(b: int) -> list:
    """The demo's b messages."""
    return [f'message #{i:04d}'.encode() for i in range(b)]


def run(mpc, b: int, d: int = 256, shake: bool = False) -> dict:
    """Input b messages' bits, hash them (``np_sha3``, or SHAKE128 with
    ``shake``) and open the digests: the demo's main without its
    printing. Returns the name, the digests, hashlib's, the opened bits
    and the seconds of the hash and its opening (synchronized)."""
    secfld = mpc.SecFld(2)
    msgs = messages(b)
    bits = np.stack([bytes_to_bits(m) for m in msgs])   # (b, n)
    M = mpc.input(secfld.array(bits), senders=0)
    sync(mpc)
    t0 = time.perf_counter()
    if shake:
        digests = np_shake(mpc, secfld, M, d, c=256)
        name = 'SHAKE128'
        expect = [hashlib.shake_128(m).digest(d // 8) for m in msgs]
    else:
        digests = np_sha3(mpc, secfld, M, d)
        name = f'SHA3-{d}'
        expect = [getattr(hashlib, f'sha3_{d}')(m).digest() for m in msgs]
    opened = mpc.output(digests, raw=True).value
    sync(mpc)
    dt = time.perf_counter() - t0
    got = [bits_to_bytes(opened[i]) for i in range(b)]
    return dict(name=name, got=got, expect=expect, opened=opened, s=dt,
                digests=digests)


def sync(mpc) -> None:
    """Wait for the runtime's card (nothing on the CPU)."""
    if mpc.device.type == 'cuda':
        import torch
        torch.cuda.synchronize(mpc.device)


def card_label(device) -> str:
    """The card's name and power limit as nvidia-smi prints them (the
    device's name on the CPU)."""
    import torch
    if torch.device(device).type != 'cuda':
        return 'cpu'
    import subprocess
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=30).stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('-b', '--batch', type=int, metavar='B', default=8,
                        help='number of messages hashed at once (default 8)')
    parser.add_argument('-d', type=int, metavar='D', default=256,
                        help='digest length D in bits (default 256)')
    parser.add_argument('--shake', action='store_true',
                        help='SHAKE128 instead of SHA3')
    parser.add_argument('--bench', action='store_true',
                        help='one warm pass first, then one JSON line with '
                             'ms a digest')
    parser.add_argument('--device', default='cuda',
                        help='device of the shares (default: the card)')
    args = parties.parse_args(parser, argv)
    mpc = parties.runtime(args)
    mpc.start()
    b = args.batch
    if args.bench:
        run(mpc, b, args.d, args.shake)
    res = run(mpc, b, args.d, args.shake)
    ok = res['got'] == res['expect']
    if args.bench:
        print(json.dumps({'np_sha3_ms_per_digest': 1e3 * res['s'] / b,
                          'batch': b, 'ok': ok,
                          'card': card_label(mpc.device)}))
    else:
        print(f'{res["name"]} x{b} batch {"OK" if ok else "FAILED"} in '
              f'{res["s"]:.4f} s ({1e3 * res["s"] / b:.4f} ms a digest) on '
              f'{card_label(mpc.device)}')
        print('digest[0]:', res['got'][0].hex())
    mpc.shutdown()
    return 0 if ok else 1


if __name__ == '__main__':
    sys.exit(main())
