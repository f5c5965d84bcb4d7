#!/usr/bin/env python3
"""Time K6 (mont_pow) and K7 (random_bits_tail) of several checkouts of
the port in one run on one card, interleaved, to compare them.

    python3 tools/pow_ab.py LABEL=DIR [LABEL=DIR ...] [--rounds 3]

Each DIR is the root of a checkout (an unpacked ``git archive``); its own
``chip_smoke.py`` and ``mpyc_tpu_torch`` are imported in a process of its
own, which builds its kernels on first use. A round runs every checkout
once, the order reversed every other round (a, b, b, a, a, b for two).
Each run prints the device ms (CUDA events, the mean of 20 launches after
a warm-up) of K6 at the inverse square root's exponent (3p - 5) / 4 and
of K7, both on conv1's 15,052,800 random bits at SecFxp(14, 6)'s field
(``chip_smoke.FXP_BITS``), on random inputs from a fixed seed. With
``--six`` instead at SecFxp(96)'s six-limb field, on the random bits of
kb2's rank-1 update (69 x 42 products, 48 bits each: 139,104) and on
2^20 elements: the A/B of K6's and K7's elements a thread at six limbs
(``MTT_POW_EPT6`` in one checkout's csrc/pow.cuh against another's).
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys


def one(root: str, label: str, six: bool = False) -> None:
    """Time K6 and K7 with the checkout at root."""
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    os.chdir(root)
    import numpy as np
    import chip_smoke as c
    from mpyc_tpu_torch import finfields, sectypes
    from mpyc_tpu_torch.models import pipelines
    from mpyc_tpu_torch.ops import fieldops
    from mpyc_tpu_torch.ops.fieldops import prime_field_ctx
    l, f, sizes = (96, 48, (69 * 42 * 48, 1 << 20)) if six else \
        (c.FXP_L, c.FXP_F, (c.FXP_BITS,))
    p = sectypes.SecFxp(l, f, 'cuda').field.modulus
    ctx = prime_field_ctx(p)
    gen = np.random.default_rng(5)
    e = (3 * p - 5) // 4
    field = finfields.GF(p)
    for n in sizes:
        x = c.random_field(p, (n,), gen)
        k6 = c.cuda_ms(lambda: fieldops.mont_pow(x, e, ctx), 20)
        r, z = c.tail_shares(p, n, gen)
        k7 = c.cuda_ms(lambda: pipelines.random_bits_tail(r, z, field, False,
                                                          0), 20)
        print(f'{label}: L = {ctx.L}, {n} elements: K6 {k6:.4f} ms, K7 '
              f'{k7:.4f} ms', flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('trees', nargs='*', metavar='LABEL=DIR')
    parser.add_argument('--rounds', type=int, default=3)
    parser.add_argument('--six', action='store_true',
                        help='SecFxp(96)\'s six-limb field, kb2\'s sizes')
    parser.add_argument('--one', nargs=2, metavar=('DIR', 'LABEL'),
                        help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.one:
        one(*args.one, six=args.six)
        return 0
    if not args.trees:
        parser.error('name at least one LABEL=DIR')
    trees = [t.split('=', 1) for t in args.trees]
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=30).stdout.strip()
    print(smi, flush=True)
    rc = 0
    for k in range(args.rounds):
        for label, root in (trees if k % 2 == 0 else trees[::-1]):
            rc |= subprocess.run([sys.executable, os.path.abspath(__file__),
                                  '--one', root, label]
                                 + ['--six'] * args.six).returncode
    return rc


if __name__ == '__main__':
    sys.exit(main())
