"""Demo: Secret Santa, a jointly drawn random derangement, on the port.

    python -m mpyc_tpu_torch.demos.secretsanta [-n N] [--trials T]
        [--device cuda|cpu]

The co-located path of ``demos/secretsanta.py`` on ``SimRuntime(3)``
(t = 1): three times, a uniformly random secret derangement of 0..n-1
(default n = 5) at SecInt(32) (``random.random_derangement``: oblivious
Fisher-Yates permutations, each drawn again while one public zero test
of the product of its differences from the identity finds a fixed
point), opened. Each result is checked to be a derangement (a
permutation with no fixed point); the runner exits 1 otherwise.
"""

from __future__ import annotations

import argparse
import sys
import time

from mpyc_tpu_torch import random
from mpyc_tpu_torch.demos import parties


def is_derangement(p: list) -> bool:
    """Whether p is a permutation of 0..n-1 with p[i] != i for all i."""
    return sorted(p) == list(range(len(p))) and \
        all(v != i for i, v in enumerate(p))


def run(mpc, n: int = 5, trials: int = 3, out=print) -> dict:
    """``trials`` derangements of n at SecInt(32), opened and checked:
    {'ok', 'draws' (the opened derangements), 's' (seconds each)}."""
    secint = mpc.SecInt()
    draws, secs = [], []
    for _ in range(trials):
        t0 = time.perf_counter()
        der = random.random_derangement(secint, n)
        got = [int(v) for v in mpc.output(der)]
        secs.append(time.perf_counter() - t0)
        ok = is_derangement(got)
        out(f'derangement {got if n <= 16 else "(n = %d)" % n} '
            f'{"OK" if ok else "FAILED"}')
        draws.append(got)
    return {'ok': all(map(is_derangement, draws)), 'draws': draws,
            's': secs}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('-n', type=int, default=5,
                        help='number of participants (default 5)')
    parser.add_argument('--trials', type=int, default=3,
                        help='derangements drawn (default 3)')
    parser.add_argument('--device', default='cuda',
                        help='device of the shares (default: the card)')
    args = parties.parse_args(parser, argv)
    mpc = parties.runtime(args)
    mpc.run(mpc.start())
    res = run(mpc, args.n, args.trials)
    mpc.run(mpc.shutdown())
    print(f'every draw a derangement: {res["ok"]}')
    return 0 if res['ok'] else 1


if __name__ == '__main__':
    sys.exit(main())
