"""Tutorial: Secret Santa built up from first principles, on the port.

    python -m mpyc_tpu_torch.demos.SecretSantaExplained [-n N]
        [--device cuda|cpu]

The co-located path of ``demos/SecretSantaExplained.py`` on
``SimRuntime(3)`` (t = 1) at SecInt(32), its three layers as the JAX
tutorial writes them:

1. ``random_unit_vector(n)``: a secret unit vector from secret random
   bits (``Runtime.random_bit``), one bit a level of a recursion that
   halves n; for odd n one outcome is dropped by opening z[0], the only
   thing revealed;
2. ``random_permutation(n)``: an oblivious Fisher-Yates, position i
   swapped with a random position >= i by a unit vector (one inner
   product and one scalar product a step);
3. ``random_derangement(n)``: permutations drawn until one public zero
   test of prod(p(i) - i) says it has no fixed point (about e draws).

Stage 1 draws 20 unit vectors of length n (default 5), stage 2 five
permutations, stage 3 five derangements; each result is checked (one 1
among 0s; a permutation; a derangement), and the runner exits 1 where
one fails.
"""

from __future__ import annotations

import argparse
import math
import sys
from collections import Counter

from mpyc_tpu_torch.demos import parties


class Tutorial:
    """The tutorial's three layers over one runtime's SecInt(32)."""

    def __init__(self, mpc):
        self.mpc = mpc
        self.secint = mpc.SecInt()

    def random_unit_vector(self, n: int) -> list:
        """A secret unit vector of length n: a random bit b picks the
        high or low copy of a vector of length ceil(n / 2); odd n drops
        the outcome b = 1, x[0] = 1 (opened: the rejection event)."""
        mpc, secint = self.mpc, self.secint
        if n == 1:
            return [secint(1)]
        b = mpc.random_bit(secint)
        x = self.random_unit_vector((n + 1) // 2)
        z = mpc.scalar_mul(b, x)
        if n % 2 == 0:
            return z + mpc.vector_sub(x, z)
        if mpc.output(z[0]):
            return self.random_unit_vector(n)
        return z[1:] + mpc.vector_sub(x, z)

    def random_permutation(self, n: int) -> list:
        """An oblivious Fisher-Yates: x[i] takes <x[i:], u> and the value
        moving out goes to the slot u selects."""
        mpc, secint = self.mpc, self.secint
        x = [secint(i) for i in range(n)]
        for i in range(n - 1):
            u = self.random_unit_vector(n - i)
            x_u = mpc.in_prod(x[i:], u)
            d = mpc.scalar_mul(x[i] - x_u, u)
            x[i] = x_u
            for j in range(n - i):
                x[i + j] = x[i + j] + d[j]
        return x

    def random_derangement(self, n: int, stats=None) -> list:
        """Permutations until prod(p(i) - i) is not 0, by a public zero
        test."""
        mpc = self.mpc
        while True:
            p = self.random_permutation(n)
            t = mpc.prod([p[i] - i for i in range(n)])
            if stats is not None:
                stats['trials'] += 1
            if not mpc.is_zero_public(t):
                return p


def run(mpc, n: int = 5, units: int = 20, perms: int = 5, ders: int = 5,
        out=print) -> dict:
    """The tutorial's three stages, every result checked: {'ok',
    'trials' (permutations drawn for the derangements)}."""
    tut = Tutorial(mpc)
    ok = True
    out(f'stage 1: random unit vectors of length {n}')
    hist = Counter()
    for _ in range(units):
        vals = [int(v) for v in mpc.output(tut.random_unit_vector(n))]
        good = sum(vals) == 1 and all(v in (0, 1) for v in vals)
        ok = ok and good
        if good:
            hist[vals.index(1)] += 1
    out(f'  {units} draws, position histogram: {dict(sorted(hist.items()))}')
    out('stage 2: random permutations')
    vals = []
    for _ in range(perms):
        vals = [int(v) for v in mpc.output(tut.random_permutation(n))]
        ok = ok and sorted(vals) == list(range(n))
    out(f'  {perms} draws, all valid permutations: {ok}, last: {vals}')
    out('stage 3: random derangements (Secret Santa)')
    stats = {'trials': 0}
    for _ in range(ders):
        vals = [int(v) for v in mpc.output(tut.random_derangement(n, stats))]
        ok = ok and sorted(vals) == list(range(n)) and \
            all(v != i for i, v in enumerate(vals))
        out(f'   {vals}')
    out(f'  {stats["trials"]} permutations drawn for {ders} derangements '
        f'(expected ratio ~e = {math.e:.2f})')
    return {'ok': ok, 'trials': stats['trials']}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('-n', type=int, default=5,
                        help='number of Secret Santa participants')
    parser.add_argument('--device', default='cuda',
                        help='device of the shares (default: the card)')
    args = parties.parse_args(parser, argv)
    mpc = parties.runtime(args)
    mpc.run(mpc.start())
    res = run(mpc, args.n)
    mpc.run(mpc.shutdown())
    print(f'every stage checked: {res["ok"]}')
    return 0 if res['ok'] else 1


if __name__ == '__main__':
    sys.exit(main())
