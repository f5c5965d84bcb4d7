"""Tutorial: ways to compute a prefix-or, ``mpctools.accumulate``
explained, on the port.

    python -m mpyc_tpu_torch.demos.PrefixOrExplained [-n N]
        [--device cuda|cpu]

The co-located path of ``demos/PrefixOrExplained.py`` on ``SimRuntime(3)``
(t = 1) at SecInt(32): five prefix-or circuits over secret bits, built
from one gate, a | b = a + b - a b (one secure product), each checked on
all 2^n bit vectors of length n (default 8) against
``itertools.accumulate``, with its depth (the longest chain of gates:
rounds) and its work (gates):

  variant                 depth          work
  1. chain (itertools)    n - 1          n - 1
  2. square-root blocks   ~2 sqrt(n)     ~2n
  3. Sklansky             ceil(log2 n)   (n/2) log2 n
  4. Brent-Kung           ~2 log2 n      ~2n
  5. mpctools.accumulate  picks 3 or 4 by a cost rule

The JAX tutorial runs each circuit once a bit vector; here the 2^n
vectors are the columns of one secure array a bit position, so a gate is
one batched product for all of them: the same gates, depth and work.
The runner exits 1 where a circuit's output differs.
"""

from __future__ import annotations

import argparse
import itertools
import sys
import time

import numpy as np

from mpyc_tpu_torch import mpctools
from mpyc_tpu_torch.demos import parties


class Gates:
    """The or-gate, counted: ``count`` gates since the last reset, and the
    depth of each result (by id: secure numbers have no attributes)."""

    def __init__(self):
        self.count = 0
        self.depths = {}

    def reset(self):
        self.count = 0
        self.depths.clear()

    def or2(self, a, b):
        self.count += 1
        c = a + b - a * b
        self.depths[id(c)] = max(self.depths.get(id(a), 0),
                                 self.depths.get(id(b), 0)) + 1
        return c


def variants(g: Gates) -> list:
    """The tutorial's five prefix-or circuits over the gate g.or2."""
    or2 = g.or2

    def chain(x):
        return list(itertools.accumulate(x, or2))

    def sqrt_blocks(x):
        n = len(x)
        s = max(1, round(n ** 0.5))
        blocks = [x[i:i + s] for i in range(0, n, s)]
        inner = [chain(b) for b in blocks]
        heads = chain([b[-1] for b in inner[:-1]])
        y = list(inner[0])
        for h, b in zip(heads, inner[1:]):
            y.extend(or2(h, v) for v in b)
        return y

    def sklansky(x):
        n = len(x)
        if n == 1:
            return list(x)
        h = (n + 1) // 2
        left, right = sklansky(x[:h]), sklansky(x[h:])
        return left + [or2(left[-1], v) for v in right]

    def brent_kung(x):
        n = len(x)
        if n == 1:
            return list(x)
        pairs = [or2(x[i], x[i + 1]) for i in range(0, n - 1, 2)]
        inner = brent_kung(pairs)
        y = [x[0]]
        for i in range(1, n):
            y.append(inner[i // 2] if i % 2 else or2(inner[i // 2 - 1], x[i]))
        return y

    def accumulate(x):
        return list(mpctools.accumulate(x, or2))

    return [('chain (itertools)  ', chain),
            ('square-root blocks ', sqrt_blocks),
            ('Sklansky           ', sklansky),
            ('Brent-Kung         ', brent_kung),
            ('accumulate()       ', accumulate)]


def measure(mpc, g: Gates, prefix_fn, n: int = 8) -> tuple:
    """(depth, work, ok) of prefix_fn on all 2^n bit vectors of length n
    at once: bit position i of every vector is one secure array."""
    secint = mpc.SecInt()
    vecs = np.array(list(itertools.product([0, 1], repeat=n)), np.int64)
    x = [mpc.input(secint.array(vecs[:, i]), senders=0) for i in range(n)]
    g.reset()
    y = prefix_fn(x)
    got = np.stack([np.asarray(mpc.output(v), np.int64) for v in y], -1)
    want = np.maximum.accumulate(vecs, axis=1)
    depth = max((g.depths.get(id(v), 0) for v in y), default=0)
    return depth, g.count, bool((got == want).all())


def run(mpc, n: int = 8, out=print) -> dict:
    """Every variant on all 2^n vectors: {'ok', 'rows': [(name, depth,
    work, ok, seconds)]}."""
    g = Gates()
    out(f'all variants checked on all {1 << n} bit vectors of length {n}:')
    rows = []
    for name, fn in variants(g):
        t0 = time.perf_counter()
        depth, work, ok = measure(mpc, g, fn, n)
        rows.append((name.strip(), depth, work, ok,
                     time.perf_counter() - t0))
        out(f'  {name} depth {depth:2d}   work {work:2d}'
            f'{"" if ok else "   FAILED"}')
    return {'ok': all(r[3] for r in rows), 'rows': rows}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('-n', type=int, default=8,
                        help='length of the bit vectors (default 8)')
    parser.add_argument('--device', default='cuda',
                        help='device of the shares (default: the card)')
    args = parties.parse_args(parser, argv)
    mpc = parties.runtime(args)
    mpc.run(mpc.start())
    res = run(mpc, args.n)
    mpc.run(mpc.shutdown())
    print(f'every prefix-or equal to itertools.accumulate\'s: {res["ok"]}')
    return 0 if res['ok'] else 1


if __name__ == '__main__':
    sys.exit(main())
