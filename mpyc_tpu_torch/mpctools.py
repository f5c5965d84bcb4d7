"""Low-depth alternatives to itertools/functools patterns: ``reduce`` and
``accumulate`` as logarithmic-depth trees and prefix networks.

The port's own copy of ``mpyc_tpu/mpctools.py`` (which it does not
import): Sklansky's network takes the fewest rounds (ceil(log2 n)),
Brent-Kung's the fewest applications of f (about 2n, in about 2 log2 n
rounds). Both are written as span-doubling passes over the list, the
same schedules of f as the recursive forms, with flat Python recursion.
f may be any associative function; on secure numbers each application is
usually one secure product, one round.
"""

from __future__ import annotations

import operator


class _NoValue:
    """Sentinel distinct from every value, None included."""

    def __repr__(self):
        return '<no value>'


_no_value = _NoValue()


def _seeded(x, initial) -> list:
    """x as a list, led by the initial value if one is given."""
    seq = [] if initial is _no_value else [initial]
    seq.extend(x)
    return seq


def reduce(f, x, initial=_no_value):
    """x reduced by an associative f in a tree of log depth
    (``mpyc_tpu/mpctools.py:36``): neighbours paired level by level, the
    leftmost one carried over on an odd level, so that the operands keep
    their order for a non-commutative f."""
    x = _seeded(x, initial)
    if not x:
        raise TypeError('reduce() of empty sequence with no initial value')
    while len(x) > 1:
        odd = len(x) % 2
        x = x[:odd] + [f(x[i], x[i + 1]) for i in range(odd, len(x) - 1, 2)]
    return x[0]


def _interactive(x) -> bool:
    """Whether the random values of x's runtime come from interaction (a
    runtime without PRSS, ``no_prss``), where multiplications are the
    scarcer resource. The co-located plane draws PRSS values: never."""
    for v in x:
        rt = getattr(v, 'runtime', None)
        if rt is not None:
            return bool(getattr(rt, 'no_prss', False))
    return False


def accumulate(x, f=operator.add, initial=_no_value, method=None):
    """The prefixes of x under an associative f, in log depth
    (``mpyc_tpu/mpctools.py:53``), as an iterator. ``method``
    'Sklansky' (depth ceil(log2 n), (n / 2) log2 n applications) or
    'Brent-Kung' (about 2 log2 n rounds, about 2n applications); by
    default the JAX package's cost rule (``mpyc_tpu/mpctools.py:65``):
    Brent-Kung where randomness is interactive and n >= 32, else
    Sklansky."""
    x = _seeded(x, initial)
    n = len(x)
    if method is None:
        method = 'Brent-Kung' if _interactive(x) and n >= 32 else 'Sklansky'
    if method == 'Brent-Kung':
        # up: span-doubling partial results at 2d - 1, 4d - 1, ...
        d = 1
        while 2 * d <= n:
            for k in range(2 * d - 1, n, 2 * d):
                x[k] = f(x[k - d], x[k])
            d *= 2
        # down: the remaining prefixes from the partial results
        d //= 2
        while d >= 1:
            for k in range(3 * d - 1, n, 2 * d):
                x[k] = f(x[k - d], x[k])
            d //= 2
    elif method == 'Sklansky':
        # each level, a block of 2 span fans its mid-point prefix into the
        # whole second half of the block
        span = 1
        while span < n:
            for blk in range(0, n, 2 * span):
                mid = blk + span
                if mid >= n:
                    break
                pivot = x[mid - 1]
                for j in range(mid, min(mid + span, n)):
                    x[j] = f(pivot, x[j])
            span *= 2
    else:
        raise ValueError('invalid method')
    return iter(x)
