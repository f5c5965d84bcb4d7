"""Demo: oblivious sorting with full secrecy, on the port.

    python -m mpyc_tpu_torch.demos.sort [N] [--device cuda|cpu]

The co-located path of ``demos/sort.py`` on ``SimRuntime(3)`` (t = 1):
``demo_sorted_with_key`` shuffles a list of secure integers obliviously
(``random.shuffle``: a random unit vector a slot) and sorts it by the
key a**2 with ``Runtime.sorted`` (Batcher's merge-exchange network, one
secure comparison and one product a comparator); ``demo_np_sort`` sorts
a secure array with ``Runtime.np_sort``, every stage of the network one
batched comparison and one batched product. The input is the demo's
alternating-sign ramp of N values (default 5). Each result is checked
with Python's ``sorted``; the runner exits 1 otherwise.
``demo_seclist_descending`` shuffles secure fixed-point numbers
(SecFxp(32, 16), the ramp plus 0.5) and sorts them in place, descending,
as a secure list (``seclists.seclist.sort``).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from mpyc_tpu_torch import random, seclists
from mpyc_tpu_torch.demos import parties


def ramp(n: int) -> list:
    """The demo's input: an alternating-sign ramp, e.g. n = 5:
    [4, -9, 16, -25, 36]."""
    return [(i + n // 2) ** 2 * (1 if i % 2 == 0 else -1) for i in range(n)]


def demo_sorted_with_key(mpc, values, out=print) -> bool:
    """Shuffle secure integers obliviously, sort them by a**2; whether
    the opened result is sorted(values, key=abs)."""
    secint = mpc.SecInt()
    out(f'Using secure integers: {secint.__name__}')
    xs = [secint(v) for v in values]
    random.shuffle(secint, xs)
    out(f'Randomly shuffled input: {mpc.output(xs)}')
    by_abs = mpc.sorted(xs, key=lambda a: a**2)
    opened = [int(v) for v in mpc.output(by_abs)]
    out(f'Sorted by absolute value: {opened}')
    return opened == sorted(values, key=abs)


def demo_seclist_descending(mpc, values, out=print) -> bool:
    """Shuffle secure fixed-point numbers v + 0.5 obliviously and sort
    them descending in a secure list; whether the opened result is
    sorted((v + 0.5 for v in values), reverse=True)."""
    secfxp = mpc.SecFxp()
    out(f'Using secure fixed-point numbers: {secfxp.__name__}')
    xs = [secfxp(v + 0.5) for v in values]
    random.shuffle(secfxp, xs)
    out(f'Randomly shuffled input: {mpc.output(xs)}')
    lst = seclists.seclist(xs)
    lst.sort(reverse=True)
    opened = [float(v) for v in mpc.output(list(lst))]
    out(f'Sorted by descending value: {opened}')
    return opened == sorted((v + 0.5 for v in values), reverse=True)


def demo_np_sort(mpc, values, out=print) -> bool:
    """Input a secure integer array, np_sort it; whether the opened result
    is sorted(values)."""
    secint = mpc.SecInt()
    out(f'Using secure integer arrays: {secint.__name__}')
    arr = mpc.input(secint.array(np.array(values, dtype=object)), senders=0)
    asc = mpc.np_sort(arr)
    opened = [int(v) for v in np.asarray(mpc.output(asc)).tolist()]
    out(f'np_sort ascending: {opened if len(opened) <= 64 else "..."}')
    return opened == sorted(values)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('n', type=int, nargs='?', default=None,
                        help='number of values (default 5)')
    parser.add_argument('--device', default='cuda',
                        help='device of the shares (default: the card)')
    args = parties.parse_args(parser, argv)
    n = args.n
    if n is None:
        n = 5
        print('Setting input to default =', n)
    values = ramp(n)
    mpc = parties.runtime(args)
    mpc.run(mpc.start())
    ok = demo_sorted_with_key(mpc, values)
    ok = demo_seclist_descending(mpc, values) and ok
    ok = demo_np_sort(mpc, values) and ok
    mpc.run(mpc.shutdown())
    print(f'all results equal Python\'s sorted: {ok}')
    return 0 if ok else 1


if __name__ == '__main__':
    sys.exit(main())
