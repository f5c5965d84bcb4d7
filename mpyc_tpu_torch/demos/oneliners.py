"""Demo: the oneliners, on the port.

    python -m mpyc_tpu_torch.demos.oneliners [--device cuda|cpu]

The co-located path of ``demos/oneliners.py`` on ``SimRuntime(3)``: from
one input a party, m = sum 1, m^2 = sum 2 i + 1, 2^m = prod 2 and m! =
prod i + 1, each over secure integers just wide enough for any m, and
each opened result checked against Python. The runner exits 1 otherwise.
"""

from __future__ import annotations

import argparse
import math
import sys

from mpyc_tpu_torch.demos import parties


def run(mpc, out=print) -> bool:
    """The four oneliners opened; whether they are (m, m^2, 2^m, m!)."""
    m = len(mpc.parties)
    l = m.bit_length()
    r1 = int(mpc.output(mpc.sum(
        mpc.input_each(lambda i: mpc.SecInt(l + 1)(1)))))
    out(f'm    = {r1}')
    r2 = int(mpc.output(mpc.sum(
        mpc.input_each(lambda i: mpc.SecInt(2 * l + 1)(2 * i + 1)))))
    out(f'm**2 = {r2}')
    r3 = int(mpc.output(mpc.prod(
        mpc.input_each(lambda i: mpc.SecInt(m + 2)(2)))))
    out(f'2**m = {r3}')
    r4 = int(mpc.output(mpc.prod(mpc.input_each(
        lambda i: mpc.SecInt(int(m * (l - 1.4) + 3))(i + 1)))))
    out(f'm!   = {r4}')
    return (r1, r2, r3, r4) == (m, m ** 2, 2 ** m, math.factorial(m))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--device', default='cuda',
                        help='device of the shares (default: the card)')
    args = parties.parse_args(parser, argv)
    mpc = parties.runtime(args)
    mpc.run(mpc.start())
    ok = run(mpc)
    mpc.run(mpc.shutdown())
    print(f'all four equal to Python\'s: {ok}')
    return 0 if ok else 1


if __name__ == '__main__':
    sys.exit(main())
