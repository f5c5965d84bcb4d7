"""Demo: hello world, on the port.

    python -m mpyc_tpu_torch.demos.helloworld [--device cuda|cpu]

The co-located path of ``demos/helloworld.py`` at ``-M3 --sim`` on
``SimRuntime(3)``: each party i inputs the greeting ordinal i + 1 as a
SecInt(32) (``input_each``), and only their sum is opened; it must be m
(m + 1) / 2. The runner exits 1 otherwise.
"""

from __future__ import annotations

import argparse
import sys

from mpyc_tpu_torch.demos import parties


def run(mpc, out=print) -> bool:
    """Every party's ordinal input, their sum opened; whether it is
    m (m + 1) / 2."""
    secint = mpc.SecInt()
    m = len(mpc.parties)
    xs = mpc.input_each(lambda i: secint(i + 1))
    total = int(mpc.output(mpc.sum(xs)))
    expect = m * (m + 1) // 2
    out(f'sum of greetings = {total} {"OK" if total == expect else "FAILED"}')
    return total == expect


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--device', default='cuda',
                        help='device of the shares (default: the card)')
    args = parties.parse_args(parser, argv)
    mpc = parties.runtime(args)
    mpc.run(mpc.start())
    ok = run(mpc)
    mpc.run(mpc.shutdown())
    return 0 if ok else 1


if __name__ == '__main__':
    sys.exit(main())
