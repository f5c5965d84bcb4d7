"""Demo: parallel sorting of the parties' inputs, on the port.

    python -m mpyc_tpu_torch.demos.parallelsort [--device cuda|cpu]

The co-located path of ``demos/parallelsort.py`` on ``SimRuntime(3)``:
party i inputs (37 i mod 11) - 5 as a SecInt(32) and a quarter of it as
a SecFxp(32); each type's inputs become one secure array, sorted by
``np_sort`` (Batcher's network, every stage one batched comparison) and
opened, and each sorted sequence is checked against Python's sorted. The
runner exits 1 otherwise.
"""

from __future__ import annotations

import argparse
import sys

from mpyc_tpu_torch.demos import parties


def run(mpc, out=print) -> bool:
    """Each type's inputs sorted and opened; whether all equal Python's
    sorted."""
    m = len(mpc.parties)
    ok = True
    for name, sectype, mk in (
            ('secint32', mpc.SecInt(32), lambda i: (i * 37) % 11 - 5),
            ('secfxp32', mpc.SecFxp(32),
             lambda i: ((i * 37) % 11 - 5) / 4)):
        xs = mpc.input_each(lambda i: sectype(mk(i)))
        got = [float(v) for v in mpc.output(mpc.np_sort(
            mpc.np_fromlist(xs)))]
        expect = sorted(mk(i) for i in range(m))
        good = all(abs(g - e) < 1e-6 for g, e in zip(got, expect))
        out(f'{name} sorted {got} {"OK" if good else "FAILED"}')
        ok &= good
    return ok


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
