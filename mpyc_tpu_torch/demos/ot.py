"""Demo: 1-out-of-2 oblivious transfer by honest-majority MPC, on the
port.

    python -m mpyc_tpu_torch.demos.ot [--seed S] [--device cuda|cpu]

The co-located path of ``demos/ot.py`` on ``SimRuntime(3)`` (m = 2t + 1,
t = 1): sender i (party i, 1 <= i <= t) inputs a message pair (x0, x1),
receiver i (party t + i) a choice bit b, party 0 helps; the multiplexer
x0 + b (x1 - x0) is opened to the receiver alone (``output(...,
receivers=t + i)``). One process plays every party, so the runner draws
every pair and bit itself (from ``--seed``) and checks each received
message against x_b; it exits 1 otherwise.
"""

from __future__ import annotations

import argparse
import random
import sys

from mpyc_tpu_torch.demos import parties


def run(mpc, seed=None, out=print) -> bool:
    """The t transfers; whether every receiver got x_b."""
    m = len(mpc.parties)
    if m % 2 == 0:
        raise ValueError('ot needs an odd party count (m = 2t + 1)')
    t = m // 2
    rnd = random.Random(seed)
    pairs = {i: (rnd.randrange(100), rnd.randrange(100))
             for i in range(1, t + 1)}
    bits = {i: rnd.getrandbits(1) for i in range(1, t + 1)}
    out(f'Simulating {t} sender/receiver pairs.')
    secint = mpc.SecInt()
    ok = True
    for i in range(1, t + 1):
        x0, x1 = mpc.input([secint(pairs[i][0]), secint(pairs[i][1])],
                           senders=i)
        b = mpc.input(secint(bits[i]), senders=t + i)
        selected = x0 + b * (x1 - x0)
        got = int(mpc.output(selected, receivers=t + i))
        out(f'Transfer {i}: received message {got}.')
        ok &= got == pairs[i][bits[i]]
    return ok


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--seed', type=int, default=None,
                        help='seed of the pairs and bits (default: fresh)')
    parser.add_argument('--device', default='cuda',
                        help='device of the shares (default: the card)')
    args = parties.parse_args(parser, argv)
    mpc = parties.runtime(args)
    mpc.run(mpc.start())
    ok = run(mpc, args.seed)
    mpc.run(mpc.shutdown())
    print(f'every receiver got x_b: {ok}')
    return 0 if ok else 1


if __name__ == '__main__':
    sys.exit(main())
