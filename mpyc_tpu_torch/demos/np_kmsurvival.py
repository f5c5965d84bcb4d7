"""Demo: Kaplan-Meier survival analysis and the logrank test on
secret-shared event tables, on the port.

    python -m mpyc_tpu_torch.demos.np_kmsurvival [-i {0,2}] [-s S] [-a A]
        [--agg] [--device cuda|cpu]

The co-located path of ``demos/kmsurvival.py`` on ``SimRuntime(3)`` (t =
1), line for line: each party holds every third row of the dataset's
event table; the secure union inputs each party's per-time counts
(``input_each``) and sums them; the maximum time is a tournament of
secure comparisons (``max``); the logrank test takes one batched
fixed-point division for all time steps (Newton's reciprocal) and one
more for the statistic. With ``--agg`` the time steps are first compacted
obliviously within intervals of ``stride`` steps (``if_else`` on lists,
the interval's opened event count bounding its candidates), and the test
runs on the candidates.

Datasets (``demos/data/surv``): 0 = btrial (months; SecFxp(56, 28), a
116-bit field of four limbs), 2 = aml (weeks; SecFxp(64, 32), a 128-bit
field of four limbs with 4p >= R, where zero tests take [NO07]'s
probabilistic test). ``-a A`` sets the fixed point to SecFxp(2A, A).

The runner checks itself as the JAX demo does (exit 1 otherwise): the
secure chi-squared statistic, and with ``--agg`` the aggregated one,
within 1e-3 (relative, at least 1e-3 absolute) of ``plain_logrank``, the
test on the cleartext union.
"""

from __future__ import annotations

import argparse
import csv
import logging
import math
import sys
import time
from pathlib import Path

from mpyc_tpu_torch.demos import parties

DATA = Path(__file__).resolve().parents[2] / 'demos' / 'data' / 'surv'

# dataset -> file, stride, accuracy, time unit, time, event and group
# columns, the two groups
SETTINGS = {0: ('btrial.csv', 12, 28, 'months', 'time', 'death', 'im',
                (1, 2)),
            2: ('aml.csv', 16, 32, 'weeks', 'time', 'cens', 'group',
                (1, 2))}


def chi2_sf_1df(x):
    """Survival function of chi-squared with 1 degree of freedom."""
    return math.erfc(math.sqrt(max(x, 0.0) / 2))


def events_to_table(maxT, T, E):
    """Survival table with one entry per time j = 1..maxT."""
    d = [0] * maxT
    n = [0] * maxT
    for t, e in zip(T, E):
        j = round(t)
        d[j-1] += e     # observed events at time j
        n[j-1] += 1-e   # censored events at time j
    N = sum(d) + sum(n)
    for j in range(maxT):
        n[j], N = N, N - (d[j] + n[j])
    return d, n


def plain_logrank(d1, d2, n1, n2):
    """Cleartext logrank chi-squared statistic."""
    detot = 0.0
    vtot = 0.0
    for dd1, dd2, nn1, nn2 in zip(d1, d2, n1, n2):
        d_j = dd1 + dd2
        n_j = nn1 + nn2
        if n_j < 2 or d_j == 0:
            continue
        e1 = d_j * nn1 / n_j
        detot += dd1 - e1
        vtot += e1 * (nn2 / n_j) * (n_j - d_j) / (n_j - 1)
    return detot**2 / vtot


def logrank_test(mpc, secfxp, d1, d2, n1, n2):
    """Secure logrank test: all time steps in one batched fixed-point
    division."""
    D1 = mpc.np_fromlist(list(d1))
    D2 = mpc.np_fromlist(list(d2))
    N1 = mpc.np_fromlist(list(n1))
    N2 = mpc.np_fromlist(list(n2))
    d_j = D1 + D2
    n_j = N1 + N2
    b = n_j * (n_j - 1)
    c = d_j * N1 / (n_j * b)  # one batched division for all time steps
    detot = mpc.np_sum(D1 - b * c)
    vtot = mpc.np_sum(N2 * (n_j - d_j) * c)
    chi = mpc.run(mpc.output(detot**2 / vtot))
    return float(chi)


def aggregate(mpc, d, n, stride):
    agg_d = [mpc.sum(d[s:s + stride]) for s in range(0, len(d), stride)]
    return agg_d, n[::stride]


def agg_logrank_test(mpc, secfxp, d1, d2, n1, n2, agg_d1, agg_d2, stride):
    """Aggregated variant: oblivious compaction of active time steps."""
    candidates = []
    maxT = len(d1)
    for start in range(0, maxT, stride):
        group = start // stride
        n_observed = agg_d1[group] + agg_d2[group]
        msn = min(stride, n_observed)
        stop = min(start + stride, maxT)
        logging.info(f'Interval {group + 1} (time {start + 1} to {stop}) '
                     f'# observed events = {n_observed}')
        if msn == 0:
            continue

        table = [[secfxp(0), secfxp(0), secfxp(1), secfxp(1)]] * msn
        ix = [secfxp(0)] * msn
        for j in range(start, stop):
            is_active = d1[j] + d2[j] != 0
            ix = mpc.if_else(is_active, [1 - mpc.sum(ix)] + ix[:-1], ix)
            select = mpc.scalar_mul(is_active, ix)
            new = [d1[j], d2[j], n1[j], n2[j]]
            for i in range(msn):
                table[i] = mpc.if_else(select[i], new, table[i])
        candidates.extend(table)
    return logrank_test(mpc, secfxp, *zip(*candidates))


def run(mpc, dataset=0, stride=0, accuracy=0, agg=False, out=print):
    """The JAX demo's main on runtime mpc, printing its lines through
    ``out``. Returns the secure statistic chi, the plain one chi_ref, and
    with ``agg`` the aggregated one chi_agg (else None)."""
    name, stride_, accuracy_, unit, times, events, groups, (v1, v2) = \
        SETTINGS[dataset]
    stride = stride or stride_
    accuracy = accuracy or accuracy_

    with open(DATA / name) as file:
        rows = list(csv.DictReader(file))
    T = [float(r[times]) for r in rows]
    E = [int(r[events]) for r in rows]
    G = [r[groups] for r in rows]

    mpc.run(mpc.start())
    m = len(mpc.parties)
    secfxp = mpc.SecFxp(2*accuracy, accuracy)
    out(f'Using secure fixed-point numbers: {secfxp.__name__}')
    out(f'dataset: {name}, with {len(rows)} individuals over '
        f'{m} parties ({unit})')

    # each party owns every m-th row
    def rows_of(pid):
        return [i for i in range(len(rows)) if i % m == pid]

    maxT = int(mpc.run(mpc.output(mpc.max(mpc.input_each(
        lambda j: mpc.SecInt(32)(max(round(T[i]) for i in rows_of(j))))))))

    def party_table(pid, value):
        idx = [i for i in rows_of(pid) if str(G[i]) == str(value)]
        return events_to_table(maxT, [T[i] for i in idx],
                               [E[i] for i in idx])

    # secure union: share per-time counts and add over parties
    def share_sum(col_fn):
        cols = mpc.input_each(
            lambda j: [secfxp(v) for v in col_fn(j)])
        return [mpc.sum(col) for col in zip(*cols)]

    d1 = share_sum(lambda j: party_table(j, v1)[0])
    n1 = share_sum(lambda j: party_table(j, v1)[1])
    d2 = share_sum(lambda j: party_table(j, v2)[0])
    n2 = share_sum(lambda j: party_table(j, v2)[1])

    chi = logrank_test(mpc, secfxp, d1, d2, n1, n2)
    out(f'secure logrank: chi2 = {chi:.6f}, p = {chi2_sf_1df(chi):.6f}')

    # cleartext verification on the full union
    dd1, nn1 = events_to_table(maxT, [T[i] for i in range(len(rows))
                                      if str(G[i]) == str(v1)],
                               [E[i] for i in range(len(rows))
                                if str(G[i]) == str(v1)])
    dd2, nn2 = events_to_table(maxT, [T[i] for i in range(len(rows))
                                      if str(G[i]) == str(v2)],
                               [E[i] for i in range(len(rows))
                                if str(G[i]) == str(v2)])
    chi_ref = plain_logrank(dd1, dd2, nn1, nn2)
    out(f'plain  logrank: chi2 = {chi_ref:.6f}, '
        f'p = {chi2_sf_1df(chi_ref):.6f}')

    chi_a = None
    if agg:
        agg_d1, _ = aggregate(mpc, d1, n1, stride)
        agg_d2, _ = aggregate(mpc, d2, n2, stride)
        agg_d1 = [int(v) for v in mpc.run(mpc.output(agg_d1))]
        agg_d2 = [int(v) for v in mpc.run(mpc.output(agg_d2))]
        chi_a = agg_logrank_test(mpc, secfxp, d1, d2, n1, n2,
                                 agg_d1, agg_d2, stride)
        out(f'agg    logrank: chi2 = {chi_a:.6f}, '
            f'p = {chi2_sf_1df(chi_a):.6f}')

    mpc.run(mpc.shutdown())
    return dict(chi=chi, chi_ref=chi_ref, chi_agg=chi_a, maxT=maxT)


def close(chi, chi_ref) -> bool:
    """The JAX demo's check: within 1e-3 relative of the plain statistic
    (1e-3 absolute below 1)."""
    return abs(chi - chi_ref) < 1e-3 * max(1, chi_ref)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('-i', '--dataset', type=int, metavar='I', default=0,
                        choices=sorted(SETTINGS),
                        help='dataset 0=btrial (default), 2=aml')
    parser.add_argument('-s', '--stride', type=int, metavar='S', default=0)
    parser.add_argument('-a', '--accuracy', type=int, metavar='A', default=0)
    parser.add_argument('--agg', action='store_true',
                        help='also run the aggregated (compacted) variant')
    parser.add_argument('--device', default='cuda',
                        help='device of the shares (default: the card)')
    args = parties.parse_args(parser, argv)
    mpc = parties.runtime(args)
    t0 = time.perf_counter()
    res = run(mpc, args.dataset, args.stride, args.accuracy, args.agg)
    good = close(res['chi'], res['chi_ref']) and \
        (res['chi_agg'] is None or close(res['chi_agg'], res['chi_ref']))
    print(f'{time.perf_counter() - t0:.3f} s; '
          f'{"ok" if good else "FAILED"}')
    return 0 if good else 1


if __name__ == '__main__':
    sys.exit(main())
