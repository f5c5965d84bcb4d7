#!/usr/bin/env python3
"""Solve one dataset of the fixed-point LP solver several times, each time
on a new runtime (new PRSS and reshare keys, so new probabilistic
truncations), and report each certificate with the keys that gave it.

    python3 tools/lpfxp_certificates.py [-i 5] [--runs 8] [--workers 1]
        [--keys-out FILE] [--device cuda|cpu]
    python3 tools/lpfxp_certificates.py -i 5 --replay FILE [--line K]
        [--device cpu]
    python3 tools/lpfxp_certificates.py -i 5 --label 'lp fxp sc50b' \
        --runs 1 [--keys-out FILE] [--device cpu]

Per run: the pivots, the opened maximum, seconds, the certificate and,
where it is false, the names of its conditions that fail
(``np_lpsolverfxp.solve``'s ``failed``). With ``--keys-out`` each run
appends one JSON line to FILE: the runtime's randomness state at the
start (PRSS keys, reshare key and counter, input generator key and
nonce, program counter) and the run's results. ``--workers W`` builds the
kernels once, then runs W processes of ``--runs`` solves each at once
(a solve keeps the card mostly idle), each appending to FILE.

``--replay FILE`` solves again from the state on line K of FILE (default:
the first whose certificate was false; ``chip_smoke.recorded_keys``):
the opened values depend on the PRSS keys and the program counter only,
so a replay on any device opens the same values (the card's kernels and
their plain versions agree bit for bit). ``--label`` starts every solve
from the keys ``chip_smoke.fixed_keys`` derives from the label.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

from chip_smoke import fixed_keys, recorded_keys  # noqa: E402
from mpyc_tpu_torch.demos import np_lpsolverfxp as lpf  # noqa: E402
from mpyc_tpu_torch.parallel.simulator import SimRuntime  # noqa: E402


def state_of(rt) -> dict:
    """A runtime's randomness state, as ``load_state`` takes it (hex)."""
    return dict(
        prss_keys={','.join(map(str, S)): k.hex()
                   for S, k in rt._prss_keys.items()},
        fused_key=rt._fused_key.hex(), ctr=[int(c) for c in rt._fused_ctr],
        rng_key=rt._rng.key.hex(), rng_nonce=int(rt._rng._nonce),
        pc=int(rt._program_counter[0]))


def solve_once(dataset: int, device: str, start=None,
               out=lambda s: None) -> dict:
    """One solve on a new runtime, first passed to ``start`` (if given)."""
    rt = SimRuntime(3, device=device)
    if start is not None:
        start(rt)
    state = state_of(rt)
    sync = torch.cuda.synchronize if rt.device.type == 'cuda' else \
        (lambda: None)
    sync()
    t0 = time.perf_counter()
    res = lpf.solve(rt, dataset, out=out)
    sync()
    return dict(state=state, s=time.perf_counter() - t0, dataset=dataset,
                iterations=res['iterations'], mx=res['mx'], ok=res['ok'],
                failed=res['failed'], x=res['x'])


def line(k, r) -> str:
    return (f'run {k}: {r["iterations"]} pivots, max {r["mx"]!r}, '
            f'{r["s"]:.3f} s, certificate {r["ok"]}'
            + (f' ({", ".join(r["failed"])} fail)' if r['failed'] else ''))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('-i', '--dataset', type=int, default=5)
    parser.add_argument('--runs', type=int, default=8)
    parser.add_argument('--workers', type=int, default=1)
    parser.add_argument('--keys-out', default=None)
    parser.add_argument('--replay', default=None)
    parser.add_argument('--line', type=int, default=None)
    parser.add_argument('--label', default=None)
    parser.add_argument('--device', default='cuda')
    args = parser.parse_args()
    if args.device == 'cuda':
        smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                              '--format=csv,noheader'], capture_output=True,
                             text=True, timeout=30).stdout.strip()
    else:
        smi = 'the CPU'
    print(smi, flush=True)
    if args.replay:
        rows = [json.loads(s) for s in open(args.replay)]
        k = args.line if args.line is not None else next(
            j for j, r in enumerate(rows) if not r['ok'])
        r = solve_once(args.dataset, args.device,
                       lambda rt: recorded_keys(rt, args.replay, k), print)
        same = r['mx'] == rows[k]['mx'] and r['x'] == rows[k]['x'] and \
            r['ok'] == rows[k]['ok']
        print(line(f'replay of line {k}', r))
        print(f'the same opened max, solution and certificate as the '
              f'recorded run: {same}')
        return 0 if same else 1
    if args.workers > 1:
        from mpyc_tpu_torch import _build
        _build.library()
        cmd = [sys.executable, os.path.abspath(__file__), '-i',
               str(args.dataset), '--runs', str(args.runs),
               '--device', args.device] + (['--label', args.label]
                                           if args.label else [])
        procs = [subprocess.Popen(cmd + (['--keys-out', args.keys_out]
                                         if args.keys_out else []))
                 for _ in range(args.workers)]
        rc = max(p.wait() for p in procs)
        if args.keys_out:
            rows = [json.loads(s) for s in open(args.keys_out)]
            false = sum(not r['ok'] for r in rows)
            print(f'{lpf.DATASETS[args.dataset][0]}: certificate false in '
                  f'{false} of {len(rows)} runs on {smi}')
        return rc
    false = 0
    for k in range(args.runs):
        r = solve_once(args.dataset, args.device, None if args.label is None
                       else lambda rt: fixed_keys(rt, args.label))
        false += not r['ok']
        print(line(k, r), flush=True)
        if args.keys_out:
            with open(args.keys_out, 'a') as fh:   # one short write a line
                fh.write(json.dumps(r) + '\n')
    print(f'{lpf.DATASETS[args.dataset][0]}: certificate false in {false} '
          f'of {args.runs} runs on {smi}')
    return 0


if __name__ == '__main__':
    sys.exit(main())
