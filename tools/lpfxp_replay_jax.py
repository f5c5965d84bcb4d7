#!/usr/bin/env python3
"""Replay a recorded fixed-point LP solve on the JAX package's demo, on
the CPU: the reference side of ``tools/lpfxp_certificates.py --replay``.

    JAX_PLATFORMS=cpu python3 tools/lpfxp_replay_jax.py -i 5 \
        --replay FILE [--line K]

Line K of FILE (default: the first whose certificate was false) holds a
port runtime's randomness state at the start of a solve
(``lpfxp_certificates.state_of``). A JAX ``SimRuntime(3)`` takes its
PRSS keys, reshare key, input generator and program counter, and
``demos/np_lpsolverfxp.py`` runs on it as ``tests/test_torch_lpfxp.py``
runs it: on the CPU the JAX package's comparisons of fields above 32
bits draw PRSS random bits that the port's fused comparison does not
(their opened results do not depend on them), so each comparison leaves
the program counter as it found it. Both packages then draw the same
PRSS randomness for every truncation and open the same values. Prints
the demo's lines (the certificate's line ends in its value) and exits 0
if the certificate is the one recorded, else 1.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import io
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('-i', '--dataset', type=int, default=5)
    parser.add_argument('--replay', required=True)
    parser.add_argument('--line', type=int, default=None)
    args = parser.parse_args()
    rows = [json.loads(s) for s in open(args.replay)]
    k = args.line if args.line is not None else next(
        j for j, r in enumerate(rows) if not r['ok'])
    st = rows[k]['state']

    import mpyc_tpu.runtime as jruntime
    from mpyc_tpu.ops.rng import KeccakRNG
    from mpyc_tpu.parallel.simulator import SimRuntime
    from mpyc_tpu.runtime import _Options

    os.environ['MPYC_TPU_CACHE'] = '0'
    jr = SimRuntime(3, _Options())
    jr._prss_keys = {tuple(map(int, S.split(','))): bytes.fromhex(v)
                     for S, v in st['prss_keys'].items()}
    jr.prfs.cache_clear()
    jr._fused_key = bytes.fromhex(st['fused_key'])
    jr._rng = KeccakRNG(bytes.fromhex(st['rng_key']))
    jr._rng._nonce = st['rng_nonce']
    jr._program_counter[0] = st['pc']
    jr._wire_modules()
    jruntime.mpc = jr
    np_sgn = jr.np_sgn

    def np_sgn_same_pc(*a, **kw):
        pc = jr._program_counter[0]
        try:
            return np_sgn(*a, **kw)
        finally:
            jr._program_counter[0] = pc
    jr.np_sgn = np_sgn_same_pc
    spec = importlib.util.spec_from_file_location(
        'jax_lpfxp_demo', os.path.join(ROOT, 'demos', 'np_lpsolverfxp.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    sys.argv = ['np_lpsolverfxp.py', '-i', str(args.dataset)]
    buf = io.StringIO()
    failed = False
    with contextlib.redirect_stdout(buf):
        try:
            mod.main()
        except AssertionError:      # the demo asserts its certificate
            failed = True
    print(buf.getvalue(), end='')
    print(f'JAX demo on line {k}\'s keys: certificate {not failed} '
          f'(recorded: {rows[k]["ok"]})')
    return 0 if (not failed) == rows[k]['ok'] else 1


if __name__ == '__main__':
    sys.exit(main())
