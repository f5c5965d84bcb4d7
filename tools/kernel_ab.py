#!/usr/bin/env python3
"""Time the squeezing kernels of several checkouts of the port in one run
on one card, interleaved, to compare them: K1, K2, K3, K5 and a GF(2^d)
reshare round.

    python3 tools/kernel_ab.py LABEL=DIR [LABEL=DIR ...] [--rounds 2]

Each DIR is the root of a checkout (an unpacked ``git archive``); its own
``chip_smoke.py`` and ``mpyc_tpu_torch`` are imported in a process of its
own, which builds its kernels on first use. A round runs every checkout
once, the order reversed every other round (a, b, b, a for two). Each
run prints, on random inputs from a fixed seed at SecInt(32)'s field:
K1 at the block counts its paths launch (``K1_BLOCKS``: from SecInt(14)'s
input draws to a 2^22-element draw, through the pool refill, the most
one CTA an SM of five-thread sponges takes and a SHA3 round's stream in
the design where K8 read K1's blocks) and a GF(2^d) reshare round
(``make_reshare2_step``, fused: one K8 launch, or K1 and K8 where K8
read K1's blocks) at SHA3's chi (3, 2^19) in GF(4) and AES's S-box (3,
32,768) in GF(2^8), each the device time of launches replayed from a CUDA
graph (``chip_smoke.graph_ms``); K2 at 2^22 draws of 24 bytes, K3 fused
at (3, 2^22, 2) and K5 (LT, l = 32) at (3, 2^20, 2), each the mean of 10
launches by CUDA events (``chip_smoke.cuda_ms``), as chip_smoke.py times
them.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys


K1_BLOCKS = (293, 512, 1024, 3168, 4224, 9363, 599187)


def one(root: str, label: str) -> None:
    """Time the kernels of the checkout at root."""
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    os.chdir(root)
    import numpy as np
    import chip_smoke as c
    from mpyc_tpu_torch import sectypes
    from mpyc_tpu_torch.models import pipelines
    from mpyc_tpu_torch.ops import keccak, rng
    p = sectypes.SecInt(32, 'cuda').field.modulus
    gen = np.random.default_rng(11)
    st_np, lane = keccak.ctr_state(bytes(range(40)))
    st = keccak.state_tensor(st_np, 'cuda')
    nonce = (5, 0)
    res = {}
    for n in K1_BLOCKS:
        res[f'K1 {n}'] = c.graph_ms(lambda: keccak.keccak_ctr(st, n, lane),
                                    20)
    ctr = np.array([5, 0], np.uint32)
    for d, md, n in ((2, c.GF4, c.SHA3_CHI), (8, c.GF256, c.AES_SBOX)):
        step = pipelines.make_reshare2_step(md, 1, 3, fuse_mul=True)
        a, b = c.gf2_field(d, (3, n), gen), c.gf2_field(d, (3, n), gen)
        res[f'GF(2^{d}) reshare {n}'] = c.graph_ms(
            lambda: step(a, b, st, ctr), 10)
    res['K2 2^22'] = c.cuda_ms(lambda: rng.squeeze_mont(st, 1 << 22, 24, p,
                                                        lane), 10)
    spec3 = pipelines.ReshareSpec(p, 1, 3)
    a, b = (c.random_field(p, (3, 1 << 22), gen) for _ in range(2))
    res['K3 fused 2^22'] = c.cuda_ms(
        lambda: pipelines.reshare_mul(a, b, st, nonce, spec3), 10)
    del a, b
    spec5 = pipelines.SgnSpec(p, 1, 3, 32, LT=True)
    a = c.random_field(p, (3, 1 << 20), gen)
    res['K5 LT 2^20'] = c.cuda_ms(
        lambda: pipelines.sgn_chunks(a, st, nonce, spec5, 1 << 20), 10)
    print(f'{label}: ' + ', '.join(f'{k} {v:.4f} ms' for k, v in res.items()),
          flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('trees', nargs='*', metavar='LABEL=DIR')
    parser.add_argument('--rounds', type=int, default=2)
    parser.add_argument('--one', nargs=2, metavar=('DIR', 'LABEL'),
                        help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.one:
        one(*args.one)
        return 0
    if not args.trees:
        parser.error('name at least one LABEL=DIR')
    trees = [t.split('=', 1) for t in args.trees]
    for r in range(args.rounds):
        for label, root in (trees if r % 2 == 0 else trees[::-1]):
            subprocess.run([sys.executable, os.path.abspath(__file__),
                            '--one', root, label], check=True, timeout=900)
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=30).stdout.strip())
    return 0


if __name__ == '__main__':
    sys.exit(main())
