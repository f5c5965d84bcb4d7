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
and not at (3, 2^22, 2), K4 at the split/recombine round's 3,010,560
secrets, K5 (LT, l = 32) at (3, 2^20, 2) and K7 at conv1's 15,052,800
random bits (SecFxp(14, 6)'s field), each the mean of 10 (K4: 20)
launches by CUDA events (``chip_smoke.cuda_ms``), as chip_smoke.py times
them: the (1, 3) rows of PERF.md section 6 that K3, K4, K5 and K7 own.

With ``--parties`` each run also times K5 (l = 32) at 2^20 elements in
its three modes at (t, m) = (2, 5) and in LT mode at (3, 7) and (4, 9),
and K7 at conv1's random bits at (2, 5), after holding K3 and K4 at (1,
3) and each of those K5 against their plain versions at 2^16 elements
(bit for bit), and prints the ptxas report of K3, K4 and K5 on two limbs
and of K7 where its process built the library.

With ``--wide`` each run times only the wide K5 and K6 (csrc/sgn_wide.cu,
csrc/wide.cu), at the shapes of their rows in PERF.md section 6: the wide
K5 in LT mode on kb2's widest call ((3, 68, 19) shares at l = 560 on
kb2's SecInt(560) field, one launch in chunks of 1,024, as np_sgn makes
it) and in its three modes on (3, 8, 48) shares at l = 1504 (SecInt(1504),
one call of 8), each the mean of 10 launches by CUDA events, and the wide
K6 on one element at e = p - 2 at 19 limbs (kb2's field) and 42
(SecInt(1300)), the mean of 3; each is first held bit for bit against its
plain version, and where its process built the library it prints the
ptxas report of sgn_wide_kernel and mont_pow_wide_kernel and the seconds
of the units sgn_wide and wide. About three minutes a checkout and round
on an H100, builds and plain checks included.

With ``--small`` each run times only K5 and K3 on the small calls of the
LP solvers, the fixed-point LP and the ID3 trees (``SMALL_K5``,
``SMALL_K3``), and the large calls whose geometry must not move (K3 fused
and not at (3, 2^22, 2), fused at (3, 2^22, 3); K5 LT at (3, 2^20, 2)
and at the CNN's 1,254,400 elements at l = 16 on three limbs), each held
bit for bit against its plain version and then timed: K5 the mean of 10
launches by CUDA events, on the route its checkout's launch takes
(``pipelines.sgn_chunks``), and, where the checkout has K5's CTA route,
also forced onto the narrow kernel and onto the CTA route; K3 the mean of
10 launches replayed from a CUDA graph (``chip_smoke.graph_ms``: a small
call's launch is shorter than its host call). With ``--tune`` as well, a
checkout with the CTA route also times every CTA width and group it is
built for (``_build.SGN_CTA_THREADS_BUILT``, ``SGN_CTA_GROUPS_BUILT``) at
1, 64, 288 and 1,024 elements at each limb count's path width
(``TUNE_K5``), each held against its plain version at 64, and times the
narrow kernel and the CTA route (its CTA from n, ``_build.sgn_cta_shape``)
at the crossover sizes ``CROSS_N``, the two held equal to each other and
up to 288 elements to the plain version too: the measurements behind
``_build.SGN_CTA_SHAPE`` and ``SGN_CTA_MAX``.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys


K1_BLOCKS = (293, 512, 1024, 3168, 4224, 9363, 599187)
# K5's (t, m, mode) of --parties: the three modes at (2, 5), LT at (3, 7)
# and (4, 9)
K5_PARTIES = ((2, 5, 'sgn'), (2, 5, 'LT'), (2, 5, 'EQ'), (3, 7, 'LT'),
              (4, 9, 'LT'))
# --wide: the wide K5's (bits of SecInt, 0 for kb2's field; l; modes;
# elements; chunk) and the wide K6's fields (bits, limbs)
WIDE_K5 = ((0, 560, ('LT',), 68, 1024),
           (1504, 1504, ('sgn', 'LT', 'EQ'), 8, 8))
WIDE_K6 = ((0, 19), (1300, 42))
# --small: K5's small calls (mode, l, f, elements, field: 'lp' SecInt(l)
# with the LP solver's root of unity, 'fxp' SecFxp(l, f), 'int'
# SecInt(l): small_field) and K3's ((t, m), elements, field, fused: kb2's
# and LPExample's rank-1 updates, LPExample_R20's, a secure prime field's
# products at one limb, kb2's at (2, 5), then the (1, 3) rows at 2^22)
SMALL_K5 = (('LT', 110, 0, 288, 'lp'), ('LT', 104, 0, 70, 'lp'),
            ('LT', 96, 48, 68, 'fxp'), ('LT', 52, 26, 70, 'fxp'),
            ('LT', 70, 0, 20, 'lp'), ('LT', 42, 0, 1, 'int'),
            ('LT', 69, 0, 1, 'int'), ('LT', 95, 0, 1, 'int'),
            ('EQ', 56, 28, 1, 'fxp'), ('EQ', 42, 0, 1, 'int'))
SMALL_K3 = (((1, 3), 2898, ('fxp', 96, 48), True),
            ((1, 3), 2898, ('fxp', 96, 48), False),
            ((1, 3), 58667, ('lp', 110, 0), True),
            ((1, 3), 58667, ('lp', 110, 0), False),
            ((1, 3), 441, ('lp', 70, 0), True),
            ((1, 3), 1024, ('prime', 1031, 0), True),
            ((2, 5), 2898, ('fxp', 96, 48), True),
            ((1, 3), 1 << 22, ('int', 32, 0), True),
            ((1, 3), 1 << 22, ('int', 32, 0), False),
            ((1, 3), 1 << 22, ('int', 64, 0), True))
# --tune: each limb count's path width (l, f, field) and the sizes
TUNE_K5 = ((3, 42, 0, 'int'), (4, 70, 0, 'lp'), (5, 110, 0, 'lp'),
           (6, 96, 48, 'fxp'))
TUNE_N = (1, 64, 288, 1024)
CROSS_N = (1, 8, 64, 132, 133, 264, 265, 288, 528, 529, 792, 1024, 1056,
           1057, 2048, 4096, 16384)


def one(root: str, label: str, parties: bool = False,
        wide: bool = False, small: bool = False, tune: bool = False) -> None:
    """Time the kernels of the checkout at root (with ``parties``, also
    at (2, 5); with ``wide``, only the wide K5 and K6; with ``small``,
    only K5 and K3 on small calls, and with ``tune`` the CTA route's
    shapes and crossover)."""
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
    if small:
        res = time_small(c, pipelines, st, gen, label, tune)
        print(f'{label}: ' + ', '.join(f'{k} {v:.4f} ms'
                                       for k, v in res.items()), flush=True)
        return
    if wide:
        res = time_wide(c, pipelines, st, gen, label)
        print(f'{label}: ' + ', '.join(f'{k} {v:.4f} ms'
                                       for k, v in res.items()), flush=True)
        return
    if parties:
        from mpyc_tpu_torch import _build
        lib = _build.library()
        for fn, r in c.ptxas_report(lib.log).items():
            if shown(fn):
                print(f'{label}: ptxas {fn}: ' + ', '.join(
                    f'{k} {v}' for k, v in r.items()), flush=True)
        check_plain(c, pipelines, p, st, nonce, gen)
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
    res['K3 2^22'] = c.cuda_ms(
        lambda: pipelines.reshare_mul(a, None, st, nonce, spec3), 10)
    del a, b
    spec4 = pipelines.SplitSpec(p, 1, 3)
    sec = c.random_field(p, (c.N_SPLIT,), gen)
    res[f'K4 {c.N_SPLIT}'] = c.cuda_ms(
        lambda: pipelines.split_recombine(sec, st, spec4), 20)
    del sec
    spec5 = pipelines.SgnSpec(p, 1, 3, 32, LT=True)
    a = c.random_field(p, (3, 1 << 20), gen)
    res['K5 LT 2^20'] = c.cuda_ms(
        lambda: pipelines.sgn_chunks(a, st, nonce, spec5, 1 << 20), 10)
    del a
    from mpyc_tpu_torch import finfields
    p52 = sectypes.SecFxp(c.FXP_L, c.FXP_F, 'cuda').field.modulus
    r, z = c.tail_shares(p52, c.FXP_BITS, gen)
    field = finfields.GF(p52)
    res[f'K7 {c.FXP_BITS}'] = c.cuda_ms(
        lambda: pipelines.random_bits_tail(r, z, field, False, 0), 10)
    del r, z
    if parties:
        for t, m, mode in K5_PARTIES:
            spec5 = pipelines.SgnSpec(p, t, m, 32, LT=mode == 'LT',
                                      EQ=mode == 'EQ')
            a = c.random_field(p, (m, 1 << 20), gen)
            res[f'K5 {mode} ({t}, {m}) 2^20'] = c.cuda_ms(
                lambda: pipelines.sgn_chunks(a, st, nonce, spec5, 1 << 20),
                10)
            del a
        r, z = c.tail_shares(p52, c.FXP_BITS, gen, m=5)
        res[f'K7 (2, 5) {c.FXP_BITS}'] = c.cuda_ms(
            lambda: pipelines.random_bits_tail(r, z, field, False, 0, 2), 10)
        del r, z
    print(f'{label}: ' + ', '.join(f'{k} {v:.4f} ms' for k, v in res.items()),
          flush=True)


def time_wide(c, pipelines, st, gen, label: str) -> dict:
    """--wide: the wide K5 and K6 at WIDE_K5 and WIDE_K6, each held
    against its plain version (raise unless equal bit for bit), then
    timed; the ptxas report and unit seconds where this process built."""
    import numpy as np
    from mpyc_tpu_torch import _build
    from mpyc_tpu_torch.ops import fieldops
    from mpyc_tpu_torch.ops.fieldops import prime_field_ctx
    lib = _build.library()
    if lib.built:
        for fn, r in c.ptxas_report(lib.log).items():
            if fn.startswith(('sgn_wide_kernel', 'mont_pow_wide_kernel')):
                print(f'{label}: ptxas {fn}: ' + ', '.join(
                    f'{k} {v}' for k, v in r.items()), flush=True)
        print(f'{label}: units sgn_wide {lib.unit_s.get("sgn_wide")} s, '
              f'wide {lib.unit_s.get("wide")} s', flush=True)
    ctr = np.array([5, 0], np.uint32)
    res = {}
    for bits, l, modes, n, chunk in WIDE_K5:
        p = c.wide_field(bits)
        L = prime_field_ctx(p).L
        for mode in modes:
            spec = pipelines.SgnSpec(p, 1, 3, l, 30, LT=mode == 'LT',
                                     EQ=mode == 'EQ')
            a = c.random_field(p, (3, n), gen)
            c.sgn_chunks_check(spec, a, st, ctr, chunk)
            res[f'K5 {mode} (3, {n}, {L}) l = {l}'] = c.cuda_ms(
                lambda: pipelines.sgn_chunks(a, st, ctr, spec, chunk), 10)
    for bits, L in WIDE_K6:
        p = c.wide_field(bits)
        ctx = prime_field_ctx(p)
        c.check(ctx.L == L, f'SecInt({bits}) has not {L} limbs')
        z = c.random_field(p, (1,), gen)
        c.check(c.max_abs_err(fieldops.mont_pow(z, p - 2, ctx),
                              fieldops._mont_pow_plain(z, p - 2, ctx)) == 0,
                f'the wide K6 at {L} limbs differs from its plain version')
        res[f'K6 1 element, L = {L}, e = p - 2'] = c.cuda_ms(
            lambda: fieldops.mont_pow(z, p - 2, ctx), 3)
    return res


def small_field(c, kind: str, l: int, f: int) -> int:
    """The prime of SMALL_K5's and SMALL_K3's fields (as
    chip_smoke.small_field, which a parent checkout's chip_smoke lacks)."""
    from mpyc_tpu_torch import sectypes
    if kind == 'lp':
        return c.lp_field(l)
    if kind == 'fxp':
        return c.fxp_field(l, f)
    if kind == 'prime':
        return l
    return sectypes.SecInt(l, 'cuda').field.modulus


def time_small(c, pipelines, st, gen, label: str, tune: bool) -> dict:
    """--small: K5 at SMALL_K5 and K3 at SMALL_K3, then the large calls,
    each held against its plain version (raise unless equal bit for bit)
    and timed; K5 on its launch's route, and where the checkout has the
    CTA route forced onto each route too; with ``tune``, ``tune_small``.
    The ptxas report of the CTA route and K3 and the unit seconds where
    this process built."""
    import torch
    from mpyc_tpu_torch import _build
    lib = _build.library()
    cta = hasattr(pipelines, 'sgn_route')
    if lib.built:
        for fn, r in c.ptxas_report(lib.log).items():
            if fn.startswith(('sgn_wide_kernel', 'reshare_kernel<6',
                              'reshare_kernel<5')):
                print(f'{label}: ptxas {fn}: ' + ', '.join(
                    f'{k} {v}' for k, v in r.items()), flush=True)
        print(f'{label}: units ' + ', '.join(
            f'{u} {s_:.1f} s' for u, s_ in lib.unit_s.items()
            if s_ is not None), flush=True)
    ctr = nonce = (0xFFFFFFFE, 5)
    chunk = 1024
    res = {}
    for mode, l, f, n, kind in SMALL_K5:
        p = small_field(c, kind, l, f)
        spec = pipelines.SgnSpec(p, 1, 3, l, 30, LT=mode == 'LT',
                                 EQ=mode == 'EQ', f=f)
        L = spec.ctx.L
        a = c.random_field(p, (3, n), gen)
        c.sgn_chunks_check(spec, a, st, ctr, chunk)
        name = f'K5 {mode} l = {l}, L = {L} at {n}'
        res[name] = c.cuda_ms(
            lambda: pipelines.sgn_chunks(a, st, ctr, spec, chunk), 10)
        if cta:
            want, _ = pipelines._sgn_chunks_plain(a, st, ctr, spec, chunk)
            for route in ('narrow', 'cta'):
                fn = routed(pipelines, a, st, nonce, spec, chunk, route)
                c.check(c.max_abs_err(fn(), want) == 0,
                        f'{name} on the {route} route differs from its '
                        'plain version')
                res[f'{name} {route}'] = c.cuda_ms(fn, 10)
    for (t, m), n, (kind, l, f), fused in SMALL_K3:
        p = small_field(c, kind, l, f)
        spec = pipelines.ReshareSpec(p, t, m)
        a = c.random_field(p, (m, n), gen)
        b = c.random_field(p, (m, n), gen) if fused else None
        out = pipelines.reshare_mul(a, b, st, nonce, spec)
        want = pipelines._reshare_mul_plain(a, b, st, nonce, spec)
        torch.cuda.synchronize()
        c.check(c.max_abs_err(out, want) == 0,
                f'K3 at ({m}, {n}, {spec.ctx.L}) differs from its plain '
                'version')
        del out, want
        res[f'K3 {"fused " if fused else ""}({t}, {m}) ({m}, {n}, '
            f'{spec.ctx.L})'] = c.graph_ms(
            lambda: pipelines.reshare_mul(a, b, st, nonce, spec), 10)
        del a, b
    for l, L, n in ((32, 2, 1 << 20), (16, 3, c.CNN_CMP[16])):
        p = small_field(c, 'int', 32 if L == 2 else 37, 0)
        spec = pipelines.SgnSpec(p, 1, 3, l, 30, LT=True)
        ch = 1 << 20 if L == 2 else chunk
        a = c.random_field(p, (3, n), gen)
        c.sgn_ends_check(spec, a, st, ch)
        res[f'K5 LT l = {l}, L = {L} at {n}'] = c.cuda_ms(
            lambda: pipelines.sgn_chunks(a, st, ctr, spec, ch), 10)
        del a
    if tune and cta:
        res.update(tune_small(c, pipelines, st, gen, label))
    return res


def routed(pipelines, a, st, nonce, spec, chunk: int, route: str):
    """K5's launch of a's chunks, as ``sgn_chunks`` cuts them, forced onto
    ``route``: a function of no arguments."""
    n = a.shape[1]
    n_last = pipelines.bucket(n - (n - 1) // chunk * chunk, chunk)
    return lambda: pipelines._launch_sgn(a, st, nonce, spec, chunk, n_last,
                                         route)


def tune_small(c, pipelines, st, gen, label: str) -> dict:
    """--tune: every CTA width and group of the CTA route at TUNE_K5's
    widths and TUNE_N's sizes (held against the plain version at 64), then
    the narrow kernel and the CTA route at CROSS_N (held equal to each
    other, and to the plain version up to 288)."""
    from mpyc_tpu_torch import _build
    ctr = nonce = (3, 0)
    chunk = 1024
    res = {}
    for L, l, f, kind in TUNE_K5:
        p = small_field(c, kind, l, f)
        spec = pipelines.SgnSpec(p, 1, 3, l, 30, LT=True, f=f)
        c.check(spec.ctx.L == L, f'{kind} {l} has not {L} limbs')
        keep = _build.SGN_CTA_SHAPE
        for group in _build.SGN_CTA_GROUPS_BUILT:
            for threads in _build.SGN_CTA_THREADS_BUILT:
                _build.SGN_CTA_SHAPE = ((None, threads, group),)
                for n in TUNE_N:
                    a = c.random_field(p, (3, n), gen)
                    fn = routed(pipelines, a, st, nonce, spec, chunk, 'cta')
                    if n == 64:
                        want, _ = pipelines._sgn_chunks_plain(a, st, ctr,
                                                              spec, chunk)
                        c.check(c.max_abs_err(fn(), want) == 0,
                                f'the CTA route ({threads} threads, groups '
                                f'of {group}) at L = {L} differs from its '
                                'plain version')
                    res[f'cta L = {L} l = {l} {threads}x{group} at {n}'] = \
                        c.cuda_ms(fn, 5)
        _build.SGN_CTA_SHAPE = keep
        for n in CROSS_N:
            a = c.random_field(p, (3, n), gen)
            fns = {r: routed(pipelines, a, st, nonce, spec, chunk, r)
                   for r in ('narrow', 'cta')}
            got = fns['cta']()
            c.check(c.max_abs_err(got, fns['narrow']()) == 0,
                    f'the two routes differ at L = {L}, {n} elements')
            if n <= 288:
                want, _ = pipelines._sgn_chunks_plain(a, st, ctr, spec,
                                                      chunk)
                c.check(c.max_abs_err(got, want) == 0,
                        f'the CTA route at L = {L}, {n} elements differs '
                        'from its plain version')
            for r, fn in fns.items():
                res[f'cross L = {L} l = {l} {r} at {n}'] = c.cuda_ms(fn, 5)
    return res


def shown(fn: str) -> bool:
    """Whether --parties prints the ptxas report of the kernel fn."""
    return fn.startswith(('reshare_kernel<2,', 'split_recombine_kernel',
                          'random_bits_tail_kernel<2,')) or (
        fn.startswith('sgn_kernel<') and fn.endswith(',2>'))


def check_plain(c, pipelines, p, st, nonce, gen) -> None:
    """Hold K3 (fused and not) and K4 at (1, 3) and K5 in each mode at (2,
    5) against their plain versions at 2^16 elements; raise unless equal
    bit for bit."""
    n = c.N_KCHECK
    spec3 = pipelines.ReshareSpec(p, 1, 3)
    a, b = (c.random_field(p, (3, n), gen) for _ in range(2))
    for bb in (b, None):
        c.check(c.max_abs_err(
            pipelines.reshare_mul(a, bb, st, nonce, spec3),
            pipelines._reshare_mul_plain(a, bb, st, nonce, spec3)) == 0,
            'K3 at (1, 3) differs from its plain version')
    spec4 = pipelines.SplitSpec(p, 1, 3)
    sec = c.random_field(p, (n,), gen)
    c.check(c.max_abs_err(pipelines.split_recombine(sec, st, spec4),
                          pipelines._split_recombine_plain(
                              sec, st, spec4)[0]) == 0,
            'K4 at (1, 3) differs from its plain version')
    for t, m, mode in K5_PARTIES:
        spec5 = pipelines.SgnSpec(p, t, m, 32, LT=mode == 'LT',
                                  EQ=mode == 'EQ')
        a5 = c.random_field(p, (m, n), gen)
        c.check(c.max_abs_err(
            pipelines.sgn_step(a5, st, nonce, spec5),
            pipelines._sgn_step_plain(a5, st, nonce, spec5)) == 0,
            f'K5 ({mode}) at ({t}, {m}) differs from its plain version')


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('trees', nargs='*', metavar='LABEL=DIR')
    parser.add_argument('--rounds', type=int, default=2)
    parser.add_argument('--parties', action='store_true',
                        help='also time K5 and K7 at other (t, m)')
    parser.add_argument('--wide', action='store_true',
                        help='time only the wide K5 and K6')
    parser.add_argument('--small', action='store_true',
                        help='time only K5 and K3 on small calls')
    parser.add_argument('--tune', action='store_true',
                        help='with --small: the CTA route\'s shapes and '
                        'crossover')
    parser.add_argument('--one', nargs=2, metavar=('DIR', 'LABEL'),
                        help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.one:
        one(*args.one, args.parties, args.wide, args.small, args.tune)
        return 0
    if not args.trees:
        parser.error('name at least one LABEL=DIR')
    trees = [t.split('=', 1) for t in args.trees]
    for r in range(args.rounds):
        for label, root in (trees if r % 2 == 0 else trees[::-1]):
            subprocess.run([sys.executable, os.path.abspath(__file__),
                            '--one', root, label]
                           + ['--parties'] * args.parties
                           + ['--wide'] * args.wide
                           + ['--small'] * args.small
                           + ['--tune'] * args.tune, check=True,
                           timeout=1800)
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=30).stdout.strip())
    return 0


if __name__ == '__main__':
    sys.exit(main())
