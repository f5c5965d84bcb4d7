#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's paths on one NVIDIA card.

    python3 chip_smoke.py          # from the root of a checkout, one card

Paths on the co-located plane, all at ``SimRuntime(3)`` (t = 1): three as
``bench.py`` drives the JAX package, at ``SecInt(32)`` (the 64-bit field):
secure multiplication (input, ``np_multiply``, output), secure comparison
(``np_less``, ``np_equal``, ``np_sgn``, ``np_maximum`` and the BNN sign at
2^20 elements, bench.py:203) and the split/recombine round (bench.py:88);
and the BNN flagship (``demos/np_bnnmnist.py``) at ``SecInt(14)``, through
the port's runner ``mpyc_tpu_torch/demos/np_bnnmnist.py``: the MNIST flow
at full width and its selftest. Phases, each printing one line with its
elapsed seconds:

1. probe: a CUDA card must be present (else exit 1, no result); print its
   name and its power limit as nvidia-smi reports them;
2. build: compile the kernels with nvcc (csrc/, sm_90a); print nvcc's
   warnings, each kernel's registers, stack frame, spills and shared
   memory as ptxas reports them, K5's thread block size B, and the build
   time;
3. kernels: K1 (keccak_ctr), K2 (squeeze_mont) and K3 (reshare_mul, also at
   a size that is no multiple of its thread block) at the main path's sizes,
   K4 (split_recombine) with its shares at 2^16 and at
   the round's 3,010,560 elements, K5 (sgn_step) in its three modes at
   2^16 and at the comparison's 2^20 elements, and in LT mode at the BNN's
   l = 14 and l = 10 (SecInt(14)'s field) at 2^16 and at a BNN layer's
   bucket of 2^19 elements, each equal bit for bit to its
   plain PyTorch version on the same inputs (tolerance: exact, integer
   arithmetic), K1 also to hashlib; time each and its plain version with
   CUDA events, beside its bound; for K5 also the permutations per warp of
   32 elements that its stage serialises, from a model of the stage
   (``sgn_squeezes``, held against the kernel source's own count by
   tests/test_torch_kernels_host.py);
4. main path: 256 and 4096 values in, product out and checked against
   a*b; then 2^22 values from int64 arrays, 10 chained
   ``X = np_multiply(X, B)``, and 4096 sampled outputs checked against the
   plaintext product mod p;
5. comparison: A, B of 2^20 values in [-2^30, 2^30) (one pair in 8
   equal, the range ends planted); np_less, np_equal, np_sgn(A - B),
   np_maximum and the BNN sign np_sgn(A, LT=True) * -2 + 1, every output
   checked against the plaintext; the median of 7 np_less calls as
   comparisons/s; one try of torch.profiler over 3 more np_less calls:
   device time by kernel and the device's idle share, or "no device time";
6. split/recombine: 3,010,560 secrets, 100 chained rounds, the output
   equal to the input; ms per round;
7. bnn: the MNIST flow on test images 0-99 (B = 100; fc 784-4096-4096-
   4096-10, SecInt(14)), twice (cold, warm): all 100 predictions equal
   to the plaintext model of the protocol (``plain_forward``), the count
   correct against the labels, seconds a pass and images/s; then, outside
   the counted run, per layer at its shapes the device ms of the plane
   GEMM (``torch._int_mm``), the planes and the GEMM, the carry and fold,
   K3 and K5 (CUDA events); one try of torch.profiler over a warm pass;
8. selftest: the runner's 64-32-10 network with ``rt.input`` at B = 100
   (SecInt(14)'s 22-byte input draws: K1 and the split), predictions
   equal to the plaintext forward pass;
9. report: one JSON line of the kernels, the card's name and power limit,
   and last ``{"ok": true, "device": {...}}``.

Each of phases 4-8 zeroes the launch counters just before it and reads them
just after; each must show that the kernels of its path ran (K1-K3, then
K2, K3 and K5, then K4, then K3 and K5, then K1, K3 and K5).

Any failed check raises, and the script exits non-zero without the last
line. Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import faulthandler
import json
import os
import re
import subprocess
import sys
import time
from hashlib import shake_128

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from mpyc_tpu_torch import sectypes  # noqa: E402
from mpyc_tpu_torch.models import pipelines  # noqa: E402
from mpyc_tpu_torch.ops import keccak, limb, rng  # noqa: E402
from mpyc_tpu_torch.ops.fieldops import prime_field_ctx  # noqa: E402
from mpyc_tpu_torch.parallel.simulator import SimRuntime  # noqa: E402

N_POOL = 256                   # values whose input draws use the pool
N_CMP = 1 << 20                # comparison: bench.py:203, one K5 chunk
CMP_CALLS = 7                  # np_less calls timed (median)
PROFILE_CALLS = 3              # np_less calls under torch.profiler
N_KCHECK = 1 << 16             # K4, K5 against their plain versions
N_RAGGED = 100003              # K3 at no multiple of its thread block
N_SPLIT = 147 * 16 * 128 * 10  # bench.py:105-108 (3,010,560)
SPLIT_ROUNDS = 100             # chained split/recombine rounds
N_SMALL = 4096                 # bench.py's in-run correctness check
N_BIG = 1 << 22                # bench.py's size on the device
ROUNDS = 10                    # chained np_multiply calls
SAMPLE = 4096                  # opened outputs checked against plaintext
N_BNN = 100                    # images of the bnn phase (B), 0-99
N_BNN_BUCKET = 1 << 19         # bucket of a BNN layer's 100 x 4096 sums
N_SELFTEST = 100               # batch of the selftest phase
M, T = 3, 1
DEADLINE_S = 1100              # hard stop, inside the 1200 s limit

# Peaks for bound_ms (H100 SXM, 700 W; see PERF.md). The integer rate is
# the card's 64 INT32 lanes per SM: 132 SMs x 64 x 1.98 GHz = 16.7e12 32-bit
# integer instructions/s, a quarter of the 67 TFLOP/s float32 peak (128
# lanes, 2 flops per FMA).
HBM_BYTES_PER_S = 3.35e12
INT_OPS_PER_S = 132 * 64 * 1.98e9
INT8_TENSOR_OPS_PER_S = 1979e12   # dense int8 tensor-core peak
# 32-bit instructions, counted at their fewest: a Keccak-f round is 20
# three-input XORs (column parities) + 10 funnel shifts (theta rotations)
# + 50 XORs (theta) + 48 funnel shifts (rho) + 50 three-input chi ops + 2
# (iota) on the 32-bit halves; a two-limb Montgomery product 10 32x32-bit
# products of 2 instructions each + 16 adds/selects; a modular add 8.
KECCAK_F_OPS = 24 * 180
MONT_MUL_OPS = 36
ADD_MOD_OPS = 8

SOURCE = 'mpyc_tpu_torch/csrc/kernels.cu'
KERNELS = {
    'keccak_ctr': dict(replaces='mpyc_tpu/ops/keccak.py:215',
                       wrapper=keccak.keccak_ctr, source=SOURCE),
    'squeeze_mont': dict(replaces='mpyc_tpu/ops/rng.py:99',
                         wrapper=rng.squeeze_mont, source=SOURCE),
    'reshare_mul': dict(replaces='mpyc_tpu/models/pipelines.py:87',
                        wrapper=pipelines.reshare_mul, source=SOURCE),
    'split_recombine': dict(replaces='mpyc_tpu/models/pipelines.py:378',
                            wrapper=pipelines.split_recombine,
                            source=SOURCE),
    'sgn_step': dict(replaces='mpyc_tpu/models/pipelines.py:503',
                     wrapper=pipelines.sgn_step,
                     source='mpyc_tpu_torch/csrc/sgn.cuh'),
}
# the kernels each path must launch
PATH_KERNELS = {'main path': ('keccak_ctr', 'squeeze_mont', 'reshare_mul'),
                'comparison': ('squeeze_mont', 'reshare_mul', 'sgn_step'),
                'split/recombine': ('split_recombine',),
                'bnn': ('reshare_mul', 'sgn_step'),
                'selftest': ('keccak_ctr', 'reshare_mul', 'sgn_step')}


def say(msg: str) -> None:
    print(msg, flush=True)


class Phase:
    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        say(f'[{self.name}] start')
        return self

    def __exit__(self, exc_type, exc, tb):
        dt = time.perf_counter() - self.t0
        status = 'ok' if exc_type is None else f'FAILED ({exc_type.__name__})'
        say(f'[{self.name}] {status} in {dt:.3f} s')
        return False


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def reset_counts() -> None:
    for k in KERNELS.values():
        k['wrapper'].launches = 0


def counts() -> dict:
    return {name: k['wrapper'].launches for name, k in KERNELS.items()}


def bound(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / INT_OPS_PER_S * 1e3
    return (t_ops, 'operations') if t_ops >= t_bytes else (t_bytes, 'bytes')


def draw_ops(n_draws: int, W: int, L: int = 2) -> int:
    """Montgomery work to map n_draws W-word draws into GF(p)."""
    nc = -(-W // L)
    return n_draws * (nc * MONT_MUL_OPS + (nc - 1) * ADD_MOD_OPS)


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of fn over iters calls (after one warm-up call)."""
    fn()
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    ev0.record()
    for _ in range(iters):
        fn()
    ev1.record()
    torch.cuda.synchronize()
    return ev0.elapsed_time(ev1) / iters


def short_name(mangled: str) -> str:
    """name<args> of a mangled kernel name of the port (``_ZN3mtt10sgn_
    kernelILi1E...``); of a demangled one (a profiler's), the name without
    its return type and parameters, cut to 100 characters."""
    m = re.match(r'_ZN3mtt(\d+)', mangled)
    if not m:
        name = mangled.removeprefix('void ').replace(
            '(anonymous namespace)::', '')
        return name.partition('(')[0].strip()[:100]
    k = m.end()
    name = mangled[k:k + int(m.group(1))]
    rest = mangled[k + int(m.group(1)):]
    if rest.startswith('I'):
        args = re.findall(r'L[ib](\d+)E', rest[:rest.find('EE') + 2])
        name += f'<{",".join(args)}>'
    return name


def ptxas_report(log: str) -> dict:
    """Per function of nvcc's -Xptxas -v report: registers, stack frame,
    spill stores and loads, and static shared memory, in bytes."""
    res, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties "
                      r"for )(\w+)", line)
        if m:
            fn = short_name(m.group(1))
            res.setdefault(fn, {})
            continue
        if fn is None:
            continue
        m = re.search(r'(\d+) bytes stack frame, (\d+) bytes spill stores, '
                      r'(\d+) bytes spill loads', line)
        if m:
            res[fn].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                           spill_loads=int(m.group(3)))
        m = re.search(r'Used (\d+) registers', line)
        if m:
            res[fn]['registers'] = int(m.group(1))
            sm = re.search(r'(\d+) bytes smem', line)
            res[fn]['smem'] = int(sm.group(1)) if sm else 0
    return res


def sgn_squeezes(spec, n: int, threads: int) -> tuple:
    """Model of K5's stage (csrc/sgn.cuh, csrc/stage.cuh) on n elements in
    thread blocks (CTAs) of ``threads``: each CTA squeezes every block of
    each of its ranges once, block b of a range by thread b % threads, so
    a warp runs a permutation in every round of the range that gives any
    of its lanes a block. Ranges: the CTA's words of stream A, then per
    call of stream B (``SgnSpec.draw_calls``) and per set its draws.
    Returns (blocks squeezed, permutations per warp of 32 elements as the
    warps serialise them)."""
    rate_words = keccak.RATE // 4
    epb = keccak.RATE // 16          # 16-byte draws a block
    squeezed = warp_perms = 0
    for e0 in range(0, n, threads):
        cnt = min(threads, n - e0)
        spans = [(e0 * spec.wpe, cnt * spec.wpe, rate_words)]
        off = 0
        for sets, c in spec.draw_calls():
            spans += [(off + kk * n * c + e0 * c, cnt * c, epb)
                      for kk in range(sets)]
            off += sets * n * c
        for first, count, per in spans:
            nb = (first + count - 1) // per - first // per + 1
            squeezed += nb
            for k0 in range(0, nb, threads):
                warp_perms += -(-min(threads, nb - k0) // 32)
    return squeezed, warp_perms * 32 / n


def profile_calls(fn, calls: int, top: int | None = None) -> list:
    """One try of torch.profiler over ``calls`` calls of fn: lines of
    device time by kernel (the ``top`` largest and the rest summed, if
    given) and the device's idle share over the traced window (first to
    last event), or "no device time"."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = list(prof.events())
    dev = [e for e in events
           if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev:
        return ['no device time']
    by_name = {}
    for e in dev:
        name = short_name(e.name)
        by_name[name] = by_name.get(name, 0.0) + (e.time_range.end
                                                  - e.time_range.start)
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev)
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s0, e0 in spans[1:]:
        if s0 > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s0, e0
        else:
            cur_e = max(cur_e, e0)
    busy += cur_e - cur_s
    window = (max(e.time_range.end for e in events)
              - min(e.time_range.start for e in events))
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])
    lines = [f'{name}: {us / 1e3:.4f} ms device time'
             for name, us in ranked[:top]]
    if top is not None and len(ranked) > top:
        rest = sum(us for _, us in ranked[top:])
        lines.append(f'{len(ranked) - top} other kernels: {rest / 1e3:.4f} '
                     'ms device time')
    lines.append(f'device busy {busy / 1e3:.4f} ms of a {window / 1e3:.4f} '
                 f'ms window: idle share {1 - busy / window:.4f}')
    return lines


def max_abs_err(x: torch.Tensor, y: torch.Tensor) -> int:
    """Largest difference of two uint32 word tensors (held as int32)."""
    xa = x.to(torch.int64) & 0xFFFFFFFF
    ya = y.to(torch.int64) & 0xFFFFFFFF
    return int((xa - ya).abs().max().item()) if x.numel() else 0


def random_shares(p: int, shape, gen: np.random.Generator) -> torch.Tensor:
    """Canonical (< p) random two-limb field data, as stored limbs."""
    lo = gen.integers(0, 1 << 32, shape, dtype=np.uint64)
    hi = gen.integers(0, p >> 32, shape, dtype=np.uint64)
    u = (hi << np.uint64(32)) | lo
    limbs = np.stack([(u & np.uint64(0xFFFFFFFF)).astype(np.uint32),
                      (u >> np.uint64(32)).astype(np.uint32)], axis=-1)
    return torch.from_numpy(limbs.view(np.int32)).cuda()


def check_kernels(p: int) -> dict:
    """Phase 3: each kernel against its plain version at the main path's
    sizes; returns per-kernel measurements."""
    gen = np.random.default_rng(7)
    res = {}
    key = bytes(gen.integers(0, 256, 32, dtype=np.uint8))

    # K1 at the main path's shape, the pool refill of 512 blocks for the
    # small input draws, and at the blocks of one 2^22-element draw of 24
    # bytes (7 a block): instance j is shake_128(key || nonce || pad8 || j)
    l_in = ((p - 1).bit_length() + 7 >> 3) + 16
    n_pool = rng._POOL_BLOCKS
    n1 = rng.blocks_needed(N_BIG, l_in)
    prefix = key + (5).to_bytes(8, 'little')
    st_np, lane = keccak.ctr_state(prefix)
    st = keccak.state_tensor(st_np, 'cuda')
    err1 = 0
    for n in (n_pool, n1):
        out_k = keccak.keccak_ctr(st, n, lane)
        out_p = keccak._keccak_ctr_plain(st, n, lane)
        torch.cuda.synchronize()
        err1 = max(err1, max_abs_err(out_k, out_p))
        check(err1 == 0, f'K1 ({n} blocks) differs from its plain version')
    head = out_k[:256].cpu().numpy().view(np.uint32)
    for j in range(256):
        msg = prefix + j.to_bytes(8, 'little')
        check(head[j].astype('<u4').tobytes() == shake_128(msg).digest(168),
              f'K1 instance {j} differs from hashlib')
    say(f'  K1 keccak_ctr: {n_pool} and {n1} blocks, equal to plain and '
        'hashlib')

    def k1_meas(n):
        b, o = bound(n * 168 + 200, n * KECCAK_F_OPS)
        return dict(
            shape=f'{n} blocks', max_abs_err=err1,
            ms=cuda_ms(lambda: keccak.keccak_ctr(st, n, lane), 20),
            plain_ms=cuda_ms(lambda: keccak._keccak_ctr_plain(st, n, lane),
                             2),
            bound_ms=b, bound_by=o)
    res['keccak_ctr'] = k1_meas(n_pool)
    res['keccak_ctr (one 2^22-element draw)'] = k1_meas(n1)

    # K2 at the main path's input draws (4096 and 2^22 draws of 24 bytes),
    # and at the reshare stream's 16-byte draws
    err2 = 0
    for n, l_bytes in ((N_SMALL, l_in), (N_BIG, l_in),
                       (N_BIG, rng.fused_draw_bytes(p))):
        out_k = rng.squeeze_mont(st, n, l_bytes, p, lane)
        out_p = rng._squeeze_mont_plain(st, n, l_bytes, p, lane)
        torch.cuda.synchronize()
        err2 = max(err2, max_abs_err(out_k, out_p))
        check(err2 == 0, f'K2 ({n} draws of {l_bytes} bytes) differs from '
              'plain')
        say(f'  K2 squeeze_mont: {n} draws of {l_bytes} bytes, '
            'equal to plain')
    W = l_in // 4
    nb = rng.blocks_needed(N_BIG, l_in)
    b, o = bound(N_BIG * 8 + 200, nb * KECCAK_F_OPS + draw_ops(N_BIG, W))
    res['squeeze_mont'] = dict(
        shape=f'{N_BIG} draws of {l_in} bytes', max_abs_err=err2,
        ms=cuda_ms(lambda: rng.squeeze_mont(st, N_BIG, l_in, p, lane), 20),
        plain_ms=cuda_ms(
            lambda: rng._squeeze_mont_plain(st, N_BIG, l_in, p, lane), 2),
        bound_ms=b, bound_by=o)

    # A draw too large for the pool (the 4096-element input's 586 blocks)
    # squeezes into the field with K2; the other way to the same elements
    # is K1 and a reduction in torch, as the JAX package draws them
    ctx = prime_field_ctx(p)
    ms_k2 = cuda_ms(lambda: rng.squeeze_mont(st, N_SMALL, l_in, p, lane), 20)
    nb_small = rng.blocks_needed(N_SMALL, l_in)
    ms_k1 = cuda_ms(lambda: ctx.reduce_chunks(rng.words_to_elements(
        keccak.keccak_ctr(st, nb_small, lane), N_SMALL, l_in, ctx.L)), 20)
    say(f'  {N_SMALL} draws of {l_in} bytes ({nb_small} blocks): K2 '
        f'{ms_k2:.4f} ms, K1 + torch reduction {ms_k1:.4f} ms')

    # K3 on (3, 2^22, 2) shares, fused product
    spec = pipelines.ReshareSpec(p, T, M)
    a = random_shares(p, (M, N_BIG), gen)
    bb = random_shares(p, (M, N_BIG), gen)
    nonce = (0xFFFFFFFF, 3)
    out_k = pipelines.reshare_mul(a, bb, st, nonce, spec)
    out_p = pipelines._reshare_mul_plain(a, bb, st, nonce, spec)
    torch.cuda.synchronize()
    err3 = max_abs_err(out_k, out_p)
    check(err3 == 0, 'K3 differs from its plain version')
    out_k = pipelines.reshare_mul(a, None, st, nonce, spec)
    out_p = pipelines._reshare_mul_plain(a, None, st, nonce, spec)
    torch.cuda.synchronize()
    check(max_abs_err(out_k, out_p) == 0,
          'K3 (without the product) differs from its plain version')
    for b_r in (bb[:, :N_RAGGED].contiguous(), None):
        a_r = a[:, :N_RAGGED].contiguous()
        out_k = pipelines.reshare_mul(a_r, b_r, st, nonce, spec)
        out_p = pipelines._reshare_mul_plain(a_r, b_r, st, nonce, spec)
        torch.cuda.synchronize()
        err3 = max(err3, max_abs_err(out_k, out_p))
        check(err3 == 0, f'K3 at {N_RAGGED} elements differs from its plain '
              'version')
    del out_k, out_p, a_r, b_r
    W3 = spec.l_bytes // 4
    nb3 = rng.blocks_needed(N_BIG, spec.l_bytes)
    ops3 = (nb3 * KECCAK_F_OPS + draw_ops(N_BIG, W3)
            + N_BIG * spec.n_send * 2 * MONT_MUL_OPS
            + N_BIG * (spec.n_send - 1) * ADD_MOD_OPS
            + N_BIG * M * (MONT_MUL_OPS + ADD_MOD_OPS))
    b, o = bound(N_BIG * (M * 2 * 8 + M * 8), ops3)
    res['reshare_mul'] = dict(
        shape=f'({M}, {N_BIG}, 2) shares, fused product', max_abs_err=err3,
        ms=cuda_ms(lambda: pipelines.reshare_mul(a, bb, st, nonce, spec),
                   20),
        plain_ms=cuda_ms(
            lambda: pipelines._reshare_mul_plain(a, bb, st, nonce, spec), 2),
        bound_ms=b, bound_by=o)
    say(f'  K3 reshare_mul: ({M}, {N_BIG}, 2) and ({M}, {N_RAGGED}, 2), '
        'fused and unfused, equal to plain')
    return res


def check_slice_kernels(p: int) -> dict:
    """Phase 3, second part: K4 and K5 against their plain versions (bit
    for bit) at 2^16 elements and at the paths' shapes, K4 at the round's
    3,010,560 elements and K5 in each of its three modes at 2^20, each
    timed, K5 (LT, np_less's mode) and K4 also with their plain versions.
    Returns per-kernel measurements."""
    from mpyc_tpu_torch import _build
    sgn_threads = _build.library().lib.mtt_sgn_threads()
    gen = np.random.default_rng(8)
    res = {}
    st_np = keccak._absorb_host(bytes(gen.integers(0, 256, 32,
                                                   dtype=np.uint8))
                                + bytes(8))
    st = keccak.state_tensor(st_np, 'cuda')

    # K4 with its shares
    spec4 = pipelines.SplitSpec(p, T, M)
    err4 = 0
    for n in (N_KCHECK, N_SPLIT):
        sec = random_shares(p, (n,), gen)
        sh = torch.empty((M, n, 2), dtype=torch.int32, device='cuda')
        out = pipelines.split_recombine(sec, st, spec4, shares=sh)
        want, want_sh = pipelines._split_recombine_plain(sec, st, spec4)
        torch.cuda.synchronize()
        err4 = max(err4, max_abs_err(out, want), max_abs_err(sh, want_sh),
                   max_abs_err(out, sec))
        check(err4 == 0, f'K4 ({n} elements) differs from its plain version')
        say(f'  K4 split_recombine: {n} elements, output and shares equal '
            'to plain, output equal to input')
    del sh, want_sh
    mont, adds = spec4.field_ops()
    ops4 = (rng.blocks_needed(T * N_SPLIT, spec4.l_bytes) * KECCAK_F_OPS
            + draw_ops(T * N_SPLIT, spec4.l_bytes // 4)
            + N_SPLIT * (mont * MONT_MUL_OPS + adds * ADD_MOD_OPS))
    b, o = bound(N_SPLIT * 2 * 8, ops4)
    res['split_recombine'] = dict(
        shape=f'{N_SPLIT} secrets', max_abs_err=err4,
        ms=cuda_ms(lambda: pipelines.split_recombine(sec, st, spec4), 20),
        plain_ms=cuda_ms(
            lambda: pipelines._split_recombine_plain(sec, st, spec4), 2),
        bound_ms=b, bound_by=o)
    del sec, out, want

    # K5 in each mode at 2^16 and at the comparison's 2^20 elements
    err5 = 0
    nonce = (0xFFFFFFFF, 5)
    for mode in pipelines.SGN_MODES:
        spec5 = pipelines.SgnSpec(p, T, M, 32, 30, LT=mode == 'LT',
                                  EQ=mode == 'EQ')
        torch.cuda.reset_peak_memory_stats()
        for n in (N_KCHECK, N_CMP):
            a = random_shares(p, (M, n), gen)
            out = pipelines.sgn_step(a, st, nonce, spec5)
            want = pipelines._sgn_step_plain(a, st, nonce, spec5)
            torch.cuda.synchronize()
            err5 = max(err5, max_abs_err(out, want))
            check(err5 == 0, f'K5 ({mode}, {n} elements) differs from its '
                  'plain version')
            del out, want
        mont, adds, ops5 = sgn_ops(spec5, N_CMP)
        b, o = bound(N_CMP * M * 2 * 4 * 2, ops5)
        iters = 10 if mode == 'LT' else 5
        ms = cuda_ms(lambda: pipelines.sgn_step(a, st, nonce, spec5), iters)
        squeezed, per_warp = sgn_squeezes(spec5, N_CMP, sgn_threads)
        say(f'  K5 sgn_step {mode} stage model at {N_CMP} elements, B = '
            f'{sgn_threads}: {squeezed} blocks squeezed against '
            f'{spec5.blocks(N_CMP)} in the stream, {per_warp:.4f} '
            'permutations per warp of 32 elements')
        say(f'  K5 sgn_step {mode}: {N_KCHECK} and {N_CMP} elements equal '
            f'to plain (peak {torch.cuda.max_memory_allocated() / 2**30:.1f}'
            f' GiB allocated); per element {mont} Montgomery products, '
            f'{adds:.0f} modular adds/subs, {spec5.draws_per_element()} '
            'draws, '
            f'{spec5.blocks(N_CMP) / N_CMP:.4f} stream blocks; {ms:.4f} ms '
            f'at {N_CMP} elements, bound {b:.4f} ms ({o}), {ms / b:.2f}x')
        if mode == 'LT':      # np_less's mode goes into the kernels line
            res['sgn_step'] = dict(
                shape=f'({M}, {N_CMP}, 2) shares, LT', ms=ms,
                plain_ms=cuda_ms(lambda: pipelines._sgn_step_plain(
                    a, st, nonce, spec5), 1),
                bound_ms=b, bound_by=o)
        del a
    res['sgn_step']['max_abs_err'] = err5

    # K5 (LT) at the BNN's widths, on SecInt(14)'s field: l = 14 (fc1, the
    # argmax) and l = 10 (fc2, fc3), at 2^16 and at a layer's bucket
    p14 = sectypes.SecInt(14, 'cuda').field.modulus
    for l in (14, 10):
        spec5 = pipelines.SgnSpec(p14, T, M, l, 30, LT=True)
        for n in (N_KCHECK, N_BNN_BUCKET):
            a = random_shares(p14, (M, n), gen)
            out = pipelines.sgn_step(a, st, nonce, spec5)
            want = pipelines._sgn_step_plain(a, st, nonce, spec5)
            torch.cuda.synchronize()
            err = max_abs_err(out, want)
            check(err == 0, f'K5 (LT, l = {l}, {n} elements) differs from '
                  'its plain version')
            del out, want
        res[f'sgn_step (LT, l = {l})'] = sgn_meas(
            spec5, a, st, nonce, N_BNN_BUCKET, err)
        r = res[f'sgn_step (LT, l = {l})']
        say(f'  K5 sgn_step LT at l = {l}: {N_KCHECK} and {N_BNN_BUCKET} '
            f'elements equal to plain; per element {r["mont"]} Montgomery '
            f'products, {r["adds"]:.0f} modular adds/subs; {r["ms"]:.4f} ms '
            f'at {N_BNN_BUCKET} elements, bound {r["bound_ms"]:.4f} ms '
            f'({r["bound_by"]}), {r["ms"] / r["bound_ms"]:.2f}x')
        del a
    return res


def sgn_ops(spec, n: int) -> tuple:
    """(field products, adds/subs per element, integer instructions) of
    K5 on n elements as the kernel does them: its field operations
    (SgnSpec.field_ops, held against the source by
    tests/test_torch_kernels_host.py), with c mod 2^l uniform, the
    reduction of its draws and the stream's blocks."""
    draws = n * spec.draws_per_element()
    mont, adds = spec.field_ops(spec.l / 2)
    ops = (spec.blocks(n) * KECCAK_F_OPS
           + draw_ops(draws, spec.l_bytes // 4)
           + n * (mont * MONT_MUL_OPS + adds * ADD_MOD_OPS))
    return mont, adds, ops


def sgn_meas(spec, a, st, nonce, n: int, err: int) -> dict:
    """K5's time at n elements (a: (m, n, 2) shares), its plain version's
    and its bound."""
    mont, adds, ops = sgn_ops(spec, n)
    b, o = bound(n * M * 2 * 4 * 2, ops)
    return dict(
        shape=f'({M}, {n}, 2) shares, {spec.mode}, l = {spec.l}',
        max_abs_err=err, mont=mont, adds=adds,
        ms=cuda_ms(lambda: pipelines.sgn_step(a, st, nonce, spec), 10),
        plain_ms=cuda_ms(lambda: pipelines._sgn_step_plain(
            a, st, nonce, spec), 1),
        bound_ms=b, bound_by=o)


def run_main_path(device, n_small=N_SMALL, n_big=N_BIG, rounds=ROUNDS,
                  sample=SAMPLE, seed=0) -> dict:
    """The port's main path through the user's entry points; raises on a
    wrong result. Returns the field modulus and, on the card, the device
    time of each chained np_multiply (ms, CUDA events)."""
    rt = SimRuntime(M, device=device)
    rt.start()
    secint = rt.SecInt(32)
    p = secint.field.modulus

    # bench.py:58-65: a small secure product, opened and compared; at
    # N_POOL values the input draws come from the pooled stream (K1), at
    # n_small they squeeze straight into the field (K2)
    for n in (N_POOL, n_small):
        a = np.arange(n, dtype=object)
        b = (a * 7 + 1) % 9999
        A = rt.input(secint.array(a))[0]
        B = rt.input(secint.array(b))[0]
        got = rt.output(rt.np_multiply(A, B))
        check(got.shape == (n,) and (got.astype(object) == a * b).all(),
              f'secure product of {n} values wrong')

    gen = np.random.default_rng(seed)
    vals = gen.integers(-(1 << 31), 1 << 31, n_big, dtype=np.int64)
    bvals = gen.integers(-(1 << 31), 1 << 31, n_big, dtype=np.int64)
    A = rt.input(secint.array(vals))[0]
    B = rt.input(secint.array(bvals))[0]
    X = rt.np_multiply(A, B)
    per_call_ms = []
    on_card = torch.device(device).type == 'cuda'
    for _ in range(rounds):
        if on_card:
            ev0 = torch.cuda.Event(enable_timing=True)
            ev1 = torch.cuda.Event(enable_timing=True)
            ev0.record()
            X = rt.np_multiply(X, B)
            ev1.record()
            per_call_ms.append((ev0, ev1))
        else:
            X = rt.np_multiply(X, B)
    opened = rt.output(X)
    if on_card:
        torch.cuda.synchronize()
        per_call_ms = [e0.elapsed_time(e1) for e0, e1 in per_call_ms]
    check(opened.shape == (n_big,), 'opened product has the wrong shape')
    idx = gen.choice(n_big, size=min(sample, n_big), replace=False)
    for i in idx:
        want = int(vals[i]) * pow(int(bvals[i]), rounds + 1, p) % p
        check(int(opened[i]) % p == want, f'product {i} wrong')
    rt.shutdown()
    return dict(p=p, per_call_ms=per_call_ms)


def run_compare(device, n=N_CMP, calls=CMP_CALLS, seed=1,
                profile=False) -> dict:
    """Secure comparison through the user's entry points at n elements;
    raises on a wrong result. Returns, on the card, the device time of each
    timed np_less call (ms, CUDA events) and, with ``profile``, the lines
    of ``profile_calls`` over PROFILE_CALLS more."""
    rt = SimRuntime(M, device=device)
    rt.start()
    secint = rt.SecInt(32)
    gen = np.random.default_rng(seed)
    half = 1 << 30      # a - b must fit the 32 bits that np_less compares
    a = gen.integers(-half, half, n, dtype=np.int64)
    b = gen.integers(-half, half, n, dtype=np.int64)
    same = gen.choice(n, n // 8, replace=False)
    b[same] = a[same]
    ends = [(-half, half - 1), (half - 1, -half), (-half, -half),
            (half - 1, half - 1), (0, 0)]
    for i, (x, y) in enumerate(ends[:n]):
        a[i], b[i] = x, y
    A = rt.input(secint.array(a))[0]
    B = rt.input(secint.array(b))[1]
    cases = {
        'np_less': (lambda: rt.np_less(A, B), a < b),
        'np_equal': (lambda: rt.np_equal(A, B), a == b),
        'np_sgn': (lambda: rt.np_sgn(A - B), np.sign(a - b)),
        'np_maximum': (lambda: rt.np_maximum(A, B), np.maximum(a, b)),
        'bnn_sign': (lambda: rt.np_sgn(A, LT=True) * -2 + 1,
                     np.where(a < 0, -1, 1)),
    }
    for name, (secure, want) in cases.items():
        got = rt.output(secure())
        check(got.shape == (n,), f'{name}: wrong shape')
        bad = np.flatnonzero(got != want)
        check(bad.size == 0, f'{name}: {bad.size} of {n} outputs wrong, '
              f'first at {bad[:5].tolist()}')
    per_call_ms = []
    if torch.device(device).type == 'cuda':
        for _ in range(calls):
            ev0 = torch.cuda.Event(enable_timing=True)
            ev1 = torch.cuda.Event(enable_timing=True)
            ev0.record()
            rt.np_less(A, B)
            ev1.record()
            per_call_ms.append((ev0, ev1))
        torch.cuda.synchronize()
        per_call_ms = [e0.elapsed_time(e1) for e0, e1 in per_call_ms]
    trace = []
    if profile:
        try:   # one try: the profiler's tracing of the card is untried
            trace = profile_calls(lambda: rt.np_less(A, B), PROFILE_CALLS)
        except Exception as exc:  # noqa: BLE001 (reported, not a check)
            trace = [f'torch.profiler failed: {exc!r}']
    rt.shutdown()
    return dict(per_call_ms=per_call_ms, checked=list(cases), trace=trace)


def run_split_recombine(device, n=N_SPLIT, rounds=SPLIT_ROUNDS,
                        seed=2) -> dict:
    """bench.py:88's round trip on n secrets, chained rounds; raises unless
    the output equals the input. Returns, on the card, ms per round."""
    p = sectypes.SecInt(32, device).field.modulus
    ctx = prime_field_ctx(p)
    step = pipelines.make_split_recombine(p, T, M)
    state = keccak.state_tensor(
        keccak._absorb_host(b'\x42' * 32 + b'bench-coef-stream'), device)
    gen = np.random.default_rng(seed)
    secrets = ctx.encode(gen.integers(0, 1 << 62, n, dtype=np.int64),
                         device)
    on_card = torch.device(device).type == 'cuda'
    if on_card:
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        ev0.record()
    x = secrets
    for _ in range(rounds):
        x = step(x, state)
    ms = None
    if on_card:
        ev1.record()
        torch.cuda.synchronize()
        ms = ev0.elapsed_time(ev1) / rounds
    check(torch.equal(x, secrets), 'split/recombine changed its input')
    return dict(ms_per_round=ms)


def run_bnn(device, batch=N_BNN, passes=2, profile=False) -> dict:
    """The runner's MNIST flow on test images 0..batch-1 through the user's
    entry points, ``passes`` times (the first cold); raises unless every
    pass's predictions equal the plaintext model of the protocol. Returns
    the count correct against the labels, the set-up seconds (weights
    loaded and encoded on the device), the seconds of each pass and, with
    ``profile``, the lines of ``profile_calls`` over one more pass."""
    from mpyc_tpu_torch.demos import np_bnnmnist as bnn
    rt = SimRuntime(M, device=device)
    rt.start()
    secint = rt.SecInt(bnn.L_IN)
    labels, images = bnn.load_mnist(0, batch)
    on_card = torch.device(device).type == 'cuda'
    t0 = time.perf_counter()
    layers = {name: bnn.load_layer(name) for name in bnn.LAYERS}
    slayers = bnn.secure_layers(secint, layers)
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    stats = {}
    model = bnn.plain_forward(images, layers, stats)
    pass_s = []
    for _ in range(passes):
        t0 = time.perf_counter()
        preds = bnn.secure_forward(rt, secint, images, slayers)
        pass_s.append(time.perf_counter() - t0)   # output is on the host
        bad = np.flatnonzero(preds != model)
        check(preds.shape == (batch,) and bad.size == 0,
              f'bnn: {bad.size} of {batch} predictions differ from the '
              f'plaintext model, first at {bad[:5].tolist()}')
    trace = []
    if profile:
        try:   # one try, as in the comparison phase
            trace = profile_calls(
                lambda: bnn.secure_forward(rt, secint, images, slayers), 1,
                top=20)
        except Exception as exc:  # noqa: BLE001 (reported, not a check)
            trace = [f'torch.profiler failed: {exc!r}']
    rt.shutdown()
    return dict(correct=int((preds == labels).sum()), setup_s=setup_s,
                pass_s=pass_s, trace=trace, stats=stats)


def bnn_components(batch=N_BNN) -> list:
    """Device ms of each BNN layer's parts at the flow's shapes (CUDA
    events, random shares of SecInt(14)'s field): the plane GEMM alone
    (``torch._int_mm``), the planes and the GEMM (``plane_gemm``), the
    bucket sums, carry and fold (``fold_planes``), K3 without the product
    on the layer's bucket of 3 x B x N shares, and K5 (LT) at the sign's
    l on that bucket; for fc4 K5 at the argmax's four calls (buckets of
    5, 2, 1 and 1 columns). Each layer's matmul bound: its plane
    contractions' int8 operations over the dense int8 peak, or its bytes
    (operands read, product written) over the memory rate."""
    from mpyc_tpu_torch.demos import np_bnnmnist as bnn
    from mpyc_tpu_torch.ops import fieldops
    p = sectypes.SecInt(bnn.L_IN, 'cuda').field.modulus
    ctx = prime_field_ctx(p)
    gen = np.random.default_rng(9)
    st = keccak.state_tensor(keccak._absorb_host(b'\x07' * 40), 'cuda')
    nonce = (1, 0)
    spec3 = pipelines.ReshareSpec(p, T, M)
    P = 8 * ctx.L

    def bucket(n):
        return max(64, 1 << (n - 1).bit_length())

    rows = []
    shapes = {'fc1': (batch, 784, 4096), 'fc2': (M * batch, 4096, 4096),
              'fc3': (M * batch, 4096, 4096), 'fc4': (M * batch, 4096, 10)}
    for name, (rows_a, K, N) in shapes.items():
        a = random_shares(p, (rows_a, K), gen)
        b = random_shares(p, (K, N), gen)
        pa = fieldops._nibble_planes(a).reshape(P * rows_a, K)
        pb = fieldops._nibble_planes(b.transpose(0, 1)).reshape(P * N, K)
        gemm = cuda_ms(lambda: fieldops._int8_gemm(pa, pb), 5)
        del pa, pb
        planes = cuda_ms(lambda: ctx.plane_gemm(a, b), 3)
        prod = ctx.plane_gemm(a, b)
        fold = cuda_ms(lambda: ctx.fold_planes(prod), 3)
        del prod
        nb = bucket(batch * N)
        x = random_shares(p, (M, nb), gen)
        k3 = cuda_ms(lambda: pipelines.reshare_mul(x, None, st, nonce,
                                                   spec3), 10)
        if name == 'fc4':
            k5 = 0.0
            for cols in (5, 2, 1, 1):
                spec5 = pipelines.SgnSpec(p, T, M, bnn.L_IN, 30, LT=True)
                y = random_shares(p, (M, bucket(batch * cols)), gen)
                k5 += cuda_ms(lambda: pipelines.sgn_step(y, st, nonce,
                                                         spec5), 10)
        else:
            l = bnn.L_IN if name == 'fc1' else bnn.L_HIDDEN
            spec5 = pipelines.SgnSpec(p, T, M, l, 30, LT=True)
            k5 = cuda_ms(lambda: pipelines.sgn_step(x, st, nonce, spec5), 5)
        ops = 2 * (P * rows_a) * K * (P * N)
        b_ms, b_by = bound((rows_a * K + K * N + rows_a * N) * ctx.L * 4, 0)
        t_ops = ops / INT8_TENSOR_OPS_PER_S * 1e3
        if t_ops >= b_ms:
            b_ms, b_by = t_ops, 'operations'
        rows.append(dict(layer=name, M=rows_a, K=K, N=N, gemm_ms=gemm,
                         planes_gemm_ms=planes, fold_ms=fold, k3_ms=k3,
                         k5_ms=k5, matmul_bound_ms=b_ms,
                         matmul_bound_by=b_by))
        del a, b, x
        torch.cuda.empty_cache()
    return rows


def run_selftest(device, batch=N_SELFTEST) -> None:
    """The runner's selftest network through ``rt.input`` (SecInt(14)):
    raises unless its predictions equal the plaintext forward pass."""
    from mpyc_tpu_torch.demos import np_bnnmnist as bnn
    rt = SimRuntime(M, device=device)
    rt.start()
    got, expect = bnn.selftest(rt, rt.SecInt(bnn.L_IN), batch)
    rt.shutdown()
    check(got.shape == (batch,) and (got == expect).all(),
          f'selftest: predictions {got.tolist()} differ from {expect.tolist()}')


def main() -> int:
    faulthandler.dump_traceback_later(DEADLINE_S, exit=True)
    t_all = time.perf_counter()
    if not torch.cuda.is_available():
        print('chip_smoke: torch sees no CUDA device; the port runs on the '
              'card', file=sys.stderr)
        return 1
    with Phase('probe'):
        kind = torch.cuda.get_device_name(0)
        smi = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
        say(f'  torch {torch.__version__}, CUDA {torch.version.cuda}, '
            f'device {kind}, {torch.cuda.device_count()} visible')
        say(f'  nvidia-smi: {smi}')

    with Phase('build'):
        from mpyc_tpu_torch import _build
        lib = _build.library()
        for line in lib.log.splitlines():   # all but ptxas' report
            if line.strip() and not line.startswith('ptxas info') and \
                    'bytes stack frame' not in line:
                say(f'  nvcc: {line.strip()}')
        for fn, r in ptxas_report(lib.log).items():
            say(f'  ptxas {fn}: ' + ', '.join(f'{k} {v}'
                                              for k, v in r.items()))
        say(f'  K5 thread block: B = {lib.lib.mtt_sgn_threads()} elements')
        say(f'  library {lib.path.name}: '
            f'{"built" if lib.built else "found"} in {lib.seconds:.3f} s')

    p = sectypes.SecInt(32, 'cuda').field.modulus
    with Phase('kernels'):
        meas = check_kernels(p)
        meas.update(check_slice_kernels(p))
        for name, r in meas.items():
            say(f'  {name} [{r["shape"]}]: {r["ms"]:.4f} ms, plain '
                f'{r["plain_ms"]:.3f} ms, bound {r["bound_ms"]:.4f} ms '
                f'({r["bound_by"]}) on {smi}')
        torch.cuda.empty_cache()

    launches = dict.fromkeys(KERNELS, 0)

    def drive(path, fn):
        reset_counts()
        res = fn()
        torch.cuda.synchronize()
        got = counts()
        say(f'  launches: {got}')
        for name in PATH_KERNELS[path]:
            check(got[name] > 0, f'kernel {name} was not launched on the '
                  f'{path}')
        for name, c in got.items():
            launches[name] += c
        return res

    with Phase('main path'):
        res = drive('main path', lambda: run_main_path('cuda'))
        ms = sorted(res['per_call_ms'])
        med = ms[len(ms) // 2]
        say(f'  np_multiply of {N_BIG} elements: median {med:.4f} ms '
            f'(calls: {", ".join(f"{x:.4f}" for x in res["per_call_ms"])}),'
            f' {N_BIG / (med / 1e3):.6g} multiplications/s on {smi}')
        torch.cuda.empty_cache()

    with Phase('comparison'):
        res = drive('comparison', lambda: run_compare('cuda', profile=True))
        ms = sorted(res['per_call_ms'])
        med_cmp = ms[len(ms) // 2]
        say(f'  all {N_CMP} outputs correct: {", ".join(res["checked"])}')
        say(f'  np_less of {N_CMP} elements: median {med_cmp:.4f} ms '
            f'(calls: {", ".join(f"{x:.4f}" for x in res["per_call_ms"])}),'
            f' {N_CMP / (med_cmp / 1e3):.6g} comparisons/s on {smi}')
        say(f'  torch.profiler over {PROFILE_CALLS} np_less calls of {N_CMP} '
            'elements:')
        for line in res['trace']:
            say(f'    {line}')
        torch.cuda.empty_cache()

    with Phase('split/recombine'):
        res = drive('split/recombine', lambda: run_split_recombine('cuda'))
        ms_round = res['ms_per_round']
        say(f'  {SPLIT_ROUNDS} chained rounds of {N_SPLIT} secrets, output '
            f'equal to input: {ms_round:.4f} ms per round, '
            f'{N_SPLIT / (ms_round / 1e3):.6g} secrets/s on {smi}')

    with Phase('bnn'):
        res_bnn = res = drive('bnn', lambda: run_bnn('cuda', profile=True))
        cold, warm = res['pass_s']
        say(f'  MNIST images 0-{N_BNN - 1}, fc 784-4096-4096-4096-10, '
            f'SecInt(14), m = {M}: all {N_BNN} predictions equal the '
            f'plaintext model; {res["correct"]}/{N_BNN} correct against the '
            'labels')
        for name, (lo, hi, wide) in res['stats'].items():
            say(f'  plaintext model, {name}: sums in [{lo}, {hi}], {wide} '
                f'of {N_BNN * 4096} activations not +-1')
        say(f'  weights loaded and encoded in {res["setup_s"]:.3f} s; pass '
            f'cold {cold:.4f} s, warm {warm:.4f} s: {N_BNN / warm:.6g} '
            f'images/s on {smi}')
        layers = bnn_components()
        for r in layers:
            say(f'  {r["layer"]} ({r["M"]} x {r["K"]} @ {r["K"]} x '
                f'{r["N"]}): plane GEMM {r["gemm_ms"]:.4f} ms (bound '
                f'{r["matmul_bound_ms"]:.4f} ms, {r["matmul_bound_by"]}), '
                f'planes + GEMM {r["planes_gemm_ms"]:.4f} ms, carry and fold '
                f'{r["fold_ms"]:.4f} ms, K3 {r["k3_ms"]:.4f} ms, K5 '
                f'{r["k5_ms"]:.4f} ms')
        say('  torch.profiler over one warm pass:')
        for line in res['trace']:
            say(f'    {line}')
        torch.cuda.empty_cache()

    with Phase('selftest'):
        drive('selftest', lambda: run_selftest('cuda'))
        say(f'  {N_SELFTEST} x 64 -> 32 -> 10 with rt.input at SecInt(14): '
            'predictions equal the plaintext forward pass')

    say(f'  launches over the five paths: {launches}')
    kernels = [dict(name=name, route='cuda', source=k['source'],
                    replaces=k['replaces'], launches=launches[name],
                    max_abs_err=meas[name]['max_abs_err'],
                    ms=meas[name]['ms'], plain_ms=meas[name]['plain_ms'],
                    bound_ms=meas[name]['bound_ms'],
                    bound_by=meas[name]['bound_by'], library_ms=None)
               for name, k in KERNELS.items()]
    say(json.dumps({'kernels': kernels}))
    say(json.dumps({'np_multiply_median_ms': med, 'elements': N_BIG,
                    'mul_per_s': N_BIG / (med / 1e3),
                    'np_less_median_ms': med_cmp, 'cmp_elements': N_CMP,
                    'cmp_per_s': N_CMP / (med_cmp / 1e3),
                    'split_recombine_ms_per_round': ms_round,
                    'split_elements': N_SPLIT,
                    'bnn_images': N_BNN, 'bnn_correct': res_bnn['correct'],
                    'bnn_cold_s': cold, 'bnn_warm_s': warm,
                    'bnn_images_per_s': N_BNN / warm, 'bnn_layers': layers,
                    'card': smi}))
    say(f'total {time.perf_counter() - t_all:.3f} s')
    say(smi)
    say(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': kind,
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
