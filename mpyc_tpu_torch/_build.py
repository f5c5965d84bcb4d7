"""Builds the CUDA kernels with nvcc and binds them with ctypes.

The sources under ``csrc/`` compile for ``sm_90a`` into one shared library
with a plain C interface: each translation unit (``UNITS``: ``kernels.cu``,
``sgn.cu`` once for each limb count and threshold of K5 (at three to
six limbs t = 1 and a run-time t), ``gf2.cu``, K8, ``wide.cu``,
K3, K6, K7 and K9 on fields of 7 to 48 limbs, and ``sgn_wide.cu`` twice,
K5 on fields of 7 to 48 limbs and K5's CTA route for the small calls of
two to six limbs) in an
``nvcc -c`` of its own, all started together, then one ``nvcc -shared`` links them. The
library goes to ``build/mpyc_tpu_torch/<hash of sources, flags and nvcc
version>/`` beside the package, is written under a temporary name and
moved into place with ``os.replace``: no lock file, nothing to wait on,
and a directory left half built by an interrupted run is simply built
again. Nothing here includes PyTorch's headers or needs ninja.

The library exports ``extern "C" int`` launchers that take device
pointers, sizes, constants and a stream, and return ``cudaGetLastError()``
right after the launch; ``call`` raises if that is not 0.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

CSRC = Path(__file__).resolve().parent / 'csrc'
# every source file, all hashed into the build's directory
SOURCES = ('kernels.cu', 'reshare.cu', 'pow.cu', 'sgn.cu', 'gf2.cu',
           'wide.cu', 'sgn_wide.cu', 'common.cuh', 'keccak.cuh', 'limb.cuh',
           'stage.cuh', 'reshare.cuh', 'sgn.cuh', 'pow.cuh', 'wide.cuh')
# the translation units: (object name, source, extra nvcc flags); K3 at a
# run-time (t, m), K6 and K7 a unit each (MTT_POW_KERNEL); K5's
# launchers one limb count (MTT_SGN_NL) and threshold (MTT_SGN_T) a unit,
# sgn<nl>t<t>: at two limbs t = 1 to MAX_T, at three to six t = 1 and a
# run-time t (t0); sgn_wide.cu's kernel for 7 to 48 limbs, and again for
# K5's CTA route (MTT_SGN_CTA)
UNITS = (('kernels', 'kernels.cu', ()), ('reshare', 'reshare.cu', ()),
         ('pow6', 'pow.cu', ('-DMTT_POW_KERNEL=6',)),
         ('pow7', 'pow.cu', ('-DMTT_POW_KERNEL=7',))) + tuple(
    (f'sgn{nl}t{T}', 'sgn.cu', (f'-DMTT_SGN_NL={nl}', f'-DMTT_SGN_T={T}'))
    for nl, ts in ((2, (4, 3, 2, 1)), (3, (1, 0)), (4, (1, 0)),
                   (5, (1, 0)), (6, (1, 0))) for T in ts) \
    + (('gf2', 'gf2.cu', ()), ('wide', 'wide.cu', ()),
       ('sgn_wide', 'sgn_wide.cu', ()),
       ('sgn_cta', 'sgn_wide.cu', ('-DMTT_SGN_CTA',)))
# units whose objects stay beside the library: the powers' kernels, whose
# SASS chip_smoke.py reads from them rather than from the whole library
KEPT_UNITS = ('pow6', 'pow7')
BUILD_ROOT = Path(__file__).resolve().parent.parent / 'build' / \
    'mpyc_tpu_torch'
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-lineinfo', '-Xptxas', '-v', '-Xcompiler', '-fPIC']
LIB_NAME = 'libmpyc_tpu_torch_kernels.so'
BUILD_TIMEOUT_S = 600

# limits of the kernels' parameter blocks (csrc/kernels.cu)
MAX_NL = 6       # limbs of a field element (p < 2^192; csrc/common.cuh)
# the wide kernels' limb counts (csrc/wide.cu, csrc/sgn_wide.cu: L a launch
# parameter, the field's constants in a device buffer, not in a parameter
# block)
WIDE_MIN_NL = 7
WIDE_MAX_NL = 48  # p < 2^1536
# the wide K5 (csrc/sgn_wide.cu): a CTA of SGN_WIDE_THREADS threads (groups
# of wide_group(L) lanes) takes one element at a time, a launch at most
# SGN_WIDE_GRID CTAs; its draws staged SGN_WIDE_STAGE a set at a time; the
# element's vectors in shared memory where they fit in SGN_WIDE_SMEM_MAX
# bytes with the rest, else in a workspace (sgn_wide_ws_words a CTA), the
# launch's at most SGN_WIDE_WS_BYTES
SGN_WIDE_THREADS = 512
SGN_WIDE_STAGE = 128
SGN_WIDE_WORDS = 64
SGN_WIDE_SMEM_MAX = 232448
SGN_WIDE_GRID = 1024
SGN_WIDE_WS_BYTES = 1 << 31
# K5's CTA route (csrc/sgn_wide.cu built with MTT_SGN_CTA): the same
# kernel at two to six limbs, one element a CTA, for the calls of at most
# SGN_CTA_MAX[L] elements (the crossover with csrc/sgn.cuh's one element a
# thread, measured on the card by ``tools/kernel_ab.py --small --tune``:
# PERF.md). SGN_CTA_SHAPE: (most elements, threads, lanes a group) in
# order (``sgn_cta_shape``): CTAs of 512, 256 and 128 threads fill the
# H100's 132 SMs once each (at most 128 registers a thread: 1, 2 and 4
# CTAs an SM), whole-warp groups where a CTA takes few items at a time,
# groups of 8 lanes where it is narrow. All six pairs are built.
SGN_CTA_NL = (2, 3, 4, 5, 6)
SGN_CTA_GROUPS_BUILT = (8, 32)
SGN_CTA_THREADS_BUILT = (128, 256, 512)
SGN_CTA_SHAPE = ((132, 512, 32), (264, 256, 32), (None, 128, 8))
SGN_CTA_MAX = {2: 0, 3: 528, 4: 528, 5: 1024, 6: 1056}
MAX_NC = 4       # chunks per draw
MAX_SEND = 9     # 2t + 1
MAX_T = (MAX_SEND - 1) // 2   # threshold t: 1 to 4
MAX_M = 16       # parties
POW_MAX_STEPS = 32 * MAX_NL   # a step of a power's plan a bit at most

_U32xNL = ctypes.c_uint32 * MAX_NL


class DrawParams(ctypes.Structure):
    """Mirror of ``struct DrawParams`` in csrc/kernels.cu: field constants
    fill the first ``nl`` limbs."""
    _fields_ = [('p', _U32xNL), ('n0inv', ctypes.c_uint32),
                ('radix', _U32xNL * MAX_NC), ('nl', ctypes.c_int32)]


class ReshareParams(ctypes.Structure):
    """Mirror of ``struct ReshareParams`` in csrc/kernels.cu (K3, and K4
    with lag holding the t + 1 coefficients of the opening)."""
    _fields_ = [('draw', DrawParams), ('lag', _U32xNL * MAX_SEND),
                ('xs', _U32xNL * MAX_M), ('nonce_lo', ctypes.c_uint32),
                ('nonce_hi', ctypes.c_uint32), ('t', ctypes.c_int32),
                ('m', ctypes.c_int32), ('n_send', ctypes.c_int32)]


class Reshare2Params(ctypes.Structure):
    """Mirror of ``struct Reshare2Params`` in csrc/gf2.cu (K8): the
    residues x^(d + j) mod f as uint32 values, the call's counter."""
    _fields_ = [('red', ctypes.c_uint32 * 32),
                ('nonce_lo', ctypes.c_uint32), ('nonce_hi', ctypes.c_uint32),
                ('d', ctypes.c_int32)]


class SgnParams(ctypes.Structure):
    """Mirror of ``struct SgnParams`` in csrc/sgn.cuh."""
    _fields_ = [('draw', DrawParams), ('lag_t', _U32xNL * MAX_SEND),
                ('lag_2t', _U32xNL * MAX_SEND), ('xs', _U32xNL * MAX_M),
                ('one', _U32xNL), ('three', _U32xNL),
                ('r2', _U32xNL), ('pow2l', _U32xNL), ('inv2l', _U32xNL),
                ('pow2l1', _U32xNL), ('powf', _U32xNL),
                ('nonce_lo', ctypes.c_uint32), ('nonce_hi', ctypes.c_uint32),
                ('t', ctypes.c_int32), ('m', ctypes.c_int32),
                ('l', ctypes.c_int32), ('k', ctypes.c_int32),
                ('mode', ctypes.c_int32), ('has_f', ctypes.c_int32)]


class PowParams(ctypes.Structure):
    """Mirror of ``struct PowParams`` in csrc/pow.cuh: the field and the
    plan of the exponent (``fieldops.pow_plan``)."""
    _fields_ = [('p', _U32xNL), ('n0inv', ctypes.c_uint32),
                ('one', _U32xNL), ('nbits', ctypes.c_int32),
                ('nl', ctypes.c_int32), ('n_table', ctypes.c_int32),
                ('first', ctypes.c_int32), ('n_steps', ctypes.c_int32),
                ('tail', ctypes.c_int32),
                ('step', ctypes.c_uint32 * POW_MAX_STEPS)]


class WidePow(ctypes.Structure):
    """Mirror of ``struct WidePow`` in csrc/wide.cu: the limb count and
    the plan of the exponent (``fieldops.pow_plan``), whose steps follow
    the field's constants in the kernel's device buffer."""
    _fields_ = [('nl', ctypes.c_int32), ('nbits', ctypes.c_int32),
                ('n_table', ctypes.c_int32), ('first', ctypes.c_int32),
                ('n_steps', ctypes.c_int32), ('tail', ctypes.c_int32),
                ('n0inv', ctypes.c_uint32)]


class WideTail(ctypes.Structure):
    """Mirror of ``struct WideTail`` in csrc/wide.cu (K7 at 7 to 48
    limbs)."""
    _fields_ = [('pow', WidePow), ('has_scale', ctypes.c_int32),
                ('has_offset', ctypes.c_int32), ('t', ctypes.c_int32),
                ('m', ctypes.c_int32)]


class SgnWide(ctypes.Structure):
    """Mirror of ``struct SgnWide`` in csrc/sgn_wide.cu (K5 at 7 to 48
    limbs, and its CTA route at two to six): the comparison's parameters,
    the call's counter, the lanes of a group and threads of a CTA, and the
    workspace words of a CTA."""
    _fields_ = [('nl', ctypes.c_int32), ('t', ctypes.c_int32),
                ('m', ctypes.c_int32), ('l', ctypes.c_int32),
                ('k', ctypes.c_int32), ('mode', ctypes.c_int32),
                ('has_f', ctypes.c_int32), ('n0inv', ctypes.c_uint32),
                ('nonce_lo', ctypes.c_uint32), ('nonce_hi', ctypes.c_uint32),
                ('group', ctypes.c_int32), ('threads', ctypes.c_int32),
                ('ws_stride', ctypes.c_longlong)]


class TailParams(ctypes.Structure):
    """Mirror of ``struct TailParams`` in csrc/pow.cuh (K7)."""
    _fields_ = [('pow', PowParams), ('lag', _U32xNL * MAX_SEND),
                ('scale', _U32xNL), ('offset', _U32xNL),
                ('has_scale', ctypes.c_int32), ('has_offset', ctypes.c_int32),
                ('t', ctypes.c_int32), ('m', ctypes.c_int32)]


# limb counts of the fields K3, K6, K7 and K9 are built for
# (csrc/kernels.cu; K2 takes the draws of two- and three-limb fields that
# a path takes, K4 two-limb fields): one limb for the secure prime
# fields SecFld(p) of p < 2^32. The comparison (K5) is built for two to six
# (SGN_BUILT_NL: a secure integer's field has l + k + 2 > 32 bits) and
# takes its bit width l as a launch parameter: every l with l + k + 2 <= 32
# limbs, in every mode (csrc/sgn.cuh sgn_lb_max), at t = 1; at t > 1 the
# bit call's draws bound it (``sgn_lb_fit``; the CTA route's calls, of
# few elements, keep no such bound: ``sgn_cta``). K3, K4, K5 and K7 take
# every threshold t and party count m with 1 <= t <= MAX_T and 2t + 1 <= m
# <= MAX_M (``check_parties``).
# Fields of 7 to 48 limbs take the wide kernels instead (csrc/wide.cu: K3,
# K6, K7 and K9, csrc/sgn_wide.cu: K5, with L a launch parameter;
# ``wide(L)``; K3, K5 and K7 at every (t, m) of ``check_parties``), and
# fields of more than 48 limbs raise NotImplementedError on the card.
BUILT_NL = (1, 2, 3, 4, 5, 6)
SGN_BUILT_NL = (2, 3, 4, 5, 6)
# (limbs, words a draw) of K2's instantiations (csrc/kernels.cu
# mtt_squeeze_mont): the fused streams' draws of two-limb fields, the input
# draws of SecInt(32) and SecInt(64)
SQUEEZE_BUILT = ((2, 4), (2, 6), (3, 7))
# K5's dynamic shared memory a CTA (csrc/sgn.cuh SGN_SMEM_MAX: 227 KB less
# the constants of t and m)
SGN_SMEM_MAX = 232448 - (MAX_M + 2 * MAX_SEND) * MAX_NL * 4


def check_parties(what: str, t: int, m: int) -> None:
    """Raise NotImplementedError unless the kernels take threshold t with
    m parties (csrc/common.cuh parties_ok)."""
    if not (1 <= t <= MAX_T and 2 * t + 1 <= m <= MAX_M):
        raise NotImplementedError(
            f'the CUDA {what} is built for thresholds 1 <= t <= {MAX_T} and '
            f'2t + 1 <= m <= {MAX_M} parties, not (t, m) = ({t}, {m})')


def sgn_lb_fit(t: int, L: int) -> int:
    """The widest random bits lb (l + 1, l in EQ mode) of a comparison
    K5 takes at threshold t on L limbs (csrc/sgn.cuh sgn_lb_fit): at most
    32 L - 1, and the bit call's draws, t lb of 4 L bytes an element, with
    the stream's words in a CTA of one warp. Calls on the CTA route
    (``sgn_cta``) take every lb up to 32 L - 1."""
    lb = 32 * L - 1
    while lb > 0 and (t * lb * L * 4 + (-(-lb // 32) + 2) * 4) * 32 \
            > SGN_SMEM_MAX:
        lb -= 1
    return lb


def wide_group(L: int) -> int:
    """Lanes of a group that holds an L-limb value in the wide K5 and K6
    (csrc/wide.cuh wide_group): 8 to 8 limbs, 16 to 16, else 32, one or
    two words a lane."""
    return 8 if L <= 8 else 16 if L <= 16 else 32


def sgn_wide_groups(L: int) -> int:
    """Groups of lanes in a wide K5 CTA at L limbs."""
    return SGN_WIDE_THREADS // wide_group(L)


def sgn_cta_shape(n: int) -> tuple:
    """(threads, lanes a group) of a CTA of K5's CTA route on a launch of
    n elements."""
    return next((t, g) for most, t, g in SGN_CTA_SHAPE if most is None
                or n <= most)


def sgn_cta_groups(n: int) -> int:
    """Groups of lanes in a CTA of K5's CTA route on n elements."""
    threads, group = sgn_cta_shape(n)
    return threads // group


def sgn_cta(L: int, n: int) -> bool:
    """Whether K5 takes a call of n elements at L limbs on its CTA route
    (calls of at most SGN_CTA_MAX[L] elements)."""
    return L in SGN_CTA_NL and n <= SGN_CTA_MAX[L]


def sgn_wide_vec_words(t: int, L: int, l: int, mode: int) -> int:
    """Words of a wide K5 element's vectors (csrc/sgn_wide.cu
    sgn_wide_vec_words): the bit shares, lb = l + 1 (l in EQ mode, mode
    2) values of the 2t + 1 senders' shares, and unless LT (mode 1) the xor
    vector, l of them; L words a value."""
    lb = l + (0 if mode == 2 else 1)
    return (lb + (0 if mode == 1 else l)) * (2 * t + 1) * L


def sgn_wide_base_words(t: int, m: int, L: int,
                        groups: int | None = None) -> int:
    """Shared memory words of a wide K5 CTA (of ``groups`` groups; the
    wide route's by default) but the vectors (csrc/sgn_wide.cu
    sgn_wide_base_words): the constants, t sets of SGN_WIDE_STAGE staged
    draws of L + 2 words, the stream-A words, the element's values and the
    groups' scratch."""
    ns = 2 * t + 1
    consts = 10                              # SGN_WIDE_CONSTS
    state = 1 + m + 2 * ns + (t + 1) + t + m + t + 3
    groups = groups or sgn_wide_groups(L)
    return (consts + state + 2 * groups + 2) * L \
        + t * SGN_WIDE_STAGE * (L + 2) + SGN_WIDE_WORDS


def sgn_wide_layout(t: int, m: int, L: int, l: int, mode: int,
                    groups: int | None = None) -> tuple:
    """(dynamic shared memory bytes of a wide K5 CTA of ``groups`` groups
    (the wide route's by default), its workspace words): the vectors in
    shared memory where they fit in SGN_WIDE_SMEM_MAX bytes beside the rest
    (no workspace), else in the workspace (csrc/sgn_wide.cu
    sgn_wide_smem_bytes, sgn_wide_ws_words)."""
    base = sgn_wide_base_words(t, m, L, groups)
    vec = sgn_wide_vec_words(t, L, l, mode)
    if (base + vec) * 4 <= SGN_WIDE_SMEM_MAX:
        return (base + vec) * 4, 0
    return base * 4, vec


def sgn_wide_grid(n: int, ws_words: int) -> int:
    """CTAs of a wide K5 launch on n elements: one an element, at most
    SGN_WIDE_GRID, and as many as SGN_WIDE_WS_BYTES of workspace hold (at
    least one; ws_words 0: the vectors in shared memory)."""
    if not ws_words:
        return max(1, min(n, SGN_WIDE_GRID))
    return max(1, min(n, SGN_WIDE_GRID,
                      SGN_WIDE_WS_BYTES // (4 * ws_words)))


def set_limbs(dst, limbs) -> None:
    """Fill the first len(limbs) words of a ctypes limb array."""
    for q, v in enumerate(limbs):
        dst[q] = v


def wide(L: int) -> bool:
    """Whether the wide kernels (csrc/wide.cu) take a field of L limbs."""
    return WIDE_MIN_NL <= L <= WIDE_MAX_NL


def wide_words(device, *consts) -> torch.Tensor:
    """A wide kernel's device buffer: the words of each constant (a
    sequence of uint32 limbs or words) in order, as int32."""
    words = np.concatenate([np.asarray(c, dtype=np.uint64).reshape(-1)
                            for c in consts]).astype(np.uint32)
    return torch.from_numpy(words.view(np.int32).copy()).to(device)


def wide_pow(ctx, e: int) -> tuple:
    """(WidePow, its steps as words: squarings, table entry) for a^e in
    ctx's wide field."""
    from mpyc_tpu_torch.ops.fieldops import pow_plan
    if not wide(ctx.L):
        raise NotImplementedError(
            f'the wide CUDA kernels take fields of {WIDE_MIN_NL} to '
            f'{WIDE_MAX_NL} limbs, not L={ctx.L}')
    if not 0 <= e < 1 << 32 * ctx.L:
        raise ValueError('exponent outside [0, 2^(32 L))')
    plan = pow_plan(e)
    P = WidePow()
    P.nl, P.nbits, P.n0inv = ctx.L, e.bit_length(), ctx.n0inv
    P.n_table, P.first, P.tail = plan.n_table, plan.first, plan.tail
    P.n_steps = len(plan.steps)
    return P, [w for step in plan.steps for w in step]


def draw_params(ctx, n_chunks: int) -> DrawParams:
    """The field constants a squeeze-to-field kernel needs."""
    if ctx.L not in BUILT_NL:
        raise NotImplementedError(
            f'the CUDA kernels take fields of {BUILT_NL} limbs, not '
            f'L={ctx.L}')
    if n_chunks > MAX_NC:
        raise NotImplementedError(f'{n_chunks} chunks per draw')
    P = DrawParams()
    set_limbs(P.p, ctx.p_limbs)
    P.n0inv = ctx.n0inv
    for c, rad in enumerate(ctx.radix_limbs(n_chunks)):
        set_limbs(P.radix[c], rad)
    P.nl = ctx.L
    return P


def pow_params(ctx, e: int) -> PowParams:
    """K6's parameter block for the power a^e in ctx's field: the field
    and e's plan (``fieldops.pow_plan``)."""
    from mpyc_tpu_torch.ops.fieldops import pow_plan
    if ctx.L not in BUILT_NL:
        raise NotImplementedError(
            f'the CUDA kernels take fields of {BUILT_NL} limbs, not '
            f'L={ctx.L}')
    plan = pow_plan(e)
    P = PowParams()
    set_limbs(P.p, ctx.p_limbs)
    P.n0inv = ctx.n0inv
    set_limbs(P.one, ctx.one_mont)
    P.nbits = e.bit_length()
    P.nl = ctx.L
    P.n_table, P.first, P.tail = plan.n_table, plan.first, plan.tail
    P.n_steps = len(plan.steps)
    for k, (sq, j) in enumerate(plan.steps):
        P.step[k] = sq | j << 8
    return P


_C = ctypes.c_void_p
_SIGNATURES = {
    'mtt_keccak_ctr': [_C, _C, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_ulonglong, _C],
    'mtt_squeeze_mont': [_C, _C, ctypes.c_longlong, ctypes.c_int,
                         ctypes.c_int, ctypes.c_ulonglong, _C, _C],
    'mtt_reshare': [_C, _C, _C, _C, ctypes.c_longlong, ctypes.c_int, _C, _C],
    'mtt_split_recombine': [_C, _C, _C, _C, ctypes.c_longlong, _C, _C],
    'mtt_sgn': [_C, _C, _C, ctypes.c_longlong, ctypes.c_longlong,
                ctypes.c_longlong, _C, _C],
    'mtt_sgn_threads': [_C],
    'mtt_mont_pow': [_C, _C, ctypes.c_longlong, _C, _C],
    'mtt_random_bits_tail': [_C, _C, _C, _C, _C, ctypes.c_longlong, _C, _C],
    'mtt_reshare2': [_C, _C, _C, _C, ctypes.c_longlong, ctypes.c_int, _C,
                     _C],
    'mtt_reshare2_elems': [ctypes.c_longlong],
    'mtt_keccak_ctr_cta': [ctypes.c_longlong],
    'mtt_empty': [_C],
    'mtt_field_op': [_C, _C, _C, ctypes.c_longlong, ctypes.c_int,
                     ctypes.c_int, ctypes.c_int, _C, _C],
    'mtt_field_op_wide': [_C, _C, _C, ctypes.c_longlong, ctypes.c_int,
                          ctypes.c_int, ctypes.c_int, _C, ctypes.c_uint,
                          ctypes.c_int, _C],
    'mtt_reshare_wide': [_C, _C, _C, _C, ctypes.c_longlong, ctypes.c_int, _C,
                         ctypes.c_uint, ctypes.c_int, ctypes.c_uint,
                         ctypes.c_uint, ctypes.c_int, ctypes.c_int, _C],
    'mtt_sgn_wide': [_C, _C, _C, ctypes.c_longlong, ctypes.c_longlong,
                     ctypes.c_longlong, _C, _C, ctypes.c_longlong, _C, _C],
    'mtt_sgn_wide_smem': [ctypes.c_int] * 5,
    'mtt_sgn_wide_ws': [ctypes.c_int] * 5,
    'mtt_sgn_cta': [_C, _C, _C, ctypes.c_longlong, ctypes.c_longlong,
                    ctypes.c_longlong, _C, _C, ctypes.c_longlong, _C, _C],
    'mtt_sgn_cta_smem': [ctypes.c_int] * 6,
    'mtt_sgn_cta_ws': [ctypes.c_int] * 6,
    'mtt_reshare_cta': [ctypes.c_longlong, ctypes.c_int, ctypes.c_int],
    'mtt_mont_pow_wide': [_C, _C, ctypes.c_longlong, _C, _C, _C],
    'mtt_group_op_wide': [_C, _C, _C, ctypes.c_longlong, ctypes.c_int, _C,
                          ctypes.c_uint, ctypes.c_int, _C],
    'mtt_random_bits_tail_wide': [_C, _C, _C, _C, _C, ctypes.c_longlong, _C,
                                  _C, _C],
}


@dataclasses.dataclass
class Library:
    lib: ctypes.CDLL
    path: Path
    built: bool          # compiled by this process (else found on disk)
    seconds: float       # time to build (or to find) and load
    log: str             # nvcc's output (-Xptxas -v: registers, spills)
    unit_s: dict         # seconds to each unit's nvcc -c exit (if built)


def _nvcc() -> str:
    found = shutil.which('nvcc')
    if found:
        return found
    cuda_home = os.environ.get('CUDA_HOME', '/usr/local/cuda')
    cand = Path(cuda_home) / 'bin' / 'nvcc'
    if cand.exists():
        return str(cand)
    raise RuntimeError('nvcc not found: the CUDA kernels cannot be built')


def _key(nvcc: str) -> str:
    ver = subprocess.run([nvcc, '--version'], capture_output=True,
                         text=True, timeout=60).stdout
    h = hashlib.sha256()
    for name in SOURCES:
        h.update(name.encode() + b'\0' + (CSRC / name).read_bytes())
    h.update(repr(UNITS).encode() + ' '.join(NVCC_FLAGS).encode()
             + ver.encode())
    return h.hexdigest()[:16]


@functools.cache
def library() -> Library:
    """Build the kernels (once per source hash) and load them."""
    t0 = time.perf_counter()
    nvcc = _nvcc()
    out_dir = BUILD_ROOT / _key(nvcc)
    so = out_dir / LIB_NAME
    built, log, unit_s = False, '', {}
    if not so.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        for stale in out_dir.glob('*.tmp*'):
            stale.unlink(missing_ok=True)
        tmp = out_dir / f'{LIB_NAME}.tmp{os.getpid()}'
        objs = [out_dir / f'{name}.tmp{os.getpid()}.o' for name, _, _ in
                UNITS]
        outs = [obj.with_suffix('.log') for obj in objs]
        t_start = time.perf_counter()
        procs = []
        for (_, source, extra), obj, out in zip(UNITS, objs, outs):
            with open(out, 'w') as fh:
                procs.append(subprocess.Popen(
                    [nvcc, *NVCC_FLAGS, *extra, '-c', '-o', str(obj),
                     str(CSRC / source)], stdout=fh,
                    stderr=subprocess.STDOUT))
        # each unit's seconds from the common start to its exit
        while any(name not in unit_s for name, _, _ in UNITS):
            for (name, _, _), proc in zip(UNITS, procs):
                if name not in unit_s and proc.poll() is not None:
                    unit_s[name] = time.perf_counter() - t_start
                elif name not in unit_s and \
                        time.perf_counter() - t_start > BUILD_TIMEOUT_S:
                    proc.kill()
                    proc.wait()
                    unit_s[name] = None
            time.sleep(0.05)
        logs, failed = [], []
        for (name, _, _), proc, out in zip(UNITS, procs, outs):
            logs.append(out.read_text()
                        + ('\n(timed out)' if unit_s[name] is None else ''))
            out.unlink(missing_ok=True)
            if proc.returncode != 0:
                failed.append(name)
        if not failed:
            link = subprocess.run(
                [nvcc, '-shared', '-o', str(tmp), *map(str, objs)],
                capture_output=True, text=True, timeout=BUILD_TIMEOUT_S)
            logs.append(link.stdout + link.stderr)
            if link.returncode != 0:
                failed.append('link')
        log = ''.join(logs)
        for (name, _, _), obj in zip(UNITS, objs):
            if name in KEPT_UNITS and not failed:
                os.replace(obj, out_dir / f'{name}.o')
            obj.unlink(missing_ok=True)
        if failed:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f'nvcc failed ({", ".join(failed)}):\n{log}')
        os.replace(tmp, so)
        built = True
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.mtt_error_string.argtypes = [ctypes.c_int]
    lib.mtt_error_string.restype = ctypes.c_char_p
    return Library(lib, so, built, time.perf_counter() - t0, log, unit_s)


def stream_of(device) -> int:
    """Handle of torch's current stream on ``device``, for the launchers."""
    return torch.cuda.current_stream(device).cuda_stream


def call(name: str, *args) -> None:
    """Run launcher ``name``; raise if the launch was refused."""
    lib = library().lib
    rc = getattr(lib, name)(*args)
    if rc != 0:
        if rc > 0:
            msg = lib.mtt_error_string(rc).decode()
        else:
            msg = 'configuration the kernels were not built for'
        raise RuntimeError(f'{name}: launch failed ({rc}): {msg}')
