"""The CUDA kernels' source, built as host C++ and held against the plain
PyTorch versions.

There is no nvcc here, so ``mpyc_tpu_torch/csrc/kernels.cu`` is compiled
with g++ against a small header that defines CUDA's qualifiers away and
runs every launch as a loop over blocks and threads. That checks the
kernels' arithmetic, indexing and launch geometry (not their CUDA code
generation, which only the card shows: chip_smoke.py and the ``cuda``
tests). Tolerance: exact equality.
"""
import ctypes
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from mpyc_tpu_torch import _build
from mpyc_tpu_torch.models import pipelines
from mpyc_tpu_torch.ops import keccak, rng
from mpyc_tpu_torch.ops.fieldops import prime_field_ctx

P = 18446744073709551427

_SHIM = '''
#pragma once
#include <cstdint>
#define __global__
#define __device__
#define __host__
#define __constant__
#define __forceinline__ inline
#define __noinline__
#define __launch_bounds__(x)
#define __restrict__
struct HostDim3 { unsigned x, y, z; };
static HostDim3 blockIdx, blockDim, threadIdx;
typedef struct CUstream_st* cudaStream_t;
typedef int cudaError_t;
inline int cudaGetLastError() { return 0; }
inline const char* cudaGetErrorString(cudaError_t) { return "host"; }
inline unsigned __ldg(const unsigned* p) { return *p; }
extern "C" { unsigned long long mtt_op_counts[2]; }
#define MTT_COUNT_OP(kind) (++mtt_op_counts[kind])
'''

_LAUNCH = re.compile(r'([\w:]+(?:<[^<>]*>)?)<<<(.*?)>>>\((.*?)\);', re.S)


def _as_loop(m):
    kernel, config, args = m.groups()
    grid, threads = [c.strip() for c in config.split(',')[:2]]
    return (f'for (unsigned b_ = 0; b_ < (unsigned)({grid}); ++b_) '
            f'for (unsigned t_ = 0; t_ < (unsigned)({threads}); ++t_) {{ '
            f'blockIdx.x = b_; threadIdx.x = t_; blockDim.x = {threads}; '
            f'{kernel}({args}); }}')


@pytest.fixture(scope='module')
def host_lib(tmp_path_factory):
    gxx = shutil.which('g++')
    if gxx is None:
        pytest.skip('needs g++ to build the kernel source for the host')
    d = tmp_path_factory.mktemp('kernels_host')
    for name in _build.SOURCES[1:]:
        shutil.copy(_build.CSRC / name, d / name)
    (d / 'cuda_runtime.h').write_text(_SHIM)
    src, n = _LAUNCH.subn(_as_loop, (_build.CSRC / 'kernels.cu').read_text())
    assert n == 5, 'every launch must become a host loop'
    (d / 'kernels_host.cpp').write_text(src)
    so = d / 'libkernels_host.so'
    subprocess.run([gxx, '-std=c++17', '-O1', '-w', '-shared', '-fPIC',
                    f'-I{d}', '-o', str(so), str(d / 'kernels_host.cpp')],
                   check=True, timeout=300)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _build._SIGNATURES.items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = ctypes.c_int
    return lib


@pytest.fixture(scope='module')
def state():
    st, lane = keccak.ctr_state(bytes(range(40)))
    return keccak.state_tensor(st, 'cpu'), lane


def _shares(n, seed):
    g = np.random.default_rng(seed)
    lo = g.integers(0, 1 << 32, (3, n), dtype=np.uint64)
    hi = g.integers(0, P >> 32, (3, n), dtype=np.uint64)
    limbs = np.stack([lo, hi], -1).astype(np.uint32)
    return torch.from_numpy(limbs.view(np.int32))


def test_keccak_ctr_source_matches_plain(host_lib, state):
    st, lane = state
    n = 1001
    out = torch.empty((n, 42), dtype=torch.int32)
    assert host_lib.mtt_keccak_ctr(st.data_ptr(), out.data_ptr(), n, lane,
                                   17, None) == 0
    assert torch.equal(out, keccak._keccak_ctr_plain(st, n, lane, 17))


@pytest.mark.parametrize('l_bytes', [16, 24])
def test_squeeze_mont_source_matches_plain(host_lib, state, l_bytes):
    st, lane = state
    n = 2003
    W = l_bytes // 4
    params = _build.draw_params(prime_field_ctx(P), -(-W // 2))
    out = torch.empty((n, 2), dtype=torch.int32)
    assert host_lib.mtt_squeeze_mont(st.data_ptr(), out.data_ptr(), n, W,
                                     lane, 5, ctypes.addressof(params),
                                     None) == 0
    assert torch.equal(out, rng._squeeze_mont_plain(st, n, l_bytes, P, lane,
                                                    5))


@pytest.mark.parametrize('n', [7, 64, 1003])
@pytest.mark.parametrize('fuse', [True, False])
def test_reshare_source_matches_plain(host_lib, state, n, fuse):
    st, _ = state
    spec = pipelines.ReshareSpec(P, 1, 3)
    a, b = _shares(n, 1), _shares(n, 2)
    nonce = (0xFFFFFFFF, 9)
    params = spec.params(nonce)
    out = torch.empty_like(a)
    assert host_lib.mtt_reshare(a.data_ptr(), b.data_ptr() if fuse else None,
                                out.data_ptr(), st.data_ptr(), n, int(fuse),
                                ctypes.addressof(params), None) == 0
    want = pipelines._reshare_mul_plain(a, b if fuse else None, st, nonce,
                                        spec)
    assert torch.equal(out, want)


def test_launchers_refuse_what_was_not_built(host_lib, state):
    st, lane = state
    params = _build.draw_params(prime_field_ctx(P), 3)
    out = torch.empty((10, 2), dtype=torch.int32)
    assert host_lib.mtt_squeeze_mont(st.data_ptr(), out.data_ptr(), 10, 5,
                                     lane, 0, ctypes.addressof(params),
                                     None) == -1
    spec = pipelines.ReshareSpec(P, 1, 4)
    a = _shares(10, 3)
    a4 = torch.cat([a, a[:1]])
    params = spec.params((0, 0))
    assert host_lib.mtt_reshare(a4.data_ptr(), None, a4.data_ptr(),
                                st.data_ptr(), 10, 0,
                                ctypes.addressof(params), None) == -1


@pytest.mark.parametrize('n', [7, 64, 1003])
def test_split_recombine_source_matches_plain(host_lib, state, n):
    st, _ = state
    spec = pipelines.SplitSpec(P, 1, 3)
    sec = _shares(n, 4)[0].contiguous()
    out = torch.empty_like(sec)
    shares = torch.empty((3, n, 2), dtype=torch.int32)
    params = spec.params()
    assert host_lib.mtt_split_recombine(
        sec.data_ptr(), out.data_ptr(), shares.data_ptr(), st.data_ptr(), n,
        ctypes.addressof(params), None) == 0
    want, want_shares = pipelines._split_recombine_plain(sec, st, spec)
    assert torch.equal(out, want) and torch.equal(out, sec)
    assert torch.equal(shares, want_shares)


@pytest.mark.parametrize('mode', pipelines.SGN_MODES)
def test_sgn_source_matches_plain(host_lib, state, mode):
    """K5 at its built width (l = 32, k = 30), 100 elements."""
    st, _ = state
    spec = pipelines.SgnSpec(P, 1, 3, 32, 30, LT=mode == 'LT',
                             EQ=mode == 'EQ')
    n = 100
    a = _shares(n, 5)
    nonce = (0xFFFFFFFF, 4)
    out = torch.empty_like(a)
    params = spec.params(nonce)
    assert host_lib.mtt_sgn(a.data_ptr(), out.data_ptr(), st.data_ptr(), n,
                            spec.blocks_a(n), ctypes.addressof(params),
                            None) == 0
    assert torch.equal(out, pipelines._sgn_step_plain(a, st, nonce, spec))


def _op_counts(host_lib):
    """The host build's counts of Montgomery products and modular adds."""
    return (ctypes.c_ulonglong * 2).in_dll(host_lib, 'mtt_op_counts')


# 16-byte draws into the two-limb field: two products and an add each
DRAW_OPS = (2, 1)


@pytest.mark.parametrize('mode,f', [('sgn', 0), ('LT', 0), ('EQ', 0),
                                    ('LT', 3)])
def test_sgn_field_ops_match_the_source(host_lib, state, mode, f):
    """SgnSpec.field_ops, from which chip_smoke.py bounds K5, counts the
    products the kernel's source runs exactly, and its adds up to the
    subtractions that the ones of c mod 2^l select: n is prime to 6, so
    an error of 1-5 adds per element leaves a remainder, and c mod 2^l is
    uniform, so its ones lie within 5 standard deviations of n l / 2."""
    st, _ = state
    spec = pipelines.SgnSpec(P, 1, 3, 32, 30, LT=mode == 'LT',
                             EQ=mode == 'EQ', f=f)
    n = 641
    a = _shares(n, 8)
    out = torch.empty_like(a)
    params = spec.params((3, 0))
    counts = _op_counts(host_lib)
    counts[0] = counts[1] = 0
    assert host_lib.mtt_sgn(a.data_ptr(), out.data_ptr(), st.data_ptr(), n,
                            spec.blocks_a(n), ctypes.addressof(params),
                            None) == 0
    draws = spec.draws_per_element()
    mont, adds = spec.field_ops(0)
    per_one = spec.field_ops(1)[1] - adds
    assert per_one == (3 if mode == 'EQ' else 6)
    assert counts[0] == n * (mont + draws * DRAW_OPS[0])
    ones, rest = divmod(counts[1] - n * (adds + draws * DRAW_OPS[1]),
                        per_one)
    assert rest == 0
    assert abs(ones - n * spec.l / 2) <= 5 * (n * spec.l) ** 0.5 / 2


def test_split_field_ops_match_the_source(host_lib, state):
    st, _ = state
    spec = pipelines.SplitSpec(P, 1, 3)
    n = 1000
    sec = _shares(n, 9)[0].contiguous()
    out = torch.empty_like(sec)
    counts = _op_counts(host_lib)
    counts[0] = counts[1] = 0
    assert host_lib.mtt_split_recombine(
        sec.data_ptr(), out.data_ptr(), None, st.data_ptr(), n,
        ctypes.addressof(spec.params()), None) == 0
    mont, adds = spec.field_ops()
    assert tuple(counts) == (n * (mont + spec.t * DRAW_OPS[0]),
                             n * (adds + spec.t * DRAW_OPS[1]))


def test_sgn_source_scales_by_2f(host_lib, state):
    st, _ = state
    spec = pipelines.SgnSpec(P, 1, 3, 32, 30, LT=True, f=3)
    a = _shares(20, 6)
    out = torch.empty_like(a)
    params = spec.params((1, 0))
    assert host_lib.mtt_sgn(a.data_ptr(), out.data_ptr(), st.data_ptr(), 20,
                            spec.blocks_a(20), ctypes.addressof(params),
                            None) == 0
    assert torch.equal(out, pipelines._sgn_step_plain(a, st, (1, 0), spec))


def test_comparison_and_round_trip_refuse_what_was_not_built(host_lib,
                                                             state):
    """The Python side names what is built; the launchers refuse the rest."""
    st, _ = state
    with pytest.raises(NotImplementedError, match='l=32'):
        pipelines.SgnSpec(P, 1, 3, 16).params((0, 0))
    with pytest.raises(NotImplementedError, match='built for'):
        pipelines.SplitSpec(P, 1, 4).params()
    params = pipelines.SgnSpec(P, 1, 3, 32).params((0, 0))
    params.l = 16
    a = _shares(10, 7)
    assert host_lib.mtt_sgn(a.data_ptr(), a.data_ptr(), st.data_ptr(), 10,
                            1, ctypes.addressof(params), None) == -1
    params = pipelines.SplitSpec(P, 1, 3).params()
    params.m = 4
    assert host_lib.mtt_split_recombine(a.data_ptr(), a.data_ptr(), None,
                                        st.data_ptr(), 10,
                                        ctypes.addressof(params), None) == -1
