"""The host build of the port's CUDA sources, for the tests that hold the
kernels' arithmetic against their plain versions without nvcc
(``test_torch_kernels_host.py``, ``test_torch_small_calls_host.py``).

g++ (C++20) compiles the translation units of ``_build.UNITS`` against a
small header (``SHIM``) that defines CUDA's qualifiers away and runs every
launch block by block, the threads of a block as fibers of one OS thread:
each runs until it reaches ``__syncthreads()``, a warp collective or
returns, and the block's next phase starts when every thread still running
has reached the barrier. ``__shared__`` arrays are ``static`` (one block
runs at a time), dynamic shared memory is a buffer of the launch's size,
and ``blockIdx``/``threadIdx`` are set before each fiber runs (inline
variables: one for all the units, whose template functions the linker
merges). ``build`` compiles the units a test file needs, one g++ a unit,
all at once; the launchers of the units it leaves out that the built ones
call become stubs that refuse (-1). Beside it, the helpers both files
use: the build's operation counts, Shamir shares of integers and their
opening, and the comparison K5 computes.
"""
import ctypes
import re
import shutil
import subprocess

import numpy as np
import pytest

from mpyc_tpu_torch import _build
from mpyc_tpu_torch.ops.fieldops import prime_field_ctx

SHIM = '''
#pragma once
#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <sys/mman.h>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __constant__
#define __shared__ static
#define __forceinline__ inline
#define __noinline__
#define __launch_bounds__(...)
#define __restrict__
struct HostDim3 { unsigned x, y, z; };
inline HostDim3 blockIdx, blockDim, threadIdx, gridDim;
struct uint2 { unsigned x, y; };
struct uint4 { unsigned x, y, z, w; };
inline uint2 make_uint2(unsigned x, unsigned y) { return {x, y}; }
typedef struct CUstream_st* cudaStream_t;
typedef int cudaError_t;
constexpr cudaError_t cudaSuccess = 0;
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
template <class F>
inline cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) {
  return cudaSuccess;
}
inline int cudaGetLastError() { return 0; }
// the launchers that size their grid from n read an H100's SM count
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount };
inline cudaError_t cudaGetDevice(int* dev) { *dev = 0; return cudaSuccess; }
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) {
  *v = 132;
  return cudaSuccess;
}
inline const char* cudaGetErrorString(cudaError_t) { return "host"; }
inline unsigned __ldg(const unsigned* p) { return *p; }
inline uint2 __ldg(const uint2* p) { return *p; }
inline uint32_t __funnelshift_l(uint32_t lo, uint32_t hi, int s) {
  return (uint32_t)((((uint64_t)hi << 32) | lo) << (s & 31) >> 32);
}
inline int atomicAdd(int* p, int v) {
  return __atomic_fetch_add(p, v, __ATOMIC_RELAXED);
}
extern "C" { extern unsigned long long mtt_op_counts[2], mtt_perm_count; }
#define MTT_COUNT_OP(kind) \\
  __atomic_fetch_add(&mtt_op_counts[kind], 1ull, __ATOMIC_RELAXED)
#define MTT_COUNT_PERM() \\
  __atomic_fetch_add(&mtt_perm_count, 1ull, __ATOMIC_RELAXED)
// A block's threads are fibers: one stack each (reserved once, touched
// only as deep as a thread goes), switched by the launch's scheduler
// through mtt_switch(save, load): the callee-saved registers pushed on the
// stack that is left, its pointer stored to *save, the one entered loaded
// from load and its registers popped (x86-64; no system call).
__attribute__((naked, noinline)) static void mtt_switch(void**, void*) {
  asm("pushq %rbp\\n pushq %rbx\\n pushq %r12\\n pushq %r13\\n pushq %r14\\n"
      " pushq %r15\\n movq %rsp, (%rdi)\\n movq %rsi, %rsp\\n popq %r15\\n"
      " popq %r14\\n popq %r13\\n popq %r12\\n popq %rbx\\n popq %rbp\\n"
      " ret\\n");
}
enum MttState { MTT_RUN, MTT_BLOCK, MTT_WARP, MTT_DONE };
enum MttOp { MTT_SHFL, MTT_DOWN, MTT_UP, MTT_BALLOT, MTT_SYNCWARP };
struct MttFiber {
  void* sp; void* stack; MttState state;
  unsigned mask, val, result; MttOp op; int arg, width;
};
constexpr size_t MTT_STACK = size_t(1) << 20;
inline std::vector<MttFiber> mtt_fibers;
inline void* mtt_scheduler_sp;
inline unsigned mtt_current, mtt_threads;
inline void (*mtt_body)(void*);
inline void* mtt_body_arg;
inline std::vector<uint64_t> mtt_dynamic_smem;
inline void mtt_yield(MttState s) {
  mtt_fibers[mtt_current].state = s;
  mtt_switch(&mtt_fibers[mtt_current].sp, mtt_scheduler_sp);
}
inline void mtt_fiber_entry() {      // entered by a fiber's first switch
  mtt_body(mtt_body_arg);
  mtt_yield(MTT_DONE);               // never resumed
}
inline void __syncthreads() { mtt_yield(MTT_BLOCK); }
// A warp collective: the thread waits until every live lane of its mask
// has reached a collective with that mask; the scheduler then gives each
// its result, as the card gives it to a warp (or to the lanes of mask)
// that meet there. A warp whose lanes take other paths waits for none of
// the block's other warps.
inline unsigned mtt_collective(unsigned mask, MttOp op, unsigned v, int arg,
                               int width) {
  MttFiber& f = mtt_fibers[mtt_current];
  f.mask = mask; f.op = op; f.val = v; f.arg = arg; f.width = width;
  mtt_yield(MTT_WARP);
  return mtt_fibers[mtt_current].result;
}
inline unsigned __shfl_sync(unsigned mask, unsigned v, int src,
                            int width = 32) {
  return mtt_collective(mask, MTT_SHFL, v, src, width);
}
inline unsigned __shfl_down_sync(unsigned mask, unsigned v, unsigned d,
                                 int width = 32) {
  return mtt_collective(mask, MTT_DOWN, v, (int)d, width);
}
inline unsigned __shfl_up_sync(unsigned mask, unsigned v, unsigned d,
                               int width = 32) {
  return mtt_collective(mask, MTT_UP, v, (int)d, width);
}
inline unsigned __ballot_sync(unsigned mask, int pred) {
  return mtt_collective(mask, MTT_BALLOT, pred != 0, 0, 32);
}
inline void __syncwarp(unsigned mask = 0xFFFFFFFFu) {
  mtt_collective(mask, MTT_SYNCWARP, 0, 0, 32);
}
// Complete the collective that thread t waits at, if every live lane of
// its mask (within the block) has reached one with the same mask.
inline void mtt_try_release(unsigned t) {
  const unsigned w0 = t & ~31u, mask = mtt_fibers[t].mask;
  unsigned part = 0, ballot = 0;
  // from the top lane down: the scheduler runs a warp's lanes in order, so
  // a lane that is not the last to arrive finds one still running at once
  for (unsigned lane = 32; lane-- > 0;) {
    if (!(mask >> lane & 1u) || w0 + lane >= mtt_threads) continue;
    const MttFiber& g = mtt_fibers[w0 + lane];
    if (g.state == MTT_DONE) continue;
    if (g.state != MTT_WARP || g.mask != mask || g.op != mtt_fibers[t].op)
      return;
    part |= 1u << lane;
    ballot |= (g.val != 0) << lane;
  }
  for (unsigned lane = 0; lane < 32; ++lane) {
    if (!(part >> lane & 1u)) continue;
    MttFiber& g = mtt_fibers[w0 + lane];
    const unsigned w = (unsigned)g.width, seg = lane & ~(w - 1);
    unsigned src = lane;
    if (g.op == MTT_SHFL) src = seg | ((unsigned)g.arg & (w - 1));
    else if (g.op == MTT_DOWN && (lane & (w - 1)) + g.arg < w)
      src = lane + g.arg;
    else if (g.op == MTT_UP && (lane & (w - 1)) >= (unsigned)g.arg)
      src = lane - g.arg;
    g.result = g.op == MTT_BALLOT ? ballot
               : part >> src & 1u ? mtt_fibers[w0 + src].val : g.val;
  }
  for (unsigned lane = 0; lane < 32; ++lane)
    if (part >> lane & 1u) mtt_fibers[w0 + lane].state = MTT_RUN;
}
// One launch: the blocks in turn. A block's fibers run in passes, each
// runnable one up to its next barrier, collective or return; a barrier is
// passed once every thread still running has reached it (a thread that
// returns leaves it, as on the card), a collective once its lanes have.
template <class F>
void mtt_host_launch(unsigned grid, unsigned threads, unsigned smem,
                     F body) {
  while (mtt_fibers.size() < threads) {
    void* stack = mmap(nullptr, MTT_STACK, PROT_READ | PROT_WRITE,
                       MAP_PRIVATE | MAP_ANONYMOUS | MAP_NORESERVE, -1, 0);
    mtt_fibers.push_back({});
    mtt_fibers.back().stack = stack;
  }
  mtt_body = [](void* f) { (*static_cast<F*>(f))(); };
  mtt_body_arg = &body;
  mtt_threads = threads;
  blockDim = {threads, 1, 1};
  gridDim = {grid, 1, 1};
  for (unsigned b = 0; b < grid; ++b) {
    mtt_dynamic_smem.assign((smem + 7) / 8, 0);
    for (unsigned t = 0; t < threads; ++t) {
      MttFiber& f = mtt_fibers[t];
      // the first switch pops six zero registers and returns into
      // mtt_fiber_entry, its stack aligned as after a call
      void** sp = reinterpret_cast<void**>(
          static_cast<char*>(f.stack) + MTT_STACK - 64);
      for (int r = 0; r < 6; ++r) sp[r] = nullptr;
      sp[6] = reinterpret_cast<void*>(&mtt_fiber_entry);
      sp[7] = nullptr;
      f.sp = sp;
      f.state = MTT_RUN;
    }
    for (;;) {
      bool ran = false;
      unsigned live = 0, waiting = 0;
      for (unsigned t = 0; t < threads; ++t) {
        MttFiber& f = mtt_fibers[t];
        if (f.state == MTT_RUN) {
          mtt_current = t;
          blockIdx = {b, 0, 0};
          threadIdx = {t, 0, 0};
          mtt_switch(&mtt_scheduler_sp, f.sp);
          ran = true;
          if (f.state == MTT_WARP) {
            mtt_try_release(t);
          } else if (f.state == MTT_DONE) {   // it may complete one
            for (unsigned u = t & ~31u; u < (t | 31u) + 1 && u < threads;
                 ++u)
              if (mtt_fibers[u].state == MTT_WARP) mtt_try_release(u);
          }
        }
      }
      for (unsigned t = 0; t < threads; ++t) {
        live += mtt_fibers[t].state != MTT_DONE;
        waiting += mtt_fibers[t].state == MTT_BLOCK;
      }
      if (live == 0) break;
      if (waiting == live) {
        for (unsigned t = 0; t < threads; ++t)
          if (mtt_fibers[t].state == MTT_BLOCK)
            mtt_fibers[t].state = MTT_RUN;
      } else if (!ran) {
        fprintf(stderr, "host launch: block %u deadlocked\\n", b);
        abort();
      }
    }
  }
}
'''

LAUNCH = re.compile(r'([\w:]+(?:<[^<>]*>)?)<<<(.*?)>>>\((.*?)\);', re.S)
DYNAMIC_SMEM = re.compile(r'extern __shared__ (\w+) (\w+)\[\];')


def as_loop(m):
    kernel, config, args = m.groups()
    grid, threads, smem = [c.strip() for c in config.split(',')[:3]]
    return (f'mtt_host_launch((unsigned)({grid}), (unsigned)({threads}), '
            f'(unsigned)({smem}), [&] {{ {kernel}({args}); }});')


def host_source(src: str) -> str:
    """A source as the shim builds it: launches as host loops, dynamic
    shared memory as the launch's buffer."""
    return DYNAMIC_SMEM.sub(
        r'\1* \2 = reinterpret_cast<\1*>(mtt_dynamic_smem.data());',
        LAUNCH.sub(as_loop, src))


def launch_sites() -> int:
    """The ``<<<...>>>`` launches in the library's sources."""
    return sum(len(LAUNCH.findall((_build.CSRC / name).read_text()))
               for name in _build.SOURCES)


# the launchers that kernels.cu calls in other units: K5's narrow ones, one
# a unit sgn<nl>t<t>
_SGN_LAUNCHER = (
    'extern "C" int mtt_sgn_launch_nl{nl}_t{t}(const void*, void*, '
    'const void*, long long, long long, long long, const void*, int, int, '
    'void*) {{ return -1; }}\n')


def build(d, names=None):
    """The units ``names`` of ``_build.UNITS`` (all by default) in the
    directory d, compiled for the host and linked with the shim's counters
    and the stubs of the narrow K5 launchers left out: the library, its
    functions bound as ``_build._SIGNATURES`` gives them."""
    gxx = shutil.which('g++')
    if gxx is None:
        pytest.skip('needs g++ to build the kernel source for the host')
    for name in _build.SOURCES:
        (d / name).write_text(host_source(
            (_build.CSRC / name).read_text()))
    (d / 'cuda_runtime.h').write_text(SHIM)
    stubs = ''.join(
        _SGN_LAUNCHER.format(nl=unit[3], t=unit[5:])
        for unit, _, _ in _build.UNITS
        if unit.startswith('sgn') and unit[3].isdigit() and names is not None
        and unit not in names)
    (d / 'counters.cpp').write_text(
        'extern "C" { unsigned long long mtt_op_counts[2], '
        'mtt_perm_count; }\n' + stubs)
    units = []      # each unit as a source of its own (its -D in the text)
    for name, source, extra in _build.UNITS:
        if names is not None and name not in names:
            continue
        defs = ''.join(f'#define {f[2:].replace("=", " ")}\n'
                       for f in extra)
        (d / f'{name}.cpp').write_text(f'{defs}#include "{source}"\n')
        units.append(d / f'{name}.cpp')
    units.append(d / 'counters.cpp')
    so = d / 'libkernels_host.so'
    procs = [subprocess.Popen([gxx, '-std=c++20', '-O1', '-w', '-fPIC',
                               '-pthread', f'-I{d}', '-c', '-o',
                               f'{u}.o', str(u)]) for u in units]
    for proc in procs:      # one g++ a unit, all at once
        assert proc.wait(timeout=600) == 0, 'g++ failed on a unit'
    subprocess.run([gxx, '-shared', '-pthread', '-o', str(so),
                    *(f'{u}.o' for u in units)], check=True, timeout=600)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _build._SIGNATURES.items():
        fn = getattr(lib, name, None)
        if fn is not None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def op_counts(lib):
    """The host build's counts of Montgomery products and modular adds
    (``MTT_COUNT_OP``), settable to 0."""
    return (ctypes.c_ulonglong * 2).in_dll(lib, 'mtt_op_counts')


def value_shares(values, p, t, m, seed):
    """(m, n, L) Montgomery limbs of degree-t Shamir shares of the integers
    ``values`` (mod p) at the points 1..m, random coefficients."""
    g = np.random.default_rng(seed)
    coefs = [[int(c) for c in g.integers(0, 1 << 62, t)] for _ in values]
    rows = [[(v + sum(c * x ** (k + 1) for k, c in enumerate(cs))) % p
             for v, cs in zip(values, coefs)] for x in range(1, m + 1)]
    return prime_field_ctx(p).encode(np.array(rows, dtype=object), 'cpu')


def open_shares(sh, p, t, f=0):
    """The values of (m, n, L) degree-t shares, from the points 1..t + 1,
    as signed ints (|v| < p / 2) divided by 2^f."""
    vals = prime_field_ctx(p).decode(sh)
    xs = range(1, t + 2)
    out = []
    for e in range(sh.shape[1]):
        v = 0
        for i in xs:
            lam = 1
            for j in xs:
                if j != i:
                    lam = lam * j * pow(j - i, -1, p) % p
            v += lam * int(vals[i - 1][e])
        v %= p
        out.append((v - p if v > p // 2 else v) >> f)
    return out


def compare(mode, v):
    """The comparison of v that K5's mode computes: sgn, LT (v < 0) or EQ
    (v == 0)."""
    return (v > 0) - (v < 0) if mode == 'sgn' else int(
        v < 0 if mode == 'LT' else v == 0)
