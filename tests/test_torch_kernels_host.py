"""The CUDA kernels' source, built as host C++ and held against the plain
PyTorch versions.

There is no nvcc here, so the library's translation units
(``mpyc_tpu_torch/csrc/kernels.cu``, ``sgn.cu`` for each limb count and
``gf2.cu``, ``_build.UNITS``) are compiled with g++ (C++20) against a
small header that defines CUDA's qualifiers away and runs every launch
block by block, the threads of a block as fibers of one OS thread
(``torch_host_shim.py``). That checks the kernels' arithmetic, indexing,
staging through shared memory and launch geometry (not their CUDA code
generation, which only the card shows: chip_smoke.py and the ``cuda``
tests). K5's CTA route and K3's geometry for small calls are held in
``test_torch_small_calls_host.py``. Tolerance: exact equality.
"""
import ctypes

import numpy as np
import pytest
import torch
import torch_host_shim
from torch_host_shim import compare as _compare
from torch_host_shim import op_counts as _op_counts
from torch_host_shim import open_shares as _open
from torch_host_shim import value_shares as _value_shares

from mpyc_tpu_torch import _build
from mpyc_tpu_torch.models import pipelines
from mpyc_tpu_torch.ops import fieldops, keccak, limb, rng
from mpyc_tpu_torch.ops.fieldops import prime_field_ctx


@pytest.fixture(autouse=True)
def one_thread():
    """The plain versions on small tensors gain nothing from torch's
    threads, and the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


P = 18446744073709551427
P46 = 70368744177643         # SecInt(14)'s field (the BNN's)
P69 = 590295810358705651619  # SecInt(37)'s field (the CNN's), three limbs
P96 = 79228162514264337593543950319   # SecInt(64)'s field, three limbs
P52 = 4503599627370323       # SecFxp(14, 6)'s field (the fixed-point CNN's)
# the LP solver's fields (find_prime_root(l + 32, n = m + n)): SecInt(70)
# on LPExample_R20, four limbs; SecInt(104) on sc50b and SecInt(110) on
# LPExample, five limbs
P102 = 2535301200456458802993406413211
P136 = 43556142965880123323311949751266331071191
P142 = 2787593149816327892691964784081045188544327


@pytest.fixture(scope='module')
def host_lib(tmp_path_factory):
    """The library's translation units (``_build.UNITS``) compiled by one
    g++ call each, all at once, and linked with the shim's counters."""
    assert torch_host_shim.launch_sites() == 17, \
        'every launch must become a host loop'
    return torch_host_shim.build(tmp_path_factory.mktemp('kernels_host'))


@pytest.fixture(scope='module')
def state():
    st, lane = keccak.ctr_state(bytes(range(40)))
    return keccak.state_tensor(st, 'cpu'), lane


def _shares(n, seed, p=P):
    """(3, n) canonical field elements (< p) as stored limbs."""
    g = np.random.default_rng(seed)
    L = prime_field_ctx(p).L
    if L == 2:
        lo = g.integers(0, 1 << 32, (3, n), dtype=np.uint64)
        hi = g.integers(0, p >> 32, (3, n), dtype=np.uint64)
        limbs = np.stack([lo, hi], -1).astype(np.uint32)
        return torch.from_numpy(limbs.view(np.int32))
    words = g.integers(0, 1 << 32, (3, n, L), dtype=np.uint64)
    words[..., -1] = g.integers(0, p >> 32 * (L - 1), (3, n))
    return torch.from_numpy(words.astype(np.uint32).view(np.int32))


# K1's CTA comes from n: up to one CTA for each of the H100's 132 SMs
# (3,168 blocks) 24 sponges of five threads each, beyond that one thread a
# sponge, 32 threads doubled up to 256 while the grid keeps two CTAs an
# SM: 1, 31, 33, 512 (the pool refill) and 3,168 blocks take five threads
# a sponge, 3,169 and 9,363 (a SHA3 round in the last design) CTAs of 32,
# 16,901 64, 33,797 128 and 67,589 256; the last CTA ragged, of an odd
# count where one thread a sponge (its last 8-byte lane stored alone)
K1_CTA = {1: 24, 31: 24, 33: 24, 512: 24, 3168: 24, 3169: 32, 9363: 32,
          16901: 64, 33797: 128, 67589: 256}


# every size but 3,168, the most five threads a sponge take: the host runs
# a CTA's shuffles through barriers, 132 CTAs in about half a minute (the
# card's tests take it)
@pytest.mark.parametrize('n', sorted(set(K1_CTA) - {3168}))
def test_keccak_ctr_source_matches_plain_at_every_width(host_lib, state, n):
    st, lane = state
    assert host_lib.mtt_keccak_ctr_cta(n) == K1_CTA[n]
    out = torch.full((n, 42), -1, dtype=torch.int32)
    assert host_lib.mtt_keccak_ctr(st.data_ptr(), out.data_ptr(), n, lane,
                                   17, None) == 0
    assert torch.equal(out, keccak._keccak_ctr_plain(st, n, lane, 17))


def test_keccak_ctr_widths_cover_the_rule(host_lib):
    """The sizes above take every CTA the rule picks, and the grid reaches
    all 132 SMs from 132 x 24 blocks on."""
    assert set(K1_CTA.values()) == {24, 32, 64, 128, 256}
    for n in (132 * 24, 4224, 9363, 599187):
        assert -(-n // host_lib.mtt_keccak_ctr_cta(n)) >= 132


def test_keccak_ctr_refuses_an_unaligned_output(host_lib, state):
    """K1 stores 16 bytes at a time: an output off a 16-byte boundary is
    refused."""
    st, lane = state
    buf = torch.empty((3, 42), dtype=torch.int32)
    base = buf.data_ptr() + (8 if buf.data_ptr() % 16 == 0 else 0)
    assert host_lib.mtt_keccak_ctr(st.data_ptr(), base, 2, lane, 0,
                                   None) == -1


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


@pytest.mark.parametrize('n', [7, 64, 1003, 6407])
@pytest.mark.parametrize('fuse', [True, False])
def test_reshare_source_matches_plain(host_lib, state, n, fuse):
    """3,200 elements a thread block of 320 threads: 6,407 elements span
    three blocks, the last ragged."""
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


@pytest.mark.parametrize('p,l_bytes', [(P96, 28)])
def test_squeeze_mont_source_matches_plain_at_three_limbs(host_lib, state,
                                                          p, l_bytes):
    """The 28-byte input draws of SecInt(64)'s field."""
    st, lane = state
    n = 2003
    W = l_bytes // 4
    params = _build.draw_params(prime_field_ctx(p), -(-W // 3))
    out = torch.empty((n, 3), dtype=torch.int32)
    assert host_lib.mtt_squeeze_mont(st.data_ptr(), out.data_ptr(), n, W,
                                     lane, 5, ctypes.addressof(params),
                                     None) == 0
    assert torch.equal(out, rng._squeeze_mont_plain(st, n, l_bytes, p, lane,
                                                    5))


@pytest.mark.parametrize('n', [7, 6407])
@pytest.mark.parametrize('fuse', [True, False])
def test_reshare_source_matches_plain_at_three_limbs(host_lib, state, n,
                                                     fuse):
    """K3 on SecInt(37)'s 69-bit field: 12-byte shares, 20-byte draws."""
    st, _ = state
    spec = pipelines.ReshareSpec(P69, 1, 3)
    a, b = _shares(n, 21, P69), _shares(n, 22, P69)
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
    # no path draws 20-byte values into a three-limb field through K2
    params = _build.draw_params(prime_field_ctx(P69), 2)
    out = torch.empty((10, 3), dtype=torch.int32)
    assert host_lib.mtt_squeeze_mont(st.data_ptr(), out.data_ptr(), 10, 5,
                                     lane, 0, ctypes.addressof(params),
                                     None) == -1
    # K3 takes 1 <= t <= 4 and 2t + 1 <= m <= 16 (the Python side names
    # the limits), and n_send must be 2t + 1
    for t, m in ((1, 17), (5, 11)):
        with pytest.raises(NotImplementedError, match='t <= 4'):
            pipelines.ReshareSpec(P, t, m).params((0, 0))
    with pytest.raises(ValueError, match='2t'):
        pipelines.ReshareSpec(P, 2, 4)
    a = _parties_shares(10, 3, P, 17)
    for field, value in (('m', 17), ('t', 5), ('n_send', 3), ('m', 2)):
        params = pipelines.ReshareSpec(P, 2, 5).params((0, 0))
        setattr(params, field, value)
        if field == 't':
            params.m, params.n_send = 11, 11
        assert host_lib.mtt_reshare(a.data_ptr(), None, a.data_ptr(),
                                    st.data_ptr(), 10, 0,
                                    ctypes.addressof(params), None) == -1, \
            field


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


@pytest.mark.parametrize('n', [100, 641])
@pytest.mark.parametrize('mode', pipelines.SGN_MODES)
def test_sgn_source_matches_plain(host_lib, state, mode, n):
    """K5 at its built width (l = 32, k = 30): one ragged thread block of
    256, and three blocks, the last ragged."""
    st, _ = state
    spec = pipelines.SgnSpec(P, 1, 3, 32, 30, LT=mode == 'LT',
                             EQ=mode == 'EQ')
    a = _shares(n, 5)
    nonce = (0xFFFFFFFF, 4)
    out = torch.empty_like(a)
    params = spec.params(nonce)
    assert host_lib.mtt_sgn(a.data_ptr(), out.data_ptr(), st.data_ptr(), n,
                            n, n, ctypes.addressof(params), None) == 0
    assert torch.equal(out, pipelines._sgn_step_plain(a, st, nonce, spec))


@pytest.mark.parametrize('l', [14, 10])
@pytest.mark.parametrize('mode', pipelines.SGN_MODES)
def test_sgn_source_matches_plain_at_bnn_widths(host_lib, state, mode, l):
    """K5's instantiations for the BNN (SecInt(14)'s 46-bit field, k = 30)
    on three thread blocks, the last ragged."""
    st, _ = state
    spec = pipelines.SgnSpec(P46, 1, 3, l, 30, LT=mode == 'LT',
                             EQ=mode == 'EQ')
    n = 641
    a = _shares(n, 11, P46)
    nonce = (7, 0)
    out = torch.empty_like(a)
    params = spec.params(nonce)
    assert host_lib.mtt_sgn(a.data_ptr(), out.data_ptr(), st.data_ptr(), n,
                            n, n, ctypes.addressof(params), None) == 0
    assert torch.equal(out, pipelines._sgn_step_plain(a, st, nonce, spec))


@pytest.mark.parametrize('l', [16, 37])
def test_sgn_source_matches_plain_at_three_limbs(host_lib, state, l):
    """K5 (LT) on SecInt(37)'s 69-bit field at the CNN's first and last
    widths, on two thread blocks, the last ragged."""
    st, _ = state
    spec = pipelines.SgnSpec(P69, 1, 3, l, 30, LT=True)
    n = 300
    a = _shares(n, 23, P69)
    nonce = (0xFFFFFFFF, 2)
    out = torch.empty_like(a)
    params = spec.params(nonce)
    assert host_lib.mtt_sgn(a.data_ptr(), out.data_ptr(), st.data_ptr(), n,
                            n, n, ctypes.addressof(params), None) == 0
    assert torch.equal(out, pipelines._sgn_step_plain(a, st, nonce, spec))


@pytest.mark.parametrize('p,l,n,chunk', [(P69, 23, 1100, 1024),
                                         (P69, 30, 300, 256),
                                         (P46, 14, 1100, 512)])
def test_sgn_source_takes_many_chunks_in_one_launch(host_lib, state, p, l,
                                                    n, chunk):
    """One launch of K5 on n elements in chunks equals one plain call per
    chunk, chunk c with counter ctr + c (carried into the high word) on its
    shares padded to its bucket (the last: 1100 - 1024 = 76 given of a
    bucket of 128; 300 - 256 = 44 of 64; 1100 - 1024 = 76 of 128)."""
    st, _ = state
    spec = pipelines.SgnSpec(p, 1, 3, l, 30, LT=True)
    a = _shares(n, 24, p)
    ctr = (0xFFFFFFFE, 7)
    starts = list(range(0, n, chunk))
    n_last = pipelines.bucket(n - starts[-1], chunk)
    out = torch.empty_like(a)
    params = spec.params(ctr)      # alive across the call
    assert host_lib.mtt_sgn(a.data_ptr(), out.data_ptr(), st.data_ptr(), n,
                            chunk, n_last, ctypes.addressof(params),
                            None) == 0
    for c, j0 in enumerate(starts):
        part = a[:, j0:j0 + chunk]
        size = part.shape[1]
        pad = chunk if j0 + chunk < n else n_last
        part = torch.cat([part, torch.zeros((3, pad - size, a.shape[2]),
                                            dtype=torch.int32)], dim=1)
        lo = (ctr[0] + c) & 0xFFFFFFFF
        hi = ctr[1] + ((ctr[0] + c) >> 32)
        want = pipelines._sgn_step_plain(part, st, (lo, hi), spec)
        assert torch.equal(out[:, j0:j0 + size], want[:, :size]), c
    got, ctr2 = pipelines.sgn_chunks(a, st, ctr, spec, chunk)
    assert torch.equal(got, out)
    assert ctr2.tolist() == [(ctr[0] + len(starts)) & 0xFFFFFFFF, ctr[1] + 1]


# 16-byte draws into the two-limb field: two products and an add each
DRAW_OPS = (2, 1)


@pytest.mark.parametrize('mode,f', [('sgn', 0), ('LT', 0), ('EQ', 0),
                                    ('LT', 3)])
def test_sgn_field_ops_match_the_source(host_lib, state, mode, f):
    _check_sgn_field_ops(host_lib, state, mode, f, 32, P)


@pytest.mark.parametrize('l', [14, 10])
def test_sgn_field_ops_match_the_source_at_bnn_widths(host_lib, state, l):
    """As below, LT mode at the BNN's widths: 5 standard deviations of
    the ones are 335 (l = 14) and 283 (l = 10), below n / 2 = 640."""
    _check_sgn_field_ops(host_lib, state, 'LT', 0, l, P46)


@pytest.mark.parametrize('l', [16, 37])
def test_sgn_field_ops_match_the_source_at_three_limbs(host_lib, state, l):
    """As below, LT mode on SecInt(37)'s field at the CNN's first and last
    widths: 5 standard deviations of the ones are 358 (l = 16) and 544
    (l = 37), below n / 2 = 640; a 20-byte draw is two products and an add
    there too."""
    _check_sgn_field_ops(host_lib, state, 'LT', 0, l, P69)


def _check_sgn_field_ops(host_lib, state, mode, f, l, p, t=1, m=3):
    """SgnSpec.field_ops, from which chip_smoke.py bounds K5, counts the
    products the kernel's source runs exactly, and its adds up to the
    subtractions that the ones of c mod 2^l select. n = 1280 fills whole
    CTAs (the lanes of a CTA past n run the protocol on zeros, and their
    operations would count too); c mod 2^l is uniform, so its ones lie
    within 5 standard deviations (506 at l = 32) of n l / 2, and n = 2 mod
    6, so an error of 1, 2, 4 or 5 adds per element leaves a remainder and
    one of 3 moves the ones by n / 2."""
    st, _ = state
    spec = pipelines.SgnSpec(p, t, m, l, 30, LT=mode == 'LT',
                             EQ=mode == 'EQ', f=f)
    n = 1280
    params = spec.params((3, 0))
    assert n % host_lib.mtt_sgn_threads(ctypes.addressof(params)) == 0
    a = _shares(n, 8, p) if m == 3 else _parties_shares(n, 8, p, m)
    out = torch.empty_like(a)
    counts = _op_counts(host_lib)
    counts[0] = counts[1] = 0
    assert host_lib.mtt_sgn(a.data_ptr(), out.data_ptr(), st.data_ptr(), n,
                            n, n, ctypes.addressof(params), None) == 0
    draws = spec.draws_per_element()
    mont, adds = spec.field_ops(0)
    per_one = spec.field_ops(1)[1] - adds
    ns = 2 * t + 1     # the senders, and at l = 1 in EQ mode every party
    assert per_one == ((m if l == 1 else ns) if mode == 'EQ' else 2 * ns)
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
    params = spec.params()         # alive across the call
    assert host_lib.mtt_split_recombine(
        sec.data_ptr(), out.data_ptr(), None, st.data_ptr(), n,
        ctypes.addressof(params), None) == 0
    mont, adds = spec.field_ops()
    assert tuple(counts) == (n * (mont + spec.t * DRAW_OPS[0]),
                             n * (adds + spec.t * DRAW_OPS[1]))


@pytest.mark.parametrize('n', [20, 641])
def test_sgn_source_scales_by_2f(host_lib, state, n):
    st, _ = state
    spec = pipelines.SgnSpec(P, 1, 3, 32, 30, LT=True, f=3)
    a = _shares(n, 6)
    out = torch.empty_like(a)
    params = spec.params((1, 0))
    assert host_lib.mtt_sgn(a.data_ptr(), out.data_ptr(), st.data_ptr(), n,
                            n, n, ctypes.addressof(params), None) == 0
    assert torch.equal(out, pipelines._sgn_step_plain(a, st, (1, 0), spec))


def test_comparison_and_round_trip_refuse_what_was_not_built(host_lib,
                                                             state):
    """The Python side names what is built; the launchers refuse the rest:
    K5 takes any width whose random bits fit its limb count (l + 1 <= 63
    at two limbs), and K4 and K5 every (t, m) with 1 <= t <= 4 and 2t + 1
    <= m <= 16."""
    st, _ = state
    for t, m in ((1, 17), (5, 11)):
        with pytest.raises(NotImplementedError, match='t <= 4'):
            pipelines.SgnSpec(P, t, m, 16).params((0, 0))
        with pytest.raises(NotImplementedError, match='t <= 4'):
            pipelines.SplitSpec(P, t, m).params()
    with pytest.raises(NotImplementedError, match='2-limb'):
        pipelines.SplitSpec(P69, 1, 3).params()
    a = _parties_shares(10, 7, P, 17)
    for field, value in (('l', 63), ('l', 0), ('k', 65), ('m', 17),
                         ('t', 5), ('m', 2)):
        params = pipelines.SgnSpec(P, 1, 3, 32).params((0, 0))
        setattr(params, field, value)
        if field == 't':
            params.m = 11
        assert host_lib.mtt_sgn(a.data_ptr(), a.data_ptr(), st.data_ptr(),
                                10, 10, 10, ctypes.addressof(params),
                                None) == -1, field
        assert host_lib.mtt_sgn_threads(ctypes.addressof(params)) == -1
    for field, value in (('m', 17), ('t', 5), ('n_send', 3)):
        params = pipelines.SplitSpec(P, 1, 3).params()
        setattr(params, field, value)
        if field == 't':
            params.m, params.n_send = 11, 6
        assert host_lib.mtt_split_recombine(
            a.data_ptr(), a.data_ptr(), None, st.data_ptr(), 10,
            ctypes.addressof(params), None) == -1, field


@pytest.mark.parametrize('mode', pipelines.SGN_MODES)
def test_sgn_source_squeezes_each_block_once_per_thread_block(host_lib,
                                                              state, mode):
    """K5's stage squeezes every block of a range once per thread block
    (CTA): its permutations are those of chip_smoke.sgn_squeezes, the model
    whose warp count chip_smoke.py reports, and at most the stream's
    blocks plus two for each range and CTA (a block on the edge of two
    CTAs, or of two calls, is squeezed by both)."""
    import chip_smoke
    st, _ = state
    spec = pipelines.SgnSpec(P, 1, 3, 32, 30, LT=mode == 'LT',
                             EQ=mode == 'EQ')
    n = 1007
    a = _shares(n, 10)
    out = torch.empty_like(a)
    perms = ctypes.c_ulonglong.in_dll(host_lib, 'mtt_perm_count')
    perms.value = 0
    params = spec.params((2, 0))   # alive across the calls
    assert host_lib.mtt_sgn(a.data_ptr(), out.data_ptr(), st.data_ptr(), n,
                            n, n, ctypes.addressof(params), None) == 0
    threads = host_lib.mtt_sgn_threads(ctypes.addressof(params))
    assert threads == 256
    ctas = -(-n // threads)
    ranges = 1 + sum(sets for sets, _ in spec.draw_calls())
    assert perms.value == chip_smoke.sgn_squeezes(spec, n, threads)[0]
    assert perms.value <= spec.blocks(n) + 2 * ranges * ctas


def _pow_inputs(p, n, seed):
    """n canonical Montgomery elements of GF(p), 0 and 1 among them."""
    ctx = prime_field_ctx(p)
    x = _shares(n, seed, p)[0].contiguous()
    x[0] = 0
    x[1] = torch.tensor(ctx.one_mont, dtype=torch.int64).to(torch.int32)
    return ctx, x


@pytest.mark.parametrize('e', ['0', '1', 'p-2', '(3p-5)/4', '(p+1)/4'])
@pytest.mark.parametrize('p', [P52, P69, P96])
def test_mont_pow_source_matches_plain(host_lib, p, e):
    """K6 (a^e R mod p, one thread an element, 256 a block) on two thread
    blocks, the last ragged, at two and three limbs."""
    ctx, x = _pow_inputs(p, 300, 31)
    e = {'0': 0, '1': 1, 'p-2': p - 2, '(3p-5)/4': (3 * p - 5) // 4,
         '(p+1)/4': (p + 1) // 4}[e]
    out = torch.empty_like(x)
    params = _build.pow_params(ctx, e)
    assert host_lib.mtt_mont_pow(x.data_ptr(), out.data_ptr(), x.shape[0],
                                 ctypes.addressof(params), None) == 0
    assert torch.equal(out, fieldops._mont_pow_plain(x, e, ctx))


@pytest.mark.parametrize('p', [P52, P69])
def test_mont_pow_products_match_the_source(host_lib, p):
    """fieldops.plan_products, K6's product count, counts the Montgomery
    products the source runs: 68 an element at the Blum inverse-sqrt
    exponent of SecFxp(14, 6)'s field (the ladder's 99), 90 at SecInt(37)'s
    (132)."""
    ctx, x = _pow_inputs(p, 256, 32)
    e = (3 * p - 5) // 4
    counts = _op_counts(host_lib)
    counts[0] = counts[1] = 0
    out = torch.empty_like(x)
    params = _build.pow_params(ctx, e)   # alive across the call
    assert host_lib.mtt_mont_pow(
        x.data_ptr(), out.data_ptr(), x.shape[0],
        ctypes.addressof(params), None) == 0
    assert tuple(counts) == (x.shape[0] * fieldops.plan_products(e), 0)
    assert fieldops.plan_products(e) == {P52: 68, P69: 90}[p]
    assert fieldops.pow_products(e) == {P52: 99, P69: 132}[p]


# fields of each instantiation of K6 and K7: (limbs, lazy) = (2, True),
# (2, False) (SecInt(32)'s 64-bit field, 4p > R), (3, True), (3, False)
POW_FIELDS = [P52, P, P69, P96]


def _pow_exponent(name, p):
    k = 32 * prime_field_ctx(p).L
    return {'2^k': 1 << k - 1, '2^k-1': (1 << k) - 1, '9': 9, 'p-2': p - 2,
            '(3p-5)/4': (3 * p - 5) // 4}[name]


@pytest.mark.parametrize('e', ['2^k', '2^k-1', '9', 'p-2', '(3p-5)/4'])
@pytest.mark.parametrize('n', [300, 129])
@pytest.mark.parametrize('p', POW_FIELDS)
def test_mont_pow_source_matches_plain_by_field_and_threads(host_lib, p,
                                                            n, e):
    """K6 (two elements a thread, 128 threads a block: 256 elements a
    block) on ragged last blocks (300: the first slot part-filled and the
    second empty; 129: the second slot holds one element), on lazy and
    canonical fields of two and three limbs: the plan's table in shared
    memory, its steps, a plan of no steps and 2^k - 1 squarings (2^k), of
    the most windows (2^k - 1), of the ladder (9: windows of one bit)."""
    ctx, x = _pow_inputs(p, n, 34)
    assert ctx.lazy == (p in (P52, P69))
    e = _pow_exponent(e, p)
    out = torch.empty_like(x)
    params = _build.pow_params(ctx, e)
    assert host_lib.mtt_mont_pow(x.data_ptr(), out.data_ptr(), x.shape[0],
                                 ctypes.addressof(params), None) == 0
    assert torch.equal(out, fieldops._mont_pow_plain(x, e, ctx))


@pytest.mark.parametrize('e', ['(3p-5)/4', 'p-2'])
@pytest.mark.parametrize('p', POW_FIELDS)
def test_mont_pow_products_match_the_plan(host_lib, p, e):
    """The products of every instantiation are the plan's, at e = (3p -
    5) / 4 and at p - 2, on whole blocks."""
    ctx, x = _pow_inputs(p, 256, 35)
    e = _pow_exponent(e, p)
    counts = _op_counts(host_lib)
    out = torch.empty_like(x)
    counts[0] = counts[1] = 0
    params = _build.pow_params(ctx, e)   # alive across the call
    assert host_lib.mtt_mont_pow(
        x.data_ptr(), out.data_ptr(), x.shape[0],
        ctypes.addressof(params), None) == 0
    assert tuple(counts) == (x.shape[0] * fieldops.plan_products(e), 0)
    assert fieldops.plan_products(e) < fieldops.pow_products(e)


def _tail_shares(p, n, seed, every=7, m=3):
    """(m, n, L) shares r and z, every ``every``-th element planted so that
    the opening of r^2 + z at threshold 2t (2t <= m - 1) is 0 with no
    share 0 (r a sharing of 0 of degree 1, z one of degree 2), the rest
    random."""
    g = np.random.default_rng(seed)
    ctx = prime_field_ctx(p)
    rv = np.empty((m, n), dtype=object)
    zv = np.empty((m, n), dtype=object)
    for j in range(n):
        a, b, c = (int(v) for v in g.integers(1, 1 << 62, 3))
        for i in range(m):
            x = i + 1
            if j % every == 0:
                rv[i, j], zv[i, j] = a * x % p, (b * x + c * x * x) % p
            else:
                rv[i, j], zv[i, j] = (a * (i + 5)) ** 3 % p, b * c * x % p
    return ctx.encode(rv, 'cpu'), ctx.encode(zv, 'cpu')


def _tail_launch(host_lib, r, z, field, signed, f, t=1):
    n = r.shape[1]
    bits = torch.empty_like(r)
    flags = torch.empty(n, dtype=torch.uint8)
    count = torch.zeros(1, dtype=torch.int32)
    params = pipelines._tail_params(field, t, r.shape[0], signed, f)
    assert host_lib.mtt_random_bits_tail(
        r.data_ptr(), z.data_ptr(), bits.data_ptr(), flags.data_ptr(),
        count.data_ptr(), n, ctypes.addressof(params), None) == 0
    return bits, flags, count


@pytest.mark.parametrize('n', [300, 129])
@pytest.mark.parametrize('f', [0, 6])
@pytest.mark.parametrize('signed', [False, True])
@pytest.mark.parametrize('p', [P52, P69])
def test_random_bits_tail_source_matches_plain(host_lib, p, signed, f, n):
    """K7 (two and three limbs) equals _random_bits_tail_plain on n
    elements (ragged last blocks, as K6's test), one in 7 planted to open
    to 0: bits, flags and count."""
    from mpyc_tpu_torch import finfields
    field = finfields.GF(p)
    r, z = _tail_shares(p, n, 36)
    bits, flags, count = _tail_launch(host_lib, r, z, field, signed, f)
    want = pipelines._random_bits_tail_plain(r, z, field, signed, f)
    assert torch.equal(flags, want[1])
    assert count.item() == want[2].item() == -(-n // 7)
    assert torch.equal(bits, want[0])


@pytest.mark.parametrize('signed,f', [(False, 0), (True, 0), (True, 6)])
def test_random_bits_tail_field_ops_match_the_source(host_lib, signed, f):
    """pipelines.random_bits_tail_ops, from which chip_smoke.py counts K7's
    work, counts the source's products and modular adds (whole blocks)."""
    from mpyc_tpu_torch import finfields
    field = finfields.GF(P52)
    r, z = _tail_shares(P52, 256, 37)
    counts = _op_counts(host_lib)
    counts[0] = counts[1] = 0
    _tail_launch(host_lib, r, z, field, signed, f)
    mont, adds = pipelines.random_bits_tail_ops(P52, signed, f)
    assert tuple(counts) == (256 * mont, 256 * adds)
    assert mont == 3 + 3 + 68 + int(not signed or f > 0) + 3


def test_random_bits_tail_refuses_what_was_not_built(host_lib):
    """The Python side names what K7 is built for; the launcher refuses
    the rest."""
    from mpyc_tpu_torch import finfields
    field = finfields.GF(P52)
    for t, m in ((1, 17), (5, 11)):
        with pytest.raises(NotImplementedError, match='t <= 4'):
            pipelines._tail_params(field, t, m, False, 0)
    with pytest.raises(NotImplementedError, match='3 mod 4'):
        pipelines._tail_params(finfields.GF(4503599627370449), 1, 3, False,
                               0)
    r, z = _tail_shares(P52, 10, 38)
    for field_name, value in (('m', 17), ('t', 5), ('m', 4)):
        params = pipelines._tail_params(field, 2, 5, False, 0)
        setattr(params, field_name, value)
        assert host_lib.mtt_random_bits_tail(
            r.data_ptr(), z.data_ptr(), r.data_ptr(), r.data_ptr(),
            r.data_ptr(), 10, ctypes.addressof(params), None) == -1
    params = pipelines._tail_params(field, 1, 3, False, 0)
    params.m = 17
    assert host_lib.mtt_random_bits_tail(
        r.data_ptr(), z.data_ptr(), r.data_ptr(), r.data_ptr(),
        r.data_ptr(), 10, ctypes.addressof(params), None) == -1
    params = pipelines._tail_params(field, 1, 3, False, 0)
    params.pow.nl = 7
    assert host_lib.mtt_random_bits_tail(
        r.data_ptr(), z.data_ptr(), r.data_ptr(), r.data_ptr(),
        r.data_ptr(), 10, ctypes.addressof(params), None) == -1


def test_mont_pow_refuses_what_was_not_built(host_lib):
    ctx, x = _pow_inputs(P52, 10, 33)
    params = _build.pow_params(ctx, 5)
    params.nl = 7
    assert host_lib.mtt_mont_pow(x.data_ptr(), x.data_ptr(), 10,
                                 ctypes.addressof(params), None) == -1
    params = _build.pow_params(ctx, 5)
    params.nbits = 32 * _build.MAX_NL + 1
    assert host_lib.mtt_mont_pow(x.data_ptr(), x.data_ptr(), 10,
                                 ctypes.addressof(params), None) == -1
    with pytest.raises(NotImplementedError, match='limbs'):
        _build.pow_params(prime_field_ctx((1 << 521) - 1), 3)


# -- the LP solver's fields: four and five limbs ------------------------------

@pytest.mark.parametrize('p', [P102, P136])
@pytest.mark.parametrize('fuse', [True, False])
def test_reshare_source_matches_plain_at_four_and_five_limbs(host_lib, state,
                                                             p, fuse):
    """K3 on the LP solver's 102-bit (four limbs, 24-byte draws) and
    136-bit (five limbs, 28-byte draws) fields, its staged coefficients in
    dynamic shared memory, on two thread blocks, the last ragged."""
    st, _ = state
    spec = pipelines.ReshareSpec(p, 1, 3)
    assert spec.l_bytes == 4 * (spec.ctx.L + 2)
    n = 3300
    a, b = _shares(n, 41, p), _shares(n, 42, p)
    nonce = (0xFFFFFFFF, 9)
    params = spec.params(nonce)
    out = torch.empty_like(a)
    assert host_lib.mtt_reshare(a.data_ptr(), b.data_ptr() if fuse else None,
                                out.data_ptr(), st.data_ptr(), n, int(fuse),
                                ctypes.addressof(params), None) == 0
    want = pipelines._reshare_mul_plain(a, b if fuse else None, st, nonce,
                                        spec)
    assert torch.equal(out, want)


@pytest.mark.parametrize('p,l', [(P102, 70), (P136, 104), (P142, 110),
                                 (P46, 6), (P46, 8), (P, 20), (P96, 45)])
@pytest.mark.parametrize('mode', ['LT', 'EQ'])
def test_sgn_source_matches_plain_at_any_width(host_lib, state, mode, p, l):
    """K5 with l a launch parameter: the LP solver's widths on its four-
    and five-limb fields (l + 1 random bits in three and four words, 64
    elements a CTA at five limbs), and widths that no instantiation took
    before on two and three limbs; 130 elements, over more than one CTA
    wherever the CTA is narrower than 256."""
    st, _ = state
    spec = pipelines.SgnSpec(p, 1, 3, l, 30, LT=mode == 'LT',
                             EQ=mode == 'EQ')
    n = 130
    a = _shares(n, 43, p)
    nonce = (0xFFFFFFFF, 5)
    out = torch.empty_like(a)
    params = spec.params(nonce)
    B = host_lib.mtt_sgn_threads(ctypes.addressof(params))
    assert B == (64 if spec.ctx.L == 5 else 128 if spec.ctx.L == 4 else 256)
    assert host_lib.mtt_sgn(a.data_ptr(), out.data_ptr(), st.data_ptr(), n,
                            n, n, ctypes.addressof(params), None) == 0
    assert torch.equal(out, pipelines._sgn_step_plain(a, st, nonce, spec))


@pytest.mark.parametrize('e', ['p-2', '(p-1)/2', '(3p-5)/4'])
@pytest.mark.parametrize('p', [P102, P142, (1 << 127) - 1])
def test_mont_pow_source_matches_plain_at_four_and_five_limbs(host_lib, p,
                                                              e):
    """K6 at four and five limbs (lazy: the LP solver's fields) and at a
    four-limb field with 4p > R (2^127 - 1: the canonical products), at
    the public inverse's exponent, the Legendre symbol's and the inverse
    square root's, on a ragged last block."""
    ctx, x = _pow_inputs(p, 300, 44)
    assert ctx.lazy == (p != (1 << 127) - 1)
    e = {'p-2': p - 2, '(p-1)/2': (p - 1) // 2,
         '(3p-5)/4': (3 * p - 5) // 4}[e]
    out = torch.empty_like(x)
    params = _build.pow_params(ctx, e)
    assert host_lib.mtt_mont_pow(x.data_ptr(), out.data_ptr(), x.shape[0],
                                 ctypes.addressof(params), None) == 0
    assert torch.equal(out, fieldops._mont_pow_plain(x, e, ctx))


@pytest.mark.parametrize('p', [P102, P142])
def test_random_bits_tail_source_matches_plain_at_four_and_five_limbs(
        host_lib, p):
    """K7 on the LP solver's fields (the random bits of its [NO07] zero
    tests), one element in 7 planted to open to 0."""
    from mpyc_tpu_torch import finfields
    field = finfields.GF(p)
    r, z = _tail_shares(p, 129, 45)
    bits, flags, count = _tail_launch(host_lib, r, z, field, False, 0)
    want = pipelines._random_bits_tail_plain(r, z, field, False, 0)
    assert torch.equal(flags, want[1])
    assert count.item() == want[2].item() == -(-129 // 7)
    assert torch.equal(bits, want[0])


# K8: the GF(2^d) reshare, squeezing its own stream. The moduli: GF(4)
# (SecFld(2)'s extension at m = 3), GF(2^8) (AES's), GF(2^12) (two-byte
# draws, 84 a block), GF(2^16) (two-byte draws of whole words), GF(2^17)
# (three-byte draws, 56 a block) and GF(2^32) (the widest the kernel
# takes). GF(2) has no three points: its spec refuses (d = 1).
GF2_MODULI = {2: 0b111, 8: 0x11B, 12: 0x1009, 16: 0x1002B, 17: 0x20009,
              32: (1 << 32) | 0x8D}
# A K8 CTA takes 128 x ept elements, ept from n (the largest power of two
# up to 8 that keeps a CTA for each of 132 SMs): 128 up to 33,791
# elements, 256 up to 67,583, 512 up to 135,167, then 1,024
K8_ELEMS = {1: 128, 64: 128, 127: 128, 128: 128, 129: 128, 1000: 128,
            4099: 128, 33797: 256, 67589: 512, 135173: 1024}


def _gf2_shares(n, d, seed):
    g = np.random.default_rng(seed)
    v = g.integers(0, 1 << d, (3, n, 1), dtype=np.uint64).astype(np.uint32)
    return torch.from_numpy(v.view(np.int32))


def _reshare2_source(host_lib, st, spec, a, b, nonce):
    """One host launch of K8; (out, general products, permutations)."""
    out = torch.empty_like(a)
    counts = _op_counts(host_lib)
    counts[0] = counts[1] = 0
    perms = ctypes.c_ulonglong.in_dll(host_lib, 'mtt_perm_count')
    perms.value = 0
    params = spec.params(nonce)    # alive across the call
    assert host_lib.mtt_reshare2(
        a.data_ptr(), b.data_ptr() if b is not None else None,
        out.data_ptr(), st.data_ptr(), a.shape[1], int(b is not None),
        ctypes.addressof(params), None) == 0
    return out, tuple(counts), perms.value


def _reshare2_blocks(spec, n, elems):
    """The blocks a launch on n elements squeezes: for each CTA the union
    of its three draw runs' blocks, each once."""
    epb = 168 // spec.l_bytes
    total = 0
    for e0 in range(0, n, elems):
        cnt = min(elems, n - e0)
        touched = set()
        for i in range(3):
            d0 = i * n + e0
            touched.update(range(d0 // epb, (d0 + cnt - 1) // epb + 1))
        total += len(touched)
    return total


@pytest.mark.parametrize('d', sorted(GF2_MODULI))
@pytest.mark.parametrize('fused', [True, False])
@pytest.mark.parametrize('n', [64, 1000, 1, 127, 128, 129, 4099])
def test_reshare2_source_matches_plain(host_lib, state, d, fused, n):
    """K8 equals its plain version from the same state and counter: at one
    element, at a bucket of 64, on both sides of a CTA's edge (128
    elements at these n), and at 1,000 and 4,099 elements, whose draws
    straddle 168-byte blocks (the second sender's first draw is byte
    1000 % 168 = 160 of its block at one byte a draw); its general
    products are ``Reshare2Spec.field_ops`` an element (3 fused, none
    without), and it squeezes each block its CTAs touch once a CTA."""
    st, _ = state
    spec = pipelines.Reshare2Spec(GF2_MODULI[d], 1, 3)
    assert spec.d == d
    assert host_lib.mtt_reshare2_elems(n) == K8_ELEMS[n]
    a, b = _gf2_shares(n, d, d), _gf2_shares(n, d, d + 1)
    b = b if fused else None
    nonce = (0xFFFFFFFF, 7)
    out, counts, perms = _reshare2_source(host_lib, st, spec, a, b, nonce)
    assert torch.equal(out, pipelines._reshare2_plain(a, b, st, nonce,
                                                      spec))
    assert counts == (n * spec.field_ops(fused), 0)
    assert perms == _reshare2_blocks(spec, n, K8_ELEMS[n])


@pytest.mark.parametrize('n', [33797, 67589, 135173])
@pytest.mark.parametrize('d', [2, 8])
def test_reshare2_source_matches_plain_at_every_cta_size(host_lib, state, n,
                                                         d):
    """K8 at the sizes where a CTA takes 256, 512 and 1,024 elements (2, 4
    and 8 a thread), fused, at SHA3's and AES's d: bit-equal to its plain
    version, each block squeezed once a CTA, and the squeezes at most 1.3
    times the stream's blocks from 1,024 elements a CTA on (n = 2^19 at
    SHA3's chi: 1.16)."""
    st, _ = state
    spec = pipelines.Reshare2Spec(GF2_MODULI[d], 1, 3)
    elems = host_lib.mtt_reshare2_elems(n)
    assert elems == K8_ELEMS[n]
    a, b = _gf2_shares(n, d, n), _gf2_shares(n, d, n + 1)
    nonce = (3, 0)
    out, counts, perms = _reshare2_source(host_lib, st, spec, a, b, nonce)
    assert torch.equal(out, pipelines._reshare2_plain(a, b, st, nonce,
                                                      spec))
    assert counts == (3 * n, 0)
    assert perms == _reshare2_blocks(spec, n, elems)
    if elems == 1024:
        assert perms <= 1.3 * spec.n_blocks(n)
    big = 1 << 19
    assert host_lib.mtt_reshare2_elems(big) == 1024
    assert _reshare2_blocks(spec, big, 1024) <= 1.2 * spec.n_blocks(big)
    assert -(-32768 // host_lib.mtt_reshare2_elems(32768)) >= 132


def test_reshare2_refuses_what_was_not_built():
    """GF(2) has no three points (its spec cannot be made), and the
    kernel's parameters exist only at (t, m) = (1, 3)."""
    with pytest.raises(ZeroDivisionError):
        pipelines.Reshare2Spec(0b11, 1, 3)
    for t, m in ((1, 4), (2, 5)):
        with pytest.raises(NotImplementedError, match='(1, 3)'):
            pipelines.Reshare2Spec(0x11B, t, m).params((0, 0))


# -- the fixed-point fields: six limbs, and four with 4p >= R -----------------

# SecFxp(96)'s 176-bit field (the fixed-point LP solver's kb2 and
# LPExample), six limbs, lazy; SecFxp(64, 32)'s 128-bit field (the survival
# test on aml), four limbs with 4p >= R: the canonical products
P176 = 95780971304118053647396689196894323976171195136474903
P128 = 340282366920938463463374607431768211283


@pytest.mark.parametrize('fuse', [True, False])
def test_reshare_source_matches_plain_at_six_limbs(host_lib, state, fuse):
    """K3 on SecFxp(96)'s field (32-byte draws), its staged coefficients in
    76,800 bytes of dynamic shared memory, on two thread blocks, the last
    ragged."""
    st, _ = state
    spec = pipelines.ReshareSpec(P176, 1, 3)
    assert (spec.ctx.L, spec.l_bytes) == (6, 32)
    n = 3300
    a, b = _shares(n, 51, P176), _shares(n, 52, P176)
    nonce = (0xFFFFFFFF, 11)
    params = spec.params(nonce)
    out = torch.empty_like(a)
    assert host_lib.mtt_reshare(a.data_ptr(), b.data_ptr() if fuse else None,
                                out.data_ptr(), st.data_ptr(), n, int(fuse),
                                ctypes.addressof(params), None) == 0
    want = pipelines._reshare_mul_plain(a, b if fuse else None, st, nonce,
                                        spec)
    assert torch.equal(out, want)


@pytest.mark.parametrize('l,f', [(96, 0), (96, 48), (160, 0)])
@pytest.mark.parametrize('mode', pipelines.SGN_MODES)
def test_sgn_source_matches_plain_at_six_limbs(host_lib, state, mode, l, f):
    """K5 on SecFxp(96)'s field at its comparisons' width (l = 96, with
    and without the fixed-point scale 2^48) and at l = 160 (the widest
    with l + k + 2 bits of p = 176), 70 elements over more than one CTA."""
    st, _ = state
    spec = pipelines.SgnSpec(P176, 1, 3, l, 14 if l == 160 else 30,
                             LT=mode == 'LT', EQ=mode == 'EQ', f=f)
    n = 70
    a = _shares(n, 53, P176)
    nonce = (0xFFFFFFFF, 6)
    out = torch.empty_like(a)
    params = spec.params(nonce)
    B = host_lib.mtt_sgn_threads(ctypes.addressof(params))
    assert B in (32, 64)
    assert host_lib.mtt_sgn(a.data_ptr(), out.data_ptr(), st.data_ptr(), n,
                            n, n, ctypes.addressof(params), None) == 0
    assert torch.equal(out, pipelines._sgn_step_plain(a, st, nonce, spec))


@pytest.mark.parametrize('e', ['p-2', '(p-1)/2', '(3p-5)/4'])
@pytest.mark.parametrize('p', [P176, P128])
def test_mont_pow_source_matches_plain_at_six_limbs_and_canonical_four(
        host_lib, p, e):
    """K6 on SecFxp(96)'s six-limb field (its table of odd powers in
    dynamic shared memory past 48 KB) and on SecFxp(64, 32)'s canonical
    four-limb one, at the public inverse's, the Legendre symbol's and the
    inverse square root's exponents, on a ragged last block."""
    ctx, x = _pow_inputs(p, 300, 54)
    assert (ctx.L, ctx.lazy) == ((6, True) if p == P176 else (4, False))
    e = {'p-2': p - 2, '(p-1)/2': (p - 1) // 2,
         '(3p-5)/4': (3 * p - 5) // 4}[e]
    out = torch.empty_like(x)
    params = _build.pow_params(ctx, e)
    assert host_lib.mtt_mont_pow(x.data_ptr(), out.data_ptr(), x.shape[0],
                                 ctypes.addressof(params), None) == 0
    assert torch.equal(out, fieldops._mont_pow_plain(x, e, ctx))


@pytest.mark.parametrize('signed,f', [(False, 0), (False, 48), (True, 0)])
@pytest.mark.parametrize('p', [P176, P128])
def test_random_bits_tail_source_matches_plain_at_six_limbs_and_canonical_four(
        host_lib, p, signed, f):
    """K7 on SecFxp(96)'s and SecFxp(64, 32)'s fields (the truncations' and
    zero tests' random bits of the fixed-point LP solver and the survival
    test), one element in 7 planted to open to 0."""
    from mpyc_tpu_torch import finfields
    field = finfields.GF(p)
    r, z = _tail_shares(p, 129, 55)
    bits, flags, count = _tail_launch(host_lib, r, z, field, signed, f)
    want = pipelines._random_bits_tail_plain(r, z, field, signed, f)
    assert torch.equal(flags, want[1])
    assert count.item() == want[2].item() == -(-129 // 7)
    assert torch.equal(bits, want[0])


# a one-limb field (2^31 - 1) and a seven-limb one (a 200-bit prime,
# 3 mod 4)
P31 = (1 << 31) - 1
P200 = 1606938044258990275541962092341162602522202993782792835301259


def test_one_and_seven_limb_fields_raise(host_lib, state):
    """The narrow kernels' parameter blocks (``_build.BUILT_NL``, one to
    six limbs) refuse more: K3's, K5's, K6's and K7's raise
    NotImplementedError on the Python side, and their launchers refuse a
    block of seven limbs (fields of 7 to 48 limbs take the wide kernels,
    ``test_wide_sources_match_plain``; K5 has none); a one-limb field (the
    secure prime fields SecFld(p)) has no comparison, so K5 alone refuses
    it, on both sides."""
    from mpyc_tpu_torch import finfields
    assert _build.BUILT_NL == (1, 2, 3, 4, 5, 6) and _build.MAX_NL == 6
    assert _build.SGN_BUILT_NL == (2, 3, 4, 5, 6)
    for p in (P31, P200):
        ctx = prime_field_ctx(p)
        assert ctx.L in (1, 7) and p % 4 == 3
        with pytest.raises(NotImplementedError, match='limbs'):
            pipelines.SgnSpec(p, 1, 3, 8, 8, LT=True).params((0, 0))
    ctx = prime_field_ctx(P200)
    with pytest.raises(NotImplementedError, match='limbs'):
        pipelines.ReshareSpec(P200, 1, 3).params((0, 0))
    with pytest.raises(NotImplementedError, match='limbs'):
        _build.pow_params(ctx, 5)
    with pytest.raises(NotImplementedError, match='limbs'):
        pipelines._tail_params(finfields.GF(P200), 1, 3, False, 0)
    pipelines.ReshareSpec(P31, 1, 3).params((0, 0))
    _build.pow_params(prime_field_ctx(P31), 5)
    pipelines._tail_params(finfields.GF(P31), 1, 3, False, 0)
    st, _ = state
    a = _shares(10, 56, P176)
    for nl in (1, 7):
        params = pipelines.SgnSpec(P176, 1, 3, 96, LT=True).params((0, 0))
        params.draw.nl = nl
        assert host_lib.mtt_sgn(a.data_ptr(), a.data_ptr(), st.data_ptr(),
                                10, 10, 10, ctypes.addressof(params),
                                None) == -1
    params = pipelines.ReshareSpec(P176, 1, 3).params((0, 0))
    params.draw.nl = 7
    assert host_lib.mtt_reshare(a.data_ptr(), None, a.data_ptr(),
                                st.data_ptr(), 10, 0,
                                ctypes.addressof(params), None) == -1
    params = _build.pow_params(prime_field_ctx(P176), 5)
    params.nl = 7
    assert host_lib.mtt_mont_pow(a.data_ptr(), a.data_ptr(), 10,
                                 ctypes.addressof(params), None) == -1


# one-limb fields: GF(11) and GF(1031) (indextounitvector's fields at n =
# 10 and 1,024; 4p < 2^32, lazy) and GF(2^31 - 1) (canonical)
ONE_LIMB = [11, 1031, P31]


@pytest.mark.parametrize('p', ONE_LIMB)
@pytest.mark.parametrize('kernel', ['K3 fused', 'K3', 'K6', 'K7', 'K9'])
def test_one_limb_sources_match_plain(host_lib, state, kernel, p):
    """The one-limb instantiations equal their plain versions bit for bit:
    K3 (fused and not) on 6,407 elements (three thread blocks, the last
    ragged; 14 draws of 12 bytes a sponge block), K6 at e = p - 2, (3p -
    5) / 4 and 2^32 - 1 on 300 elements (two blocks, the last ragged), K7
    on 300 elements with one in 7 planted to open to 0 (bits, flags,
    count), K9's three ops with arrays and a constant."""
    from mpyc_tpu_torch import finfields
    st, _ = state
    ctx = prime_field_ctx(p)
    assert ctx.L == 1 and ctx.lazy == (p < 1 << 30)
    if kernel.startswith('K3'):
        fuse = kernel == 'K3 fused'
        spec = pipelines.ReshareSpec(p, 1, 3)
        assert spec.l_bytes == 12
        n = 6407
        a, b = _shares(n, 70, p), _shares(n, 71, p)
        nonce = (0xFFFFFFFF, 9)
        params = spec.params(nonce)
        out = torch.empty_like(a)
        assert host_lib.mtt_reshare(
            a.data_ptr(), b.data_ptr() if fuse else None, out.data_ptr(),
            st.data_ptr(), n, int(fuse), ctypes.addressof(params),
            None) == 0
        assert torch.equal(out, pipelines._reshare_mul_plain(
            a, b if fuse else None, st, nonce, spec))
    elif kernel == 'K6':
        _, x = _pow_inputs(p, 300, 72)
        for e in (p - 2, (3 * p - 5) // 4, (1 << 32) - 1):
            out = torch.empty_like(x)
            params = _build.pow_params(ctx, e)
            assert host_lib.mtt_mont_pow(x.data_ptr(), out.data_ptr(), 300,
                                         ctypes.addressof(params),
                                         None) == 0
            assert torch.equal(out, fieldops._mont_pow_plain(x, e, ctx))
    elif kernel == 'K7':
        field = finfields.GF(p)
        r, z = _tail_shares(p, 300, 73)
        for signed, f in ((False, 0), (True, 0)):
            bits, flags, count = _tail_launch(host_lib, r, z, field, signed,
                                              f)
            want = pipelines._random_bits_tail_plain(r, z, field, signed, f)
            assert torch.equal(flags, want[1]) and torch.equal(bits, want[0])
            assert count.item() == want[2].item() >= 300 // 7
    else:
        params = _build.draw_params(ctx, 1)
        a, b = _shares(300, 74, p)[0].contiguous(), _shares(300, 75, p)[0]
        c = _shares(1, 76, p)[0].contiguous()
        for op in ('mul', 'add', 'sub'):
            for x, y, sx, sy in ((a, b.contiguous(), 1, 1), (a, c, 1, 0),
                                 (c, a, 0, 1)):
                out = torch.empty((300, 1), dtype=torch.int32)
                assert host_lib.mtt_field_op(
                    x.data_ptr(), y.data_ptr(), out.data_ptr(), 300, sx, sy,
                    fieldops._FIELD_OPS.index(op), ctypes.addressof(params),
                    None) == 0
                assert torch.equal(out,
                                   fieldops._field_op_plain(x, y, op, ctx))


def test_one_limb_squeeze_is_not_built(host_lib, state):
    """K2 takes draws of up to MAX_NC = 4 chunks: a one-limb field's
    20-byte input draws (GF(2^31 - 1)) are five, so K2 refuses them and
    the generator squeezes them with K1 and splits them
    (``rng.KeccakRNG.field_uniform``)."""
    st, lane = state
    assert _build.MAX_NC == 4
    params = _build.draw_params(prime_field_ctx(P31), 4)
    out = torch.empty((10, 1), dtype=torch.int32)
    assert host_lib.mtt_squeeze_mont(st.data_ptr(), out.data_ptr(), 10, 5,
                                     lane, 0, ctypes.addressof(params),
                                     None) == -1


# -- K9: elementwise field arithmetic -------------------------------------------

@pytest.mark.parametrize('op', ['mul', 'add', 'sub'])
@pytest.mark.parametrize('p', [P, P69, P102, P142, P176])
def test_field_op_source_matches_plain(host_lib, p, op):
    """K9 at two to six limbs, each op on 300 elements (two thread blocks,
    the last ragged), with both operands arrays and with either one a
    constant (step 0); the product also with a below R (a draw's chunk, as
    reduce_chunks passes it)."""
    ctx = prime_field_ctx(p)
    params = _build.draw_params(ctx, 1)
    a, b = _shares(300, 57, p)[0].contiguous(), _shares(300, 58, p)[0]
    c = _shares(1, 59, p)[0].contiguous()
    cases = [(a, b.contiguous(), 1, 1), (a, c, 1, 0), (c, a, 0, 1)]
    if op == 'mul':
        wide = torch.from_numpy(np.random.default_rng(60).integers(
            0, 1 << 32, (300, ctx.L), dtype=np.uint64).astype(
            np.uint32).view(np.int32))
        cases.append((wide, c, 1, 0))
    for x, y, sx, sy in cases:
        out = torch.empty((300, ctx.L), dtype=torch.int32)
        assert host_lib.mtt_field_op(
            x.data_ptr(), y.data_ptr(), out.data_ptr(), 300, sx, sy,
            fieldops._FIELD_OPS.index(op), ctypes.addressof(params),
            None) == 0
        assert torch.equal(out, fieldops._field_op_plain(x, y, op, ctx))


def test_field_op_refuses_what_was_not_built(host_lib):
    """K9 takes one to six limbs, ops 0-2 and steps 0 and 1; its parameter
    block refuses a seven-limb field, which the wide K9 takes
    (``test_wide_sources_match_plain``)."""
    a = _shares(10, 61, P176)[0].contiguous()
    for nl, op, sa in ((0, 0, 1), (7, 0, 1), (6, 3, 1), (6, 0, 2)):
        params = _build.draw_params(prime_field_ctx(P176), 1)
        params.nl = nl
        assert host_lib.mtt_field_op(a.data_ptr(), a.data_ptr(),
                                     a.data_ptr(), 10, sa, 1, op,
                                     ctypes.addressof(params), None) == -1
    with pytest.raises(NotImplementedError, match='limbs'):
        _build.draw_params(prime_field_ctx(P200), 1)
    _build.draw_params(prime_field_ctx(P31), 1)


# -- wide fields: K3, K6, K7 and K9 at 7 to 48 limbs (csrc/wide.cu) ------------

# SecInt(335)'s field (multilateration, 12 limbs) and a 1,030-bit Blum
# prime (33 limbs; ridge regression's student-mat field has 42)
P367 = int('30061345059505065316985351638903513950408736626026494345053324'
           '4356122755214669880763353471793250393988087676127')
P1030 = (1 << 1029) + 639
WIDE = [P200, P367, P1030]
WIDE_IDS = ['L7', 'L12', 'L33']
# a 1,314-bit Blum prime, 42 limbs (student-mat's field is as wide): its
# fused draws of 176 bytes are wider than a sponge block
P1314 = (1 << 1313) + 359


def test_wide_fields_are_what_the_paths_take():
    """The constants above are the fields the tests name: 7, 12, 33 and
    42 limbs, each p = 3 mod 4 (K7's inverse square root)."""
    from mpyc_tpu_torch import gmpy, sectypes
    assert P367 == sectypes.SecInt(335, 'cpu').field.modulus
    assert gmpy.is_prime(P1030) and gmpy.is_prime(P200)
    assert [prime_field_ctx(p).L for p in WIDE] == [7, 12, 33]
    assert all(p % 4 == 3 for p in WIDE)
    assert all(_build.wide(prime_field_ctx(p).L) for p in WIDE)
    assert gmpy.is_prime(P1314) and prime_field_ctx(P1314).L == 42


@pytest.mark.parametrize('fuse', [True, False])
def test_wide_reshare_source_matches_plain_at_two_blocks_a_draw(
        host_lib, state, fuse):
    """The wide K3 at 42 limbs: each 176-byte draw owns two whole sponge
    blocks (``rng.words_to_elements``), so a thread squeezes both; 7 and
    300 elements (three thread blocks, the last ragged)."""
    st, _ = state
    spec = pipelines.ReshareSpec(P1314, 1, 3)
    assert spec.l_bytes == 176 > keccak.RATE
    for n in (7, 300):
        a = _shares(n, 93, P1314)
        b = _shares(n, 94, P1314) if fuse else None
        assert torch.equal(
            _wide_reshare(host_lib, st, spec, a, b, (1, 0)),
            pipelines._reshare_mul_plain(a, b, st, (1, 0), spec))


def _wide_reshare(host_lib, st, spec, a, b, nonce):
    out = torch.empty_like(a)
    consts = spec.wide_consts('cpu')
    assert host_lib.mtt_reshare_wide(
        a.data_ptr(), b.data_ptr() if b is not None else None,
        out.data_ptr(), st.data_ptr(), a.shape[1], int(b is not None),
        consts.data_ptr(), spec.ctx.n0inv, spec.ctx.L, nonce[0], nonce[1],
        spec.t, spec.m, None) == 0
    return out


def _wide_pow(host_lib, x, e, ctx):
    out = torch.empty_like(x)
    params, steps = _build.wide_pow(ctx, e)
    consts = _build.wide_words('cpu', ctx.p_limbs, ctx.one_mont, steps)
    assert host_lib.mtt_mont_pow_wide(x.data_ptr(), out.data_ptr(),
                                      x.shape[0], consts.data_ptr(),
                                      ctypes.addressof(params), None) == 0
    return out


def _wide_tail(host_lib, r, z, field, signed, f, t=1):
    n = r.shape[1]
    bits = torch.empty_like(r)
    flags = torch.empty(n, dtype=torch.uint8)
    count = torch.zeros(1, dtype=torch.int32)
    params, consts = pipelines._wide_tail_params(field, t, r.shape[0],
                                                 signed, f, 'cpu')
    assert host_lib.mtt_random_bits_tail_wide(
        r.data_ptr(), z.data_ptr(), bits.data_ptr(), flags.data_ptr(),
        count.data_ptr(), n, consts.data_ptr(), ctypes.addressof(params),
        None) == 0
    return bits, flags, count


@pytest.mark.parametrize('p', WIDE, ids=WIDE_IDS)
@pytest.mark.parametrize('kernel', ['K3 fused', 'K3', 'K6', 'K7', 'K9'])
def test_wide_sources_match_plain(host_lib, state, kernel, p):
    """The wide kernels equal their plain versions bit for bit at 7, 12
    and 33 limbs: K3 (fused and not) on 7 elements and on 300 (three
    thread blocks of 128, the last ragged; 4, 3 and 1 draws a sponge
    block, so blocks straddle the CTAs' edges), K6 at e = p - 2, (p - 1) /
    2 and 0 on 130 elements (two blocks, 0 and 1 among them; 20 at 33
    limbs, where each plain power takes seconds), K7 on as many with one
    in 7 planted to open to 0 (bits, flags, count; bits in {0, 1} and
    signed at 2^6), K9's three ops with arrays and a constant (the
    product also with a below R, a draw's chunk)."""
    from mpyc_tpu_torch import finfields
    st, _ = state
    ctx = prime_field_ctx(p)
    n_pow = 130 if ctx.L < 33 else 20   # the plain powers of 1,030 bits
    if kernel.startswith('K3'):
        fuse = kernel == 'K3 fused'
        spec = pipelines.ReshareSpec(p, 1, 3)
        assert spec.l_bytes == 4 * (ctx.L + 2)
        for n in (7, 300):
            a, b = _shares(n, 80, p), _shares(n, 81, p) if fuse else None
            nonce = (0xFFFFFFFF, 9)
            assert torch.equal(
                _wide_reshare(host_lib, st, spec, a, b, nonce),
                pipelines._reshare_mul_plain(a, b, st, nonce, spec))
    elif kernel == 'K6':
        _, x = _pow_inputs(p, n_pow, 82)
        for e in (p - 2, (p - 1) // 2, 0):
            assert torch.equal(_wide_pow(host_lib, x, e, ctx),
                               fieldops._mont_pow_plain(x, e, ctx))
    elif kernel == 'K7':
        field = finfields.GF(p)
        r, z = _tail_shares(p, n_pow, 83)
        for signed, f in ((False, 0), (True, 6)):
            bits, flags, count = _wide_tail(host_lib, r, z, field, signed, f)
            want = pipelines._random_bits_tail_plain(r, z, field, signed, f)
            assert torch.equal(flags, want[1]) and torch.equal(bits, want[0])
            assert count.item() == want[2].item() == -(-n_pow // 7)
    else:
        consts = fieldops.wide_field_consts(ctx, 'cpu')
        a, b = _shares(300, 84, p)[0].contiguous(), _shares(300, 85, p)[0]
        c = _shares(1, 86, p)[0].contiguous()
        wide = torch.from_numpy(np.random.default_rng(87).integers(
            0, 1 << 32, (300, ctx.L), dtype=np.uint64).astype(
            np.uint32).view(np.int32))
        for op in fieldops._FIELD_OPS:
            cases = [(a, b.contiguous(), 1, 1), (a, c, 1, 0), (c, a, 0, 1)]
            if op == 'mul':
                cases.append((wide, c, 1, 0))
            for x, y, sx, sy in cases:
                out = torch.empty((300, ctx.L), dtype=torch.int32)
                assert host_lib.mtt_field_op_wide(
                    x.data_ptr(), y.data_ptr(), out.data_ptr(), 300, sx, sy,
                    fieldops._FIELD_OPS.index(op), consts.data_ptr(),
                    ctx.n0inv, ctx.L, None) == 0
                assert torch.equal(out,
                                   fieldops._field_op_plain(x, y, op, ctx))


def test_wide_plain_product_matches_python_ints():
    """From seven limbs on the plain Montgomery product takes whole-vector
    operations on 16-bit digits (``limb._mont_mul_vec``): its values are
    a b R^-1 mod p exactly, on random operands, on a below R, and on a
    Mersenne prime, whose digits are all ones."""
    from mpyc_tpu_torch.ops import limb
    g = np.random.default_rng(88)
    for p in WIDE + [(1 << 521) - 1]:
        ctx = prime_field_ctx(p)
        L, R = ctx.L, 1 << 32 * ctx.L
        xs = [int.from_bytes(g.bytes(4 * L), 'little') % p for _ in range(40)]
        ys = [int.from_bytes(g.bytes(4 * L), 'little') % p for _ in range(40)]
        xs += [0, p - 1, R - 1, p - 1]
        ys += [p - 1, p - 1, p - 1, 1]
        a = [torch.tensor([x >> 32 * i & limb.M32 for x in xs])
             for i in range(L)]
        b = [torch.tensor([y >> 32 * i & limb.M32 for y in ys])
             for i in range(L)]
        got = limb.limbs_to_ints(limb.stack(limb.mont_mul(
            a, b, ctx.p_limbs, ctx.n0inv)).numpy().view(np.uint32))
        r_inv = pow(R, -1, p)
        assert list(got) == [x * y * r_inv % p for x, y in zip(xs, ys)]


# a prime of each limb count the group arithmetic is checked at: the ends
# of each group size (8 lanes to 8 limbs, 16 to 16, 32 above, two words a
# lane from 33 limbs), a group with lanes past L (9, 12), kb2's 19 and
# student-mat's 42
GROUP_LIMBS = (7, 8, 9, 12, 16, 19, 32, 33, 42, 48)


def _group_prime(L: int) -> int:
    from mpyc_tpu_torch import gmpy
    return int(gmpy.next_prime((1 << 32 * L - 1) + (1 << 32 * L - 3)))


def _group_operands(L: int, p: int):
    """Operand pairs that the carries and borrows of the group's
    arithmetic show on: random ones, 0, 1, p - 1, the all-ones limbs of
    R - 1 (as a, below R), and values of all-ones limbs below p."""
    g = np.random.default_rng(L)
    R = 1 << 32 * L
    rnd = [int.from_bytes(g.bytes(4 * L), 'little') % p for _ in range(24)]
    ones = [(1 << 32 * k) - 1 for k in range(1, L)]     # all-ones limbs < p
    edge = [0, 1, p - 1, p - 2, (p - 1) // 2] + ones[-3:]
    pairs = [(x, y) for x in edge for y in edge]
    pairs += list(zip(rnd[:12], rnd[12:])) + [(y, x) for x, y in pairs[:8]]
    wide = [(R - 1, p - 1), (R - 1, 1), (R - 1, R % p), (R - 2, p - 1)]
    return pairs, wide


@pytest.mark.parametrize('L', GROUP_LIMBS)
def test_wide_group_arithmetic_matches_python_ints(host_lib, L):
    """The group arithmetic of the wide K5 and K6 (csrc/wide.cuh WGroup:
    8, 16 or 32 lanes, one or two words a lane) against Python ints: the
    Montgomery product a b R^-1 mod p (also with a below R: all-ones
    limbs), the add and the subtraction mod p, and (a - b) (a + b) R^-1
    (results in registers the operands of a product: a value's words past
    L stay 0), on operands with all-ones limbs, p - 1, 0 and random ones,
    at each limb count of GROUP_LIMBS; a group a product, many in a
    block."""
    p = _group_prime(L)
    ctx = prime_field_ctx(p)
    assert ctx.L == L and (p >> 32 * (L - 1)) >> 31 == 1
    R = 1 << 32 * L
    pairs, wide = _group_operands(L, p)
    consts = fieldops.wide_field_consts(ctx, 'cpu')

    def enc(vals):
        w = np.array([[v >> 32 * i & 0xFFFFFFFF for i in range(L)]
                      for v in vals], dtype=np.uint64).astype(np.uint32)
        return torch.from_numpy(w.view(np.int32))
    r_inv = pow(R, -1, p)
    ops = {'mul': lambda x, y: x * y * r_inv % p,
           'add': lambda x, y: (x + y) % p, 'sub': lambda x, y: (x - y) % p,
           'chain': lambda x, y: (x - y) * (x + y) * r_inv % p}
    for k, (op, fn) in enumerate(ops.items()):
        cases = pairs + wide if op == 'mul' else pairs
        a, b = enc([x for x, _ in cases]), enc([y for _, y in cases])
        out = torch.empty_like(a)
        assert host_lib.mtt_group_op_wide(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), len(cases), k,
            consts.data_ptr(), ctx.n0inv, L, None) == 0
        got = [int(v) for v in limb.limbs_to_ints(out.numpy().view(
            np.uint32))]
        assert got == [fn(x, y) for x, y in cases], op


@pytest.mark.parametrize('p', [P200, P1030], ids=['L7', 'L33'])
def test_wide_pow_products_match_the_plan(host_lib, p):
    """The wide K6 runs its exponent's plan (fieldops.plan_products
    products an element, the bound's count) at e = p - 2."""
    ctx, x = _pow_inputs(p, 128, 89)
    counts = _op_counts(host_lib)
    counts[0] = counts[1] = 0
    _wide_pow(host_lib, x, p - 2, ctx)
    assert tuple(counts) == (128 * fieldops.plan_products(p - 2), 0)


def test_wide_reshare_field_ops_match_the_source(host_lib, state):
    """The wide K3's products and modular adds an element, as
    chip_smoke.py's ``reshare_meas`` prices them: its draw's two chunks
    reduced (two products, one add), the three local products when fused,
    three by the Lagrange coefficients and their two adds, and each of
    the three parties' product by its point and add."""
    st, _ = state
    spec = pipelines.ReshareSpec(P367, 1, 3)
    counts = _op_counts(host_lib)
    for fuse in (True, False):
        a = _shares(128, 90, P367)
        b = _shares(128, 91, P367) if fuse else None
        counts[0] = counts[1] = 0
        _wide_reshare(host_lib, st, spec, a, b, (3, 0))
        n_prod = 2 + spec.n_send * (2 if fuse else 1) + 3
        assert tuple(counts) == (128 * n_prod, 128 * (1 + spec.n_send - 1
                                                      + 3))


def test_wide_launchers_refuse_what_was_not_built(host_lib, state):
    """The wide launchers take 7 to 48 limbs; fewer take the narrow
    kernels, more raise NotImplementedError on the Python side. K3, K5 and
    K7 take every (t, m) of ``_build.check_parties`` and refuse the rest,
    on both sides; K5 also a workspace smaller than a CTA's, or none,
    where the vectors do not fit in shared memory."""
    st, _ = state
    ctx = prime_field_ctx(P200)
    a = _shares(10, 92, P200)
    consts = fieldops.wide_field_consts(ctx, 'cpu')
    for L in (6, 49):
        assert host_lib.mtt_field_op_wide(
            a.data_ptr(), a.data_ptr(), a.data_ptr(), 10, 1, 1, 0,
            consts.data_ptr(), ctx.n0inv, L, None) == -1
        assert host_lib.mtt_reshare_wide(
            a.data_ptr(), None, a.data_ptr(), st.data_ptr(), 10, 0,
            consts.data_ptr(), ctx.n0inv, L, 0, 0, 1, 3, None) == -1
    for t, m in ((0, 3), (5, 11), (2, 4), (1, 17)):
        assert host_lib.mtt_reshare_wide(
            a.data_ptr(), None, a.data_ptr(), st.data_ptr(), 10, 0,
            consts.data_ptr(), ctx.n0inv, 7, 0, 0, t, m, None) == -1
    params, _ = _build.wide_pow(ctx, 5)
    params.nl = 49
    assert host_lib.mtt_mont_pow_wide(a.data_ptr(), a.data_ptr(), 10,
                                      consts.data_ptr(),
                                      ctypes.addressof(params), None) == -1
    from mpyc_tpu_torch import gmpy
    big = gmpy.next_prime(1 << 32 * 48)
    with pytest.raises(NotImplementedError, match='limbs'):
        _build.wide_pow(prime_field_ctx(big), 5)
    with pytest.raises(NotImplementedError, match='limbs'):
        pipelines.ReshareSpec(big, 1, 3).wide_consts('cpu')
    with pytest.raises(NotImplementedError, match='limbs'):
        pipelines.SgnSpec(P367, 1, 3, 335, LT=True).params((0, 0))
    # past 48 limbs K5 raises too, naming the wide kernel's range
    with pytest.raises(NotImplementedError, match='7 to 48 limbs'):
        pipelines.SgnSpec(big, 1, 3, 64, LT=True).wide_params((0, 0))
    # the wide K3 and K7 at (t, m) other than (1, 3); beyond t = 4 or m =
    # 16 they raise
    from mpyc_tpu_torch import finfields
    pipelines.ReshareSpec(P200, 2, 5).wide_consts('cpu')
    pipelines._wide_tail_params(finfields.GF(P200), 4, 16, False, 0, 'cpu')
    with pytest.raises(NotImplementedError, match='t <= 4'):
        pipelines.ReshareSpec(P200, 5, 11).wide_consts('cpu')
    with pytest.raises(NotImplementedError, match='m <= 16'):
        pipelines._wide_tail_params(finfields.GF(P200), 1, 17, False, 0,
                                    'cpu')
    with pytest.raises(NotImplementedError, match='t <= 4'):
        pipelines.SgnSpec(P200, 5, 11, 64, LT=True).wide_params((0, 0))
    params, consts = pipelines._wide_tail_params(finfields.GF(P200), 1, 3,
                                                 False, 0, 'cpu')
    params.m = 2
    assert host_lib.mtt_random_bits_tail_wide(
        a.data_ptr(), a.data_ptr(), a.data_ptr(), a.data_ptr(),
        a.data_ptr(), 10, consts.data_ptr(), ctypes.addressof(params),
        None) == -1
    # K5: the limbs, (t, m), k, l; a workspace smaller than a CTA's, or
    # none, where the vectors do not fit in shared memory
    spec = pipelines.SgnSpec(P200, 1, 3, 64, LT=True)
    wconsts = spec.wide_consts('cpu')
    for field, v in (('nl', 6), ('nl', 49), ('t', 5), ('m', 2), ('k', 65),
                     ('l', 0)):
        params = spec.wide_params((0, 0))
        setattr(params, field, v)
        assert host_lib.mtt_sgn_wide(
            a.data_ptr(), a.data_ptr(), st.data_ptr(), 10, 10, 10,
            wconsts.data_ptr(), None, 1, ctypes.addressof(params),
            None) == -1, field
    spec = pipelines.SgnSpec(P1314, 1, 3, 197)
    a42 = _shares(10, 92, P1314)
    wconsts = spec.wide_consts('cpu')
    ws = torch.empty(spec.wide_params((0, 0)).ws_stride, dtype=torch.int32)
    assert ws.numel() == 49770
    for short, buf in ((1, ws), (0, None)):
        params = spec.wide_params((0, 0))
        params.ws_stride -= short
        assert host_lib.mtt_sgn_wide(
            a42.data_ptr(), a42.data_ptr(), st.data_ptr(), 10, 10, 10,
            wconsts.data_ptr(), buf if buf is None else buf.data_ptr(), 1,
            ctypes.addressof(params), None) == -1


# -- parties other than three: 1 <= t <= 4, 2t + 1 <= m <= 16 -----------------

def _parties_shares(n, seed, p, m):
    """(m, n) canonical field elements (< p) as stored limbs."""
    g = np.random.default_rng(seed)
    L = prime_field_ctx(p).L
    words = g.integers(0, 1 << 32, (m, n, L), dtype=np.uint64)
    words[..., -1] = g.integers(0, p >> 32 * (L - 1), (m, n))
    return torch.from_numpy(words.astype(np.uint32).view(np.int32))


# (1, 4) and (3, 9) have parties past the 2t + 1 senders, (2, 5) and (4, 9)
# none; (1, 3) is the instantiation of its own
PARTIES = [(1, 4), (2, 5), (3, 9), (4, 9)]


@pytest.mark.parametrize('fuse', [True, False])
@pytest.mark.parametrize('t,m', PARTIES)
def test_reshare_source_matches_plain_at_parties(host_lib, state, t, m,
                                                 fuse):
    """K3 at a run-time (t, m): 6,407 elements span three thread blocks of
    3,200, the last ragged."""
    st, _ = state
    spec = pipelines.ReshareSpec(P, t, m)
    n = 6407
    a, b = _parties_shares(n, 61, P, m), _parties_shares(n, 62, P, m)
    nonce = (0xFFFFFFFF, 9)
    params = spec.params(nonce)
    out = torch.empty_like(a)
    assert host_lib.mtt_reshare(a.data_ptr(), b.data_ptr() if fuse else None,
                                out.data_ptr(), st.data_ptr(), n, int(fuse),
                                ctypes.addressof(params), None) == 0
    want = pipelines._reshare_mul_plain(a, b if fuse else None, st, nonce,
                                        spec)
    assert torch.equal(out, want)


def test_reshare_source_takes_fewer_elements_a_block_at_six_limbs(
        host_lib, state):
    """At t = 4 on six limbs the coefficients of 3,200 elements would pass
    a CTA's shared memory: a block takes 2,240, so 2,300 elements span two
    blocks."""
    st, _ = state
    spec = pipelines.ReshareSpec(P176, 4, 9)
    n = 2300
    a, b = _parties_shares(n, 63, P176, 9), _parties_shares(n, 64, P176, 9)
    params = spec.params((5, 0))
    out = torch.empty_like(a)
    assert host_lib.mtt_reshare(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                                st.data_ptr(), n, 1,
                                ctypes.addressof(params), None) == 0
    assert torch.equal(out, pipelines._reshare_mul_plain(a, b, st, (5, 0),
                                                         spec))


@pytest.mark.parametrize('t,m', [(1, 3), (2, 5), (3, 9)])
@pytest.mark.parametrize('fuse', [True, False])
def test_reshare_field_ops_match_the_source(host_lib, state, t, m, fuse):
    """ReshareSpec.field_ops, from which chip_smoke.py bounds K3, counts
    the source's products and adds (whole thread blocks: 3,200 elements)."""
    st, _ = state
    spec = pipelines.ReshareSpec(P, t, m)
    n = 3200
    a, b = _parties_shares(n, 65, P, m), _parties_shares(n, 66, P, m)
    params = spec.params((7, 0))
    out = torch.empty_like(a)
    counts = _op_counts(host_lib)
    counts[0] = counts[1] = 0
    assert host_lib.mtt_reshare(a.data_ptr(), b.data_ptr() if fuse else None,
                                out.data_ptr(), st.data_ptr(), n, int(fuse),
                                ctypes.addressof(params), None) == 0
    mont, adds = spec.field_ops(fuse)
    assert tuple(counts) == (n * (mont + t * DRAW_OPS[0]),
                             n * (adds + t * DRAW_OPS[1]))


@pytest.mark.parametrize('t,m', PARTIES)
def test_split_recombine_source_matches_plain_at_parties(host_lib, state,
                                                         t, m):
    st, _ = state
    spec = pipelines.SplitSpec(P, t, m)
    n = 1003
    sec = _parties_shares(n, 67, P, 1)[0].contiguous()
    out = torch.empty_like(sec)
    shares = torch.empty((m, n, 2), dtype=torch.int32)
    params = spec.params()
    assert host_lib.mtt_split_recombine(
        sec.data_ptr(), out.data_ptr(), shares.data_ptr(), st.data_ptr(), n,
        ctypes.addressof(params), None) == 0
    want, want_shares = pipelines._split_recombine_plain(sec, st, spec)
    assert torch.equal(out, want) and torch.equal(out, sec)
    assert torch.equal(shares, want_shares)


@pytest.mark.parametrize('t,m', [(2, 5), (4, 9)])
def test_split_field_ops_match_the_source_at_parties(host_lib, state, t, m):
    st, _ = state
    spec = pipelines.SplitSpec(P, t, m)
    n = 1000
    sec = _parties_shares(n, 68, P, 1)[0].contiguous()
    out = torch.empty_like(sec)
    counts = _op_counts(host_lib)
    counts[0] = counts[1] = 0
    params = spec.params()         # alive across the call
    assert host_lib.mtt_split_recombine(
        sec.data_ptr(), out.data_ptr(), None, st.data_ptr(), n,
        ctypes.addressof(params), None) == 0
    mont, adds = spec.field_ops()
    assert tuple(counts) == (n * (mont + t * DRAW_OPS[0]),
                             n * (adds + t * DRAW_OPS[1]))


@pytest.mark.parametrize('mode', pipelines.SGN_MODES)
@pytest.mark.parametrize('t,m', PARTIES)
def test_sgn_source_matches_plain_at_parties(host_lib, state, t, m, mode):
    """K5 at l = 32 (k = 30) on two thread blocks, the last ragged, the
    instantiation of its t; the parties past the senders from their own
    shares (LT) or the last reshare (sgn, EQ)."""
    st, _ = state
    spec = pipelines.SgnSpec(P, t, m, 32, 30, LT=mode == 'LT',
                             EQ=mode == 'EQ')
    n = 300
    a = _parties_shares(n, 69, P, m)
    nonce = (0xFFFFFFFF, 4)
    out = torch.empty_like(a)
    params = spec.params(nonce)
    assert host_lib.mtt_sgn(a.data_ptr(), out.data_ptr(), st.data_ptr(), n,
                            n, n, ctypes.addressof(params), None) == 0
    assert torch.equal(out, pipelines._sgn_step_plain(a, st, nonce, spec))


@pytest.mark.parametrize('mode', pipelines.SGN_MODES)
@pytest.mark.parametrize('t,m', [(1, 4), (2, 7)])
def test_sgn_source_matches_plain_at_one_bit(host_lib, state, t, m, mode):
    """At l = 1 the xor tree has one leaf and no reshare: in EQ mode the
    parties past the senders take their output from their own bit
    shares."""
    st, _ = state
    spec = pipelines.SgnSpec(P46, t, m, 1, 30, LT=mode == 'LT',
                             EQ=mode == 'EQ')
    n = 100
    a = _parties_shares(n, 70, P46, m)
    out = torch.empty_like(a)
    params = spec.params((3, 0))
    assert host_lib.mtt_sgn(a.data_ptr(), out.data_ptr(), st.data_ptr(), n,
                            n, n, ctypes.addressof(params), None) == 0
    assert torch.equal(out, pipelines._sgn_step_plain(a, st, (3, 0), spec))


@pytest.mark.parametrize('p,l,f,t,m', [(P52, 14, 6, 2, 5), (P69, 37, 0, 2, 5),
                                       (P176, 74, 0, 4, 9),
                                       (P176, 96, 48, 2, 7)])
def test_sgn_source_matches_plain_at_parties_and_limbs(host_lib, state, p, l,
                                                       f, t, m):
    """K5 (LT) at (t, m) on the fixed-point CNN's field with its scale,
    at three limbs, and at six limbs: the widest l at t = 4 there (lb =
    75), and kb2's SecFxp(96, 48) at t = 2."""
    st, _ = state
    spec = pipelines.SgnSpec(p, t, m, l, 30, LT=True, f=f)
    n = 70
    a = _parties_shares(n, 71, p, m)
    out = torch.empty_like(a)
    params = spec.params((9, 0))
    assert host_lib.mtt_sgn(a.data_ptr(), out.data_ptr(), st.data_ptr(), n,
                            n, n, ctypes.addressof(params), None) == 0
    assert torch.equal(out, pipelines._sgn_step_plain(a, st, (9, 0), spec))


def test_sgn_source_takes_many_chunks_at_parties(host_lib, state):
    """One launch of K5 on chunks at (2, 5), against the plain version
    chunk by chunk (``sgn_chunks`` on the CPU)."""
    st, _ = state
    spec = pipelines.SgnSpec(P69, 2, 5, 23, 30, LT=True)
    n, chunk = 300, 256
    a = _parties_shares(n, 72, P69, 5)
    ctr = (0xFFFFFFFE, 7)
    out = torch.empty_like(a)
    params = spec.params(ctr)      # alive across the call
    assert host_lib.mtt_sgn(a.data_ptr(), out.data_ptr(), st.data_ptr(), n,
                            chunk, pipelines.bucket(n - chunk, chunk),
                            ctypes.addressof(params), None) == 0
    want, _ = pipelines.sgn_chunks(a, st, ctr, spec, chunk)
    assert torch.equal(out, want)


@pytest.mark.parametrize('mode,l,t,m', [('sgn', 32, 2, 5), ('LT', 32, 1, 4),
                                        ('EQ', 32, 3, 9), ('LT', 14, 3, 9),
                                        ('EQ', 1, 2, 7), ('sgn', 10, 4, 9)])
def test_sgn_field_ops_match_the_source_at_parties(host_lib, state, mode, l,
                                                   t, m):
    """SgnSpec.field_ops counts the source's products and adds at (t, m),
    the parties past the senders included."""
    _check_sgn_field_ops(host_lib, state, mode, 0, l, P, t, m)


def test_sgn_refuses_bits_past_their_draws(host_lib, state):
    """At t > 1 the bit call's t lb draws an element bound lb: kb2's
    SecFxp(96, 48) (lb = 97, six limbs) runs at t = 2 but not at t = 4
    (lb <= 75), raising NotImplementedError on the Python side; the
    launcher refuses it too."""
    st, _ = state
    assert [_build.sgn_lb_fit(t, 6) for t in (1, 2, 3, 4)] == \
        [191, 150, 100, 75]
    assert [_build.sgn_lb_fit(4, L) for L in (2, 3, 4, 5)] == \
        [63, 95, 112, 90]
    spec = pipelines.SgnSpec(P176, 4, 9, 96, 30, LT=True, f=48)
    with pytest.raises(NotImplementedError, match='at most 75 random bits'):
        spec.params((0, 0))
    params = pipelines.SgnSpec(P176, 2, 7, 96, 30, LT=True,
                               f=48).params((0, 0))
    assert host_lib.mtt_sgn_threads(ctypes.addressof(params)) == 32
    params.t, params.m = 4, 9
    a = _parties_shares(10, 73, P176, 9)
    assert host_lib.mtt_sgn_threads(ctypes.addressof(params)) == -1
    assert host_lib.mtt_sgn(a.data_ptr(), a.data_ptr(), st.data_ptr(), 10,
                            10, 10, ctypes.addressof(params), None) == -1


@pytest.mark.parametrize('signed,f', [(False, 6), (True, 0)])
@pytest.mark.parametrize('t,m', PARTIES)
def test_random_bits_tail_source_matches_plain_at_parties(host_lib, t, m,
                                                          signed, f):
    """K7 on (m, n) shares: the opening at 2t from 2t + 1 senders, the
    bits of all m parties (past the third read again after the power)."""
    from mpyc_tpu_torch import finfields
    field = finfields.GF(P52)
    n = 300
    r, z = _tail_shares(P52, n, 74, m=m)
    bits, flags, count = _tail_launch(host_lib, r, z, field, signed, f, t)
    want = pipelines._random_bits_tail_plain(r, z, field, signed, f, t)
    assert torch.equal(flags, want[1])
    assert count.item() == want[2].item() == -(-n // 7)
    assert torch.equal(bits, want[0])


@pytest.mark.parametrize('t,m', [(2, 5), (3, 9)])
def test_random_bits_tail_field_ops_match_the_source_at_parties(host_lib, t,
                                                                m):
    from mpyc_tpu_torch import finfields
    field = finfields.GF(P52)
    r, z = _tail_shares(P52, 256, 75, m=m)
    counts = _op_counts(host_lib)
    counts[0] = counts[1] = 0
    _tail_launch(host_lib, r, z, field, False, 6, t)
    mont, adds = pipelines.random_bits_tail_ops(P52, False, 6, t, m)
    assert tuple(counts) == (256 * mont, 256 * adds)
    assert (mont, adds) == (2 * (2 * t + 1) + 68 + 1 + m, 4 * t + 1 + m)


# -- the wide K5: comparisons at 7 to 48 limbs (csrc/sgn_wide.cu) -------------

def _wide_sgn(host_lib, st, spec, a, nonce, chunk=None, n_last=None,
              grid=None):
    """The wide K5's host launch on (m, n, L) shares a, in chunks of
    ``chunk`` (one call by default), on ``grid`` CTAs (the launcher's
    default: one an element)."""
    n = a.shape[1]
    params = spec.wide_params(nonce)
    grid = grid or _build.sgn_wide_grid(n, params.ws_stride)
    ws = torch.zeros(grid * params.ws_stride, dtype=torch.int32)
    out = torch.empty_like(a)
    consts = spec.wide_consts('cpu')
    assert host_lib.mtt_sgn_wide(
        a.data_ptr(), out.data_ptr(), st.data_ptr(), n, chunk or n,
        n_last or n, consts.data_ptr(), ws.data_ptr(), grid,
        ctypes.addressof(params), None) == 0
    return out


def _wide_sgn_ops(spec, vals, st, nonce):
    """The products and adds the wide K5 runs on one call of the l-bit
    values vals: ``SgnSpec.field_ops`` with its groups, each element at the
    ones of its c mod 2^l = (v + r mod 2^l) mod 2^l (r's bits the first
    of its stream-A words), and two products and an add a draw."""
    n, l = len(vals), spec.l
    words = keccak._keccak_ctr_plain(pipelines._nonce_state(st, nonce),
                                     spec.blocks_a(n), 19)
    words = (words.to(torch.int64) & 0xFFFFFFFF).reshape(-1)
    groups = _build.sgn_wide_groups(spec.ctx.L)
    mont = adds = 0
    for e, v in enumerate(vals):
        w = words[e * spec.wpe:e * spec.wpe + spec.wb].tolist()
        r = sum(int(x) << 32 * q for q, x in enumerate(w)) % (1 << l)
        ones = bin((v + r) % (1 << l)).count('1')
        mo, ad = spec.field_ops(ones, groups)
        mont += mo + 2 * spec.draws_per_element()
        adds += ad + spec.draws_per_element()
    return mont, adds


# (p, l, t, m): seven limbs at (1, 3), at (2, 5) and with a party past the
# senders (1, 4); twelve limbs; 42, whose draws own two sponge blocks each
WIDE_SGN = [(P200, 40, 1, 3), (P200, 24, 2, 5), (P200, 20, 1, 4),
            (P200, 1, 1, 4), (P200, 12, 4, 9), (P367, 48, 1, 3),
            (P1314, 12, 1, 3)]
WIDE_SGN_IDS = ['L7', 'L7-t2m5', 'L7-t1m4', 'L7-l1-t1m4', 'L7-t4m9', 'L12',
                'L42']


@pytest.mark.parametrize('case', WIDE_SGN, ids=WIDE_SGN_IDS)
@pytest.mark.parametrize('mode', pipelines.SGN_MODES)
def test_wide_sgn_source_matches_plain(host_lib, state, mode, case):
    """The wide K5 equals its plain version bit for bit on degree-t shares
    of l-bit values (the range ends, 0, +-1 and random ones), and its
    opened outputs are the comparisons of the values: one call on six to
    eight elements, two CTAs taking them in turn (the persistent grid), the
    counter's high word set; the parties past the senders at (1, 4), also
    at l = 1 (EQ: their xor bit). The source's products and adds (counted
    once a group's operation) are ``SgnSpec.field_ops`` with its groups at
    each element's ones of c mod 2^l, and two products and an add a
    draw."""
    p, l, t, m = case
    st, _ = state
    g = np.random.default_rng(l + t + m)
    lim = 1 << l - 1
    vals = [v for v in [0, 1, -1, -lim, lim - 1] if -lim <= v < lim] + [
        int(v) for v in g.integers(-lim, lim, 3)]
    a = _value_shares(vals, p, t, m, seed=len(vals) + l)
    spec = pipelines.SgnSpec(p, t, m, l, LT=mode == 'LT', EQ=mode == 'EQ')
    nonce = (0xFFFFFFFE, 5)
    counts = _op_counts(host_lib)
    counts[0] = counts[1] = 0
    got = _wide_sgn(host_lib, st, spec, a, nonce, grid=2)
    assert torch.equal(got, pipelines._sgn_step_plain(a, st, nonce, spec))
    assert _open(got, p, t) == [_compare(mode, v) for v in vals]
    assert tuple(counts) == _wide_sgn_ops(spec, vals, st, nonce)


@pytest.mark.parametrize('mode', pipelines.SGN_MODES)
def test_wide_sgn_source_matches_plain_in_both_placements(host_lib, state,
                                                          mode):
    """At 42 limbs and l = 197 an element's vectors fill a CTA's shared
    memory in EQ mode to within 336 of its 232,448 bytes (E and X), fit in
    LT mode (E alone), and in sgn mode (E and X, one bit share more) go to
    the device workspace: the wide K5 equals its plain version bit for bit
    in each placement, on three values, two CTAs."""
    p, l = P1314, 197
    st, _ = state
    spec = pipelines.SgnSpec(p, 1, 3, l, LT=mode == 'LT', EQ=mode == 'EQ')
    smem, ws = _build.sgn_wide_layout(1, 3, 42, l,
                                      pipelines.SGN_MODES.index(mode))
    assert (smem, ws) == {'sgn': (33536, 49770), 'LT': (133328, 0),
                          'EQ': (232112, 0)}[mode]
    assert spec.wide_params((0, 0)).ws_stride == ws
    vals = [0, -1, 1 << 150]
    a = _value_shares(vals, p, 1, 3, seed=96)
    nonce = (7, 0)
    got = _wide_sgn(host_lib, st, spec, a, nonce, grid=2)
    assert torch.equal(got, pipelines._sgn_step_plain(a, st, nonce, spec))
    assert _open(got, p, 1) == [_compare(mode, v) for v in vals]


@pytest.mark.parametrize('mode', pipelines.SGN_MODES)
def test_wide_sgn_source_takes_many_chunks_in_one_launch(host_lib, state,
                                                          mode):
    """One launch of the wide K5 on 11 elements in chunks of 4 (the last
    call on its bucket of 4 of which 3 are given; each chunk its own
    counter, carried into the high word) equals the plain version chunk by
    chunk (``_sgn_chunks_plain``, as ``sgn_chunks`` cuts them), with a
    grid of 3 CTAs."""
    st, _ = state
    spec = pipelines.SgnSpec(P200, 1, 3, 33, LT=mode == 'LT',
                             EQ=mode == 'EQ', f=5)
    a = _shares(11, 95, P200)
    ctr = np.array([0xFFFFFFFF, 2], np.uint32)
    got = _wide_sgn(host_lib, st, spec, a, (int(ctr[0]), int(ctr[1])),
                    chunk=4, n_last=pipelines.bucket(3, 4), grid=3)
    want, ctr_p = pipelines._sgn_chunks_plain(a, st, ctr, spec, 4)
    assert torch.equal(got, want) and list(ctr_p) == [2, 3]


def test_wide_sgn_sizes(host_lib):
    """The wide K5's vectors, shared memory and workspace: an element's
    vectors are (lb + l [not LT]) (2t + 1) L words (lb = l + 1, l in EQ
    mode), so kb2's LT comparison at t = 1 takes 561 x 3 x 19 words (125
    KiB) and one at 48 limbs in sgn mode 3,009 x 3 x 48; they live in
    shared memory where they fit beside the rest within a CTA's 232,448
    bytes (kb2's LT: no workspace), else in a workspace of that many words
    a CTA (kb2's field in sgn mode, SecInt(1504)), the same in ``_build``
    as in the source (``mtt_sgn_wide_smem``, ``mtt_sgn_wide_ws``) at every
    (t, m), L, l and mode here; a launch's workspace stays within
    SGN_WIDE_WS_BYTES, its grid within SGN_WIDE_GRID."""
    assert _build.sgn_wide_vec_words(1, 19, 560, 1) == 561 * 3 * 19
    assert _build.sgn_wide_vec_words(1, 19, 560, 1) * 4 == 127908
    assert _build.sgn_wide_vec_words(1, 48, 1504, 0) == 3009 * 3 * 48
    assert _build.sgn_wide_vec_words(4, 7, 64, 2) == 128 * 9 * 7
    assert _build.sgn_wide_layout(1, 3, 19, 560, 1)[1] == 0
    assert _build.sgn_wide_layout(1, 3, 19, 560, 0)[1] == 1121 * 3 * 19
    assert _build.sgn_wide_layout(1, 3, 48, 1504, 0)[1] == 3009 * 3 * 48
    for t, m, L, l, mode in ((1, 3, 19, 560, 1), (4, 9, 48, 1504, 0),
                             (2, 5, 7, 8, 2), (1, 3, 19, 560, 0)):
        w = _build.sgn_wide_layout(t, m, L, l, mode)[1]
        grid = _build.sgn_wide_grid(1 << 20, w)
        assert 1 <= grid <= _build.SGN_WIDE_GRID
        assert grid * w * 4 <= _build.SGN_WIDE_WS_BYTES
    assert _build.sgn_wide_grid(70, 0) == 70
    assert _build.sgn_wide_grid(70, 561 * 3 * 19) == 70
    for t in range(1, 5):
        for m in (2 * t + 1, 16):
            for L in (7, 19, 48):
                for l, mode in ((560, 1), (31, 0), (64, 2)):
                    if l + 1 > 32 * L - 1:
                        continue
                    smem, ws = _build.sgn_wide_layout(t, m, L, l, mode)
                    assert 0 < smem <= 232448
                    assert host_lib.mtt_sgn_wide_smem(t, m, L, l, mode) == \
                        smem
                    assert host_lib.mtt_sgn_wide_ws(t, m, L, l, mode) == ws
                    assert ws == 0 or smem + 4 * _build.sgn_wide_vec_words(
                        t, L, l, mode) > 232448


def test_wide_sgn_routes_by_limbs(monkeypatch):
    """K5's launch takes the wide kernel (``mtt_sgn_wide``; its workspace
    of grid x ws_stride words where the vectors do not fit in shared
    memory, else none) at 7 to 48 limbs and the narrow one
    (``mtt_sgn``) at two to six (with the CTA route of small calls off:
    ``test_torch_small_calls_host.py`` holds it); at 49 limbs, and at t >
    4 or m > 16, both parameter blocks raise NotImplementedError naming
    their limits."""
    from mpyc_tpu_torch import gmpy, sectypes
    calls = []
    monkeypatch.setattr(_build, 'call', lambda name, *a: calls.append(
        (name, a)))
    monkeypatch.setattr(_build, 'SGN_CTA_MAX',
                        dict.fromkeys(_build.SGN_CTA_NL, 0))
    monkeypatch.setattr(_build, 'stream_of', lambda device: 0)
    st = keccak.state_tensor(keccak._absorb_host(bytes(40)), 'cpu')
    p48 = sectypes.SecInt(1504, 'cpu').field.modulus
    for p, wide in ((P176, False), (P200, True), (P367, True),
                    (p48, True)):
        L = prime_field_ctx(p).L
        spec = pipelines.SgnSpec(p, 1, 3, 40, LT=True)
        a = _shares(5, 1, p)
        pipelines._launch_sgn(a, st, (0, 0), spec, 5, 5)
        name, args = calls.pop()
        assert name == ('mtt_sgn_wide' if wide else 'mtt_sgn')
        assert _build.wide(L) == wide
        if wide:
            params = spec.wide_params((0, 0))
            assert args[8] == 5 == _build.sgn_wide_grid(5, params.ws_stride)
            assert params.ws_stride == _build.sgn_wide_layout(
                1, 3, L, 40, 1)[1] == 0
            assert args[7] is None    # the vectors in shared memory
            with pytest.raises(NotImplementedError, match='limbs'):
                spec.params((0, 0))
        else:
            with pytest.raises(NotImplementedError, match='7 to 48 limbs'):
                spec.wide_params((0, 0))
    assert prime_field_ctx(p48).L == 48
    p49 = gmpy.next_prime(1 << 32 * 48)
    spec = pipelines.SgnSpec(p49, 1, 3, 40, LT=True)
    for make in (spec.params, spec.wide_params):
        with pytest.raises(NotImplementedError, match='48'):
            make((0, 0))
    for t, m in ((5, 11), (1, 17)):
        spec = pipelines.SgnSpec(P200, t, m, 40, LT=True)
        with pytest.raises(NotImplementedError, match='t <= 4'):
            spec.wide_params((0, 0))


def _mont_values(words, L):
    """Montgomery-form values of a buffer's L-word constants."""
    w = words.numpy().view(np.uint32).reshape(-1, L)
    return [sum(int(v) << 32 * q for q, v in enumerate(row)) for row in w]


@pytest.mark.parametrize('t,m', [(1, 3), (2, 5), (4, 9), (1, 4)])
def test_wide_constants_layout(t, m):
    """The wide kernels' device buffers, in their order (csrc/
    sgn_wide.cu SGN_WIDE_CONSTS, csrc/wide.cu wide_reshare_consts,
    wide_tail_consts): K5's p, radix_0, radix_1 2^64 R^-1 (a draw's top
    two words enter by a product of two rows), 1, 3, R^2, 2^l, 2^-l,
    2^(l-1), 2^f (its Lagrange coefficients and points are small
    integers in the kernel); K3's p,
    the radix table, the 2t + 1 Lagrange coefficients and the m points;
    K7's p, 1, the 2t + 1 coefficients, the scale and offset, then the
    power's steps; each value in Montgomery form but p, the radix table
    and R^2."""
    from mpyc_tpu_torch import finfields
    p = P200
    ctx = prime_field_ctx(p)
    L, R = ctx.L, 1 << 32 * ctx.L
    ns, l, f = 2 * t + 1, 40, 5
    mont = [x * R % p for x in range(m + 4)]

    def lag(k):
        xs = range(1, k + 1)
        out = []
        for i in xs:
            v = 1
            for j in xs:
                if j != i:
                    v = v * j * pow(j - i, -1, p) % p
            out.append(v * R % p)
        return out
    spec = pipelines.SgnSpec(p, t, m, l, EQ=True, f=f)
    vals = _mont_values(spec.wide_consts('cpu'), L)
    assert len(vals) == 10
    radix = [(1 << 32 * L * c) * R * R % p for c in range(2)]
    assert vals[:3] == [p, radix[0], radix[1] * (1 << 64) * pow(R, -1, p)
                        % p]
    assert vals[3:] == [
        R % p, 3 * R % p, R * R % p, (1 << l) * R % p,
        pow(1 << l, -1, p) * R % p, (1 << l - 1) * R % p, (1 << f) * R % p]
    vals = _mont_values(pipelines.ReshareSpec(p, t, m).wide_consts('cpu'), L)
    assert vals == [p] + radix + lag(ns) + mont[1:m + 1]
    P, consts = pipelines._wide_tail_params(finfields.GF(p), t, m, True, 0,
                                            'cpu')
    assert (P.t, P.m) == (t, m)
    words = consts.numpy().view(np.uint32)
    assert words.size == (4 + ns) * L + 2 * P.pow.n_steps
    vals = _mont_values(consts[:(4 + ns) * L], L)
    assert vals == [p, R % p] + lag(ns) + [R % p, R % p]
