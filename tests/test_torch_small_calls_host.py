"""K5's CTA route and K3's geometry for small calls, their CUDA source built
as host C++ (``torch_host_shim.py``: only the units they need, ``kernels``,
``reshare`` and ``sgn_cta``) and held against the plain PyTorch versions.

K5's CTA route (csrc/sgn_wide.cu built with MTT_SGN_CTA, ``mtt_sgn_cta``)
takes the comparisons of two to six limbs on calls of at most
``_build.SGN_CTA_MAX[L]`` elements, one element a CTA of 512, 256 or 128
threads (by n) whose groups (a warp, or 8 lanes) run each field
operation. Held bit for bit against ``_sgn_step_plain`` (and
``_sgn_chunks_plain``) at the LP solvers', the fixed-point LP's and the
ID3 trees' widths on three to six limbs, in its three modes: one element
and 70, 288 in chunks of 128 with a counter that carries into its high
word, t = 1 and (2, 5), a party past the senders, t = 3 and 4 past
``_build.sgn_lb_fit`` (where csrc/sgn.cuh refuses), at every CTA width
and group it is built for, at two limbs too; its field operations against
``SgnSpec.field_ops`` with its groups, its shared memory and workspace
against ``_build.sgn_wide_layout``, its launch route and refusals.

K3 (csrc/reshare.cuh) takes its CTA's elements from n
(``mtt_reshare_cta``): below 132 x 3,200 elements, n spread over the
132 SMs in multiples of 32, so that the LP solvers' rank-1 updates (2,898
at six limbs, 58,667 at five) fill the card. Held bit for bit against
``_reshare_mul_plain`` at one to six limbs, fused and not, at (1, 3) and
(2, 5), with sponge blocks that straddle CTAs; its field operations
against ``ReshareSpec.field_ops``. Tolerance: exact equality.
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
from mpyc_tpu_torch.ops import keccak
from mpyc_tpu_torch.ops.fieldops import prime_field_ctx


@pytest.fixture(autouse=True)
def one_thread():
    """The plain versions on small tensors gain nothing from torch's
    threads, and the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def host_lib(tmp_path_factory):
    """K3 at (1, 3) and at a run-time (t, m), and K5's CTA route, compiled
    for the host (the narrow K5's launchers stubbed)."""
    return torch_host_shim.build(tmp_path_factory.mktemp('small_calls'),
                                 ('kernels', 'reshare', 'sgn_cta'))


@pytest.fixture(scope='module')
def state():
    st, _ = keccak.ctr_state(bytes(range(40)))
    return keccak.state_tensor(st, 'cpu')


# a field of each limb count: GF(1031); SecInt(32)'s; SecInt(42)'s (ID3's
# SPECT); SecInt(70)'s (LPExample_R20); SecInt(110)'s (LPExample);
# SecFxp(96, 48)'s (the fixed-point kb2)
P1 = 1031
P2 = 18446744073709551427
P3 = 18889465931478580854739
P4 = 2535301200456458802993406413211
P5 = 2787593149816327892691964784081045188544327
P6 = 95780971304118053647396689196894323976171195136474903
FIELDS = {1: P1, 2: P2, 3: P3, 4: P4, 5: P5, 6: P6}
# (limbs, l, f): the paths' widths on three to six limbs: ID3's SPECT
# (SecInt(42)), the fixed-point LP's SecFxp(52, 26), LPExample's SecInt(110),
# the fixed-point kb2's SecFxp(96, 48)
WIDTHS = [(3, 42, 0), (4, 52, 26), (5, 110, 0), (6, 96, 48)]
DRAW_OPS = (2, 1)      # a draw's reduction: two products and an add


def _values(l, n, seed):
    """n l-bit signed values: the range's ends, 0 and +-1 first."""
    g = np.random.default_rng(seed)
    lim = 1 << l - 1
    head = [0, 1, -1, -lim, lim - 1][:n]
    return head + [int.from_bytes(g.bytes(32), 'little') % (2 * lim) - lim
                   for _ in range(n - len(head))]


def _cta(host_lib, st, spec, a, nonce, chunk=None, n_last=None, grid=None,
         params=None):
    """K5's CTA route on (m, n, L) shares a, in chunks of ``chunk`` (one
    call by default), on ``grid`` CTAs (the launch's: one an element)."""
    n = a.shape[1]
    params = params or spec.cta_params(nonce, n)
    grid = grid or _build.sgn_wide_grid(n, params.ws_stride)
    ws = torch.zeros(max(grid * params.ws_stride, 1), dtype=torch.int32)
    out = torch.empty_like(a)
    consts = spec.wide_consts('cpu')
    assert host_lib.mtt_sgn_cta(
        a.data_ptr(), out.data_ptr(), st.data_ptr(), n, chunk or n,
        n_last or n, consts.data_ptr(), ws.data_ptr(), grid,
        ctypes.addressof(params), None) == 0
    return out


@pytest.mark.parametrize('n', [1, 70])
@pytest.mark.parametrize('L,l,f', WIDTHS, ids=['L3', 'L4', 'L5', 'L6'])
@pytest.mark.parametrize('mode', pipelines.SGN_MODES)
def test_cta_route_matches_plain(host_lib, state, mode, L, l, f, n):
    """One element (an ID3 node's call) and 70 (sc50b's), each an element
    a CTA, at the paths' widths and scales: bit for bit the plain version,
    and the openings are the comparisons of the values times 2^f."""
    p = FIELDS[L]
    vals = _values(l, n, l + n)
    a = _value_shares(vals, p, 1, 3, seed=n + L)
    spec = pipelines.SgnSpec(p, 1, 3, l, LT=mode == 'LT', EQ=mode == 'EQ',
                             f=f)
    nonce = (0xFFFFFFFE, 5)
    got = _cta(host_lib, state, spec, a, nonce, grid=min(n, 3))
    assert torch.equal(got, pipelines._sgn_step_plain(a, state, nonce, spec))
    assert _open(got, p, 1, f) == [_compare(mode, v) for v in vals]


@pytest.mark.parametrize('mode', pipelines.SGN_MODES)
@pytest.mark.parametrize('L', [3, 5])
def test_cta_route_takes_many_chunks_in_one_launch(host_lib, state, L, mode):
    """LPExample's 288 elements as one launch in chunks of 128 (the last
    call on its bucket of 64, of which 32 are given), each chunk's counter
    its own and carried into the high word: chunk by chunk the plain
    version's (``_sgn_chunks_plain``), on 5 CTAs of the persistent grid."""
    p = FIELDS[L]
    spec = pipelines.SgnSpec(p, 1, 3, 40, LT=mode == 'LT', EQ=mode == 'EQ',
                             f=3)
    a = _value_shares(_values(40, 288, L), p, 1, 3, seed=L)
    ctr = np.array([0xFFFFFFFF, 2], np.uint32)
    got = _cta(host_lib, state, spec, a, (int(ctr[0]), int(ctr[1])),
               chunk=128, n_last=pipelines.bucket(32, 128), grid=5)
    want, ctr_p = pipelines._sgn_chunks_plain(a, state, ctr, spec, 128)
    assert torch.equal(got, want) and list(ctr_p) == [2, 3]


# (limbs, l, f, t, m): a party past the senders, (2, 5); t = 3 and 4 past
# sgn_lb_fit (t lb draws of the bit call past csrc/sgn.cuh's CTA of one
# warp: 121 > 100 bits at t = 3 on six limbs, the fixed-point kb2's 97 > 75
# at t = 4)
PARTIES = [(4, 52, 26, 1, 4), (5, 110, 0, 2, 5), (6, 120, 0, 3, 7),
           (6, 96, 48, 4, 9)]


@pytest.mark.parametrize('mode', pipelines.SGN_MODES)
@pytest.mark.parametrize('L,l,f,t,m', PARTIES,
                         ids=['L4-t1m4', 'L5-t2m5', 'L6-t3m7', 'L6-t4m9'])
def test_cta_route_matches_plain_at_parties(host_lib, state, mode, L, l, f,
                                            t, m):
    """At other (t, m), also where the narrow kernel's random bits run out
    (``sgn_lb_fit``, which the CTA route does not know): bit for bit the
    plain version on five values, and the openings the comparisons."""
    p = FIELDS[L]
    vals = _values(l, 5, t + m)
    a = _value_shares(vals, p, t, m, seed=l + t)
    spec = pipelines.SgnSpec(p, t, m, l, LT=mode == 'LT', EQ=mode == 'EQ',
                             f=f)
    if t > 1:
        assert (spec.lb > _build.sgn_lb_fit(t, L)) == (t > 2)
    nonce = (9, 1)
    got = _cta(host_lib, state, spec, a, nonce, grid=2)
    assert torch.equal(got, pipelines._sgn_step_plain(a, state, nonce, spec))
    assert _open(got, p, t, f) == [_compare(mode, v) for v in vals]


@pytest.mark.parametrize('L', [2, 4])
@pytest.mark.parametrize('group', _build.SGN_CTA_GROUPS_BUILT)
@pytest.mark.parametrize('threads', _build.SGN_CTA_THREADS_BUILT)
def test_every_cta_width_matches_plain(host_lib, state, threads, group, L):
    """Each instantiation of the CTA route (its CTA width and groups of 8
    lanes or a whole warp, as the launch's parameter block names them) on
    four elements at SecInt(32)'s two limbs and SecInt(70)'s four, LT,
    bit for bit the plain version; the launch takes 512 threads up to 132
    elements (one CTA an SM of the H100), 256 to 264, then 128."""
    p = FIELDS[L]
    spec = pipelines.SgnSpec(p, 1, 3, 20 if L == 2 else 70, LT=True)
    a = _value_shares(_values(spec.l, 4, threads), p, 1, 3, seed=L)
    params = spec.cta_params((1, 0), 4)
    params.threads, params.group = threads, group
    params.ws_stride = _build.sgn_wide_layout(1, 3, L, spec.l, 1,
                                              threads // group)[1]
    got = _cta(host_lib, state, spec, a, (1, 0), params=params, grid=2)
    assert torch.equal(got, pipelines._sgn_step_plain(a, state, (1, 0),
                                                      spec))
    assert [_build.sgn_cta_shape(n) for n in (1, 132, 133, 264, 265,
                                              1056)] == \
        [(512, 32), (512, 32), (256, 32), (256, 32), (128, 8), (128, 8)]
    params = spec.cta_params((1, 0), 200)
    assert (params.threads, params.group) == (256, 32)


def _cta_ops(spec, vals, st, nonce):
    """The products and adds the CTA route runs on one call of the l-bit
    values vals: ``SgnSpec.field_ops`` with its groups, each element at
    the ones of its c mod 2^l = (v + r mod 2^l) mod 2^l (r's bits the
    first of its stream-A words), and two products and an add a draw."""
    n, l = len(vals), spec.l
    words = keccak._keccak_ctr_plain(pipelines._nonce_state(st, nonce),
                                     spec.blocks_a(n), 19)
    words = (words.to(torch.int64) & 0xFFFFFFFF).reshape(-1)
    groups = _build.sgn_cta_groups(n)
    mont = adds = 0
    for e, v in enumerate(vals):
        w = words[e * spec.wpe:e * spec.wpe + spec.wb].tolist()
        r = sum(int(x) << 32 * q for q, x in enumerate(w)) % (1 << l)
        ones = bin((v + r) % (1 << l)).count('1')
        mo, ad = spec.field_ops(ones, groups)
        mont += mo + DRAW_OPS[0] * spec.draws_per_element()
        adds += ad + DRAW_OPS[1] * spec.draws_per_element()
    return mont, adds


@pytest.mark.parametrize('mode', pipelines.SGN_MODES)
@pytest.mark.parametrize('L,l,f,t,m', [(3, 42, 0, 1, 3), (6, 96, 48, 1, 3),
                                       (5, 30, 0, 2, 5)],
                         ids=['L3', 'L6', 'L5-t2m5'])
def test_cta_route_field_ops_match_the_source(host_lib, state, mode, L, l,
                                              f, t, m):
    """The source's products and adds (each counted once a group's
    operation) are ``SgnSpec.field_ops`` with the CTA route's groups at each
    element's ones of c mod 2^l, and two products and an add a draw: the
    count chip_smoke.py bounds the route by."""
    p = FIELDS[L]
    vals = _values(l, 3, L + t)
    a = _value_shares(vals, p, t, m, seed=3)
    spec = pipelines.SgnSpec(p, t, m, l, LT=mode == 'LT', EQ=mode == 'EQ',
                             f=f)
    counts = _op_counts(host_lib)
    counts[0] = counts[1] = 0
    _cta(host_lib, state, spec, a, (4, 0), grid=2)
    assert tuple(counts) == _cta_ops(spec, vals, state, (4, 0))


def test_cta_route_sizes(host_lib):
    """The CTA route's shared memory and workspace, the same in ``_build``
    (``sgn_wide_layout`` with its groups) as in the source
    (``mtt_sgn_cta_smem``, ``_ws``) at every (t, m) and CTA shape here:
    the vectors of every comparison it takes fit in shared memory (no
    workspace), the widest, l = 190 in sgn mode at (4, 16) on six limbs,
    included."""
    for t in range(1, 5):
        for m in (2 * t + 1, 16):
            for L in _build.SGN_CTA_NL:
                for threads in _build.SGN_CTA_THREADS_BUILT:
                    for group in _build.SGN_CTA_GROUPS_BUILT:
                        ng = threads // group
                        for l, mode in ((32 * L - 2, 0), (31, 1),
                                        (32 * L - 1, 2)):
                            smem, ws = _build.sgn_wide_layout(t, m, L, l,
                                                              mode, ng)
                            assert ws == 0 and 0 < smem <= 232448
                            assert host_lib.mtt_sgn_cta_smem(
                                t, m, L, l, mode, ng) == smem
                            assert host_lib.mtt_sgn_cta_ws(
                                t, m, L, l, mode, ng) == 0
    assert _build.sgn_wide_layout(1, 3, 5, 110, 1, 16) == (
        4 * _build.sgn_wide_base_words(1, 3, 5, 16)
        + 4 * _build.sgn_wide_vec_words(1, 5, 110, 1), 0)


def test_cta_route_refuses_what_it_does_not_take(host_lib, state):
    """-1 for seven limbs or one, a group of other than 8 or 32 lanes, a
    CTA of other threads, t past 4; the spec raises NotImplementedError
    from seven limbs on (the wide route's) and below two."""
    spec = pipelines.SgnSpec(FIELDS[5], 1, 3, 40, LT=True)
    a = _value_shares([1, -2], FIELDS[5], 1, 3, seed=1)
    out = torch.empty_like(a)
    consts = spec.wide_consts('cpu')
    for field, value in (('group', 4), ('group', 16), ('threads', 64),
                         ('threads', 1024), ('t', 5), ('nl', 7),
                         ('nl', 1)):
        params = spec.cta_params((0, 0), 2)
        setattr(params, field, value)
        assert host_lib.mtt_sgn_cta(
            a.data_ptr(), out.data_ptr(), state.data_ptr(), 2, 2, 2,
            consts.data_ptr(), None, 2, ctypes.addressof(params),
            None) == -1, field
    p7 = 1606938044258990275541962092341162602522202993782792835301259
    for p in (1031, p7):
        with pytest.raises(NotImplementedError, match='CTA route'):
            pipelines.SgnSpec(p, 1, 3, 4, k=2, LT=True).cta_params((0, 0),
                                                                   1)


def test_small_calls_take_the_cta_route(monkeypatch):
    """``_launch_sgn`` takes ``mtt_sgn_cta`` on calls of up to
    ``SGN_CTA_MAX[L]`` elements at two to six limbs (its launches counted
    under keys that end in ``SGN_CTA``), ``mtt_sgn`` above, and the wide
    kernel from seven limbs on; past ``sgn_lb_fit`` a large call still
    raises NotImplementedError, a small one is taken."""
    calls = []
    monkeypatch.setattr(_build, 'call', lambda name, *a: calls.append(name))
    monkeypatch.setattr(_build, 'stream_of', lambda device: 0)
    monkeypatch.setattr(_build, 'SGN_CTA_MAX',
                        {2: 0, 3: 64, 4: 64, 5: 64, 6: 64})
    st = keccak.state_tensor(keccak._absorb_host(bytes(40)), 'cpu')
    pipelines.sgn_step.by_key.clear()
    for L in (2, 3, 5, 6):
        spec = pipelines.SgnSpec(FIELDS[L], 1, 3, 20, LT=True)
        for n, name in ((1, 'mtt_sgn_cta'), (64, 'mtt_sgn_cta'),
                        (65, 'mtt_sgn')):
            a = torch.zeros((3, n, L), dtype=torch.int32)
            pipelines._launch_sgn(a, st, (0, 0), spec, n, n)
            assert calls.pop() == (name if L > 2 else 'mtt_sgn'), (L, n)
            assert pipelines.sgn_route(L, n) == (
                'cta' if name == 'mtt_sgn_cta' and L > 2 else 'narrow')
    assert pipelines.sgn_step.by_key[('LT', 20, 5, 0, 'cta')] == 2
    assert pipelines.sgn_step.by_key[('LT', 20, 5, 0)] == 1
    assert pipelines.sgn_route(7, 1) == 'wide'
    spec = pipelines.SgnSpec(FIELDS[6], 3, 7, 120, LT=True)
    a = torch.zeros((7, 65, 6), dtype=torch.int32)
    with pytest.raises(NotImplementedError, match='random bits'):
        pipelines._launch_sgn(a, st, (0, 0), spec, 65, 65)
    pipelines._launch_sgn(a[:, :64], st, (0, 0), spec, 64, 64)
    assert calls.pop() == 'mtt_sgn_cta'
    spec = pipelines.SgnSpec(FIELDS[5], 1, 3, 20, LT=True)
    a = torch.zeros((3, 1, 5), dtype=torch.int32)
    pipelines._launch_sgn(a, st, (0, 0), spec, 1, 1, route='narrow')
    assert calls.pop() == 'mtt_sgn'
    pipelines.sgn_step.by_key.clear()


# -- K3: a CTA's elements from n ---------------------------------------------

def test_reshare_cta_elements_follow_n(host_lib):
    """Below 132 CTAs of the most a CTA takes (3,200, or 2,240 at t = 4 on
    five and six limbs) a K3 CTA takes n / 132 elements rounded up to a
    multiple of 32: the fixed-point kb2's update (2,898 at six limbs) 32 a
    CTA on 91 CTAs, LPExample's (58,667 at five) 448 on 131; 2^22 keep
    3,200."""
    cta = host_lib.mtt_reshare_cta
    assert cta(2898, 1, 6) == 32 and -(-2898 // 32) == 91
    assert cta(58667, 1, 5) == 448 and -(-58667 // 448) == 131
    assert [cta(n, 1, 4) for n in (1, 441, 1024, 4224, 4225)] == \
        [32, 32, 32, 32, 64]
    assert cta(1 << 22, 1, 2) == cta(132 * 3200, 1, 2) == 3200
    assert cta(132 * 3200 - 1, 1, 2) == 3200
    assert cta(300000, 1, 3) == 2304
    assert cta(1 << 22, 4, 6) == cta(10 ** 6, 4, 6) == 2240
    assert cta(2898, 2, 6) == 32


def _shares(n, seed, p, m):
    """(m, n) canonical field elements (< p) as stored limbs."""
    g = np.random.default_rng(seed)
    L = prime_field_ctx(p).L
    words = g.integers(0, 1 << 32, (m, n, L), dtype=np.uint64)
    words[..., -1] = g.integers(0, p >> 32 * (L - 1), (m, n))
    return torch.from_numpy(words.astype(np.uint32).view(np.int32))


@pytest.mark.parametrize('t,m', [(1, 3), (2, 5)])
@pytest.mark.parametrize('fuse', [True, False])
@pytest.mark.parametrize('L', [1, 2, 3, 4, 5, 6])
def test_reshare_small_calls_match_plain(host_lib, state, L, fuse, t, m):
    """Calls of 2,898 (32 elements a CTA) and 5,003 (64, the last CTA
    ragged): a CTA's draws start and end inside sponge blocks, which both
    neighbours squeeze; bit for bit the plain version."""
    p = FIELDS[L]
    spec = pipelines.ReshareSpec(p, t, m)
    for n in (2898, 5003):
        a, b = _shares(n, L + n, p, m), _shares(n, L + n + 1, p, m)
        nonce = (0xFFFFFFFF, 9)
        params = spec.params(nonce)
        out = torch.empty_like(a)
        assert host_lib.mtt_reshare(
            a.data_ptr(), b.data_ptr() if fuse else None, out.data_ptr(),
            state.data_ptr(), n, int(fuse), ctypes.addressof(params),
            None) == 0
        assert torch.equal(out, pipelines._reshare_mul_plain(
            a, b if fuse else None, state, nonce, spec))


@pytest.mark.parametrize('t,m', [(1, 3), (2, 5)])
def test_reshare_small_call_field_ops_match_the_source(host_lib, state, t,
                                                       m):
    """``ReshareSpec.field_ops`` and t draws an element (each reduced
    once, though a block is squeezed by both CTAs it straddles) count the
    source's products and adds at 32 elements a CTA."""
    p = FIELDS[6]
    spec = pipelines.ReshareSpec(p, t, m)
    n = 2898
    a, b = _shares(n, 1, p, m), _shares(n, 2, p, m)
    params = spec.params((7, 0))
    out = torch.empty_like(a)
    counts = _op_counts(host_lib)
    counts[0] = counts[1] = 0
    assert host_lib.mtt_reshare(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                                state.data_ptr(), n, 1,
                                ctypes.addressof(params), None) == 0
    mont, adds = spec.field_ops(True)
    assert tuple(counts) == (n * (mont + t * DRAW_OPS[0]),
                             n * (adds + t * DRAW_OPS[1]))
