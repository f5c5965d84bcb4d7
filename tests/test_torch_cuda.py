"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips where torch sees no card. This file
imports neither jax nor mpyc_tpu, so it runs on the card's machine, which
has no JAX (tests/conftest.py imports jax, hence ``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerance: exact equality (integer arithmetic)."""
import numpy as np
import pytest
import torch

from mpyc_tpu_torch.models import pipelines
from mpyc_tpu_torch.ops import fieldops, keccak, rng
from mpyc_tpu_torch.ops.fieldops import limbs_from_numpy, prime_field_ctx

pytestmark = pytest.mark.cuda

P = 18446744073709551427   # SecInt(32)'s field
P46 = 70368744177643       # SecInt(14)'s field (the BNN's)
P69 = 590295810358705651619   # SecInt(37)'s field (the CNN's), three limbs
P96 = 79228162514264337593543950319   # SecInt(64)'s field, three limbs
P52 = 4503599627370323       # SecFxp(14, 6)'s field (the fixed-point CNN's)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the kernels have no CPU mode')
    return torch.device('cuda')


def _state(device):
    st, _ = keccak.ctr_state(bytes(range(7, 47)))
    return keccak.state_tensor(st, device)


def _shares(n, seed, device, p=P):
    """(3, n) canonical field elements (< p) as stored limbs."""
    g = np.random.default_rng(seed)
    L = prime_field_ctx(p).L
    if L == 2:
        lo = g.integers(0, 1 << 32, (3, n), dtype=np.uint64)
        hi = g.integers(0, p >> 32, (3, n), dtype=np.uint64)
        return limbs_from_numpy(np.stack([lo, hi], -1).astype(np.uint32),
                                device)
    words = g.integers(0, 1 << 32, (3, n, L), dtype=np.uint64)
    words[..., -1] = g.integers(0, p >> 32 * (L - 1), (3, n))
    return limbs_from_numpy(words.astype(np.uint32), device)


def test_keccak_ctr_kernel_matches_plain(cuda_device):
    st = _state(cuda_device)
    n0 = keccak.keccak_ctr.launches
    got = keccak.keccak_ctr(st, 4099, 5, 11)
    assert keccak.keccak_ctr.launches == n0 + 1
    assert torch.equal(got, keccak._keccak_ctr_plain(st, 4099, 5, 11))


# K1's CTA comes from n: 24 sponges of five threads each up to one CTA an
# SM (1, 33, the pool refill's 512, 3,168 on 132 SMs), then one thread a
# sponge: 32 threads (4,224, a SHA3 round's 9,363 in the last design), 64
# from 16,896 blocks, 128 from 33,792, 256 from 67,584 on (a 2^22-element
# draw's 599,187)
@pytest.mark.parametrize('n', [1, 33, 512, 3168, 4224, 9363, 16901, 33797,
                               67589, 599187])
def test_keccak_ctr_kernel_matches_plain_at_every_width(cuda_device, n):
    from mpyc_tpu_torch import _build
    st = _state(cuda_device)
    per = _build.library().lib.mtt_keccak_ctr_cta(n)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert per in (24, 32, 64, 128, 256)
    assert (per == 24) == (n <= 24 * sms)
    assert -(-n // per) >= min(sms, -(-n // 24))
    got = keccak.keccak_ctr(st, n, 19, 3)
    assert torch.equal(got, keccak._keccak_ctr_plain(st, n, 19, 3))


@pytest.mark.parametrize('l_bytes', [16, 24])
def test_squeeze_mont_kernel_matches_plain(cuda_device, l_bytes):
    st = _state(cuda_device)
    n0 = rng.squeeze_mont.launches
    got = rng.squeeze_mont(st, 70001, l_bytes, P, 5, 9)
    assert rng.squeeze_mont.launches == n0 + 1
    assert torch.equal(got, rng._squeeze_mont_plain(st, 70001, l_bytes, P,
                                                    5, 9))


@pytest.mark.parametrize('p,l_bytes', [(P96, 28)])
def test_squeeze_mont_kernel_matches_plain_at_three_limbs(cuda_device, p,
                                                          l_bytes):
    st = _state(cuda_device)
    n0 = rng.squeeze_mont.launches
    got = rng.squeeze_mont(st, 70001, l_bytes, p, 5, 9)
    assert rng.squeeze_mont.launches == n0 + 1
    assert torch.equal(got, rng._squeeze_mont_plain(st, 70001, l_bytes, p,
                                                    5, 9))


@pytest.mark.parametrize('n', [100003, 641])
@pytest.mark.parametrize('fuse', [True, False])
def test_reshare_kernel_matches_plain_at_three_limbs(cuda_device, fuse, n):
    """SecInt(37)'s field: 12-byte shares, 20-byte draws."""
    st = _state(cuda_device)
    spec = pipelines.ReshareSpec(P69, 1, 3)
    a = _shares(n, 14, cuda_device, P69)
    b = _shares(n, 15, cuda_device, P69) if fuse else None
    n0 = pipelines.reshare_mul.launches
    got = pipelines.reshare_mul(a, b, st, (0xFFFFFFFF, 2), spec)
    assert pipelines.reshare_mul.launches == n0 + 1
    want = pipelines._reshare_mul_plain(a, b, st, (0xFFFFFFFF, 2), spec)
    assert torch.equal(got, want)


@pytest.mark.parametrize('n', [100003, 641])
@pytest.mark.parametrize('fuse', [True, False])
def test_reshare_kernel_matches_plain(cuda_device, fuse, n):
    """Neither size a multiple of K3's 320-element thread block."""
    st = _state(cuda_device)
    spec = pipelines.ReshareSpec(P, 1, 3)
    a = _shares(n, 4, cuda_device)
    b = _shares(n, 5, cuda_device) if fuse else None
    n0 = pipelines.reshare_mul.launches
    got = pipelines.reshare_mul(a, b, st, (0xFFFFFFFF, 2), spec)
    assert pipelines.reshare_mul.launches == n0 + 1
    want = pipelines._reshare_mul_plain(a, b, st, (0xFFFFFFFF, 2), spec)
    assert torch.equal(got, want)


def test_kernels_refuse_shares_off_an_8_byte_boundary(cuda_device):
    """K3 and K5 load an element as one 8-byte word."""
    st = _state(cuda_device)
    flat = _shares(65, 9, cuda_device).reshape(-1)
    a = flat[1:1 + 3 * 64 * 2].reshape(3, 64, 2)
    with pytest.raises(ValueError, match='8-byte'):
        pipelines.reshare_mul(a, None, st, (0, 0),
                              pipelines.ReshareSpec(P, 1, 3))
    with pytest.raises(ValueError, match='8-byte'):
        pipelines.sgn_step(a, st, (0, 0), pipelines.SgnSpec(P, 1, 3, 32))


def test_reshare_kernel_refuses_other_parties(cuda_device):
    """The card's K3 takes 1 <= t <= 4 and 2t + 1 <= m <= 16: more parties
    or a higher threshold raise NotImplementedError; the wide K3 (7 to 48
    limbs) and K8 take (t, m) = (1, 3) only."""
    st = _state(cuda_device)
    for t, m in ((1, 17), (5, 11)):
        spec = pipelines.ReshareSpec(P, t, m)
        a = torch.zeros((m, 64, 2), dtype=torch.int32, device=cuda_device)
        with pytest.raises(NotImplementedError, match='t <= 4'):
            pipelines.reshare_mul(a, a, st, (0, 0), spec)
    p200 = 1606938044258990275541962092341162602522202993782792835301259
    a = torch.zeros((5, 64, 7), dtype=torch.int32, device=cuda_device)
    with pytest.raises(NotImplementedError, match='(1, 3)'):
        pipelines.reshare_mul(a, a, st, (0, 0),
                              pipelines.ReshareSpec(p200, 2, 5))
    a = torch.zeros((5, 64, 1), dtype=torch.int32, device=cuda_device)
    with pytest.raises(NotImplementedError, match='(1, 3)'):
        pipelines.reshare2(a, a, st, (0, 0),
                           pipelines.Reshare2Spec(0x11B, 2, 5))


def test_split_recombine_kernel_matches_plain(cuda_device):
    st = _state(cuda_device)
    spec = pipelines.SplitSpec(P, 1, 3)
    sec = _shares(100003, 6, cuda_device)[0].contiguous()
    shares = torch.empty((3, 100003, 2), dtype=torch.int32,
                         device=cuda_device)
    n0 = pipelines.split_recombine.launches
    got = pipelines.split_recombine(sec, st, spec, shares=shares)
    assert pipelines.split_recombine.launches == n0 + 1
    want, want_shares = pipelines._split_recombine_plain(sec, st, spec)
    assert torch.equal(got, want) and torch.equal(got, sec)
    assert torch.equal(shares, want_shares)


@pytest.mark.parametrize('n', [20011, 100003])
@pytest.mark.parametrize('mode', pipelines.SGN_MODES)
def test_sgn_kernel_matches_plain(cuda_device, mode, n):
    """Neither size a multiple of K5's 128-element thread block."""
    st = _state(cuda_device)
    spec = pipelines.SgnSpec(P, 1, 3, 32, 30, LT=mode == 'LT',
                             EQ=mode == 'EQ', f=2 if mode == 'LT' else 0)
    a = _shares(n, 7, cuda_device)
    n0 = pipelines.sgn_step.launches
    got = pipelines.sgn_step(a, st, (0xFFFFFFFF, 1), spec)
    assert pipelines.sgn_step.launches == n0 + 1
    assert torch.equal(got, pipelines._sgn_step_plain(a, st, (0xFFFFFFFF, 1),
                                                      spec))


@pytest.mark.parametrize('l', [14, 10])
@pytest.mark.parametrize('mode', pipelines.SGN_MODES)
def test_sgn_kernel_matches_plain_at_bnn_widths(cuda_device, mode, l):
    """The instantiations for the BNN, on SecInt(14)'s field."""
    st = _state(cuda_device)
    spec = pipelines.SgnSpec(P46, 1, 3, l, 30, LT=mode == 'LT',
                             EQ=mode == 'EQ')
    a = _shares(100003, 12, cuda_device, P46)
    n0 = pipelines.sgn_step.launches
    got = pipelines.sgn_step(a, st, (5, 0), spec)
    assert pipelines.sgn_step.launches == n0 + 1
    assert torch.equal(got, pipelines._sgn_step_plain(a, st, (5, 0), spec))


@pytest.mark.parametrize('l', [16, 23, 30, 37])
def test_sgn_kernel_matches_plain_at_three_limbs(cuda_device, l):
    """The instantiations for the CNN (LT), on SecInt(37)'s field."""
    st = _state(cuda_device)
    spec = pipelines.SgnSpec(P69, 1, 3, l, 30, LT=True)
    a = _shares(20011, 16, cuda_device, P69)
    n0 = pipelines.sgn_step.launches
    got = pipelines.sgn_step(a, st, (5, 0), spec)
    assert pipelines.sgn_step.launches == n0 + 1
    assert torch.equal(got, pipelines._sgn_step_plain(a, st, (5, 0), spec))


@pytest.mark.parametrize('n', [1, 70, 288])
@pytest.mark.parametrize('mode', pipelines.SGN_MODES)
def test_cta_route_matches_the_narrow_kernel_and_plain(cuda_device, mode, n):
    """K5's CTA route (one element a CTA, csrc/sgn_wide.cu) and the narrow
    kernel (csrc/sgn.cuh), each forced onto LPExample's SecInt(110) at l =
    110 on five limbs, equal the plain version bit for bit on one
    element, sc50b's 70 and LPExample's 288 on its bucket of 512; a
    launch of that size takes the CTA route, counted under its key."""
    p = 2787593149816327892691964784081045188544327
    st = _state(cuda_device)
    spec = pipelines.SgnSpec(p, 1, 3, 110, 30, LT=mode == 'LT',
                             EQ=mode == 'EQ')
    a = _shares(n, 23, cuda_device, p)
    want, want_ctr = pipelines._sgn_chunks_plain(a, st, (0xFFFFFFFE, 3),
                                                 spec, 1024)
    for route in ('narrow', 'cta'):
        got, ctr = pipelines.sgn_chunks(a, st, (0xFFFFFFFE, 3), spec, 1024,
                                        route)
        assert torch.equal(got, want), route
        assert ctr.tolist() == want_ctr.tolist()
    key = (mode, 110, 5, 0, pipelines.SGN_CTA)
    n0 = pipelines.sgn_step.by_key[key]
    pipelines.sgn_chunks(a, st, (0xFFFFFFFE, 3), spec, 1024)
    assert pipelines.sgn_route(5, n) == 'cta'
    assert pipelines.sgn_step.by_key[key] == n0 + 1


@pytest.mark.parametrize('p,l,n,chunk', [(P69, 16, 5000, 1024),
                                         (P46, 14, 70000, 1 << 15)])
def test_sgn_kernel_takes_many_chunks_in_one_launch(cuda_device, p, l, n,
                                                    chunk):
    """One launch on every chunk equals the plain version chunk by chunk
    (sgn_chunks on the CPU), the last chunk ragged."""
    st = _state(cuda_device)
    spec = pipelines.SgnSpec(p, 1, 3, l, 30, LT=True)
    a = _shares(n, 17, cuda_device, p)
    n0 = pipelines.sgn_step.launches
    got, ctr = pipelines.sgn_chunks(a, st, (0xFFFFFFFE, 3), spec, chunk)
    assert pipelines.sgn_step.launches == n0 + 1
    want, want_ctr = pipelines.sgn_chunks(a.cpu(), st.cpu(), (0xFFFFFFFE, 3),
                                          spec, chunk)
    assert torch.equal(got.cpu(), want)
    assert ctr.tolist() == want_ctr.tolist()


def test_sgn_kernel_refuses_what_was_not_built(cuda_device):
    """The card's K5 takes any width l as a launch parameter, at 1 <= t <=
    4, 2t + 1 <= m <= 16 and two to six limbs: more parties raise, and so
    does a field of 19 limbs (the LP solver's kb2, SecInt(560)), and at t
    = 4 random bits past their draws' room (SecFxp(96, 48): lb = 97 of
    at most 75 on six limbs) on a call too large for the CTA route, which
    takes them on smaller calls."""
    from mpyc_tpu_torch import _build
    st = _state(cuda_device)
    a = torch.zeros((17, 64, 2), dtype=torch.int32, device=cuda_device)
    with pytest.raises(NotImplementedError, match='t <= 4'):
        pipelines.sgn_step(a, st, (0, 0), pipelines.SgnSpec(P, 1, 17, 16))
    p176 = 95780971304118053647396689196894323976171195136474903
    a9 = torch.zeros((9, _build.SGN_CTA_MAX[6] + 1, 6), dtype=torch.int32,
                     device=cuda_device)
    with pytest.raises(NotImplementedError, match='random bits'):
        pipelines.sgn_step(a9, st, (0, 0), pipelines.SgnSpec(
            p176, 4, 9, 96, 30, LT=True, f=48))
    p = (1 << 607) - 1            # a Mersenne prime of 19 limbs
    a19 = torch.zeros((3, 64, 19), dtype=torch.int32, device=cuda_device)
    with pytest.raises(NotImplementedError, match='L=19'):
        pipelines.sgn_step(a19, st, (0, 0), pipelines.SgnSpec(p, 1, 3, 560))


def test_comparison_and_round_trip_on_the_card(cuda_device):
    import chip_smoke
    n3, n4 = pipelines.reshare_mul.launches, pipelines.split_recombine.launches
    n5 = pipelines.sgn_step.launches
    res = chip_smoke.run_compare(cuda_device, n=5000, calls=2)
    assert len(res['per_call_ms']) == 2
    # np_less, np_equal, np_sgn, np_maximum, the BNN sign, 2 timed np_less
    assert pipelines.sgn_step.launches == n5 + 7
    assert pipelines.reshare_mul.launches == n3 + 1     # np_maximum
    res = chip_smoke.run_split_recombine(cuda_device, n=30011, rounds=3)
    assert res['ms_per_round'] > 0
    assert pipelines.split_recombine.launches == n4 + 3


def test_main_path_on_the_card(cuda_device):
    import chip_smoke
    n1, n2 = keccak.keccak_ctr.launches, rng.squeeze_mont.launches
    n3 = pipelines.reshare_mul.launches
    res = chip_smoke.run_main_path(cuda_device, n_big=50000, rounds=3,
                                   sample=1000)
    assert res['p'] == P and len(res['per_call_ms']) == 3
    # pool refills for the 256-value inputs; 4096 and 50000 values squeeze
    # into the field (3 senders, 2 inputs each); one K3 per product
    assert keccak.keccak_ctr.launches > n1
    assert rng.squeeze_mont.launches == n2 + 12
    assert pipelines.reshare_mul.launches == n3 + 6


@pytest.mark.parametrize('M,K,N', [(1, 7, 5), (300, 784, 64),
                                   (300, 4096, 10), (17, 70003, 8)])
def test_field_matmul_on_the_card_equals_the_cpu(M, K, N, cuda_device):
    """The plane GEMM on the card (torch._int_mm, padded) and the fold give
    the bits of the same product on the CPU; K = 70,003 takes two chunks."""
    ctx = prime_field_ctx(P46)
    g = np.random.default_rng(M + K)
    a = ctx.encode(g.integers(0, 1 << 46, (M, K), dtype=np.int64), 'cpu')
    b = ctx.encode(g.integers(0, 1 << 46, (K, N), dtype=np.int64), 'cpu')
    got = ctx.matmul(a.to(cuda_device), b.to(cuda_device))
    assert torch.equal(got.cpu(), ctx.matmul(a, b))


def test_bnn_on_the_card(cuda_device):
    """The MNIST flow at full width on 4 images: predictions equal the
    plaintext model (run_bnn checks), through K3 and K5."""
    import chip_smoke
    n3, n5 = pipelines.reshare_mul.launches, pipelines.sgn_step.launches
    res = chip_smoke.run_bnn(cuda_device, batch=4, passes=1)
    assert res['correct'] == 4
    # a reshare per layer, one sign per hidden layer; the argmax's four
    # comparisons and two products each
    assert pipelines.reshare_mul.launches == n3 + 4 + 8
    assert pipelines.sgn_step.launches == n5 + 3 + 4


def test_bnn_selftest_on_the_card(cuda_device):
    """SecInt(14) input (22-byte draws: K1 and the split) on the card."""
    import chip_smoke
    n1 = keccak.keccak_ctr.launches
    chip_smoke.run_selftest(cuda_device, batch=8)
    assert keccak.keccak_ctr.launches > n1


def test_wide_product_on_the_card(cuda_device):
    """SecInt(64) input (28-byte draws: K2 at three limbs) and a product
    (K3 at three limbs), every output checked by run_wide."""
    import chip_smoke
    n2, n3 = rng.squeeze_mont.launches, pipelines.reshare_mul.launches
    chip_smoke.run_wide(cuda_device, n=20000)
    assert rng.squeeze_mont.launches == n2 + 2
    assert pipelines.reshare_mul.launches == n3 + 1


def test_cnn_on_the_card(cuda_device):
    """The CNN's MNIST flow at full width on 3 images: predictions equal
    the plaintext model (run_cnn checks); each comparison one K5 launch,
    however many chunks of 1024 it has (``sgn_step.chunks``)."""
    import chip_smoke
    n3, n5 = pipelines.reshare_mul.launches, pipelines.sgn_step.launches
    res = chip_smoke.run_cnn(cuda_device, batch=3, passes=1)
    assert res['correct'] == 3
    # maxpool (2 a layer), ReLU (3), the argmax's four: one launch each
    assert res['k5_launches'] == chip_smoke.CNN_COMPARISONS == 11
    assert res['chunks'] > res['k5_launches']
    # two passes (the timed and the marked): per pass four reshares,
    # six np_where and ReLU products, the argmax's eight
    assert pipelines.sgn_step.launches == n5 + 2 * 11
    assert pipelines.reshare_mul.launches == n3 + 2 * (4 + 7 + 8)


def test_cnn_selftest_on_the_card(cuda_device):
    """SecInt(37) input (25-byte draws: K1 and the split) on the card: 32
    images of 64 pixels are 342 blocks, above what hashlib squeezes."""
    import chip_smoke
    n1 = keccak.keccak_ctr.launches
    chip_smoke.run_cnn_selftest(cuda_device, batch=32)
    assert keccak.keccak_ctr.launches > n1


@pytest.mark.parametrize('e', ['0', '1', 'p-2', '(3p-5)/4', '(p+1)/4'])
@pytest.mark.parametrize('p', [P52, P69])
def test_mont_pow_kernel_matches_plain(cuda_device, p, e):
    """K6 at two and three limbs, 0 and 1 among the inputs, n no multiple
    of its 256-thread block."""
    ctx = prime_field_ctx(p)
    x = _shares(100003, 18, cuda_device, p)[0].contiguous()
    x[0] = 0
    x[1] = torch.tensor(ctx.one_mont, dtype=torch.int64).to(torch.int32)
    e = {'0': 0, '1': 1, 'p-2': p - 2, '(3p-5)/4': (3 * p - 5) // 4,
         '(p+1)/4': (p + 1) // 4}[e]
    n0 = fieldops.mont_pow.launches
    got = fieldops.mont_pow(x, e, ctx)
    assert fieldops.mont_pow.launches == n0 + 1
    assert torch.equal(got, fieldops._mont_pow_plain(x, e, ctx))
    assert torch.equal(got.cpu(), fieldops.mont_pow(x.cpu(), e, ctx))


def test_sgn_kernel_with_the_fixed_point_scale(cuda_device):
    """K5 (LT, l = 14) with f = 6 on SecFxp(14, 6)'s field, in one launch
    of three chunks, equal to the plain version chunk by chunk."""
    st = _state(cuda_device)
    spec = pipelines.SgnSpec(P52, 1, 3, 14, 30, LT=True, f=6)
    a = _shares(70000, 19, cuda_device, P52)
    n0 = pipelines.sgn_step.by_key[('LT', 14, 2, 6)]
    got, ctr = pipelines.sgn_chunks(a, st, (7, 1), spec, 1 << 15)
    assert pipelines.sgn_step.by_key[('LT', 14, 2, 6)] == n0 + 1
    want, want_ctr = pipelines.sgn_chunks(a.cpu(), st.cpu(), (7, 1), spec,
                                          1 << 15)
    assert torch.equal(got.cpu(), want)
    assert ctr.tolist() == want_ctr.tolist() == [10, 1]


@pytest.mark.parametrize('e', ['2^k-1', '(3p-5)/4'])
@pytest.mark.parametrize('n', [100003, 129])
@pytest.mark.parametrize('p', [P52, P, P69, P96])
def test_mont_pow_kernel_by_field(cuda_device, p, n, e):
    """K6 on lazy (4p < R) and canonical fields (SecInt(32)'s and
    SecInt(64)'s) of two and three limbs, n no multiple of its block of
    256 (129: the second element of a thread holds one element)."""
    ctx = prime_field_ctx(p)
    x = _shares(n, 20, cuda_device, p)[0].contiguous()
    x[0] = 0
    e = {'2^k-1': (1 << 32 * ctx.L) - 1, '(3p-5)/4': (3 * p - 5) // 4}[e]
    n0 = fieldops.mont_pow.by_key[(ctx.L, ctx.lazy)]
    got = fieldops.mont_pow(x, e, ctx)
    assert fieldops.mont_pow.by_key[(ctx.L, ctx.lazy)] == n0 + 1
    assert torch.equal(got, fieldops._mont_pow_plain(x, e, ctx))


def _tail_shares(p, n, seed, device, every=1000):
    """(3, n, L) random shares r and z, every ``every``-th element's r set
    to 0 and z to a sharing of 0 of degree 2 (x + x^2 at 1, 2, 3), so that
    r^2 + z opens to 0."""
    ctx = prime_field_ctx(p)
    r = _shares(n, seed, device, p)
    z = _shares(n, seed + 1, device, p)
    r[:, ::every] = 0
    z[:, ::every] = ctx.encode(np.array([[2], [6], [12]]), device)
    return r, z


@pytest.mark.parametrize('signed,f', [(False, 0), (True, 0), (False, 6)])
@pytest.mark.parametrize('p', [P52, P69])
def test_random_bits_tail_kernel_matches_plain(cuda_device, p, signed, f):
    """K7 equals its plain version on random shares with one r in 1,000
    planted to 0: bits, flags and count."""
    from mpyc_tpu_torch import finfields
    field = finfields.GF(p)
    r, z = _tail_shares(p, 100003, 21, cuda_device)
    n0 = pipelines.random_bits_tail.launches
    got = pipelines.random_bits_tail(r, z, field, signed, f)
    assert pipelines.random_bits_tail.launches == n0 + 1
    want = pipelines._random_bits_tail_plain(r, z, field, signed, f)
    assert got[2].item() == want[2].item() == 101
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[0], want[0])


def test_np_random_bits_launches_k7(cuda_device):
    """Every np_random_bits launches K7 (once a round), and K6 not at
    all."""
    from mpyc_tpu_torch.parallel.simulator import SimRuntime
    rt = SimRuntime(3, device=cuda_device)
    rt.start()
    field = rt.SecFxp(14, 6).field
    for n in (1, 1000, 70000):
        n7, n6 = pipelines.random_bits_tail.launches, fieldops.mont_pow.launches
        bits = rt.output(rt.np_random_bits(field, n)).value
        assert pipelines.random_bits_tail.launches == n7 + 1
        assert fieldops.mont_pow.launches == n6
        assert bits.shape == (n,) and np.isin(bits, (0, 1)).all()
    rt.shutdown()


def test_fxp_rounds_on_the_card(cuda_device):
    """np_random_bits and np_trunc at SecFxp(14, 6) on the card (checked by
    run_fxp_rounds): one K7 launch each for the random bits' tail."""
    import chip_smoke
    n7 = pipelines.random_bits_tail.launches
    res = chip_smoke.run_fxp_rounds(cuda_device, n=20000)
    assert 0.45 < res['ones'] < 0.55 and res['bits_ms'] > 0
    assert pipelines.random_bits_tail.launches == n7 + 2


def test_cnn_fxp_on_the_card(cuda_device):
    """The fixed-point MNIST flow at full width on 3 images: every stage of
    both passes (the timed and the marked) passes the stage-local check
    (run_cnn_fxp checks). A pass: 11 comparisons (K5 with f), 4 truncations
    (K7 for their random bits, K6 not at all), and 19 reshares without a
    product (K3): the four layers' and maxpool's, ReLU's and the argmax's
    products by an integral bit."""
    import chip_smoke
    n3 = pipelines.reshare_mul.by_key[(2, False)]
    n3f = pipelines.reshare_mul.by_key[(2, True)]
    n5 = pipelines.sgn_step.by_key[('LT', 14, 2, 6)]
    n7 = pipelines.random_bits_tail.by_key[(2, True)]
    res = chip_smoke.run_cnn_fxp(cuda_device, batch=3, passes=1)
    run, = res['runs']
    assert run['k5'] == 11 and run['k6'] == 0 and run['k7'] == 4
    assert pipelines.sgn_step.by_key[('LT', 14, 2, 6)] == n5 + 2 * 11
    assert pipelines.random_bits_tail.by_key[(2, True)] == n7 + 2 * 4
    assert pipelines.reshare_mul.by_key[(2, False)] == n3 + 2 * 19
    assert pipelines.reshare_mul.by_key[(2, True)] == n3f
    assert all(r['fits'] for r in res['ranges'].values())


# -- the LP solver's fields: four and five limbs, K5's width a parameter -----

P102 = 2535301200456458802993406413211    # SecInt(70), LPExample_R20's
P142 = 2787593149816327892691964784081045188544327  # SecInt(110), LPExample's


@pytest.mark.parametrize('p', [P102, P142])
@pytest.mark.parametrize('fuse', [True, False])
def test_reshare_kernel_matches_plain_at_four_and_five_limbs(cuda_device, p,
                                                             fuse):
    """K3 at 58,667 elements (LPExample's rank-1 update, no multiple of
    the block), its coefficients in dynamic shared memory."""
    st = _state(cuda_device)
    spec = pipelines.ReshareSpec(p, 1, 3)
    a, b = _shares(58667, 51, cuda_device, p), _shares(58667, 52,
                                                       cuda_device, p)
    got = pipelines.reshare_mul(a, b if fuse else None, st, (2, 0), spec)
    want = pipelines._reshare_mul_plain(a, b if fuse else None, st, (2, 0),
                                        spec)
    assert torch.equal(got, want)


@pytest.mark.parametrize('p,l', [(P102, 70), (P142, 104), (P142, 110),
                                 (P, 6), (P, 20), (P96, 45)])
@pytest.mark.parametrize('mode', pipelines.SGN_MODES)
def test_sgn_kernel_matches_plain_at_any_width(cuda_device, mode, p, l):
    """K5 with the width a launch parameter: the LP solver's on four and
    five limbs, and widths no instantiation took before on two and three,
    in one launch of three chunks of 1024 (two limbs: one call)."""
    st = _state(cuda_device)
    spec = pipelines.SgnSpec(p, 1, 3, l, 30, LT=mode == 'LT',
                             EQ=mode == 'EQ')
    chunk = 1024 if spec.ctx.L > 2 else 1 << 20
    a = _shares(2500, 53, cuda_device, p)
    got, ctr = pipelines.sgn_chunks(a, st, (9, 0), spec, chunk)
    want, want_ctr = pipelines._sgn_chunks_plain(a, st, (9, 0), spec, chunk)
    assert torch.equal(got, want)
    assert ctr.tolist() == want_ctr.tolist()


@pytest.mark.parametrize('e', ['p-2', '(p-1)/2'])
@pytest.mark.parametrize('p', [P102, P142])
def test_mont_pow_kernel_matches_plain_at_four_and_five_limbs(cuda_device, p,
                                                              e):
    """K6 at the public inverse's and the Legendre symbol's exponents."""
    ctx = prime_field_ctx(p)
    x = _shares(1001, 54, cuda_device, p)[0].contiguous()
    e = p - 2 if e == 'p-2' else (p - 1) // 2
    assert torch.equal(fieldops.mont_pow(x, e, ctx),
                       fieldops._mont_pow_plain(x, e, ctx))


@pytest.mark.parametrize('p', [P102, P142])
def test_random_bits_tail_kernel_matches_plain_at_four_and_five_limbs(
        cuda_device, p):
    import chip_smoke
    from mpyc_tpu_torch import finfields
    field = finfields.GF(p)
    r, z = chip_smoke.tail_shares(p, 1000, np.random.default_rng(55),
                                  every=7)
    got = pipelines.random_bits_tail(r, z, field, False, 0)
    want = pipelines._random_bits_tail_plain(r, z, field, False, 0)
    for u, v in zip(got, want):
        assert torch.equal(u, v)
    assert int(got[2].item()) == -(-1000 // 7)


@pytest.mark.parametrize('dataset', [0, 4])
def test_lp_solver_on_the_card(cuda_device, dataset):
    """The LP runner on the card equals the plain exact solver, with the
    demo's pivot count and a true certificate; K5, K6 and K3 launched."""
    import chip_smoke
    n5, n6 = pipelines.sgn_step.launches, fieldops.mont_pow.launches
    res = chip_smoke.run_lp(cuda_device, datasets=(dataset,))
    (name, r), = [(k, v) for k, v in res.items() if k != 'traces']
    assert r['pivots'] > 0
    assert pipelines.sgn_step.launches > n5
    assert fieldops.mont_pow.launches > n6


# -- the fixed-point fields: six limbs, and four with 4p >= R -----------------

P176 = 95780971304118053647396689196894323976171195136474903  # SecFxp(96)
P128 = 340282366920938463463374607431768211283   # SecFxp(64, 32), 4p >= R


@pytest.mark.parametrize('fuse', [True, False])
def test_reshare_kernel_matches_plain_at_six_limbs(cuda_device, fuse):
    """K3 on SecFxp(96)'s field at 58,667 elements, its coefficients in
    76,800 bytes of dynamic shared memory a CTA."""
    st = _state(cuda_device)
    spec = pipelines.ReshareSpec(P176, 1, 3)
    a, b = _shares(58667, 61, cuda_device, P176), \
        _shares(58667, 62, cuda_device, P176)
    got = pipelines.reshare_mul(a, b if fuse else None, st, (3, 0), spec)
    want = pipelines._reshare_mul_plain(a, b if fuse else None, st, (3, 0),
                                        spec)
    assert torch.equal(got, want)


@pytest.mark.parametrize('l,f', [(96, 0), (96, 48), (160, 0)])
@pytest.mark.parametrize('mode', pipelines.SGN_MODES)
def test_sgn_kernel_matches_plain_at_six_limbs(cuda_device, mode, l, f):
    """K5 on SecFxp(96)'s field, at its width with and without the scale
    2^48 and at l = 160, in one launch of three chunks of 1024."""
    st = _state(cuda_device)
    spec = pipelines.SgnSpec(P176, 1, 3, l, 14 if l == 160 else 30,
                             LT=mode == 'LT', EQ=mode == 'EQ', f=f)
    a = _shares(2500, 63, cuda_device, P176)
    got, ctr = pipelines.sgn_chunks(a, st, (9, 0), spec, 1024)
    want, want_ctr = pipelines._sgn_chunks_plain(a, st, (9, 0), spec, 1024)
    assert torch.equal(got, want)
    assert ctr.tolist() == want_ctr.tolist()


@pytest.mark.parametrize('e', ['p-2', '(p-1)/2', '(3p-5)/4'])
@pytest.mark.parametrize('n', [1001, 100003])
@pytest.mark.parametrize('p', [P176, P128])
def test_mont_pow_kernel_matches_plain_at_six_limbs_and_canonical_four(
        cuda_device, p, n, e):
    """K6 on SecFxp(96)'s six-limb field (its table past 48 KB of shared
    memory) and on SecFxp(64, 32)'s canonical four-limb one, against the
    plain version (the limb ladder), on one ragged thread block and on
    many."""
    ctx = prime_field_ctx(p)
    x = _shares(n, 64, cuda_device, p)[0].contiguous()
    e = {'p-2': p - 2, '(p-1)/2': (p - 1) // 2,
         '(3p-5)/4': (3 * p - 5) // 4}[e]
    assert torch.equal(fieldops.mont_pow(x, e, ctx),
                       fieldops._mont_pow_plain(x, e, ctx))


@pytest.mark.parametrize('p', [P176, P128])
def test_random_bits_tail_kernel_matches_plain_at_six_limbs_and_canonical_four(
        cuda_device, p):
    import chip_smoke
    from mpyc_tpu_torch import finfields
    field = finfields.GF(p)
    r, z = chip_smoke.tail_shares(p, 139104, np.random.default_rng(65),
                                  every=7)
    got = pipelines.random_bits_tail(r, z, field, False, 0)
    want = pipelines._random_bits_tail_plain(r, z, field, False, 0)
    for u, v in zip(got, want):
        assert torch.equal(u, v)
    assert int(got[2].item()) == -(-139104 // 7)


@pytest.mark.parametrize('dataset', [0, 2])
def test_lp_fxp_solver_on_the_card(cuda_device, dataset):
    """The fixed-point LP runner on the card (uvlp at SecFxp(24), three
    limbs; tb2x2 at SecFxp(18), two): the certificate true, the max within
    1% and the solution within the runner's tolerance; K3, K5 and K7
    launched."""
    import chip_smoke
    n5 = pipelines.sgn_step.launches
    n7 = pipelines.random_bits_tail.launches
    res = chip_smoke.run_lp_fxp(cuda_device, datasets=(dataset,))
    (name, r), = res.items()
    assert r['pivots'] > 0
    assert pipelines.sgn_step.launches > n5
    assert pipelines.random_bits_tail.launches > n7


def test_kmsurvival_on_the_card(cuda_device):
    """The survival test on btrial (SecFxp(56, 28)) with --agg on the card:
    chi2 within 1e-3 of the plain statistic; K5 in EQ mode (the
    compaction's zero tests, one element a call: K5's CTA route) and K7
    launched."""
    import chip_smoke
    key = ('EQ', 56, 4, 28, pipelines.SGN_CTA)
    n5 = pipelines.sgn_step.by_key[key]
    n7 = pipelines.random_bits_tail.launches
    res = chip_smoke.run_km(cuda_device, runs=((0, 0, True),))
    (r,) = res.values()
    assert abs(r['chi'] - r['chi_ref']) < 1e-3 * max(1, r['chi_ref'])
    assert pipelines.sgn_step.by_key[key] > n5
    assert pipelines.random_bits_tail.launches > n7


# K8: the GF(2^d) reshare, squeezing its own stream (the moduli of GF(4),
# AES's GF(2^8), GF(2^12), GF(2^16) and GF(2^17) of two- and three-byte
# draws, GF(2^32))
GF2_MODULI = {2: 0b111, 8: 0x11B, 12: 0x1009, 16: 0x1002B, 17: 0x20009,
              32: (1 << 32) | 0x8D}


@pytest.mark.parametrize('d', sorted(GF2_MODULI))
@pytest.mark.parametrize('fuse', [True, False])
@pytest.mark.parametrize('n', [64, 100003])
def test_reshare2_kernel_matches_plain(cuda_device, d, fuse, n):
    """K8 against its plain version from the same state and counter, at a
    bucket and at a size that is no multiple of a CTA's elements: one K8
    launch and no K1 launch."""
    spec = pipelines.Reshare2Spec(GF2_MODULI[d], 1, 3)
    g = np.random.default_rng(d + n)
    a, b = (torch.from_numpy(g.integers(0, 1 << d, (3, n, 1), dtype=np.uint64)
                             .astype(np.uint32).view(np.int32)).to(cuda_device)
            for _ in range(2))
    st = _state(cuda_device)
    n1, n8 = keccak.keccak_ctr.launches, pipelines.reshare2.launches
    got = pipelines.reshare2(a, b if fuse else None, st, (9, 1), spec)
    assert keccak.keccak_ctr.launches == n1
    assert pipelines.reshare2.launches == n8 + 1
    assert pipelines.reshare2.by_key[(d, fuse)] > 0
    assert torch.equal(got, pipelines._reshare2_plain(
        a, b if fuse else None, st, (9, 1), spec))


@pytest.mark.parametrize('d,n', [(2, 1 << 19), (8, 32768), (8, 64)])
def test_reshare2_step_is_one_launch(cuda_device, d, n):
    """make_reshare2_step at SHA3's chi, AES's S-box and the key
    schedule's bucket, fused: one K8 launch a reshare, no K1 launch, the
    plain version's bits."""
    md = GF2_MODULI[d]
    step = pipelines.make_reshare2_step(md, 1, 3, fuse_mul=True)
    spec = pipelines.Reshare2Spec(md, 1, 3)
    g = np.random.default_rng(n)
    a, b = (torch.from_numpy(g.integers(0, 1 << d, (3, n, 1), dtype=np.uint64)
                             .astype(np.uint32).view(np.int32)).to(cuda_device)
            for _ in range(2))
    st = _state(cuda_device)
    ctr = np.array([0xFFFFFFFF, 2], np.uint32)
    n1, n8 = keccak.keccak_ctr.launches, pipelines.reshare2.launches
    got, ctr2 = step(a, b, st, ctr)
    assert keccak.keccak_ctr.launches == n1
    assert pipelines.reshare2.launches == n8 + 1
    assert ctr2.tolist() == [0, 3]
    assert torch.equal(got, pipelines._reshare2_plain(
        a, b, st, (0xFFFFFFFF, 2), spec))


def test_sha3_on_the_card(cuda_device):
    """SHA3-256 and SHAKE128 of 8 messages equal hashlib's (run_sha3
    checks); each chi round one K8 launch and no K1 launch (a batch's K1
    launch, if any, refills the input draws' pool)."""
    import chip_smoke
    res = chip_smoke.run_sha3(cuda_device, b=8, passes=1)
    assert res['k8'] == 24 and res['k1'] <= 1


def test_aes_on_the_card(cuda_device):
    """AES-128 and AES-256 of 5 blocks: FIPS-197 C.1 and C.3 and the round
    trips (run_aes checks); one K8 launch a secure product."""
    import chip_smoke
    res = chip_smoke.run_aes(cuda_device, nb=5, passes=1)
    r, = res['runs']
    # S-boxes: AES-128 10 in the key schedule, 10 encrypting, 10
    # decrypting; AES-256 13, 14 and 14: 71 powers x^254 of 11 products
    assert r['k8'] == 71 * 11


def test_id3_kernels_match_plain(cuda_device):
    """The ID3 trees' instantiations (K5 LT at l = 42-95 on three and four
    limbs and EQ at l = 42, K6 at three limbs, K6 and K7 canonical at
    two) against their plain versions: chip_smoke.check_id3_kernels
    raises on any difference."""
    import chip_smoke
    meas = chip_smoke.check_id3_kernels()
    assert set(meas) == {'sgn_step<EQ, l=42, L=3>', 'mont_pow<L=3, lazy>',
                         'mont_pow<L=2>', 'random_bits_tail<L=2>'} | {
        f'sgn_step<LT, l={l}, L={L}>' for l, L in chip_smoke.ID3_WIDTHS}
    assert all(r['max_abs_err'] == 0 for r in meas.values())


@pytest.mark.parametrize('dataset', [0, 6])
def test_id3_tree_on_the_card(cuda_device, dataset):
    """Tennis (SecInt(32)) and house-votes-84 (SecInt(62), three limbs,
    [NO07]) learn plain_id3's tree; K5 compares on the card."""
    from mpyc_tpu_torch.demos import np_id3gini as id3
    from mpyc_tpu_torch.parallel.simulator import SimRuntime
    n5 = pipelines.sgn_step.launches
    tree, nodes, _ = id3.build(SimRuntime(3, device=cuda_device), dataset,
                               out=lambda s: None)
    assert tree == id3.plain_id3(dataset)
    assert pipelines.sgn_step.launches > n5 + nodes


def test_np_sort_on_the_card(cuda_device):
    """np_sort, np_amax and np_amin of 4,097 values (a ragged network of
    91 stages: one K5 launch each) and sorted by a**2 of 16 shuffled
    values, each held to numpy's or Python's (run_sort checks)."""
    import chip_smoke
    n5 = pipelines.sgn_step.by_key[('LT', 32, 2, 0)]
    res = chip_smoke.run_sort(cuda_device, n=4097, n_sorted=16)
    assert res['stages'] == 91
    assert pipelines.sgn_step.by_key[('LT', 32, 2, 0)] >= n5 + 91


def test_hash_chains_on_the_card(cuda_device):
    """AES at k = 2 and SHAKE128 at k = 3 (eager) from random seeds: every
    revealed value equals the plain chain's (run_hash_chains checks)."""
    import chip_smoke
    res = chip_smoke.run_hash_chains(cuda_device, runs=(
        ('AES, k = 2', 2, False, False), ('SHAKE128, k = 3', 3, True, True)))
    assert [r['hashes'] for r in res.values()] == [4, 12]
    assert res['AES, k = 2']['launches']['reshare2<d=8, fused>'] > 0


# -- one-limb fields: the secure prime fields SecFld(p) ------------------------

P1031, P31 = 1031, (1 << 31) - 1


@pytest.mark.parametrize('p', [11, P1031, P31])
def test_one_limb_kernels_match_plain(cuda_device, p):
    """K3 (fused and not) at 6,407 elements, K9's three ops, K6 at e =
    p - 2 and (3p - 5) / 4 (lazy below 2^30, canonical at 2^31 - 1) and
    K7 on 300 elements, bit for bit against their plain versions."""
    from mpyc_tpu_torch import finfields
    st = _state(cuda_device)
    ctx = prime_field_ctx(p)
    assert ctx.L == 1
    spec = pipelines.ReshareSpec(p, 1, 3)
    a, b = _shares(6407, 40, cuda_device, p), _shares(6407, 41, cuda_device,
                                                      p)
    for bb in (b, None):
        got = pipelines.reshare_mul(a, bb, st, (3, 1), spec)
        want = pipelines._reshare_mul_plain(a, bb, st, (3, 1), spec)
        assert torch.equal(got, want)
    x = a[0, :300].contiguous()
    for op in fieldops._FIELD_OPS:
        assert torch.equal(fieldops.field_op(x, b[1, :300], op, ctx),
                           fieldops._field_op_plain(x, b[1, :300], op, ctx))
    for e in (p - 2, (3 * p - 5) // 4):
        assert torch.equal(fieldops.mont_pow(x, e, ctx),
                           fieldops._mont_pow_plain(x, e, ctx))
    field = finfields.GF(p)
    r, z = a[:, :300].contiguous(), b[:, :300].contiguous()
    got = pipelines.random_bits_tail(r, z, field, False, 0)
    want = pipelines._random_bits_tail_plain(r, z, field, False, 0)
    assert all(torch.equal(u, v) for u, v in zip(got, want))


def test_one_limb_wide_draws_on_the_card(cuda_device):
    """GF(2^31 - 1)'s 20-byte input draws of 1,200 values (past the pool)
    take K1 and the split, not K2, and equal the plain draws."""
    from mpyc_tpu_torch import finfields
    field = finfields.GF(P31)
    key = bytes(range(32))
    n2 = rng.squeeze_mont.launches
    got = rng.KeccakRNG(key, device=cuda_device).field_uniform(field, (1200,))
    want = rng.KeccakRNG(key, device='cpu').field_uniform(field, (1200,))
    assert rng.squeeze_mont.launches == n2
    assert torch.equal(got.data.cpu(), want.data)


def test_colocated_demos_on_the_card(cuda_device):
    """chip_smoke's phase "co-located demos" at small sizes: every runner
    at its defaults and the sizes' checks (run_colocated raises on a
    wrong result); the one-limb K3, K6 and K9 are launched."""
    import chip_smoke
    n3 = pipelines.reshare_mul.by_key[(1, True)]
    n6 = fieldops.mont_pow.by_key[(1, True)]
    chip_smoke.run_colocated(cuda_device, n_santa=8, n_unit=64, n_list=32,
                             n_fld=64)
    assert pipelines.reshare_mul.by_key[(1, True)] > n3
    assert fieldops.mont_pow.by_key[(1, True)] > n6


def test_seven_limb_secure_field_raises_on_the_card(cuda_device):
    """A secure field of seven limbs (a 200-bit prime) runs its products
    on the card through the wide kernels (csrc/wide.cu), and the
    comparison of a seven-limb secure integer (SecInt(170)) through the
    wide K5 (csrc/sgn_wide.cu); what still raises NotImplementedError
    there, with nothing falling back to a plain version, is any field past
    48 limbs."""
    from mpyc_tpu_torch import gmpy
    from mpyc_tpu_torch.parallel.simulator import SimRuntime
    rt = SimRuntime(3, device=cuda_device)
    secfld = rt.SecFld(
        1606938044258990275541962092341162602522202993782792835301259)
    a = rt.input(secfld.array(np.arange(5, dtype=object)), senders=0)
    assert [int(v) for v in rt.output(a * a).value] == [0, 1, 4, 9, 16]
    secint = rt.SecInt(170)
    assert secint.field.array.ctx.L == 7
    x = rt.input(secint.array(np.arange(5, dtype=object)), senders=0)
    n5 = pipelines.sgn_step.by_key[('LT', 170, 7, 0)]
    assert [int(v) for v in rt.output(rt.np_less(x, 2))] == [1, 1, 0, 0, 0]
    assert pipelines.sgn_step.by_key[('LT', 170, 7, 0)] == n5 + 1
    big = rt.SecFld(gmpy.next_prime(1 << 32 * 48))
    with pytest.raises(NotImplementedError, match='limbs'):
        b = rt.input(big.array(np.arange(3, dtype=object)), senders=0)
        rt.output(b * b)


@pytest.mark.parametrize('mode', pipelines.SGN_MODES)
@pytest.mark.parametrize('bits,l,t,m', [(192, 192, 1, 3), (192, 64, 2, 5),
                                        (560, 64, 1, 3), (560, 40, 4, 9)])
def test_wide_sgn_kernel_matches_plain(cuda_device, mode, bits, l, t, m):
    """The wide K5 (csrc/sgn_wide.cu) at seven and 19 limbs (SecInt(192),
    SecInt(560)) on 70 elements in chunks of 32 (three calls in one
    launch, the last on its bucket), bit for bit against its plain
    version chunk by chunk."""
    from mpyc_tpu_torch import sectypes
    st = _state(cuda_device)
    p = sectypes.SecInt(bits, 'cpu').field.modulus
    spec = pipelines.SgnSpec(p, t, m, l, 30, LT=mode == 'LT',
                             EQ=mode == 'EQ')
    a = _parties_shares(70, 37, cuda_device, p, m)
    key = (mode, l, spec.ctx.L, 0) + pipelines.parties_key(t, m)
    n5 = pipelines.sgn_step.by_key[key]
    ctr = np.array([0xFFFFFFFF, 3], np.uint32)
    got, ctr_k = pipelines.sgn_chunks(a, st, ctr, spec, 32)
    assert pipelines.sgn_step.by_key[key] == n5 + 1
    want, ctr_p = pipelines._sgn_chunks_plain(a, st, ctr, spec, 32)
    assert torch.equal(got, want) and list(ctr_k) == list(ctr_p)


@pytest.mark.parametrize('L', range(7, 49))
def test_wide_group_arithmetic_matches_plain(cuda_device, L):
    """The group arithmetic of the wide K5 and K6 (csrc/wide.cuh WGroup)
    at every limb count from 7 to 48, on 1,000 random operand pairs and
    the edges (0, 1, p - 1, a below R of all-ones limbs), bit for bit
    against the plain limb arithmetic: the Montgomery product, the add and
    the subtraction mod p, and (a - b) (a + b) R^-1 (results in registers
    the operands of a product)."""
    from mpyc_tpu_torch import _build, gmpy
    from mpyc_tpu_torch.ops import limb
    p = int(gmpy.next_prime((1 << 32 * L - 1) + (1 << 32 * L - 3)))
    ctx = prime_field_ctx(p)
    g = np.random.default_rng(L)
    n = 1000
    words = g.integers(0, 1 << 32, (2, n, L), dtype=np.uint64)
    words[..., -1] %= p >> 32 * (L - 1)
    vals = [[0, 1, p - 1, p - 1, (1 << 32 * L) - 1],
            [p - 1, p - 1, p - 1, 1, p - 1]]
    for k in range(2):
        for e, v in enumerate(vals[k]):
            words[k, e] = [v >> 32 * i & 0xFFFFFFFF for i in range(L)]
    a, b = (torch.from_numpy(w.astype(np.uint32).view(np.int32)).to(
        cuda_device) for w in words)
    consts = fieldops.wide_field_consts(ctx, cuda_device)
    P, N0 = ctx.p_limbs, ctx.n0inv
    A, B = limb.unstack(a.cpu()), limb.unstack(b.cpu())
    want = [limb.mont_mul(A, B, P, N0), limb.add_mod(A, B, P),
            limb.sub_mod(A, B, P),
            limb.mont_mul(limb.sub_mod(A, B, P), limb.add_mod(A, B, P), P,
                          N0)]
    for op in range(4):
        out = torch.empty_like(a)
        _build.call('mtt_group_op_wide', a.data_ptr(), b.data_ptr(),
                    out.data_ptr(), n, op, consts.data_ptr(), N0, L,
                    _build.stream_of(cuda_device))
        assert torch.equal(out.cpu(), limb.stack(want[op])), op


@pytest.mark.parametrize('bits,L', [(0, 19), (1300, 42)])
def test_wide_sgn_and_pow_at_kb2_shapes(cuda_device, bits, L):
    """At kb2's 19 limbs the wide K5 on its widest call, (3, 68, 19) LT at
    l = 560 as np_sgn makes it (a bucket of 128), and the wide K6 on one
    element at e = p - 2 (its reciprocals' public inverses); at 42 limbs
    K6 so too: each bit for bit against its plain version."""
    import chip_smoke
    from mpyc_tpu_torch import sectypes
    p = chip_smoke.wide_field(bits) if bits == 0 else \
        sectypes.SecInt(bits, 'cpu').field.modulus
    ctx = prime_field_ctx(p)
    assert ctx.L == L
    gen = np.random.default_rng(L)
    z = chip_smoke.random_field(p, (1,), gen)
    assert torch.equal(fieldops.mont_pow(z, p - 2, ctx),
                       fieldops._mont_pow_plain(z, p - 2, ctx))
    if bits == 0:
        st = _state(cuda_device)
        spec = pipelines.SgnSpec(p, 1, 3, 560, 30, LT=True)
        a = chip_smoke.random_field(p, (3, 68), gen)
        err, _ = chip_smoke.sgn_chunks_check(spec, a, st,
                                             np.array([5, 0], np.uint32),
                                             1024)
        assert err == 0


@pytest.mark.parametrize('fuse', [True, False])
@pytest.mark.parametrize('bits', [192, 1300])
def test_wide_reshare_and_tail_match_plain_at_five_parties(cuda_device,
                                                           bits, fuse):
    """The wide K3 at (t, m) = (2, 5) at seven and 42 limbs, and the wide
    K7 at seven, bit for bit against their plain versions."""
    from mpyc_tpu_torch import finfields, sectypes
    st = _state(cuda_device)
    p = sectypes.SecInt(bits, 'cpu').field.modulus
    spec = pipelines.ReshareSpec(p, 2, 5)
    a = _parties_shares(300, 38, cuda_device, p, 5)
    b = _parties_shares(300, 39, cuda_device, p, 5) if fuse else None
    got = pipelines.reshare_mul(a, b, st, (0xFFFFFFFF, 2), spec)
    assert torch.equal(got, pipelines._reshare_mul_plain(
        a, b, st, (0xFFFFFFFF, 2), spec))
    if bits == 192 and fuse:
        field = finfields.GF(p)
        r = _parties_shares(50, 40, cuda_device, p, 5)
        z = _parties_shares(50, 41, cuda_device, p, 5)
        got = pipelines.random_bits_tail(r, z, field, False, 0, 2)
        want = pipelines._random_bits_tail_plain(r, z, field, False, 0, 2)
        assert all(torch.equal(x, y) for x, y in zip(got, want))


def test_kb2_pivots_on_the_card(cuda_device):
    """kb2 (SecInt(560), 19 limbs) stopped after two pivots: its opened
    tableau is the plain exact solver's after as many (run_lp raises
    otherwise); the wide K5 launched."""
    import chip_smoke
    n5 = pipelines.sgn_step.by_key[('LT', 560, 19, 0)]
    res = chip_smoke.run_lp(cuda_device, datasets=(chip_smoke.LP_KB2,),
                            pivots={chip_smoke.LP_KB2: 2})
    assert res['kb2']['pivots'] == 2
    assert pipelines.sgn_step.by_key[('LT', 560, 19, 0)] > n5


def test_wide_kernels_on_the_card(cuda_device):
    """chip_smoke's check of the wide instantiations (csrc/wide.cu): K3,
    K9, K6 at 7, 8, 9, 10, 12 and 42 limbs at the linear algebra's
    shapes, K7 at seven, each bit for bit against its plain version, and
    K5 EQ at l = 31 (check_wide_kernels raises on a difference)."""
    import chip_smoke
    meas = chip_smoke.check_wide_kernels()
    assert all(r['max_abs_err'] == 0 for r in meas.values())
    assert {f'reshare_mul<L={L}, fused>' for L in chip_smoke.LINALG_WIDE} \
        <= set(meas)


def test_linear_algebra_on_the_card(cuda_device):
    """chip_smoke's phase "linear algebra" at small sizes: the small
    runners, ridge regression in a nine-limb field, the 5 x 5
    pseudoinverse and one measurement of multilateration at 12 limbs
    (run_linalg raises on a wrong result); the wide K3, K6 and K9 are
    launched."""
    import chip_smoke
    n3 = pipelines.reshare_mul.by_key[(12, True)]
    n6 = fieldops.mont_pow.by_key[(12, False)]
    n9 = fieldops.field_op.by_key[12]
    chip_smoke.run_linalg(cuda_device, alphas=(6,), datasets=(),
                          pinv=((5, 5, 5, 4, 1),), k_mlat=1)
    assert pipelines.reshare_mul.by_key[(12, True)] > n3
    assert fieldops.mont_pow.by_key[(12, False)] > n6
    assert fieldops.field_op.by_key[12] > n9


# -- parties other than three -------------------------------------------------

def _parties_shares(n, seed, device, p, m):
    """(m, n) canonical field elements (< p) as stored limbs."""
    g = np.random.default_rng(seed)
    L = prime_field_ctx(p).L
    words = g.integers(0, 1 << 32, (m, n, L), dtype=np.uint64)
    words[..., -1] = g.integers(0, p >> 32 * (L - 1), (m, n))
    return limbs_from_numpy(words.astype(np.uint32), device)


@pytest.mark.parametrize('fuse', [True, False])
@pytest.mark.parametrize('t,m', [(1, 4), (2, 5), (3, 7), (4, 9)])
def test_reshare_kernel_matches_plain_at_parties(cuda_device, t, m, fuse):
    st = _state(cuda_device)
    spec = pipelines.ReshareSpec(P, t, m)
    a = _parties_shares(100003, 31, cuda_device, P, m)
    b = _parties_shares(100003, 32, cuda_device, P, m) if fuse else None
    n0 = pipelines.reshare_mul.by_key[(2, fuse, t, m)]
    got = pipelines.reshare_mul(a, b, st, (0xFFFFFFFF, 2), spec)
    assert pipelines.reshare_mul.by_key[(2, fuse, t, m)] == n0 + 1
    want = pipelines._reshare_mul_plain(a, b, st, (0xFFFFFFFF, 2), spec)
    assert torch.equal(got, want)


@pytest.mark.parametrize('t,m', [(1, 4), (2, 5), (4, 9)])
def test_split_recombine_kernel_matches_plain_at_parties(cuda_device, t, m):
    st = _state(cuda_device)
    spec = pipelines.SplitSpec(P, t, m)
    sec = _parties_shares(100003, 33, cuda_device, P, 1)[0].contiguous()
    shares = torch.empty((m, 100003, 2), dtype=torch.int32,
                         device=cuda_device)
    got = pipelines.split_recombine(sec, st, spec, shares=shares)
    want, want_shares = pipelines._split_recombine_plain(sec, st, spec)
    assert torch.equal(got, want) and torch.equal(got, sec)
    assert torch.equal(shares, want_shares)


@pytest.mark.parametrize('mode', pipelines.SGN_MODES)
@pytest.mark.parametrize('t,m', [(1, 4), (2, 5), (4, 9)])
def test_sgn_kernel_matches_plain_at_parties(cuda_device, t, m, mode):
    st = _state(cuda_device)
    spec = pipelines.SgnSpec(P, t, m, 32, 30, LT=mode == 'LT',
                             EQ=mode == 'EQ')
    a = _parties_shares(20011, 34, cuda_device, P, m)
    got = pipelines.sgn_step(a, st, (0xFFFFFFFF, 1), spec)
    assert torch.equal(got, pipelines._sgn_step_plain(a, st, (0xFFFFFFFF, 1),
                                                      spec))


@pytest.mark.parametrize('t,m', [(1, 4), (2, 5), (4, 9)])
def test_random_bits_tail_kernel_matches_plain_at_parties(cuda_device, t,
                                                          m):
    from mpyc_tpu_torch import finfields
    field = finfields.GF(P52)
    ctx = prime_field_ctx(P52)
    r = _parties_shares(100003, 35, cuda_device, P52, m)
    z = _parties_shares(100003, 36, cuda_device, P52, m)
    r[:, ::1000] = 0
    z[:, ::1000] = ctx.encode(np.array([[x + x * x] for x in range(1, m + 1)]),
                              cuda_device)
    got = pipelines.random_bits_tail(r, z, field, False, 6, t)
    want = pipelines._random_bits_tail_plain(r, z, field, False, 6, t)
    assert got[2].item() == want[2].item() == 101
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[0], want[0])


def test_parties_on_the_card(cuda_device):
    """The main path at (2, 5) and (4, 9), the comparison at (2, 5), the
    BNN's selftest through its runner's -M 5, every output checked."""
    import chip_smoke
    from mpyc_tpu_torch.demos import np_bnnmnist
    for t, m in ((2, 5), (4, 9)):
        chip_smoke.run_main_path(cuda_device, n_big=1 << 16, rounds=2, m=m,
                                 t=t)
    chip_smoke.run_compare(cuda_device, n=5000, calls=1, m=5, t=2)
    assert np_bnnmnist.main(['--selftest', '-M', '5']) == 0
