"""Parties other than three: the port's SimRuntime(m) at threshold t
against the JAX package's.

Both runtimes are loaded with one randomness state (the fused reshare key
and counter, the input generator's key and nonce, the PRSS keys and the
program counter). Then at (t, m) = (1, 4), (2, 5) and (3, 7) input,
np_multiply and output give bit-identical shares (the JAX input shares
moved to jax arrays, so that the JAX runtime takes its fused round, as on
its device). At (2, 5) the comparison equals the JAX package's XLA step
(``make_sgn_step``) bit for bit in its three modes on the same padded
shares, state and counter (the JAX runtime on the CPU fuses a comparison
only on fields of at most 32 bits), and np_less, np_equal and np_sgn at
SecInt(32) open to numpy's answers; the split/recombine round returns its
input and its shares are the Horner rows of the JAX stream. At
t = 0 (m = 1 and 2) products are local, as the JAX package's are, and a
comparison raises NotImplementedError. Setting the threshold draws new
PRSS keys for the new (m - t)-subsets, as the JAX runtime's setter does.

Tolerance: exact equality (bit patterns of Montgomery limbs, integers)."""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpyc_tpu import finfields as jfinfields
from mpyc_tpu import sectypes as jsectypes
from mpyc_tpu.models import pipelines as jpipe
from mpyc_tpu.ops import keccak as jkeccak
from mpyc_tpu.ops import rng as jrng
from mpyc_tpu.parallel.simulator import SimRuntime as JaxSim
from mpyc_tpu.runtime import _Options
from mpyc_tpu_torch import finfields
from mpyc_tpu_torch.models import pipelines as tpipe
from mpyc_tpu_torch.ops import keccak as tkeccak
from mpyc_tpu_torch.ops import limb as tlimb
from mpyc_tpu_torch.ops.fieldops import limbs_from_numpy, limbs_to_numpy
from mpyc_tpu_torch.parallel.simulator import SimRuntime as TorchSim


@pytest.fixture(autouse=True)
def one_thread():
    """The plain versions on small tensors gain nothing from torch's
    threads, and the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def jax_runtime_wired_back(monkeypatch):
    """No trace cache written into the repository; the JAX package's own
    runtime wired back after each test (other test files use it)."""
    monkeypatch.setenv('MPYC_TPU_CACHE', '0')
    old = jsectypes.runtime
    yield
    if old is not None:
        old._wire_modules()


P = 18446744073709551427   # SecInt(32)'s field


def _pair(m, t):
    """A JAX SimRuntime(m) at threshold t wired into its type layer, and
    the port's at the same (t, m), loaded with the JAX one's state."""
    jr = JaxSim(m, _Options(threshold=t))
    jr._wire_modules()
    jr.start()
    tr = TorchSim(m, device='cpu', threshold=t)
    tr.start()
    _sync(jr, tr)
    return jr, tr


def _sync(jr, tr):
    tr.load_state(jr._fused_key, np.asarray(jr._fused_ctr if
                                            jr._fused_ctr is not None
                                            else np.zeros(2, np.uint32)),
                  jr._rng.key, jr._rng._nonce, prss_keys=jr._prss_keys,
                  pc=jr._program_counter[0])


def _same(jax_share, torch_share):
    np.testing.assert_array_equal(limbs_to_numpy(torch_share.data),
                                  np.asarray(jax_share.data))


def _on_jax_device(x):
    x.share = x.share.from_data(jnp.asarray(x.share.data))
    return x


@pytest.mark.parametrize('t,m', [(1, 4), (2, 5), (3, 7)])
def test_input_multiply_output_bit_identical(t, m):
    jr, tr = _pair(m, t)
    assert jr.threshold == tr.threshold == t
    js, ts = jr.SecInt(32), tr.SecInt(32)
    n = 300
    gen = np.random.default_rng(40 + m)
    a = gen.integers(-(1 << 31), 1 << 31, n, dtype=np.int64)
    b = gen.integers(-(1 << 31), 1 << 31, n, dtype=np.int64)
    JA, JB = (jr.input(js.array(v.astype(object)))[0] for v in (a, b))
    TA, TB = (tr.input(ts.array(v))[0] for v in (a, b))
    assert TA.share.shape == (m, n)
    _same(JA.share, TA.share)
    _same(JB.share, TB.share)
    JC = jr.np_multiply(_on_jax_device(JA), _on_jax_device(JB))
    TC = tr.np_multiply(TA, TB)
    _same(JC.share, TC.share)
    JC = jr.np_multiply(JC, JB)            # chained: the counter advances
    TC = tr.np_multiply(TC, TB)
    _same(JC.share, TC.share)
    np.testing.assert_array_equal(tr._fused_ctr, np.asarray(jr._fused_ctr))
    got = tr.output(TC)
    assert [int(v) for v in got] == [int(v) for v in jr.output(JC)]
    want = [int(x) * int(y) ** 2 % P for x, y in zip(a, b)]
    assert [int(v) % P for v in got] == want
    jr.shutdown()
    tr.shutdown()


@pytest.fixture(scope='module')
def five_product():
    """At (2, 5): x * y of small integers through both runtimes (the JAX
    input moved to jax arrays), the same shares; the JAX runtime, the
    port's, both products and the plaintext."""
    old = jsectypes.runtime
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('MPYC_TPU_CACHE', '0')
        jr, tr = _pair(5, 2)
        js, ts = jr.SecInt(32), tr.SecInt(32)
        gen = np.random.default_rng(41)
        x = gen.integers(-1, 2, N_CMP)     # x y in [-2, 2): l = 2 bits
        y = gen.integers(-1, 2, N_CMP)
        JX, JY = (_on_jax_device(jr.input(js.array(v.astype(object)))[0])
                  for v in (x, y))
        TX, TY = (tr.input(ts.array(v))[0] for v in (x, y))
        JZ, TZ = jr.np_multiply(JX, JY), tr.np_multiply(TX, TY)
        _same(JZ.share, TZ.share)
        if old is not None:
            old._wire_modules()
        yield jr, tr, JZ, TZ, x * y
        jr.shutdown()
        tr.shutdown()


N_CMP = 100


@pytest.mark.parametrize('mode', tpipe.SGN_MODES)
def test_comparison_matches_the_jax_step_at_five_parties(five_product,
                                                         mode):
    """np_sgn (l = 2) at (2, 5) on a product's shares equals the JAX step
    on the same bucket-padded shares with the JAX runtime's fused state and
    counter."""
    jr, tr, JZ, TZ, z = five_product
    l = 2
    tr._fused_ctr = np.asarray(jr._fused_ctr).copy()
    LT, EQ = mode == 'LT', mode == 'EQ'
    TS = tr.np_sgn(TZ, l=l, LT=LT, EQ=EQ)
    pad = jnp.concatenate([jnp.asarray(JZ.share.data),
                           jnp.zeros((5, 128 - N_CMP, 2), jnp.uint32)],
                          axis=1)
    step = jpipe.make_sgn_step(P, 2, 5, l, 30, LT=LT, EQ=EQ)
    jout, jctr = step(pad, jr._fused_state(), jr._fused_ctr)
    np.testing.assert_array_equal(limbs_to_numpy(TS.share.data),
                                  np.asarray(jout)[:, :N_CMP])
    np.testing.assert_array_equal(tr._fused_ctr, np.asarray(jctr))
    want = {'sgn': np.sign(z), 'LT': z < 0, 'EQ': z == 0}[mode]
    np.testing.assert_array_equal(tr.output(TS), want.astype(np.int64))


def test_comparisons_open_to_numpy():
    """np_less, np_equal and np_sgn at SecInt(32) (a - b within 2^31) at
    (2, 5) on the port alone."""
    tr = TorchSim(5, device='cpu', threshold=2)
    s = tr.SecInt(32)
    gen = np.random.default_rng(42)
    half = 1 << 30
    a = gen.integers(-half, half, 200, dtype=np.int64)
    b = gen.integers(-half, half, 200, dtype=np.int64)
    b[::7] = a[::7]
    A, B = tr.input(s.array(a))[0], tr.input(s.array(b))[1]
    np.testing.assert_array_equal(tr.output(tr.np_less(A, B)), a < b)
    np.testing.assert_array_equal(tr.output(tr.np_equal(A, B)), a == b)
    np.testing.assert_array_equal(tr.output(tr.np_sgn(A - B)),
                                  np.sign(a - b))


def test_split_recombine_round_at_five_parties():
    """The round at (2, 5) returns its input, as the JAX package's
    (``make_split_recombine``) does, and its shares are the Horner rows, at
    x = 1..5, of the coefficients the JAX package's rng.squeeze_mont draws
    from the state: the JAX round's shares."""
    t, m, n = 2, 5, 1000
    hi, lo = jkeccak._absorb_host(bytes(range(100, 132)) + bytes(8))
    st = np.stack([np.array(hi, np.uint32), np.array(lo, np.uint32)])
    g = np.random.default_rng(43)
    sec = np.stack([g.integers(0, 1 << 32, n, dtype=np.uint64),
                    g.integers(0, P >> 32, n, dtype=np.uint64)],
                   -1).astype(np.uint32)
    shares = torch.empty((m, n, 2), dtype=torch.int32)
    got = tpipe.split_recombine(limbs_from_numpy(sec, 'cpu'),
                                tkeccak.state_tensor(st, 'cpu'),
                                tpipe.SplitSpec(P, t, m), shares=shares)
    np.testing.assert_array_equal(limbs_to_numpy(got), sec)
    coefs = np.asarray(jrng.squeeze_mont(jnp.asarray(st), t * n, 16, P))
    c = tlimb.limbs_to_ints(coefs).reshape(t, n)
    s = tlimb.limbs_to_ints(sec)
    rows = tlimb.limbs_to_ints(limbs_to_numpy(shares))
    for j in range(1, m + 1):
        y = np.zeros(n, dtype=object)
        for k in range(t):
            y = (y + c[k]) * j
        assert list(rows[j - 1]) == list((y + s) % P)


@pytest.mark.parametrize('m', [1, 2])
def test_products_at_t0_are_local_as_in_the_jax_package(m):
    """At t = 0 (the default for m = 1 and 2) a product needs no reshare:
    the port's shares and opened values equal the JAX package's, and a
    comparison raises NotImplementedError (the JAX package's co-located
    plane fails there too)."""
    jr, tr = _pair(m, 0)
    assert jr.threshold == tr.threshold == 0
    js, ts = jr.SecInt(32), tr.SecInt(32)
    a = np.arange(-20, 20, dtype=np.int64)
    b = 3 * a + 1
    JA, JB = (jr.input(js.array(v.astype(object)))[0] for v in (a, b))
    TA, TB = (tr.input(ts.array(v))[0] for v in (a, b))
    _same(JA.share, TA.share)
    JC, TC = jr.np_multiply(JA, JB), tr.np_multiply(TA, TB)
    _same(JC.share, TC.share)
    assert tr.output(TC).tolist() == [int(v) for v in jr.output(JC)] == \
        (a * b).tolist()
    TD = TC * TA                            # the operator, chained
    assert tr.output(TD).tolist() == (a * a * b).tolist()
    tf = tr.SecFld(2 ** 8)
    u = tr.input(tf.array(np.array([3, 5, 7], dtype=object)))[0]
    assert [int(v) for v in tr.output(u * u).value] == [5, 17, 21]
    with pytest.raises(NotImplementedError, match='t = 0'):
        tr.np_less(TA, TB)
    with pytest.raises(NotImplementedError, match='t = 0'):
        tr.np_random_bits(finfields.GF(P), 4)
    jr.shutdown()
    tr.shutdown()


def test_threshold_setter_draws_new_prss_keys():
    """Setting the threshold draws a key for each new (m - t)-subset; with
    the JAX runtime's keys and program counter loaded, PRSS values and
    random bits equal the JAX package's share for share at (1, 5) and at
    (2, 5) (``threshold=``)."""
    tr = TorchSim(5, device='cpu')
    assert tr.threshold == 2 and len(tr._prss_keys) == 10
    old = dict(tr._prss_keys)
    tr.threshold = 1
    assert tr.threshold == 1
    assert set(tr._prss_keys) == set(itertools.combinations(range(5), 4))
    assert set(old) == set(itertools.combinations(range(5), 3))
    with pytest.raises(ValueError, match='threshold'):
        tr.threshold = 5
    for t in (1, 2):
        jr = JaxSim(5, _Options())
        jr.threshold = t                   # the JAX setter's new keys
        jr._wire_modules()
        tr = TorchSim(5, device='cpu', threshold=t)
        _sync(jr, tr)
        assert set(tr._prss_keys) == set(jr._prss_keys)
        got = tr._np_randoms(finfields.GF(P), 300, None)
        want = jr._np_randoms(jfinfields.GF(P), 300, None)
        assert got.shape == (5, 300)
        _same(want, got)
        got = tr.np_random_bits(finfields.GF(P), 50)
        want = jr.np_random_bits(jfinfields.GF(P), 50)
        _same(want, got)
        assert tr._program_counter[0] == jr._program_counter[0]
