"""Wide prime fields (7 to 48 limbs) at parties other than three, on the
port against the JAX package and Python.

At nine limbs the reshare round (the plain version of the wide K3,
``csrc/wide.cu``) at (t, m) = (2, 5) and (4, 9), fused and not, equals the
JAX package's XLA step (``make_reshare_step(p, t, m, fuse_mul)``) on the
same shares, state and a counter whose low word wraps, as
``tests/test_torch_wide_fields.py`` holds it at (1, 3). Then a
``SimRuntime(5, threshold=2)`` of each package, loaded with one
randomness state, at SecInt(192) (seven limbs): the input shares and a
product's equal share for share (the JAX shares moved to jax arrays, so
that its SimRuntime takes its fused round), the product opens to
Python's; ``<`` opens to Python's and to the JAX package's; the random
bits (PRSS draws and the tail around their inverse square root: the wide
K7 on the card) open to the JAX package's bits, each 0 or 1. And ridge
regression's runner solves a synthetic set of d = 3 features at accuracy
4 in a seven-limb field at (2, 5), its (adj A) B and det A equal to a
plain integer Bareiss elimination's (the runner's own check, in Python
ints) and its train error within 0.2 of a plain ridge solve's.

Tolerance: exact equality (the train error by the JAX demo's bound, 0.2).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpyc_tpu import sectypes as jsectypes
from mpyc_tpu.models import pipelines as jpipe
from mpyc_tpu.ops import keccak as jkeccak
from mpyc_tpu.parallel.simulator import SimRuntime as JaxSim
from mpyc_tpu.runtime import _Options
from mpyc_tpu_torch.demos import ridgeregression as ridge
from mpyc_tpu_torch.models import pipelines as tpipe
from mpyc_tpu_torch.ops import keccak as tkeccak
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


def _pair(m, t):
    """A JAX SimRuntime(m) at threshold t wired into its type layer, and
    the port's at the same (t, m), loaded with the JAX one's state."""
    jr = JaxSim(m, _Options(threshold=t))
    jr._wire_modules()
    jr.start()
    tr = TorchSim(m, device='cpu', threshold=t)
    tr.start()
    tr.load_state(jr._fused_key, np.asarray(jr._fused_ctr if
                                            jr._fused_ctr is not None
                                            else np.zeros(2, np.uint32)),
                  jr._rng.key, jr._rng._nonce, prss_keys=jr._prss_keys,
                  pc=jr._program_counter[0])
    return jr, tr


def _same(jax_share, torch_share):
    np.testing.assert_array_equal(limbs_to_numpy(torch_share.data),
                                  np.asarray(jax_share.data))


def _on_jax_device(x):
    x.share = x.share.from_data(jnp.asarray(x.share.data))
    return x


@pytest.mark.parametrize('fuse', [True, False])
@pytest.mark.parametrize('t,m', [(2, 5), (4, 9)])
def test_wide_reshare_step_matches_the_jax_xla_step(t, m, fuse):
    """The nine-limb reshare round at (t, m) on the same (m, 64, 9)
    shares, state and counter: the JAX package's XLA step's shares and
    counter."""
    tr = TorchSim(3, device='cpu')
    p = tr.SecFld(min_order=1 << 270).field.modulus
    g = np.random.default_rng(t + m)
    words = g.integers(0, 1 << 32, (2, m, 8, 9), dtype=np.uint64)
    words[..., -1] = g.integers(0, p >> 32 * 8, (2, m, 8))
    a, b = words.astype(np.uint32)
    hi, lo = jkeccak._absorb_host(bytes(range(9, 41)) + bytes(8))
    st = np.stack([np.array(hi, np.uint32), np.array(lo, np.uint32)])
    ctr = np.array([0xFFFFFFFF, 4], np.uint32)
    jstep = jpipe.make_reshare_step(p, t, m, fuse_mul=fuse)
    tstep = tpipe.make_reshare_step(p, t, m, fuse)
    jargs = (jnp.asarray(a), jnp.asarray(b)) if fuse else (jnp.asarray(a),)
    targs = (limbs_from_numpy(a, 'cpu'), limbs_from_numpy(b, 'cpu')) \
        if fuse else (limbs_from_numpy(a, 'cpu'),)
    jout, jctr = jstep(*jargs, jnp.asarray(st), jnp.asarray(ctr))
    tout, tctr = tstep(*targs, tkeccak.state_tensor(st, 'cpu'), ctr)
    np.testing.assert_array_equal(limbs_to_numpy(tout), np.asarray(jout))
    np.testing.assert_array_equal(tctr, np.asarray(jctr))
    assert list(tctr) == [0, 5]


def test_seven_limbs_at_five_parties_match_jax_and_python():
    """SimRuntime(5, threshold=2) at SecInt(192): input and product share
    for share with the JAX package's, the product and < opened to
    Python's and the JAX package's, the random bits opened to the JAX
    package's."""
    jr, tr = _pair(5, 2)
    js, ts = jr.SecInt(192), tr.SecInt(192)
    assert ts.field.array.ctx.L == 7 and ts.field.modulus % 4 == 3
    a = np.array([3, -(1 << 90), 0, 123456789 << 60, -7], dtype=object)
    b = np.array([-2, 1 << 80, 5, 99 << 20, -7], dtype=object)
    JA, JB = (jr.input(js.array(v))[0] for v in (a, b))
    TA, TB = (tr.input(ts.array(v))[0] for v in (a, b))
    _same(JA.share, TA.share)
    _same(JB.share, TB.share)
    JC = jr.np_multiply(_on_jax_device(JA), _on_jax_device(JB))
    TC = tr.np_multiply(TA, TB)
    _same(JC.share, TC.share)
    got = [int(v) for v in tr.output(TC)]
    assert got == [int(v) for v in jr.output(JC)]
    assert got == [int(x) * int(y) for x, y in zip(a, b)]
    lt = [int(v) for v in tr.output(tr.np_less(TA, TB))]
    assert lt == [int(x < y) for x, y in zip(a, b)]
    assert lt == [int(v) for v in jr.output(jr.np_less(JA, JB))]
    jr, tr = _pair(5, 2)
    jbits = jr.output(jr.np_random_bits(js.field, 40))
    tbits = tr.output(tr.np_random_bits(ts.field, 40))
    assert [int(v) for v in tbits.value] == [int(v) for v in jbits.value]
    assert set(int(v) for v in tbits.value) <= {0, 1}


def test_ridgeregression_at_five_parties_in_a_seven_limb_field():
    """Ridge regression's synthetic set (60 samples, d = 3) at accuracy
    4 at (t, m) = (2, 5) in a seven-limb field: the runner's exact check
    against a plain integer Bareiss and its train error bound."""
    rt = TorchSim(5, device='cpu', threshold=2)
    res = ridge.run(rt, 0, (4,), n=60, d=3, e=1, field_bits=200, seed=2,
                    out=lambda s: None)
    sol = res['solves'][4]
    assert sol['L'] == 7 and sol['exact'] and sol['ok']
