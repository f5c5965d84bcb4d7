"""Secure matrix products on the port: the field matmul
(``PrimeFieldCtx.matmul``) and ``SimRuntime.np_matmul`` against the JAX
package's.

The field matmul's outputs are canonical Montgomery limbs, so the port's
one algorithm (nibble planes in one int8 GEMM, ``torch._int_mm``, then
bucket sums, carries and a fold) equals each branch of the JAX package's:
its host contraction for tiny products, the unrolled sum for K <= 8, its
scan, and the nibble-plane ``_matmul_mxu`` for 32 <= K <= 70,000. The
sizes below are chosen so that the JAX package takes the branch named.

``np_matmul`` of two secure operands reshares its product. The JAX
package reshares device data through its fused round (``_reshare_fused``)
and host data eagerly from another stream; the share-level checks use
products large enough that it computes on the device, with both
runtimes' randomness loaded alike, and the rest open the outputs against
numpy.

Tolerance: exact equality (bit patterns of Montgomery limbs, integers)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpyc_tpu import sectypes as jsectypes
from mpyc_tpu.ops import fieldops as jfieldops
from mpyc_tpu.parallel.simulator import SimRuntime as JaxSim
from mpyc_tpu.runtime import _Options
from mpyc_tpu_torch.ops import fieldops as tfieldops
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


P46 = 70368744177643            # SecInt(14)'s field, two limbs
P69 = 590295810358705651619     # SecInt(37)'s field (the CNN's), three limbs
P96 = 79228162514264337593543950319   # SecInt(64)'s field, three limbs


def _field_data(p, shape, seed):
    g = np.random.default_rng(seed)
    ctx = tfieldops.prime_field_ctx(p)
    vals = np.array([int(g.integers(0, 1 << 62)) * int(g.integers(1, 1 << 40))
                     for _ in range(int(np.prod(shape)))],
                    dtype=object).reshape(shape)
    return limbs_to_numpy(ctx.encode(vals, 'cpu'))


@pytest.mark.parametrize('p', [P46, P69, P96])
@pytest.mark.parametrize('sa,sb,branch', [
    ((3, 5, 1), (1, 7), 'host'),              # K = 1, tiny
    ((3, 16, 1), (1, 100), 'unrolled'),       # K = 1
    ((3, 16, 7), (7, 40), 'unrolled'),        # K = 7
    ((2, 16, 8), (2, 8, 40), 'unrolled'),     # K = 8, batched
    ((3, 8, 33), (33, 24), 'nibble planes'),  # K = 33
    ((300,), (300, 24), 'nibble planes'),     # K = 300, vector @ matrix
    ((3, 17, 300), (3, 300, 24), 'nibble planes'),  # K = 300, batched
])
def test_field_matmul_matches_jax(p, sa, sb, branch):
    """Every K of {1, 7, 8, 33, 300}, batched and vector operands, two-
    and three-limb fields (the CNN's 69-bit field among them: 24 nibble
    planes, 47 buckets)."""
    a, b = _field_data(p, sa, 1), _field_data(p, sb, 2)
    if len(sa) == 1:                    # numpy's vector promotion
        a = a[None]
    jctx = jfieldops.prime_field_ctx(p)
    tctx = tfieldops.prime_field_ctx(p)
    work = int(np.prod(a.shape[:-1])) * b.shape[-2]
    assert (work <= 4096) == (branch == 'host')
    want = np.asarray(jctx.matmul(jnp.asarray(a), jnp.asarray(b)))
    got = tctx.matmul(limbs_from_numpy(a, 'cpu'), limbs_from_numpy(b, 'cpu'))
    np.testing.assert_array_equal(limbs_to_numpy(got), want)


def test_field_matmul_cuts_rows_into_blocks(monkeypatch):
    """Rows of a product whose GEMM output exceeds the block budget are
    cut into blocks (conv1's at B = 100 into nine): the same bits."""
    a, b = _field_data(P69, (37, 33), 7), _field_data(P69, (33, 5), 8)
    ctx = tfieldops.prime_field_ctx(P69)
    ta, tb = limbs_from_numpy(a, 'cpu'), limbs_from_numpy(b, 'cpu')
    whole = ctx.matmul(ta, tb)
    monkeypatch.setattr(tfieldops, '_MATMUL_BLOCK_BYTES', 64 * 9 * 5 * 4 * 8)
    np.testing.assert_array_equal(limbs_to_numpy(ctx.matmul(ta, tb)),
                                  limbs_to_numpy(whole))
    jctx = jfieldops.prime_field_ctx(P69)
    np.testing.assert_array_equal(
        limbs_to_numpy(whole),
        np.asarray(jctx.matmul(jnp.asarray(a), jnp.asarray(b))))


def test_field_matmul_cuts_long_contractions(monkeypatch):
    """Above the planes' exactness limit the contraction is cut into
    chunks whose products are added: the same bits."""
    a, b = _field_data(P46, (5, 40), 3), _field_data(P46, (40, 6), 4)
    ctx = tfieldops.prime_field_ctx(P46)
    ta, tb = limbs_from_numpy(a, 'cpu'), limbs_from_numpy(b, 'cpu')
    whole = ctx.matmul(ta, tb)
    monkeypatch.setattr(tfieldops, '_MATMUL_K_MAX', 16)
    assert np.array_equal(limbs_to_numpy(ctx.matmul(ta, tb)),
                          limbs_to_numpy(whole))


@pytest.fixture
def runtimes():
    """A JAX SimRuntime (wired into the JAX package's type layer, its own
    runtime wired back after) and the port's, with one randomness state."""
    old = jsectypes.runtime
    jr = JaxSim(3, _Options())
    jr._wire_modules()
    jr.start()
    tr = TorchSim(3, device='cpu')
    tr.start()
    tr.load_state(jr._fused_key, np.zeros(2, np.uint32), jr._rng.key,
                  jr._rng._nonce)
    try:
        yield jr, tr
    finally:
        jr.shutdown()
        tr.shutdown()
        if old is not None:
            old._wire_modules()


def _same(jax_share, torch_share):
    np.testing.assert_array_equal(limbs_to_numpy(torch_share.data),
                                  np.asarray(jax_share.data))


def _on_jax_device(x):
    x.share = x.share.from_data(jnp.asarray(x.share.data))
    return x


def test_np_matmul_reshares_as_the_jax_package(monkeypatch, runtimes):
    """secure @ secure (16 x 33 @ 33 x 24) and public-valued secure
    arrays on either side: the product's shares after the fused reshare
    and the call counter equal the JAX package's; the outputs open to
    numpy's product."""
    monkeypatch.setenv('MPYC_TPU_CACHE', '0')
    jr, tr = runtimes
    js, ts = jr.SecInt(14), tr.SecInt(14)
    g = np.random.default_rng(5)
    x = g.integers(-60, 60, (16, 33))
    w = g.integers(-1, 2, (33, 24))
    JX, JW = (_on_jax_device(jr.input(js.array(v.astype(object)))[0])
              for v in (x, w))
    TX, TW = (tr.input(ts.array(v))[0] for v in (x, w))
    _same(JX.share, TX.share)
    cases = [(JX @ JW, TX @ TW),
             (JX @ js.array(w.astype(object)), TX @ ts.array(w)),
             (js.array(x.astype(object)) @ JW, ts.array(x) @ TW)]
    for J, T in cases:
        _same(J.share, T.share)
        assert T.shape == (16, 24)
        np.testing.assert_array_equal(tr.output(T), x @ w)
    np.testing.assert_array_equal(tr._fused_ctr, np.asarray(jr._fused_ctr))
    assert tr._fused_ctr.tolist() == [3, 0]


def test_np_matmul_shapes_and_public_operands():
    """numpy's matmul semantics on the logical shapes, opened: vectors on
    either side, a batch on one side, public integer arrays (a local
    product: no reshare, the counter stays), and two public-valued secure
    arrays (one reshare)."""
    rt = TorchSim(3, device='cpu')
    secint = rt.SecInt(14)
    g = np.random.default_rng(6)
    x = g.integers(-50, 50, (2, 5, 7))
    w = g.integers(-50, 50, (7, 3))
    v = g.integers(-50, 50, 7)
    X, W, V = (rt.input(secint.array(a))[0] for a in (x, w, v))
    assert rt._fused_ctr.tolist() == [0, 0]
    np.testing.assert_array_equal(rt.output(X @ w), x @ w)
    np.testing.assert_array_equal(rt.output(x @ W), x @ w)
    np.testing.assert_array_equal(rt.output(rt.np_matmul(v, W)), v @ w)
    assert rt._fused_ctr.tolist() == [0, 0]
    np.testing.assert_array_equal(rt.output(X @ W), x @ w)
    np.testing.assert_array_equal(rt.output(V @ W), v @ w)
    np.testing.assert_array_equal(rt.output(X @ V), x @ v)
    np.testing.assert_array_equal(rt.output(V @ V), v @ v)
    P = secint.array(x) @ secint.array(w)
    assert P.share.shape == (3, 2, 5, 3)
    np.testing.assert_array_equal(rt.output(P), x @ w)
    assert rt._fused_ctr.tolist() == [5, 0]
