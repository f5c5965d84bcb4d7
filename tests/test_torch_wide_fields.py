"""Wide prime fields (7 to 48 limbs) on the port, against the JAX package.

A JAX ``SimRuntime(3)`` and the port's take the same values in a signed
secure field ``SecFld(min_order=2^b)`` of 7, 9, 12 and 33 limbs (b = 200,
270, 360, 1,030: ridge regression's fields are 7 to 12 limbs, and 42 on
student-mat; multilateration's 12), from the same randomness state
(``load_state``; the JAX shares moved to jax arrays, so its SimRuntime
takes the fused round): the input shares, a product (one fused reshare
round: on the card the wide K3 of ``csrc/wide.cu``), a reciprocal (a
PRSS draw reduced into the field, a reshare, an opening, a public
inverse: the wide K9 and K6) and the openings equal the JAX package's
share for share (the JAX package reshares the reciprocal's small product
on its host plane, from another stream; its opening is the same), and
the reciprocals are the values' inverses mod p. At
nine limbs the reshare step itself is held against the JAX package's XLA
step (``make_reshare_step``) on the same shares, state and counter. The
JAX package compiles its step for each L on the CPU (about a minute at
33 limbs), so n stays at five.

On the CPU the port runs the kernels' plain versions; from seven limbs
on their Montgomery products are whole-vector operations on 16-bit
digits (``ops/limb.py _mont_mul_vec``), held against Python ints in
``tests/test_torch_kernels_host.py``.

Tolerance: exact equality.
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
from mpyc_tpu_torch.models import pipelines as tpipe
from mpyc_tpu_torch.ops import keccak as tkeccak
from mpyc_tpu_torch.ops.fieldops import limbs_from_numpy, limbs_to_numpy
from mpyc_tpu_torch.parallel.simulator import SimRuntime as TorchSim

BITS = {7: 200, 9: 270, 12: 360, 33: 1030}


@pytest.fixture(autouse=True)
def one_thread():
    """The plain versions on small tensors gain nothing from torch's
    threads, and the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def jr():
    """A JAX SimRuntime(3), wired into the JAX package's type layer (its
    own runtime wired back after)."""
    old = jsectypes.runtime
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('MPYC_TPU_CACHE', '0')
        rt = JaxSim(3, _Options())
        rt._wire_modules()
        rt.start()
        try:
            yield rt
        finally:
            rt.shutdown()
            if old is not None:
                old._wire_modules()


def _port(jr):
    """A port runtime continuing from the JAX runtime's randomness."""
    jr._fused_state()
    jr._rng._pool = jr._rng._byte_pool = None
    tr = TorchSim(3, device='cpu')
    tr.load_state(jr._fused_key, np.asarray(
        jr._fused_ctr if jr._fused_ctr is not None else np.zeros(2)),
        jr._rng.key, jr._rng._nonce, prss_keys=jr._prss_keys,
        pc=jr._program_counter[0])
    return tr


def _same(jx, tx):
    np.testing.assert_array_equal(limbs_to_numpy(tx.share.data),
                                  np.asarray(jx.share.data))


def _on_device(x):
    x.share = x.share.from_data(jnp.asarray(x.share.data))
    return x


@pytest.mark.parametrize('L', sorted(BITS))
def test_input_product_reciprocal_output_bit_identical(jr, L):
    tr = _port(jr)
    kw = dict(min_order=1 << BITS[L], signed=True)
    jf, tf = jr.SecFld(**kw), tr.SecFld(**kw)
    p = tf.field.modulus
    assert p == jf.field.modulus and tf.field.array.ctx.L == L
    v = np.array([5, -7, 123456, 3, -1], dtype=object)
    w = np.array([2, 9, -4, 11, 13], dtype=object)
    ja = _on_device(jr.input(jf.array(v), senders=0))
    jb = _on_device(jr.input(jf.array(w), senders=1))
    ta, tb = tr.input(tf.array(v), senders=0), tr.input(tf.array(w),
                                                         senders=1)
    _same(ja, ta)
    _same(jb, tb)
    jc, tc = ja * jb, ta * tb
    _same(jc, tc)
    np.testing.assert_array_equal(tr._fused_ctr, np.asarray(jr._fused_ctr))
    # the JAX package reshares the reciprocal's small host product r c
    # eagerly, from its input generator (its CPU plane): the opened r c,
    # and so the reciprocal's shares, are the same
    jq, tq = jr.reciprocal(jc), tr.reciprocal(tc)
    _same(jq, tq)
    got = [int(x) for x in tr.output(tq).value]
    assert got == [int(x) for x in jr.output(jq).value]
    assert all(g * int(a) * int(b) % p == 1 for g, a, b in zip(got, v, w))
    assert [int(x) for x in tr.output(tc).signed()] == \
        [int(a) * int(b) for a, b in zip(v, w)]


@pytest.mark.parametrize('fuse', [True, False])
def test_reshare_step_matches_the_jax_xla_step_at_nine_limbs(jr, fuse):
    """The wide field's reshare round (the plain version of the wide K3)
    on the same (3, 64, 9) shares, state and a counter whose low word
    wraps: the JAX package's XLA step's shares and counter."""
    tr = TorchSim(3, device='cpu')
    p = tr.SecFld(min_order=1 << BITS[9]).field.modulus
    g = np.random.default_rng(3)
    words = g.integers(0, 1 << 32, (2, 3, 64, 9), dtype=np.uint64)
    words[..., -1] = g.integers(0, p >> 32 * 8, (2, 3, 64))
    a, b = words.astype(np.uint32)
    hi, lo = jkeccak._absorb_host(bytes(range(7, 39)) + bytes(8))
    st = np.stack([np.array(hi, np.uint32), np.array(lo, np.uint32)])
    ctr = np.array([0xFFFFFFFF, 2], np.uint32)
    jstep = jpipe.make_reshare_step(p, 1, 3, fuse_mul=fuse)
    tstep = tpipe.make_reshare_step(p, 1, 3, fuse)
    jargs = (jnp.asarray(a), jnp.asarray(b)) if fuse else (jnp.asarray(a),)
    targs = (limbs_from_numpy(a, 'cpu'), limbs_from_numpy(b, 'cpu')) \
        if fuse else (limbs_from_numpy(a, 'cpu'),)
    jout, jctr = jstep(*jargs, jnp.asarray(st), jnp.asarray(ctr))
    tout, tctr = tstep(*targs, tkeccak.state_tensor(st, 'cpu'), ctr)
    np.testing.assert_array_equal(limbs_to_numpy(tout), np.asarray(jout))
    np.testing.assert_array_equal(tctr, np.asarray(jctr))
    assert list(tctr) == [0, 3]
