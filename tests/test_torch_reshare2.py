"""The GF(2^d) reshare round (``make_reshare2_step``) on the port, against
the JAX package's XLA step on the CPU.

Both steps take the same party-stacked shares, absorbed SHAKE128 state and
call counter: in both modes (the reshare alone, and with the carry-less
product first), at d = 2 (GF(4), SHA3's chi) and d = 8 (AES's field), at a
bucket of 64 elements and at one of 1,024, whose 3,072 one-byte draws
straddle 168-byte blocks (the second sender's first draw is byte 16 of
block 6), and with the counter's low word about to carry. Outputs and
the advanced counter agree bit for bit. Also the co-located plane's
product (``SimRuntime._mul_reshare2_fused``) against the JAX runtime's,
after ``load_state``, and the round's stream against K1's plain version.

Tolerance: exact equality (field elements' bit patterns)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpyc_tpu import finfields as jff
from mpyc_tpu import gfpx as jgfpx
from mpyc_tpu import sectypes as jsectypes
from mpyc_tpu.models import pipelines as jpipelines
from mpyc_tpu.parallel.simulator import SimRuntime as JaxSim
from mpyc_tpu.runtime import _Options
from mpyc_tpu_torch.models import pipelines
from mpyc_tpu_torch.ops import keccak
from mpyc_tpu_torch.parallel.simulator import SimRuntime as TorchSim


@pytest.fixture(autouse=True)
def one_thread():
    """The plain versions on small tensors gain nothing from torch's
    threads, and the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


MODULI = {2: 0b111, 8: 0x11B}


def _elements(d, shape, seed):
    g = np.random.default_rng(seed)
    return g.integers(0, 1 << d, shape, dtype=np.uint64).astype(np.uint32)


def _torch(v):
    return torch.from_numpy(v.view(np.int32).copy()).unsqueeze(-1)


@pytest.mark.parametrize('d', sorted(MODULI))
@pytest.mark.parametrize('fused', [False, True])
@pytest.mark.parametrize('n', [64, 1024])
def test_step_matches_jax(d, fused, n):
    md = MODULI[d]
    a = _elements(d, (3, n), d * n)
    b = _elements(d, (3, n), d * n + 1)
    state = keccak._absorb_host(bytes(range(32)) + bytes(8))
    ctr = np.array([0xFFFFFFFF, 6], np.uint32)
    jstep = jpipelines.make_reshare2_step(md, 1, 3, fuse_mul=fused)
    tstep = pipelines.make_reshare2_step(md, 1, 3, fuse_mul=fused)
    st = keccak.state_tensor(state, 'cpu')
    if fused:
        jout, jctr = jstep(jnp.asarray(a), jnp.asarray(b),
                           jnp.asarray(state), jnp.asarray(ctr))
        tout, tctr = tstep(_torch(a), _torch(b), st, ctr)
    else:
        jout, jctr = jstep(jnp.asarray(a), jnp.asarray(state),
                           jnp.asarray(ctr))
        tout, tctr = tstep(_torch(a), st, ctr)
    np.testing.assert_array_equal(tout[..., 0].numpy().view(np.uint32),
                                  np.asarray(jout))
    np.testing.assert_array_equal(tctr, np.asarray(jctr))
    assert tctr.tolist() == [0, 7]


@pytest.mark.parametrize('d', sorted(MODULI))
def test_stream_is_k1s(d):
    """The round's stream: the blocks of the state with the counter in
    lane 4, as K1's plain version squeezes them, and as many as the draws
    need (168 one-byte draws a block). On zero shares row 0 of the round
    is C, the XOR of an element's three draws from that stream; a general
    product is spent only on the fused local products."""
    spec = pipelines.Reshare2Spec(MODULI[d], 1, 3)
    st = keccak.state_tensor(keccak._absorb_host(bytes(40)), 'cpu')
    n = 1024
    blocks = pipelines._reshare2_stream_plain(st, (3, 4), n, spec)
    assert blocks.shape == (-(-3 * n // 168), 42) == (spec.n_blocks(n), 42)
    want = keccak._keccak_ctr_plain(pipelines._nonce_state(st, (3, 4)),
                                    spec.n_blocks(n), 19)
    assert torch.equal(blocks, want)
    draws = want.contiguous().view(torch.uint8)[:, :168].reshape(-1)
    draws = draws[:3 * n].to(torch.int32).reshape(3, n) & ((1 << d) - 1)
    zero = torch.zeros((3, n, 1), dtype=torch.int32)
    out = pipelines.reshare2(zero, None, st, (3, 4), spec)
    assert torch.equal(out[0, :, 0], draws[0] ^ draws[1] ^ draws[2])
    assert spec.field_ops(True) == 3 and spec.field_ops(False) == 0


@pytest.mark.parametrize('modulus', [0b111, 0x11B, (1 << 32) | 0x8D])
def test_constants_at_three_parties(modulus):
    """K8's constants at (t, m) = (1, 3) equal the JAX package's: the
    Lagrange coefficients at 0 of the points 1, x, x + 1 (all 1 in
    characteristic 2, which the kernel's bound in chip_smoke.py counts
    on) and the party points as elements."""
    from mpyc_tpu import thresha as jthresha
    spec = pipelines.Reshare2Spec(modulus, 1, 3)
    jfield = jff.GF(jgfpx.GFpX(2)(modulus))
    want = jthresha._recombination_vector(jfield, (1, 2, 3), 0)
    assert [int(c) for c in spec.lag] == [int(c) for c in want] == [1, 1, 1]
    assert spec.xs == [int(jfield(j).value) for j in (1, 2, 3)] == [1, 2, 3]


@pytest.fixture(scope='module')
def runtimes():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('MPYC_TPU_CACHE', '0')
        old = jsectypes.runtime
        jr = JaxSim(3, _Options())
        jr._wire_modules()
        jr.start()
        tr = TorchSim(3, device='cpu')
        tr.start()
        try:
            yield jr, tr
        finally:
            jr.shutdown()
            tr.shutdown()
            if old is not None:
                old._wire_modules()


@pytest.mark.parametrize('d', sorted(MODULI))
def test_runtime_product_matches_jax(runtimes, d):
    """A product of two (3, 5, 40) share arrays on the co-located planes,
    padded to the bucket of 256, then two more chained on the same
    counter."""
    jr, tr = runtimes
    jr._fused_state()
    tr.load_state(jr._fused_key, np.asarray(jr._fused_ctr), jr._rng.key,
                  jr._rng._nonce)
    jfield = jff.GF(jgfpx.GFpX(2)(MODULI[d]))
    tfield = pipelines.Reshare2Spec(MODULI[d], 1, 3).field
    a = _elements(d, (3, 5, 40), 11 + d)
    b = _elements(d, (3, 5, 40), 12 + d)
    ja, jb = jfield.array.from_data(jnp.asarray(a)), \
        jfield.array.from_data(jnp.asarray(b))
    ta = tfield.array.from_data(_torch(a.reshape(-1)).reshape(3, 5, 40, 1))
    tb = tfield.array.from_data(_torch(b.reshape(-1)).reshape(3, 5, 40, 1))
    for _ in range(3):
        jc = jr._mul_reshare2_fused(ja, jb)
        tc = tr._mul_reshare2_fused(ta, tb)
        np.testing.assert_array_equal(
            tc.data[..., 0].numpy().view(np.uint32), np.asarray(jc.data))
        ja, ta = jc, tc
    np.testing.assert_array_equal(tr._fused_ctr, np.asarray(jr._fused_ctr))
