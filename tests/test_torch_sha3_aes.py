"""The binary-field demos on the port against hashlib, FIPS-197 and the
JAX package's runs of ``demos/np_sha3.py`` and ``demos/np_aes.py``.

Both runtimes at m = 3 (t = 1) on the CPU, the port's loaded with the JAX
runtime's randomness (fused reshare key and counter, input generator,
PRSS keys and program counter: ``load_state``):

* SHA3-256 of 2 messages and SHAKE128 (256 bits) of 3 through the JAX
  demo's functions and the port's runner: the inputs' and the digests'
  shares equal share for share (the JAX package keeps the Keccak state on
  its device plane, where every chi round is one fused GF(4) product),
  and the opened digests equal hashlib's;
* at GF(2^8) on 300 elements, moved to the JAX package's device plane:
  ``x**254`` (AES's addition chain), ``np_to_bits`` and ``np_from_bits``,
  share for share, and opened against the host field;
* AES-128 and AES-256 of 2 blocks: FIPS-197 C.1 and C.3 on block 0, and
  the opened ciphertexts and decryptions equal to the JAX demo's. The
  JAX package keeps AES's small (b, 4, 4) states on its host plane, with
  another reshare stream, so here the opened values are what is held
  equal.

Tolerance: exact equality."""
import hashlib
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpyc_tpu.runtime as jruntime
from mpyc_tpu import sectypes as jsectypes
from mpyc_tpu.parallel.simulator import SimRuntime as JaxSim
from mpyc_tpu.runtime import _Options
from mpyc_tpu_torch.demos import np_aes, np_sha3
from mpyc_tpu_torch.parallel.simulator import SimRuntime as TorchSim


@pytest.fixture(autouse=True)
def one_thread():
    """The plain versions on small tensors gain nothing from torch's
    threads, and the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


DEMOS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), 'demos')


def _load(name, mp):
    """demos/<name>.py as a module of its own, its ``mpc`` the JAX
    runtime that ``mpyc_tpu.runtime.mpc`` points at."""
    spec = importlib.util.spec_from_file_location(
        f'jax_{name}_demo', os.path.join(DEMOS, f'{name}.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope='module')
def jax_demos():
    """The JAX runtime (wired into the JAX package's type layer, its own
    runtime wired back after) and the two demos bound to it."""
    old = jsectypes.runtime
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('MPYC_TPU_CACHE', '0')
        mp.syspath_prepend(DEMOS)       # np_sha3 imports sha3
        mp.delitem(__import__('sys').modules, 'sha3', raising=False)
        jr = JaxSim(3, _Options())
        jr._wire_modules()
        jr.start()
        mp.setattr(jruntime, 'mpc', jr)
        try:
            yield jr, _load('np_sha3', mp), _load('np_aes', mp)
        finally:
            jr.shutdown()
            __import__('sys').modules.pop('sha3', None)
            if old is not None:
                old._wire_modules()


def _port(jr):
    """A port runtime that continues from the JAX runtime's randomness,
    both input generators from a clean point (their pools dropped, so the
    next draw takes a new nonce in both)."""
    jr._fused_state()
    jr._rng._pool = jr._rng._byte_pool = None
    tr = TorchSim(3, device='cpu')
    tr.start()
    tr.load_state(jr._fused_key, np.asarray(jr._fused_ctr), jr._rng.key,
                  jr._rng._nonce, prss_keys=jr._prss_keys,
                  pc=jr._program_counter[0])
    return tr


def _same_shares(jx, tx):
    np.testing.assert_array_equal(
        tx.share.data[..., 0].numpy().view(np.uint32),
        np.asarray(jx.share.data))


@pytest.mark.parametrize('shake,b', [(False, 2), (True, 3)])
def test_sha3_matches_jax_and_hashlib(jax_demos, shake, b):
    jr, jsha3, _ = jax_demos
    tr = _port(jr)
    secfld = tr.SecFld(2)
    msgs = np_sha3.messages(b)
    bits = np.stack([np_sha3.bytes_to_bits(m) for m in msgs])
    jM = jr.input(jsha3.secfld.array(bits), senders=0)
    tM = tr.input(secfld.array(bits), senders=0)
    _same_shares(jM, tM)
    if shake:
        jD = jsha3.np_shake(jM, 256, c=256)
        tD = np_sha3.np_shake(tr, secfld, tM, 256, c=256)
        want = [hashlib.shake_128(m).digest(32) for m in msgs]
    else:
        jD = jsha3.np_sha3(jM, 256)
        tD = np_sha3.np_sha3(tr, secfld, tM, 256)
        want = [hashlib.sha3_256(m).digest() for m in msgs]
    _same_shares(jD, tD)
    np.testing.assert_array_equal(tr._fused_ctr, np.asarray(jr._fused_ctr))
    opened = tr.output(tD, raw=True).value
    assert [np_sha3.bits_to_bytes(opened[i]) for i in range(b)] == want
    jopened = jr.output(jD, raw=True).value
    np.testing.assert_array_equal(opened, np.vectorize(int)(jopened))


def test_gf256_pow_and_bits(jax_demos):
    """x**254, np_to_bits and np_from_bits of 300 GF(2^8) elements: the
    shares equal the JAX runtime's, and the openings the host field's
    inverses and bits."""
    jr, _, jaes = jax_demos
    tr = _port(jr)
    secfld = tr.SecFld(2**8)
    f256 = secfld.field
    vals = np.random.default_rng(5).integers(0, 256, 300).astype(object)
    jx = jr.input(jaes.secfld.array(jaes.f256.array(vals)), senders=0)
    tx = tr.input(secfld.array(f256.array(vals, 'cpu')), senders=0)
    _same_shares(jx, tx)
    # on the JAX package's device plane, as its TPU holds them (its CPU
    # keeps 300 shares on the host plane, which reshares another way)
    jx.share = jx.share.from_data(jnp.asarray(jx.share.data))
    jy, ty = jx**254, tx**254
    _same_shares(jy, ty)
    jb, tb = jr.np_to_bits(jy), tr.np_to_bits(ty)
    _same_shares(jb, tb)
    jz, tz = jr.np_from_bits(jb), tr.np_from_bits(tb)
    _same_shares(jz, tz)
    inv = [int(f256(int(v)) ** 254) for v in vals]
    np.testing.assert_array_equal(tr.output(tz).value, inv)
    np.testing.assert_array_equal(
        tr.output(tb).value, [[(v >> j) & 1 for j in range(8)] for v in inv])


def test_aes_matches_jax_and_fips197(jax_demos):
    """AES-128 and AES-256 of 2 blocks on both runtimes: the opened
    ciphertexts equal, block 0 FIPS-197's C.1 and C.3, and every block
    decrypts back to its plaintext."""
    jr, _, jaes = jax_demos
    tr = _port(jr)
    aes = np_aes.AES(tr)
    nb = 2
    pts = np_aes.plaintexts(nb)
    want = [bytes(b).hex() for b in pts]
    states = np_aes.to_states(pts)
    k128 = np_aes.to_states([list(range(16))])[0]
    k256 = np.swapaxes(np.array(list(range(32)), dtype=object)
                       .reshape(8, 4), 0, 1)
    jp = jr.input(jaes.secfld.array(jaes.f256.array(states)), senders=0)
    tp = tr.input(aes.secfld.array(aes.f256.array(states, 'cpu')),
                  senders=0)
    for key, ct0 in ((k128, np_aes.C1_CT), (k256, np_aes.C3_CT)):
        jk = jr.input(jaes.secfld.array(jaes.f256.array(key)), senders=0)
        tk = tr.input(aes.secfld.array(aes.f256.array(key, 'cpu')),
                      senders=0)
        jK = jaes.key_expansion(jk)
        tK = aes.key_expansion(tk)
        jc, tc = jaes.encrypt(jK, jp), aes.encrypt(tK, tp)
        cts = aes.open_hex(tc)
        assert cts == jaes.open_hex(jc)
        assert cts[0] == ct0
        back = aes.open_hex(aes.decrypt(tK, tc))
        assert back == want == jaes.open_hex(jaes.decrypt(jK, jc))


def test_aes_runner():
    """The runner's main on 2 blocks, AES-128 and AES-256 both ways."""
    tr = TorchSim(3, device='cpu')
    res = np_aes.run(tr, 2)
    assert res['aes128_ct0'] == np_aes.C1_CT
    assert res['aes256_ct0'] == np_aes.C3_CT
    assert all(res[k] for k in ('aes128_ok', 'aes128_dec_ok', 'aes256_ok',
                                'aes256_dec_ok'))
