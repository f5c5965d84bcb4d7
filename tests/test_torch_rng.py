"""Port's field randomness (mpyc_tpu_torch.ops.rng) against the JAX
package's (mpyc_tpu.ops.rng), on the same keys and states.

Tolerance: exact equality (bit patterns of Montgomery limbs)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpyc_tpu import finfields as jfinfields
from mpyc_tpu.ops import keccak as jkeccak
from mpyc_tpu.ops import rng as jrng
from mpyc_tpu_torch import finfields as tfinfields
from mpyc_tpu_torch.ops import keccak as tkeccak
from mpyc_tpu_torch.ops import rng as trng
from mpyc_tpu_torch.ops.fieldops import limbs_to_numpy, prime_field_ctx


@pytest.fixture(autouse=True)
def one_thread():
    """The plain versions on small tensors gain nothing from torch's
    threads, and the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


P64 = 18446744073709551427   # SecInt(32)'s field
P89 = (1 << 89) - 1
KEY = bytes(range(32))


def _state(seed: bytes) -> np.ndarray:
    hi, lo = jkeccak._absorb_host(seed + bytes(8))
    return np.stack([np.array(hi, np.uint32), np.array(lo, np.uint32)])


@pytest.mark.parametrize('p', [P64, P89])
def test_draw_widths_match_jax(p):
    assert trng.fused_draw_bytes(p) == jrng.fused_draw_bytes(p)
    for n, l in ((1, 16), (10, 16), (11, 16), (4096, 24), (100, 200)):
        assert trng.blocks_needed(n, l) == jrng.blocks_needed(n, l)


@pytest.mark.parametrize('p,l_bytes', [(P64, 16), (P64, 24), (P89, 20),
                                       (P89, 28)])
@pytest.mark.parametrize('n,base,lane', [(1000, 0, 19), (77, 5, 5)])
def test_squeeze_mont_matches_jax(p, l_bytes, n, base, lane):
    st = _state(b'squeeze' * 5)
    want = np.asarray(jrng.squeeze_mont(jnp.asarray(st), n, l_bytes, p,
                                        ctr_lane=lane, base=base))
    got = trng.squeeze_mont(tkeccak.state_tensor(st, 'cpu'), n, l_bytes, p,
                            lane, base)
    np.testing.assert_array_equal(limbs_to_numpy(got), want)


def test_words_to_elements_matches_jax():
    st = _state(b'w' * 40)
    blocks = np.asarray(jkeccak._squeeze_ctr(jnp.asarray(st), 64, 19))
    for n, l, L in ((600, 16, 2), (400, 24, 2), (300, 20, 3)):
        want = np.asarray(jrng.words_to_elements(blocks, n, l, L))
        got = trng.words_to_elements(
            torch.from_numpy(blocks.view(np.int32).copy()), n, l, L)
        np.testing.assert_array_equal(limbs_to_numpy(got), want)


@pytest.mark.parametrize('p', [P64, P89])
@pytest.mark.parametrize('shape', [(1, 40), (3, 100), (4096,), (1, 8192)])
def test_field_uniform_matches_jax(p, shape):
    """Pooled draws (<= 64 blocks) and larger draws, which squeeze straight
    into the field (K2 on the card), give the JAX package's elements; the
    nonce advances alike."""
    jr, tr = jrng.KeccakRNG(KEY), trng.KeccakRNG(KEY, device='cpu')
    jf, tf = jfinfields.GF(p), tfinfields.GF(p)
    for _ in range(2):
        want = np.asarray(jr.field_uniform(jf, shape).data)
        got = tr.field_uniform(tf, shape)
        assert got.shape == shape
        np.testing.assert_array_equal(limbs_to_numpy(got.data), want)
    assert tr._nonce == jr._nonce


def test_field_uniform_mont_ints_matches_jax():
    jr, tr = jrng.KeccakRNG(KEY), trng.KeccakRNG(KEY, device='cpu')
    jc, tc = jfinfields.GF(P64).array.ctx, prime_field_ctx(P64)
    for n in (3, 200, 1500):
        assert list(tr.field_uniform_mont_ints(tc, n)) == \
            list(jr.field_uniform_mont_ints(jc, n))


def test_load_continues_a_jax_stream():
    jr = jrng.KeccakRNG(KEY)
    jr.field_uniform(jfinfields.GF(P64), (500,))
    tr = trng.KeccakRNG(device='cpu')
    tr.load(jr.key, jr._nonce)
    want = np.asarray(jr.field_uniform(jfinfields.GF(P64), (700,)).data)
    got = tr.field_uniform(tfinfields.GF(P64), (700,))
    np.testing.assert_array_equal(limbs_to_numpy(got.data), want)


def test_generator_defaults_to_the_card():
    """No device named: the card, or an error where torch sees none."""
    if torch.cuda.is_available():
        assert trng.KeccakRNG(KEY).device.type == 'cuda'
    else:
        with pytest.raises(RuntimeError, match='no card'):
            trng.KeccakRNG(KEY)


# Fields whose protocol draws are not a whole number of words: SecInt(14)'s
# (46 bits: 6 + 16 = 22 bytes, two limbs), SecInt(20)'s (52 bits: 23 bytes)
# and a 70-bit one (9 + 16 = 25 bytes, three limbs)
P46 = 70368744177643
P52 = tfinfields.find_prime_root(52, n=2)[0]
P70 = tfinfields.find_prime_root(70, n=2)[0]


@pytest.mark.parametrize('n,l,L', [(300, 22, 2), (200, 23, 2), (150, 25, 3),
                                   (30, 170, 2), (20, 171, 3)])
def test_byte_granular_words_to_elements_matches_jax(n, l, L):
    """Draws that are not word-aligned, within a block (l <= 168) and over
    whole blocks (l > 168)."""
    st = _state(b'b' * 40)
    blocks = np.asarray(jkeccak._squeeze_ctr(jnp.asarray(st), 64, 19))
    want = np.asarray(jrng.words_to_elements(blocks, n, l, L))
    got = trng.words_to_elements(
        torch.from_numpy(blocks.view(np.int32).copy()), n, l, L)
    np.testing.assert_array_equal(limbs_to_numpy(got), want)


@pytest.mark.parametrize('p', [P46, P52, P70])
@pytest.mark.parametrize('shape', [(1, 40), (3, 100), (2048,), (4, 2000)])
def test_unaligned_field_uniform_matches_jax(p, shape):
    """The pool (<= 64 blocks: (1, 40), (3, 100)) and the path above it,
    where the blocks are squeezed (K1 on the card) and split, as the JAX
    package does: the same elements and nonces."""
    assert (((p - 1).bit_length() + 7 >> 3) + 16) % 4
    jr, tr = jrng.KeccakRNG(KEY), trng.KeccakRNG(KEY, device='cpu')
    jf, tf = jfinfields.GF(p), tfinfields.GF(p)
    for _ in range(2):
        want = np.asarray(jr.field_uniform(jf, shape).data)
        got = tr.field_uniform(tf, shape)
        assert got.shape == shape
        np.testing.assert_array_equal(limbs_to_numpy(got.data), want)
    assert tr._nonce == jr._nonce
