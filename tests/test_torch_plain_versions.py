"""The kernels' plain versions are plain PyTorch on every device: none of
them reaches a kernel's wrapper, so on the card a kernel is held against
plain PyTorch and never against another kernel (K9's field arithmetic or
K6's powers, which the field context's methods launch on CUDA tensors).

On the CPU the wrappers of K6 and K9 (``fieldops.mont_pow``,
``fieldops.field_op``) are made to raise while each plain version runs;
on the card (marked ``cuda``) every wrapper's launch count stays as it
was. This file imports neither jax nor mpyc_tpu.

Tolerance: none (no value is compared)."""
import numpy as np
import pytest
import torch

from mpyc_tpu_torch import finfields
from mpyc_tpu_torch.models import pipelines
from mpyc_tpu_torch.ops import fieldops, keccak, rng
from mpyc_tpu_torch.ops.fieldops import limbs_from_numpy, prime_field_ctx


@pytest.fixture(autouse=True)
def one_thread():
    """The plain versions on small tensors gain nothing from torch's
    threads, and the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


P = 18446744073709551427   # SecInt(32)'s field, two limbs
P110 = 1298074214633706907132624082305003   # SecFxp(52)'s field, four limbs


def _shares(n, seed, device, p):
    """(3, n) canonical field elements (< p) as stored limbs."""
    g = np.random.default_rng(seed)
    vals = [[int.from_bytes(g.bytes(32), 'little') % p for _ in range(n)]
            for _ in range(3)]
    L = prime_field_ctx(p).L
    words = [[[(v >> 32 * i) & 0xFFFFFFFF for i in range(L)] for v in row]
             for row in vals]
    return limbs_from_numpy(np.array(words, np.uint32), device)


def _plain_calls(device):
    """Each plain version, by kernel, as a call on ``device``."""
    st = keccak.state_tensor(keccak.ctr_state(bytes(range(40)))[0], device)
    a, b = _shares(5, 1, device, P110), _shares(5, 2, device, P110)
    ctx = prime_field_ctx(P110)
    return {
        'K2': lambda: rng._squeeze_mont_plain(st, 5, 24, P110),
        'K3': lambda: pipelines._reshare_mul_plain(
            a, b, st, (1, 0), pipelines.ReshareSpec(P110, 1, 3)),
        'K4': lambda: pipelines._split_recombine_plain(
            _shares(5, 3, device, P)[0].contiguous(), st,
            pipelines.SplitSpec(P, 1, 3)),
        'K5': lambda: pipelines._sgn_step_plain(
            a, st, (1, 0), pipelines.SgnSpec(P110, 1, 3, 52, 30, LT=True,
                                             EQ=False, f=26)),
        'K6': lambda: fieldops._mont_pow_plain(a[0], (3 * P110 - 5) // 4,
                                               ctx),
        'K7': lambda: pipelines._random_bits_tail_plain(
            a, b, finfields.GF(P110), False, 26),
        'K9': lambda: fieldops._field_op_plain(a, b[0], 'mul', ctx),
    }


@pytest.mark.parametrize('kernel', ['K2', 'K3', 'K4', 'K5', 'K6', 'K7',
                                    'K9'])
def test_plain_version_takes_no_kernel_wrapper(kernel):
    def refuse(*args, **kwargs):
        raise AssertionError('a plain version reached a kernel wrapper')
    call = _plain_calls('cpu')[kernel]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fieldops, 'field_op', refuse)
        mp.setattr(fieldops, 'mont_pow', refuse)
        call()


WRAPPERS = (keccak.keccak_ctr, rng.squeeze_mont, pipelines.reshare_mul,
            pipelines.split_recombine, pipelines.sgn_step,
            pipelines.random_bits_tail, fieldops.mont_pow, fieldops.field_op)


@pytest.mark.cuda
@pytest.mark.parametrize('kernel', ['K2', 'K3', 'K4', 'K5', 'K6', 'K7',
                                    'K9'])
def test_plain_version_launches_nothing_on_the_card(kernel):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the kernels have no CPU mode')
    call = _plain_calls('cuda')[kernel]
    before = [w.launches for w in WRAPPERS]
    call()
    torch.cuda.synchronize()
    assert [w.launches for w in WRAPPERS] == before
