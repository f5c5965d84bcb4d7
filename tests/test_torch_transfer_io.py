"""Plain-object transfer, input by senders and output to receivers on the
port, against the JAX package, and the small co-located runners.

A JAX ``SimRuntime(3)`` and the port's take the same inputs:

* ``transfer`` returns, for each form of senders (all, one, a list, and
  sender-receiver pairs), the objects the JAX package's co-located plane
  returns (copies: the one process plays every party), mirroring
  ``tests/test_runtime.py:196``;
* ``input(x, senders=i)`` gives the JAX package's shares bit for bit
  (the same generator state, ``load_state``), for each sender and for
  lists;
* ``output(x, receivers=r)`` opens to the receiver, who is played by the
  same process: the value of ``output(x)`` and of the JAX package's;
* the runners of ``helloworld``, ``oneliners``, ``parallelsort`` and
  ``ot`` check themselves (``run`` returns their verdict).

Tolerance: exact equality.
"""
import numpy as np
import pytest
import torch

from mpyc_tpu import sectypes as jsectypes
from mpyc_tpu.parallel.simulator import SimRuntime as JaxSim
from mpyc_tpu.runtime import _Options
from mpyc_tpu_torch.ops.fieldops import limbs_to_numpy
from mpyc_tpu_torch.parallel.simulator import SimRuntime as TorchSim


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


@pytest.mark.parametrize('form', ['all', 'one', 'list', 'pairs'])
def test_transfer_returns_the_jax_packages_objects(jr, form):
    """Every form of ``transfer``: the same objects, as copies."""
    tr = TorchSim(3, device='cpu')
    obj = {'pid': tr.pid, 'v': [1, 2]}
    kw = {'all': {}, 'one': {'senders': 0}, 'list': {'senders': [0, 2]},
          'pairs': {'sender_receivers': [(0, 0), (1, 0), (2, 1)]}}[form]
    got, want = tr.transfer(obj, **kw), jr.transfer(obj, **kw)
    assert got == want
    if form == 'all':
        assert len(got) == 3 and all(o['v'] == [1, 2] for o in got)
        assert got[0] is not obj and got[0]['v'] is not obj['v']
    if form == 'one':
        assert got == obj and got is not obj
    assert tr.transfer('hello', senders=0) == 'hello'


@pytest.mark.parametrize('sender', [0, 1, 2])
def test_input_by_each_sender_bit_identical(jr, sender):
    """A number, a list of two and an array input by one sender: the JAX
    package's shares, and the input generator's nonce after."""
    tr = _port(jr)
    ji, ti = jr.SecInt(32), tr.SecInt(32)
    _same(jr.input(ji(-42), senders=sender),
          tr.input(ti(-42), senders=sender))
    ja = jr.input([ji(3), ji(5)], senders=sender)
    ta = tr.input([ti(3), ti(5)], senders=sender)
    assert len(ja) == len(ta) == 2
    for x, y in zip(ja, ta):
        _same(x, y)
    v = np.array([[1, -2], [300, -4000]], dtype=object)
    _same(jr.input(ji.array(v), senders=sender),
          tr.input(ti.array(v), senders=sender))
    assert tr._rng._nonce == jr._rng._nonce


@pytest.mark.parametrize('receivers', [0, 1, [2], [0, 1, 2]])
def test_output_to_receivers(jr, receivers):
    """``output(x, receivers=r)`` gives the receiver (played here) the
    opened value: that of ``output(x)`` and the JAX package's, for a
    number, an array and a list; receivers outside the parties raise."""
    tr = _port(jr)
    ji, ti = jr.SecInt(32), tr.SecInt(32)
    v = np.array([7, -8, 9], dtype=object)
    jx = jr.input(ji.array(v), senders=0)
    tx = tr.input(ti.array(v), senders=0)
    got = tr.output(tx, receivers=receivers)
    assert list(got) == list(tr.output(tx)) == list(
        jr.output(jx, receivers=receivers)) == [7, -8, 9]
    assert int(tr.output(tr.input(ti(5), senders=1), receivers=receivers)) \
        == 5
    assert [int(a) for a in tr.output([ti(1), ti(2)],
                                      receivers=receivers)] == [1, 2]
    with pytest.raises(ValueError, match='receivers'):
        tr.output(tx, receivers=3)


@pytest.mark.parametrize('name', ['helloworld', 'oneliners', 'parallelsort',
                                  'ot'])
def test_small_runners_check_themselves(name):
    """The runners of ``demos/run-all.sh``'s first co-located demos on the
    CPU, at m = 3: each returns True where its results equal Python's."""
    import importlib
    mod = importlib.import_module(f'mpyc_tpu_torch.demos.{name}')
    rt = TorchSim(3, device='cpu')
    kw = {'seed': 5} if name == 'ot' else {}
    lines = []
    assert mod.run(rt, out=lines.append, **kw) is True
    assert lines


def test_small_runners_exit_0():
    """``main`` of each runner returns 0 on the CPU."""
    from mpyc_tpu_torch.demos import helloworld, ot
    assert helloworld.main(['--device', 'cpu']) == 0
    assert ot.main(['--seed', '3', '--device', 'cpu']) == 0
