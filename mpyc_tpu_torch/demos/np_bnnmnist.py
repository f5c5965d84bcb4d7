"""Secure binarized neural network inference on MNIST, on the port.

    python -m mpyc_tpu_torch.demos.np_bnnmnist [-b B] [-o OFFSET]
        [--selftest] [--device cuda|cpu]

The co-located path of ``demos/np_bnnmnist.py`` on ``SimRuntime(3)``
(t = 1) with SecInt(14): the published 4-layer binarized MNIST classifier
(fc 784x4096, 4096x4096, 4096x4096, 4096x10; +-1 weights and integer
biases from ``demos/data/bnn``) on MNIST test images B from OFFSET
(``demos/data/cnn``). The pixels enter as public values
(``secint.array(images)``); each layer is ``L @ W + b``, a field matmul
and one reshare round (kernel K3 on the card); the activation is the
generic sign ``np_sgn(L, LT=True) * -2 + 1`` (kernel K5), at l = 14 after
fc1 and at l = 10 after fc2 and fc3; one batched ``np_argmax`` at l = 14
gives the predictions. They must equal ``plain_forward``, the same
network in int64 with the comparison's integer semantics, and they are
counted against the MNIST labels.

``--selftest``: a random 64-32-10 network of +-1 values, input with
``rt.input``, whose predictions must equal the plaintext forward pass.

The Legendre-symbol sign protocols of the JAX package's demo (``-d``) run
on its per-party plane only, as there; this plane uses the generic sign.
"""

from __future__ import annotations

import argparse
import gzip
import sys
import time
from pathlib import Path

import numpy as np
import torch

from mpyc_tpu_torch.demos import parties

DATA = Path(__file__).resolve().parents[2] / 'demos' / 'data'
LAYERS = ('fc1', 'fc2', 'fc3', 'fc4')
L_IN = 14        # SecInt(14): the pixels, fc1's sums and the argmax
L_HIDDEN = 10    # the demo's bit length for the signs after fc2 and fc3


def load_layer(name: str):
    """Published BNN layer: packed binary weights -> +-1 (int8), integer
    biases (int64)."""
    W = np.load(DATA / 'bnn' / f'W_{name}.npy')
    W = np.unpackbits(W, axis=0).astype(np.int8) * 2 - 1
    b = np.load(DATA / 'bnn' / f'b_{name}.npy').astype(np.int64)
    return W, b


def load_mnist(offset: int, batch: int):
    """MNIST test labels and images (uint8, (batch, 784)), idx format."""
    with gzip.open(DATA / 'cnn' / 't10k-labels-idx1-ubyte.gz') as f:
        labels = np.frombuffer(f.read()[8 + offset:8 + offset + batch],
                               dtype=np.uint8).astype(np.int64)
    with gzip.open(DATA / 'cnn' / 't10k-images-idx3-ubyte.gz') as f:
        raw = f.read()[16 + offset * 784:16 + (offset + batch) * 784]
    return labels, np.frombuffer(raw, dtype=np.uint8).reshape(batch, 784)


# -- the plaintext model of the protocol -------------------------------------

def plain_less(x, y, l: int):
    """np_less(x, y) at bit length l as the comparison computes it on any
    integers (not only |x - y| < 2^l): LT(d) = -floor(d / 2^l) for
    d = x - y, 1 for d in [-2^l, 0) and 0 for d in [0, 2^l)."""
    return -((x - y) >> l)


def plain_sign(z, l: int):
    """The activation np_sgn(z, LT=True) * -2 + 1 = 2 floor(z / 2^l) + 1:
    +-1 for z in [-2^l, 2^l), odd values beyond."""
    return 2 * (z >> l) + 1


def plain_argmax(a, l: int):
    """np_argmax(a, axis=1) as the protocol computes it: the odd-even
    tournament of ``Runtime._np_argext`` with ``plain_less``."""
    def argext(a):
        n = a.shape[1]
        if n == 1:
            return np.ones_like(a), a
        n0 = n % 2
        a1, a2 = a[:, n0::2], a[:, n0 + 1::2]
        c = plain_less(a1, a2, l)
        m = c * (a2 - a1) + a1
        if n0:
            m = np.concatenate([a[:, :1], m], axis=1)
        u, m = argext(m)
        if n0:
            u0, u = u[:, :1], u[:, 1:]
        u2 = u * c
        u = np.stack([u - u2, u2], axis=-1).reshape(u.shape[0], -1)
        if n0:
            u = np.concatenate([u0, u], axis=1)
        return u, m
    u, _ = argext(np.asarray(a, dtype=np.int64))
    return (u * np.arange(u.shape[1])).sum(axis=1)


def plain_forward(images, layers, stats=None) -> np.ndarray:
    """Predictions of the network in int64 with the protocol's semantics;
    ``layers`` maps each name of LAYERS to its (W, b). The products run
    in torch on the CPU (exact in int64). A ``stats`` dict gets, per
    hidden layer, the least and largest sum and the number of
    activations that are not +-1 (sums beyond the sign's 2^l)."""
    x = torch.from_numpy(np.asarray(images, dtype=np.int64))
    for name in LAYERS:
        W, b = layers[name]
        x = x @ torch.from_numpy(W.astype(np.int64)) + torch.from_numpy(b)
        if name != 'fc4':
            z = x
            x = plain_sign(z, L_IN if name == 'fc1' else L_HIDDEN)
            if stats is not None:
                stats[name] = (int(z.min()), int(z.max()),
                               int((x.abs() != 1).sum()))
    return plain_argmax(x.numpy(), L_IN)


# -- the secure network -------------------------------------------------------

def secure_layers(secint, layers) -> dict:
    """Each layer's (W, b) as public-valued secure arrays on the device."""
    return {name: (secint.array(W), secint.array(b))
            for name, (W, b) in layers.items()}


def secure_forward(rt, secint, images, slayers) -> np.ndarray:
    """The secure network on a batch of images (public pixel values):
    the opened predictions."""
    def sign(z):
        return rt.np_sgn(z, LT=True) * -2 + 1

    x = secint.array(np.asarray(images, dtype=np.int64))
    for name in LAYERS[:3]:
        W, b = slayers[name]
        x = x @ W + b
        if name == 'fc1':
            x = sign(x)
        else:
            secint.bit_length = L_HIDDEN
            try:
                x = sign(x)
            finally:
                secint.bit_length = L_IN
        rt.barrier(f'after-{name}')
    W, b = slayers['fc4']
    x = x @ W + b
    return np.asarray(rt.output(rt.np_argmax(x, axis=1)), dtype=np.int64)


def selftest(rt, secint, batch: int, seed: int = 42):
    """Random +-1 network (batch x 64 -> 32 -> 10) with input by the
    parties; returns (predictions, the plaintext forward pass's)."""
    gen = np.random.default_rng(seed)
    D, H, O = 64, 32, 10
    x = gen.choice([-1, 1], size=(batch, D))
    w1 = gen.choice([-1, 1], size=(D, H))
    w2 = gen.choice([-1, 1], size=(H, O))
    a1 = np.where(x @ w1 >= 0, 1, -1)
    expect = np.argmax(a1 @ w2, axis=1)
    X = rt.input(secint.array(x), senders=0)
    W1 = rt.input(secint.array(w1), senders=0)
    W2 = rt.input(secint.array(w2), senders=0)
    rt.barrier()
    z = rt.np_sgn(X @ W1, LT=True) * -2 + 1
    got = rt.output(rt.np_argmax(z @ W2, axis=1))
    return np.asarray(got, dtype=np.int64), expect


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('-b', '--batch-size', type=int, default=1,
                        help='number of images to classify')
    parser.add_argument('-o', '--offset', type=int, default=0,
                        help='offset into the MNIST test set')
    parser.add_argument('--selftest', action='store_true',
                        help='random small network, no data files needed')
    parser.add_argument('--device', default='cuda',
                        help="where the shares live (default: the card; "
                        "'cpu' runs the kernels' plain versions)")
    args = parties.parse_args(parser, argv)

    rt = parties.runtime(args)
    secint = rt.SecInt(L_IN)
    rt.start()
    B = args.batch_size
    if args.selftest:
        t0 = time.time()
        got, expect = selftest(rt, secint, B)
        ok = bool((got == expect).all())
        print(f'secure BNN selftest ({B}x64->32->10) '
              f'{"OK" if ok else "FAILED"} in {time.time() - t0:.2f}s; '
              f'predictions {got.tolist()}')
        rt.shutdown()
        return 0 if ok else 1

    labels, images = load_mnist(args.offset, B)
    print(f'Type = {secint.__name__}, range = ({args.offset}, '
          f'{args.offset + B}), device = {rt.device}')
    print('Labels:', labels.tolist())
    layers = {name: load_layer(name) for name in LAYERS}
    t0 = time.time()
    preds = secure_forward(rt, secint, images, secure_layers(secint, layers))
    elapsed = time.time() - t0
    stats = {}
    model = plain_forward(images, layers, stats)
    for name, (lo, hi, wide) in stats.items():
        print(f'{name} sums in [{lo}, {hi}]: {wide} activations not +-1')
    for i in range(B):
        tag = '' if preds[i] == labels[i] else '******* ERROR *******'
        print(f'Image #{args.offset + i} with label {labels[i]}: '
              f'{preds[i]} predicted. {tag}')
    agree = bool((preds == model).all())
    print(f'{int((preds == labels).sum())}/{B} correct against the labels '
          f'in {elapsed:.2f}s; predictions '
          f'{"equal" if agree else "DIFFER from"} the plaintext model')
    rt.shutdown()
    return 0 if agree else 1


if __name__ == '__main__':
    sys.exit(main())
