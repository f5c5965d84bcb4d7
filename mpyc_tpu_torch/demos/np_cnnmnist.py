"""Secure CNN inference on MNIST, on the port.

    python -m mpyc_tpu_torch.demos.np_cnnmnist [-b B] [-o OFFSET] [--fxp]
        [--selftest] [--device cuda|cpu]

The co-located paths of ``demos/cnnmnist.py`` on ``SimRuntime(3)`` (t = 1):
the published MNIST CNN (conv 5x5x32, maxpool, conv 5x5x64, maxpool, fc
3136x1024, fc 1024x10; weights from ``demos/data/cnn``) on MNIST test
images B from OFFSET. A convolution is im2col and one secure matrix
product (a field matmul and one reshare round, kernel K3 on the card);
maxpool is two ``np_where(a >= b, a, b)`` rounds and ReLU ``(x >= 0) * x``
(comparisons: kernel K5; products: K3); one batched ``np_argmax(x,
axis=1)`` gives the predictions. They are counted against the demo's
float forward pass (``float_forward``) and against the MNIST labels.

Integer path (the default, the demo's batch B): SecInt(37). The pixels,
scaled by 2^6, enter as public values (``secint.array(scale_int(x,
2^6))``), the weights at 2^6 and the biases at 2^(6 a) as public-valued
secure arrays (``load``). The bit length of the type is set to 16, 23, 30
and 37 between the layers, as the demo does. The predictions must equal
``plain_forward``, the same network in int64 with the comparison's
integer semantics.

Fixed-point path (``--fxp``, the demo's batch B.5): SecFxp(14, 6) on a
52-bit field. The float pixels, weights and biases enter as public-valued
fixed-point arrays (``secfxp.array(x)``: round(v 2^6)), the bit length
stays 14, and every product of two non-integral values is truncated
(``_trunc_field``: PRSS random bits, one opening; kernels K1 and K6 on the
card), so the result is not deterministic: floor(v / 2^6) or one more. So
the check is stage-local (``check_fxp_stages``): every layer's opened
output against the exact product the plaintext computes from the
layer's opened input, and maxpool, ReLU and the argmax against numpy on
their opened inputs.

``--selftest``: a random CNN of the same structure on small images, input
with ``rt.input``: at SecInt(37) its predictions must equal
``plain_forward``'s; with ``--fxp`` (random float weights) every stage
must pass the stage-local check.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch

from mpyc_tpu_torch import sectypes
from mpyc_tpu_torch.demos.np_bnnmnist import (load_mnist, plain_argmax,
                                              plain_less)
from mpyc_tpu_torch.demos import parties

DATA = Path(__file__).resolve().parents[2] / 'demos' / 'data' / 'cnn'
L_TYPE = 37      # SecInt(37): the field, and the bit length of the argmax
F = 6            # fractional bits of the pixels and weights
# (name, a) of each layer: its bias is scaled by 2^(a F)
LAYERS = (('conv1', 2), ('conv2', 3), ('fc1', 4), ('fc2', 5))
# the demo's bit length after conv1, conv2 and fc1 (cnnmnist.py:161-190)
L_AFTER = {'conv1': 16, 'conv2': 23, 'fc1': 30}
L_FXP = 14       # SecFxp(14, 6): the fixed-point type (cnnmnist.py:117-120)
# the stages secure_forward can keep, in order: each convolution's output,
# after it maxpool and ReLU, fc1's output, its ReLU, the logits, the argmax
STAGES = ('conv1', 'pool1', 'conv2', 'pool2', 'fc1', 'relu3', 'fc2',
          'argmax')


def scale_int(x, f2):
    """x * f2 rounded to Python ints (the demo's ``scale_int``)."""
    return np.vectorize(round, otypes=[object])(x * f2)


def load_weights() -> dict:
    """The published float weights and biases of each layer."""
    return {name: (np.load(DATA / f'W_{name}.npy').astype(np.float64),
                   np.load(DATA / f'b_{name}.npy').astype(np.float64))
            for name, _ in LAYERS}


def scaled_weights(weights) -> dict:
    """Each layer's (W, b) as Python-int object arrays: W at 2^F, b at
    2^(a F) (the demo's ``load``)."""
    return {name: (scale_int(weights[name][0], 1 << F),
                   scale_int(weights[name][1], 1 << (a * F)))
            for name, a in LAYERS}


def images_int(images) -> np.ndarray:
    """uint8 (B, 784) images -> (B, 1, 28, 28) pixels / 255 at 2^F, as
    Python ints (the demo's input)."""
    x = np.asarray(images).reshape(-1, 1, 28, 28) / 255
    return scale_int(x, 1 << F)


# -- the plaintext models -----------------------------------------------------

def _im2col(x, s):
    """(k, r, m, n) -> (k m n, r s s) 'same' patches of an s x s kernel,
    in the order of the demo's conv2d."""
    k, r, m, n = x.shape
    pad = (s - 1) // 2
    xp = np.pad(x, ((0, 0), (0, 0), (pad, pad), (pad, pad)))
    cols = np.stack([xp[:, :, di:di + m, dj:dj + n]
                     for di in range(s) for dj in range(s)], axis=2)
    return cols.transpose(0, 3, 4, 1, 2).reshape(k * m * n, r * s * s)


def _matmul(x, W):
    """x @ W, exact for int64 (in torch on the CPU: numpy's integer matmul
    has no fast path), as it is for float64."""
    if x.dtype != np.int64:
        return x @ W
    return (torch.from_numpy(np.ascontiguousarray(x))
            @ torch.from_numpy(np.ascontiguousarray(W))).numpy()


def _conv(x, W, b):
    k, _, m, n = x.shape
    v, _, s, _ = W.shape
    out = _matmul(_im2col(x, s), W.reshape(v, -1).T) + b
    return out.reshape(k, m, n, v).transpose(0, 3, 1, 2)


def plain_stages(x, sweights) -> dict:
    """The network in int64 with the protocol's semantics, stage by stage:
    a >= b is 1 - LT(a - b) with LT(d) = -floor(d / 2^l) (exact for
    |d| < 2^l), ``np_where(c, a, b)`` is c (a - b) + b, and the argmax is
    the runtime's tournament. ``sweights``: scaled_weights. Returns each
    stage's output by name: conv1, pool1 (maxpool and ReLU), conv2, pool2,
    fc1, relu3, fc2 (the logits) and argmax (the predictions)."""
    def ge(a, b, l):
        return 1 - plain_less(a, b, l)

    def pool_relu(x, l):
        a, b = x[:, :, ::2, :], x[:, :, 1::2, :]
        x = ge(a, b, l) * (a - b) + b
        a, b = x[:, :, :, ::2], x[:, :, :, 1::2]
        x = ge(a, b, l) * (a - b) + b
        return ge(x, 0, l) * x

    w = {name: (W.astype(np.int64), b.astype(np.int64))
         for name, (W, b) in sweights.items()}
    st = {}
    x = np.asarray(x, dtype=np.int64)
    for i, name in enumerate(('conv1', 'conv2')):
        x = st[name] = _conv(x, *w[name])
        x = st[f'pool{i + 1}'] = pool_relu(x, L_AFTER[name])
    x = st['fc1'] = _matmul(x.reshape(x.shape[0], -1), w['fc1'][0]) \
        + w['fc1'][1]
    x = st['relu3'] = ge(x, 0, L_AFTER['fc1']) * x
    x = st['fc2'] = _matmul(x, w['fc2'][0]) + w['fc2'][1]
    st['argmax'] = plain_argmax(x, L_TYPE)
    return st


def plain_forward(x, sweights, stats=None) -> np.ndarray:
    """Predictions of ``plain_stages``' network. A ``stats`` dict gets each
    layer's least and largest output."""
    st = plain_stages(x, sweights)
    if stats is not None:
        for name in ('conv1', 'conv2', 'fc1', 'fc2'):
            stats[name] = (int(st[name].min()), int(st[name].max()))
    return st['argmax']


def float_forward(x, weights) -> np.ndarray:
    """The demo's float forward pass (``demos/cnnmnist.py``
    ``plain_forward``): logits of (B, 1, 28, 28) pixels in [0, 1]."""
    def pool(x):
        x = np.maximum(x[:, :, ::2, :], x[:, :, 1::2, :])
        return np.maximum(x[:, :, :, ::2], x[:, :, :, 1::2])

    x = np.maximum(pool(_conv(x, *weights['conv1'])), 0)
    x = np.maximum(pool(_conv(x, *weights['conv2'])), 0)
    x = np.maximum(x.reshape(x.shape[0], -1) @ weights['fc1'][0]
                   + weights['fc1'][1], 0)
    return x @ weights['fc2'][0] + weights['fc2'][1]


# -- the secure network -------------------------------------------------------

def conv2d(rt, x, W, b):
    """Secure 'same' 2-D convolution: im2col and one secure matmul (the
    demo's conv2d)."""
    k, r, m, n = x.shape
    v, _, s, _ = W.shape
    pad = (s - 1) // 2
    zrows = np.zeros((k, r, pad, n), dtype=object)
    xp = rt.np_concatenate((zrows, x, zrows), axis=2)
    zcols = np.zeros((k, r, m + 2 * pad, pad), dtype=object)
    xp = rt.np_concatenate((zcols, xp, zcols), axis=3)
    patches = rt.np_stack([xp[:, :, di:di + m, dj:dj + n]
                           for di in range(s) for dj in range(s)], axis=2)
    patches = rt.np_transpose(patches, (0, 3, 4, 1, 2))
    patches = rt.np_reshape(patches, (k * m * n, r * s * s))
    Wmat = rt.np_transpose(rt.np_reshape(W, (v, r * s * s)))
    out = patches @ Wmat + b
    out = rt.np_reshape(out, (k, m, n, v))
    return rt.np_transpose(out, (0, 3, 1, 2))


def maxpool(rt, x):
    """(2, 2) maxpool with stride 2: two rounds of np_where(a >= b, a, b)."""
    def maximum(a, b):
        return rt.np_where(a >= b, a, b)
    x = maximum(x[:, :, ::2, :], x[:, :, 1::2, :])
    return maximum(x[:, :, :, ::2], x[:, :, :, 1::2])


def relu(x):
    return (x >= 0) * x


def secure_layers(secint, sweights) -> dict:
    """Each layer's (W, b) as public-valued secure arrays on the device
    (for SecFxp float arrays, which the type scales by 2^6)."""
    return {name: (secint.array(W), secint.array(b))
            for name, (W, b) in sweights.items()}


def secure_forward(rt, secint, x, slayers, barrier=None,
                   stages=None) -> np.ndarray:
    """The secure network on a batch x, a secure (B, 1, H, W) array (public
    pixel values or input shares): the opened predictions. ``barrier``,
    if given, is called with each layer's name after it (a hook for
    timing); ``stages``, if a dict, receives each stage's secure output
    (``STAGES``), to be opened after the pass. At SecInt the bit length
    of the type follows the demo's layers; at SecFxp it stays."""
    barrier = barrier or rt.barrier
    keep = stages.__setitem__ if stages is not None else lambda *_: None
    widths = ({} if issubclass(secint, sectypes.SecureFixedPoint)
              else {**L_AFTER, 'fc2': L_TYPE})

    def narrow(name):
        if name in widths:
            secint.bit_length = widths[name]

    try:
        for i, name in enumerate(('conv1', 'conv2')):
            x = conv2d(rt, x, *slayers[name])
            keep(name, x)
            narrow(name)
            x = relu(maxpool(rt, x))
            keep(f'pool{i + 1}', x)
            barrier(f'after-{name}')
        x = rt.np_reshape(x, (x.shape[0], -1))
        W, b = slayers['fc1']
        x = x @ W + b
        keep('fc1', x)
        narrow('fc1')
        x = relu(x)
        keep('relu3', x)
        barrier('after-fc1')
        W, b = slayers['fc2']
        x = x @ W + b
        keep('fc2', x)
        narrow('fc2')
        a = rt.np_argmax(x, axis=1)
        keep('argmax', a)
        preds = rt.output(a)
        barrier('after-fc2')
    finally:
        if widths:
            secint.bit_length = L_TYPE
    return np.asarray(preds, dtype=np.int64)


# -- the fixed-point path's stage-local check ---------------------------------

def _fx(v) -> np.ndarray:
    """Fixed-point values (opened floats, or public floats as the type
    encodes them) at 2^F as int64."""
    return np.round(np.asarray(v, dtype=np.float64) * (1 << F)).astype(
        np.int64)


def check_fxp_stages(x, weights, opened: dict) -> dict:
    """The stage-local check of a fixed-point pass. x: the float pixels;
    weights: the float layers; opened: each stage's opened output
    (``STAGES``; the argmax as indices). A convolution or fc layer's
    output minus its bias must be floor(v / 2^6) or floor(v / 2^6) + 1,
    v the exact product at 2^12 of the layer's opened input and weights
    as the type encodes them; maxpool with ReLU, ReLU and the argmax must
    equal numpy's on their opened inputs. Returns per stage the number of
    elements that fail (all 0 when the pass is right) and, for the
    products, how many were rounded up."""
    def pool_relu(v):
        v = np.maximum(v[:, :, ::2, :], v[:, :, 1::2, :])
        return np.maximum(np.maximum(v[:, :, :, ::2], v[:, :, :, 1::2]), 0)

    w = {name: (_fx(W), _fx(b)) for name, (W, b) in weights.items()}
    o = {name: _fx(v) for name, v in opened.items()}
    res = {}

    def product(name, exact, bias):
        d = o[name] - bias - np.floor_divide(exact, 1 << F)
        res[name] = dict(bad=int(np.count_nonzero((d != 0) & (d != 1))),
                         up=int(np.count_nonzero(d == 1)), n=d.size)

    def equal(name, want):
        res[name] = dict(bad=int(np.count_nonzero(o[name] != want)),
                         n=want.size)

    for i, (name, inp) in enumerate((('conv1', _fx(x)),
                                     ('conv2', o['pool1']))):
        W, b = w[name]
        product(name, _conv(inp, W, np.zeros(W.shape[0], np.int64)),
                b[None, :, None, None])
        equal(f'pool{i + 1}', pool_relu(o[name]))
    product('fc1', _matmul(o['pool2'].reshape(x.shape[0], -1), w['fc1'][0]),
            w['fc1'][1])
    equal('relu3', np.maximum(o['fc1'], 0))
    product('fc2', _matmul(o['relu3'], w['fc2'][0]), w['fc2'][1])
    res['argmax'] = dict(bad=int(np.count_nonzero(
        np.asarray(opened['argmax']) != np.argmax(o['fc2'], axis=1))),
        n=x.shape[0])
    return res


def fxp_ranges(opened: dict) -> dict:
    """Each product layer's opened outputs at 2^6 (least, largest) and
    whether the comparisons after it stay within SecFxp(14, 6)'s exact
    range: |a - b| < 2^14 for maxpool's pairs, |a| < 2^14 for ReLU, for
    the argmax the logits' spread."""
    res = {}
    for name in ('conv1', 'conv2', 'fc1', 'fc2'):
        v = _fx(opened[name])
        lo, hi = int(v.min()), int(v.max())
        res[name] = dict(lo=lo, hi=hi,
                         fits=max(hi - lo, -lo, hi) < 1 << L_FXP)
    return res


def open_stages(rt, kept: dict, preds) -> dict:
    """The stages a pass kept, opened (fixed-point stages as floats), the
    argmax as the pass's predictions (indices)."""
    opened = {name: rt.output(v) for name, v in kept.items()}
    opened['argmax'] = preds
    return opened


def secure_stages(rt, secint, x, slayers) -> tuple:
    """A pass that keeps its stages: (predictions, each stage opened)."""
    kept = {}
    preds = secure_forward(rt, secint, x, slayers, stages=kept)
    return preds, open_stages(rt, kept, preds)


def random_cnn(gen, size: int, c1: int, c2: int, hidden: int,
               out: int = 10) -> dict:
    """A random network of the CNN's structure on size x size images (size
    a multiple of 4): small integer weights and biases, so that every
    comparison's operands stay within the bit lengths the network
    compares at."""
    q = size // 4
    return {'conv1': (gen.integers(-3, 4, (c1, 1, 5, 5)),
                      gen.integers(-99, 100, c1)),
            'conv2': (gen.integers(-3, 4, (c2, c1, 5, 5)),
                      gen.integers(-999, 1000, c2)),
            'fc1': (gen.integers(-3, 4, (c2 * q * q, hidden)),
                    gen.integers(-9999, 10000, hidden)),
            'fc2': (gen.integers(-3, 4, (hidden, out)),
                    gen.integers(-9999, 10000, out))}


def selftest(rt, secint, batch: int, size: int = 8, seed: int = 42):
    """A random CNN (1 -> 4 -> 4 channels, fc 4 (size/4)^2 -> 8 -> 10) on
    random size x size images at 2^F, input by party 1 with ``rt.input``;
    returns (predictions, plain_forward's)."""
    gen = np.random.default_rng(seed)
    sweights = {name: (W.astype(object), b.astype(object)) for name, (W, b)
                in random_cnn(gen, size, 4, 4, 8).items()}
    x = gen.integers(0, 1 << F, (batch, 1, size, size))
    expect = plain_forward(x, sweights)
    X = rt.input(secint.array(x.astype(object)), senders=0)
    rt.barrier()
    got = secure_forward(rt, secint, X, secure_layers(secint, sweights))
    return got, expect


def random_fxp_cnn(gen, size: int, c1: int, c2: int, hidden: int,
                   out: int = 10) -> dict:
    """Random float weights and biases of the CNN's structure on size x
    size images, scaled so that every layer's outputs stay well within
    SecFxp(14, 6)'s comparisons."""
    q = size // 4
    shapes = {'conv1': ((c1, 1, 5, 5), c1), 'conv2': ((c2, c1, 5, 5), c2),
              'fc1': ((c2 * q * q, hidden), hidden),
              'fc2': ((hidden, out), out)}
    return {name: (gen.normal(0, 0.4, Ws), gen.normal(0, 0.5, n))
            for name, (Ws, n) in shapes.items()}


def selftest_fxp(rt, secfxp, batch: int, size: int = 8, seed: int = 43):
    """A random float CNN (1 -> 4 -> 4 channels, fc 4 (size/4)^2 -> 8 ->
    10) on random size x size images in [0, 1], input by party 1 with
    ``rt.input`` at SecFxp(14, 6); returns (predictions, the stage-local
    check of ``check_fxp_stages``)."""
    gen = np.random.default_rng(seed)
    weights = random_fxp_cnn(gen, size, 4, 4, 8)
    x = gen.integers(0, 256, (batch, 1, size, size)) / 255
    X = rt.input(secfxp.array(x), senders=0)
    rt.barrier()
    preds, opened = secure_stages(rt, secfxp, X,
                                  secure_layers(secfxp, weights))
    return preds, check_fxp_stages(x, weights, opened)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('-b', '--batch-size', type=int, default=1,
                        help='number of images to classify')
    parser.add_argument('-o', '--offset', type=int, default=0,
                        help='offset into the MNIST test set')
    parser.add_argument('--fxp', action='store_true',
                        help='the fixed-point path, SecFxp(14, 6)')
    parser.add_argument('--selftest', action='store_true',
                        help='random small network, no data files needed')
    parser.add_argument('--device', default='cuda',
                        help="where the shares live (default: the card; "
                        "'cpu' runs the kernels' plain versions)")
    args = parties.parse_args(parser, argv)

    rt = parties.runtime(args)
    secnum = rt.SecFxp(L_FXP, F) if args.fxp else rt.SecInt(L_TYPE)
    rt.start()
    B = args.batch_size
    if args.selftest:
        t0 = time.time()
        if args.fxp:
            got, checks = selftest_fxp(rt, secnum, B)
            ok = all(c['bad'] == 0 for c in checks.values())
        else:
            got, expect = selftest(rt, secnum, B)
            ok = bool((got == expect).all())
        print(f'secure CNN selftest ({B} images of 8x8, {secnum.__name__} '
              f'input) {"OK" if ok else "FAILED"} in {time.time() - t0:.2f}s;'
              f' predictions {got.tolist()}')
        rt.shutdown()
        return 0 if ok else 1

    labels, images = load_mnist(args.offset, B)
    print(f'Type = {secnum.__name__}, range = ({args.offset}, '
          f'{args.offset + B}), device = {rt.device}')
    print('Labels:', labels.tolist())
    weights = load_weights()
    xf = np.asarray(images).reshape(-1, 1, 28, 28) / 255
    floats = np.argmax(float_forward(xf, weights), axis=1)
    t0 = time.time()
    if args.fxp:
        preds, opened = secure_stages(rt, secnum, secnum.array(xf),
                                      secure_layers(secnum, weights))
        elapsed = time.time() - t0
        checks = check_fxp_stages(xf, weights, opened)
        agree = all(c['bad'] == 0 for c in checks.values())
        for name, c in checks.items():
            up = f', {c["up"]} rounded up' if 'up' in c else ''
            print(f'{name}: {c["n"] - c["bad"]}/{c["n"]} pass the '
                  f'stage-local check{up}')
        for name, r in fxp_ranges(opened).items():
            print(f'{name} outputs in [{r["lo"]}, {r["hi"]}] at 2^{F}: '
                  f'{"within" if r["fits"] else "BEYOND"} the comparison\'s'
                  f' {L_FXP} bits')
        what = 'the stage-local check'
    else:
        sweights = scaled_weights(weights)
        x = images_int(images)
        preds = secure_forward(rt, secnum, secnum.array(x),
                               secure_layers(secnum, sweights))
        elapsed = time.time() - t0
        stats = {}
        model = plain_forward(x, sweights, stats)
        for name, (lo, hi) in stats.items():
            print(f'{name} outputs in [{lo}, {hi}]')
        agree = bool((preds == model).all())
        what = 'the plaintext model'
    for i in range(B):
        tag = '' if preds[i] == labels[i] else '******* ERROR *******'
        print(f'Image #{args.offset + i} with label {labels[i]}: '
              f'{preds[i]} predicted. {tag}')
    off = [args.offset + i for i in np.flatnonzero(preds != floats)]
    print(f'{int((preds == labels).sum())}/{B} correct against the labels, '
          f'{int((preds == floats).sum())}/{B} equal to the float model '
          f'(differ on images {off}), in {elapsed:.2f}s; '
          f'{"passes" if agree else "FAILS"} {what}')
    rt.shutdown()
    return 0 if agree else 1


if __name__ == '__main__':
    sys.exit(main())
