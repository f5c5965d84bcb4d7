#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's paths on one NVIDIA card.

    python3 chip_smoke.py          # from the root of a checkout, one card

Paths on the co-located plane, at ``SimRuntime(3)`` (t = 1) but for the
phase "parties" (m = 5, 7 and 9 at t = 2, 3 and 4): three as
``bench.py`` drives the JAX package, at ``SecInt(32)`` (the 64-bit field):
secure multiplication (input, ``np_multiply``, output), secure comparison
(``np_less``, ``np_equal``, ``np_sgn``, ``np_maximum`` and the BNN sign at
2^20 elements, bench.py:203) and the split/recombine round (bench.py:88);
the BNN flagship (``demos/np_bnnmnist.py``) at ``SecInt(14)``, through
the port's runner ``mpyc_tpu_torch/demos/np_bnnmnist.py``: the MNIST flow
at full width and its selftest; a secure product at ``SecInt(64)`` (a
three-limb field); and the CNN (``demos/cnnmnist.py``) at ``SecInt(37)``
(a three-limb field), through ``mpyc_tpu_torch/demos/np_cnnmnist.py``:
the MNIST flow at full width and its selftest; the CNN's fixed-point
path at ``SecFxp(14, 6)`` (a 52-bit field of two limbs), through the same
runner; and the secure LP solver (``demos/np_lpsolver.py``) through
``mpyc_tpu_torch/demos/np_lpsolver.py`` on its datasets, from SecInt(6)
and SecInt(8) (two limbs) to SecInt(70) (four) and SecInt(104) and
SecInt(110) (five); the fixed-point LP solver (``demos/np_lpsolverfxp.py``)
through ``mpyc_tpu_torch/demos/np_lpsolverfxp.py`` at SecFxp(18) to
SecFxp(96) (two to six limbs) and the survival test
(``demos/kmsurvival.py``) through ``mpyc_tpu_torch/demos/np_kmsurvival.py``;
and the binary-field demos, SHA3
(``demos/np_sha3.py``: SecFld(2), its shares in GF(4)) and threshold AES
(``demos/np_aes.py``: SecFld(2^8)), through
``mpyc_tpu_torch/demos/np_sha3.py`` and ``np_aes.py``; the secure ID3
trees (``demos/id3gini.py``: SecInt(32)-(95)), secure sorting
(``demos/sort.py``) and the one-way hash chains
(``demos/np_onewayhashchains.py``) through ``mpyc_tpu_torch/demos/
np_id3gini.py``, ``sort.py`` and ``np_onewayhashchains.py``; and the
co-located demos of ``demos/run-all.sh`` (secretsanta,
SecretSantaExplained, indextounitvector, unanimous, PrefixOrExplained, and
sort's secure list) through their runners in ``mpyc_tpu_torch/demos/``,
with the secure prime fields SecFld(p) on one-limb fields; and the
secure linear algebra over wide prime fields (7 to 42 limbs: the wide
kernels of ``csrc/wide.cu``): ridge regression (``demos/
ridgeregression.py``), the pseudoinverse (``demos/pseudoinverse.py``) and
multilateration (``demos/multilateration.py``), with the small runners of
``demos/run-all.sh`` (helloworld, oneliners, parallelsort, ot); and the
comparisons over wide prime fields (7 to 48 limbs: the wide K5 of
``csrc/sgn_wide.cu``): the integer LP solver on kb2 (SecInt(560), 19
limbs) and secure comparisons at SecInt(192), SecInt(560) and
SecInt(1504). Phases, each printing one line with its elapsed seconds:

1. probe: a CUDA card must be present (else exit 1, no result); print its
   name and its power limit as nvidia-smi reports them;
2. build: compile the kernels with nvcc (csrc/, sm_90a; one nvcc a
   translation unit, all at once, then a link); print nvcc's
   warnings, each kernel's registers, stack frame, spills and shared
   memory as ptxas reports them, K5's thread block size B at SecInt(32)
   and at SecInt(110), each K6 and K7
   instantiation's SASS instructions by class (``cuobjdump -sass``: the
   whole kernel, and its squaring loop per product beside the bound
   model's lazy square), and the build time;
3. kernels: K1 (keccak_ctr, replayed from a CUDA graph beside the
   events' time of a call), K2 (squeeze_mont) and K3 (reshare_mul, also at
   a size that is no multiple of its thread block) at the main path's sizes,
   K4 (split_recombine) with its shares at 2^16 and at
   the round's 3,010,560 elements, K5 (sgn_step) in its three modes at
   2^16 and at the comparison's 2^20 elements, and in LT mode at the BNN's
   l = 14 and l = 10 (SecInt(14)'s field) at 2^16 and at a BNN layer's
   call (409,600 elements on their bucket of 2^19), each equal bit for bit
   to its plain PyTorch version on the same inputs (tolerance: exact,
   integer arithmetic), K1 also to hashlib; then at three limbs K2
   (SecInt(64)'s 28-byte draws), K3 (both modes, at conv1's reshare
   bucket and at a ragged size) and K5 (LT at the CNN's l = 16, 23, 30,
   37: at 2^14 elements, and one launch of many chunks of 1024 against the
   plain version chunk by chunk, outputs and counters: 7 chunks with a
   ragged tail, and each width's largest comparison in the CNN, the
   counter carried into its high word in both); time each and its plain
   version (for K5 the same chunks) with CUDA events, beside its bound;
   for K5 also the permutations per warp of
   32 elements that its stage serialises, from a model of the stage
   (``sgn_squeezes``, held against the kernel source's own count by
   tests/test_torch_kernels_host.py); then the LP solver's
   instantiations (``check_lp_kernels``): K3 at four and five limbs at
   the rank-1 updates of LPExample_R20 and LPExample (441 and 58,667
   elements), K5 in LT and EQ mode at l = 8 and 6 (two limbs), 70
   (four), 104 and 110 (five) at each path's widest comparison, and at
   l = 20 and 45 (two and three limbs, checked only), K6 at four and five
   limbs at e = p - 2 and (p - 1) / 2, K7 at four and five limbs with
   planted zero openings, each bit for bit against its plain version and
   timed beside it and its bound; then the fixed-point paths'
   (``check_fxp_lp_kernels``): K3 at six limbs at kb2's rank-1 update, K5
   at each SecFxp(l, f)'s width and scale (LT; EQ at btrial's zero test),
   K6 at six limbs and on SecFxp(64, 32)'s canonical four-limb field, K7
   at three and six limbs and canonical four; and K9 (``check_field_ops``:
   elementwise products, adds and subtractions at two to six limbs,
   constants on either side, a draw's chunks below R), each against its
   plain version; and the ID3 trees' (``check_id3_kernels``): K5 in LT
   mode at l = 42, 62 (three limbs), 69, 75, 77, 95 (four) and in EQ mode
   at l = 42 on one element (and 300, checked), K6 at three limbs and K6
   and K7 canonical at two (SecInt(32)'s field), each against its plain
   version; and the co-located demos' (``check_one_limb_kernels``): the
   one-limb K3 (fused and not), K6 and K7 (lazy on GF(1031), canonical
   on GF(2^31 - 1)) and K9, K5 at SecFxp(32, 16)'s
   l = 32, f = 16 (EQ and LT), K8 in GF(4) without its product, each
   against its plain version; and the linear algebra's
   (``check_wide_kernels``): the wide K3 (fused and not), K9 and K6 at
   each of its fields' limb counts (7, 8, 9, 10, 12, 42), K7 at seven,
   K5 EQ at l = 31, each against its plain version at the paths' shapes;
   and the wide comparison's (``check_wide_sgn_kernels``): the wide K5 at
   seven limbs (l = 192) in its three modes and in LT mode at (2, 5) and
   (4, 9), at 19 limbs at l = 64 and 560 (LT on kb2's field at kb2's
   widest call, 68 elements; at (2, 5) too) and at 48 at l = 32 and 1504,
   on 8 elements, each bit for bit against its plain version (each plain
   call's seconds printed), then one launch at each path's shape (2^14
   at 7 and 19 limbs in 16 chunks, 2^10 at 48 in chunks of 32, kb2's 68
   at (2, 5)), its first and last chunk bit for bit against the plain
   version; the wide K3 (fused and not) at (2, 5) at 7, 8, 9, 12, 19 and
   42 limbs and at (4, 9) at 7, 12 and 42, K7 at 7 and 12 limbs at both;
   at kb2's 19 limbs K3 on its rank-1 update and K6 at e = p - 2; and
   this tree's (1, 3) rows of the wide K3 and K7 beside PERF.md's; and
   the parties' (``check_parties_kernels``): K3 (fused and not), K4 with
   its shares, K5 in its three modes at l = 32 and K7 (with planted
   zero openings) at (t, m) = (1, 4), (2, 5), (3, 7) and (4, 9) on 2^16
   elements, then each at the shapes phase "parties" launches it
   (``check_parties_paths``: K3 on (m, 2^22, 2) at (2, 5), (3, 7), (4,
   9); K5 at 2^20 at (2, 5), (3, 7); at (2, 5) K4 at 3,010,560 secrets,
   K5 (LT) at the BNN's l = 14 and 10 on 409,600 and the fixed-point
   CNN's l = 14, f = 6 in two chunks of 2^20, K7 at 15,052,800), each
   against its plain version, with its time (at the path's shape where
   it has one), plain time, bound and ptxas report;
4. main path: 256 and 4096 values in, product out and checked against
   a*b; then 2^22 values from int64 arrays, 10 chained
   ``X = np_multiply(X, B)``, and 4096 sampled outputs checked against the
   plaintext product mod p;
5. comparison: A, B of 2^20 values in [-2^30, 2^30) (one pair in 8
   equal, the range ends planted); np_less, np_equal, np_sgn(A - B),
   np_maximum and the BNN sign np_sgn(A, LT=True) * -2 + 1, every output
   checked against the plaintext; the median of 7 np_less calls as
   comparisons/s; one try of torch.profiler over 3 more np_less calls:
   device time by kernel and the device's idle share, or "no device time";
6. split/recombine: 3,010,560 secrets, 100 chained rounds, the output
   equal to the input; ms per round;
7. bnn: the MNIST flow on test images 0-99 (B = 100; fc 784-4096-4096-
   4096-10, SecInt(14)), cold and 3 times warm: all 100 predictions
   equal to the plaintext model of the protocol (``plain_forward``), the
   count correct against the labels, seconds a pass (cold; warm median,
   least and largest) and images/s; then, outside
   the counted run, per layer at its shapes the device ms of the plane
   GEMM (``torch._int_mm``), the planes and the GEMM, the carry and fold,
   K3 and K5 (CUDA events); one try of torch.profiler over a warm pass;
8. selftest: the runner's 64-32-10 network with ``rt.input`` at B = 100
   (SecInt(14)'s 22-byte input draws: K1 and the split), predictions
   equal to the plaintext forward pass;
9. wide product: 2^20 SecInt(64) values input by two parties (28-byte
   draws: K2 at three limbs), multiplied (K3 at three limbs), every
   output checked;
10. cnn: the MNIST flow on test images 0-99 (B = 100; conv 5x5x32,
   maxpool, conv 5x5x64, maxpool, fc 3136x1024, fc 1024x10, SecInt(37),
   comparisons at l = 16, 23, 30 and 37), cold and 3 times warm: all 100
   predictions equal to the plaintext model of the protocol, the counts
   equal to the float model and correct against the labels, seconds a
   pass (cold; warm median, least and largest) and images/s; the host
   seconds of encoding the pixels and the
   weights (the encoder of int64 values against its general path of
   Python ints); a marked pass: each layer's device ms and peak
   memory, K5's launches against the comparisons' chunks of 1024; per
   layer at its shapes the device ms of the planes and GEMM, the carry
   and fold, K3 and K5; one try of torch.profiler over a warm pass;
11. cnn selftest: the runner's random CNN on 8 x 8 images with
   ``rt.input`` at SecInt(37) (25-byte draws: K1 and the split), B = 100,
   predictions equal to the plaintext model;
12. fxp kernels: at SecFxp(14, 6)'s field, K6 (mont_pow, the inverse
   square root's power (3p - 5) / 4 by its plan) at conv1's random bits
   (15,052,800 elements, L = 2) and at 2^22 elements of SecInt(37)'s
   three-limb field, equal bit for bit to
   the ladder (its plain version) and timed beside it, its bound and its
   ladder kernel's time before its redesign; K7 (random_bits_tail) at
   conv1's bits on random shares and on shares with one r in 1,000
   planted to 0, bits, zero flags and
   their count equal to its plain version (the tail before K7), timed
   beside it and its bound; K5 (LT, l = 14) with the fixed-point scale 2^6 at the flow's
   largest comparison (maxpool1's first round, 1,254,400 elements in two
   chunks of 2^20, one launch, outputs and counters), equal bit for bit
   to its plain version and timed beside it and its bound; one round of
   conv1's random bits split into its PRSS draws and its tail (CUDA
   events, K7 and the plain tail); then through the runtime one
   ``np_random_bits`` of 15,052,800 bits (every opened value 0 or 1, the
   share of ones within 6 standard
   deviations of 1/2) and one ``np_trunc`` of conv1's 2,508,800 products
   (every opened value floor(x / 2^6) or one more, the share rounded up
   within 6 standard deviations of the mean of (x mod 2^6) / 2^6), each
   timed;
13. cnn fxp: the MNIST flow at SecFxp(14, 6) (``--fxp``) on test images
   0-99, cold and 3 times warm, every pass's every layer held by the
   runner's stage-local check (a product layer's output minus its bias
   floor(v / 2^6) or one more, v the exact product of its opened input;
   maxpool, ReLU and the argmax equal to numpy's on their opened inputs),
   the counts against the labels and the float model (and the images
   where fixed point and float differ), each layer's opened range against
   the comparison's 14 bits, seconds a pass (cold; warm median, least and
   largest) and images/s, K5's, K6's and K7's launches a pass; a marked
   pass: each layer's device ms and peak memory; one try of
   torch.profiler over a warm pass;
   parties: the paths at other party counts, each through its entry
   points at ``SimRuntime(m, threshold=t)`` and checked as above: the
   main path at (t, m) = (2, 5), (3, 7) and (4, 9), the comparison at
   (2, 5) and (3, 7), the split/recombine round, the BNN (the runner's
   ``-M 5``) and the fixed-point CNN (``--fxp -M 5``) at (2, 5), the
   networks cold and once warm; kb2 (``np_lpsolver -i 6 -M 5 -T 2``)
   stopped after 2 pivots, its tableau the plain exact solver's; ridge
   regression's synthetic set at accuracies 4-7 (7-9 limbs) and 2
   multilateration measurements (12 limbs) at (2, 5); ms a call, s a
   pass and images/s
   beside the (1, 3) numbers of the phases above, the launches by kernel
   of each, and this tree's (1, 3) times of K3, K4, K5 and K7 beside
   PERF.md's;
14. lp: the LP solver on datasets 0-7 (uvlp, wiki, tb2x2, woody,
   LPExample_R20, sc50b, kb2, LPExample; SimRuntime(3)): each with the
   demo's pivot count, its opened max, common denominator and solution
   equal to the plain exact solver's (``plain_solve``, Python ints), and
   its certificate true, but kb2 (SecInt(560), 19 limbs: the wide K5, K3,
   K6, K9) stopped after 12 of its 154 pivots (a cut for time), its
   opened tableau and denominator ``plain_solve``'s after as many;
   seconds a solve and a pivot, launches a solve (kb2: a pivot) by
   instantiation; one try of torch.profiler over pivots 11 and 12 of
   LPExample and over pivot 2 of kb2 (device time by kernel, idle share,
   the host's operators);
15. lp fxp: the fixed-point LP solver on datasets 0-6 (uvlp, wiki,
   tb2x2, woody, LPExample_R20, sc50b, kb2; each at its own SecFxp(l)):
   each certificate true, the opened max within 1% of the optimum, the
   opened solution within ``solution_tol`` of the plain float simplex's
   (``check_solution``); sc50b and kb2 stopped after 20 of 52 and 16 of
   173 pivots (cuts for time), each opened tableau within
   ``solution_tol`` of its opened basis's tableau in float64
   (``plain_tableau``); seconds a solve and a
   pivot, launches a pivot; one try of torch.profiler over pivot 2 of
   kb2;
16. km: the survival test with --agg on btrial (SecFxp(56, 28)), aml
   (SecFxp(64, 32): 4p >= R) and aml at SecFxp(96, 48): each statistic,
   and the aggregated one, within 1e-3 of the plain logrank test;
   seconds a run, launches;
17. gf2 kernels: K8 (reshare2, the GF(2^d) reshare squeezing its own
   stream) at SHA3's chi, (3, 2^19) in GF(4) (b = 256: 409,600 elements
   on their bucket), and at AES's S-box products, (3, 32,768) in GF(2^8)
   (b = 2,048), fused and not, and at the key schedule's bucket (3, 64),
   each one launch with no K1 launch and equal bit for bit to its plain
   version from the same state and counter, and K1 at 9,363 blocks (the
   chi's stream while K8 read K1's blocks) equal to its plain version
   and every instance to hashlib's; each timed (its device time, the launches
   replayed from a CUDA graph: they are shorter than their host calls,
   which CUDA events would time; the events' time of a call beside it)
   beside its plain version, its bound and their ratio (K1 at 9,363
   blocks is the kernels line's K1), and an empty kernel's replayed
   launch, the floor under every launch;
18. sha3: SHA3-256 of the demo's 256 messages (``np_sha3 -b 256``), cold
   and 3 times warm, then SHAKE128 (256 bits): every digest equal to
   hashlib's; seconds a batch and ms a digest (cold; warm median, least
   and largest), K8's and K1's launches a batch; one try of
   torch.profiler over a warm batch;
19. aes: the AES demo's main on 2,048 blocks (``np_aes -b 2048``), cold
   and warm: AES-128 and AES-256, FIPS-197 C.1 and C.3 on block 0 and
   every block decrypted back; seconds and ms a block of each stage, K8's
   and K1's launches a pass; one try of torch.profiler over an AES-128
   encryption; the plain carry-less products of an AES-128 encryption
   (``clmul_meas``): calls, products, their bound at their fewest
   operations and their device time replayed;
20. id3: the secure ID3 trees (``mpyc_tpu_torch/demos/np_id3gini.py``)
   of the seven datasets of ``demos/data/id3`` at the demo's bit lengths
   (SecInt(32) to SecInt(95), two to four limbs; KRKPA7 at SecInt(69),
   3,196 samples x 36 attributes), each equal to ``plain_id3``'s tree
   (Python ints); seconds a tree and a node, nodes, launches a node; one
   try of torch.profiler over KRKPA7's root node;
21. sort: 2^20 SecInt(32) values input, ``np_sort`` (210 Batcher
   stages), ``np_amax`` and ``np_amin``, each equal to numpy's; the
   sorting demo's 64 values shuffled by ``random.shuffle`` and
   ``sorted`` by a**2, equal to Python's sorted; seconds a sort and ms a
   stage; one try of torch.profiler over one np_sort;
22. hash chains: the one-way hash chains
   (``mpyc_tpu_torch/demos/np_onewayhashchains.py``) from a random seed:
   AES and SHAKE128 at k = 4 (optimal pebbling), AES at k = 3 (eager);
   every revealed value equal to the plain chain's (a plain AES-128,
   hashlib's SHAKE128) from the opened seed, k 2^(k-1) hashes; seconds a
   hash;
23. co-located demos: the runners of ``demos/run-all.sh``'s co-located
   demos at their defaults, each checking itself (secretsanta n = 5,
   three draws; SecretSantaExplained n = 5; indextounitvector n = 10 over
   GF(11), SecInt(32) and SecFxp(32, 16); unanimous, two voters, yes-yes
   and yes-no; PrefixOrExplained, five circuits on all 256 vectors of 8
   bits; sort n = 5 with its secure list), then a Secret Santa of 64, unit
   vectors of 1,024 over GF(1031) and SecInt(32), a secure list of 1,024
   SecInt(32) values read, written and inserted at secret indices, and
   GF(1031) and GF(2^31 - 1) at 1,024 elements (product, ==, /,
   randrange): every result checked against Python; seconds a call;
24. linear algebra: the runners of helloworld, oneliners, parallelsort
   and ot at m = 3; ridge regression on the synthetic set (n = 1,000, d =
   10) at accuracies 4-7 (7-9 limbs), winequality-red (10), -white (12)
   and student-mat (42 limbs), each solve's (adj A) B and det A equal to
   a plain integer Bareiss's and its train error within 0.2 of a plain
   ridge solve's; the pseudoinverse of the demo's 5 x 5 and of a 20 x 20
   of rank 16 (SecInt(163), seven limbs), the Penrose equations mod p
   and numpy's pinv; multilateration at SecInt(335) (12 limbs) on the
   first 8 measurements of sets 1 and 3, each solve equal to the plain
   integer solve and the median error under 2,000 m; seconds a call, a
   solve and a measurement;
25. wide comparison: 2^14 random SecInt(192) and SecInt(560) values and
   2^10 SecInt(1504) (7, 19 and 48 limbs; the range's ends, 0 and equal
   pairs planted), and SecInt(560) at (2, 5): np_less, np_sgn and the
   comparison in EQ mode (np_sgn(..., EQ=True)), np_equal at SecInt(192)
   ([NO07] above 60 bits), every opened output equal to Python's; the
   median ms of 3 calls and comparisons/s;
26. k1 shapes: K1's launches on each path by block count (each driven
   path prints its own; a record of the launcher's calls, no counter of
   the wrapper's), and K1 timed at each block count the paths launched
   (CTAs, device time replayed from a CUDA graph, bound, the launch
   floor);
27. report: one JSON line of the kernels (every instantiation that a path
   launches), the card's name and power limit, and last
   ``{"ok": true, "device": {...}}``.

Each of phases 4-11, 13-16, 18-25 zeroes the launch counters just
before it and reads them just after, and records K1's launches by block
count; each must show that the
instantiations of its path ran (``PATH_ENTRIES``), and that it launched
no instantiation the kernels line does not list.

Any failed check raises, and the script exits non-zero without the last
line. Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import faulthandler
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
from hashlib import shake_128
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from mpyc_tpu_torch import sectypes  # noqa: E402
from mpyc_tpu_torch.models import pipelines  # noqa: E402
from mpyc_tpu_torch.ops import fieldops, keccak, rng  # noqa: E402
from mpyc_tpu_torch.ops.fieldops import prime_field_ctx  # noqa: E402
from mpyc_tpu_torch.parallel.simulator import SimRuntime  # noqa: E402

N_POOL = 256                   # values whose input draws use the pool
N_CMP = 1 << 20                # comparison: bench.py:203, one K5 chunk
CMP_CALLS = 7                  # np_less calls timed (median)
PROFILE_CALLS = 3              # np_less calls under torch.profiler
N_KCHECK = 1 << 16             # K4, K5 against their plain versions
N_RAGGED = 100003              # K3 at no multiple of its thread block
N_SPLIT = 147 * 16 * 128 * 10  # bench.py:105-108 (3,010,560)
SPLIT_ROUNDS = 100             # chained split/recombine rounds
N_SMALL = 4096                 # bench.py's in-run correctness check
N_BIG = 1 << 22                # bench.py's size on the device
ROUNDS = 10                    # chained np_multiply calls
SAMPLE = 4096                  # opened outputs checked against plaintext
N_BNN = 100                    # images of the bnn phase (B), 0-99
N_BNN_CMP = N_BNN * 4096       # a BNN layer's comparison (100 x 4096)
N_SELFTEST = 100               # batch of the selftest phase
N_WIDE = 1 << 20               # SecInt(64) values of the wide product phase
N_CNN = 100                    # images of the cnn phase (B), 0-99
N_CNN_SELFTEST = 100           # batch of the cnn selftest phase (8 x 8)
N_K5_WIDE = 1 << 14            # K5 at L = 3 against its plain version
N_CHUNKED = 6 * 1024 + 100     # K5 at L = 3 in one launch of 7 chunks
CNN_WIDTHS = (16, 23, 30, 37)  # the CNN's comparison widths
# comparisons of a CNN pass: two a maxpool, three ReLUs, and the argmax's
# four rounds on 10 columns (5, 2, 1 and 1 pairs)
CNN_COMPARISONS = 11
# elements of each width's largest comparison at B = 100 (maxpool1's
# first round, maxpool2's, ReLU after fc1); the argmax's calls (l = 37)
# have at most 500, so K5 at l = 37 is timed at 2^14
CNN_CMP = {16: N_CNN * 32 * 14 * 28, 23: N_CNN * 64 * 7 * 14,
           30: N_CNN * 1024, 37: 1 << 14}
WARM = 3                       # warm passes of a network (median)
N_FXP = 100                    # images of the cnn fxp phase (B), 0-99
FXP_L, FXP_F = 14, 6           # SecFxp(14, 6), the demo's fixed point
FXP_CONV1 = N_FXP * 784 * 32   # conv1's products, each truncated
FXP_BITS = FXP_F * FXP_CONV1   # their random bits (K6's elements)
FXP_POOL1 = N_FXP * 32 * 14 * 28   # maxpool1's first comparison
N_POW_WIDE = 1 << 22           # K6 at three limbs
M, T = 3, 1
# parties other than three (phase "parties"): K3, K4, K5 and K7 held
# against their plain versions at (t, m) = (1, 4), (2, 5), (3, 7) and
# (4, 9) at 2^16 elements, and at the paths' shapes; the main
# path at (2, 5), (3, 7) and (4, 9), the comparisons at (2, 5) and (3, 7),
# the split/recombine round, the BNN and the fixed-point CNN at (2, 5)
PARTIES_CHECK = ((1, 4), (2, 5), (3, 7), (4, 9))
PARTIES_MAIN = ((2, 5), (3, 7), (4, 9))
PARTIES_CMP = ((2, 5), (3, 7))
PARTIES_NET = (2, 5)
PARTIES_WARM = 1               # warm passes of the networks at (2, 5)
TAIL_SLICE = 1 << 22           # K7's plain version at conv1's bits, a slice
# the (1, 3) rows of PERF.md section 6 that K3, K4, K5 and K7 own, ms on
# NVIDIA H100 80GB HBM3, 700 W, each its PR's final tree: phase "parties"
# prints this tree's beside them
PR_MS = {'reshare_mul<L=2, fused>': 0.2463, 'reshare_mul<L=2>': 0.2164,
         'split_recombine': 0.1474, 'sgn_step<LT, l=32, L=2>': 5.4808,
         'random_bits_tail<L=2, lazy>': 1.9924}
# the LP solver (demos/np_lpsolver.py): the datasets the lp phase solves,
# and each field's widest comparison on its path (the elements of the
# widest np_less: a cost row or a certificate's row) and the secure
# numbers of a [NO07] zero test (one: c.x == y.b) with its k = 30 random
# bits
LP_DATASETS = (0, 1, 2, 3, 4, 5, 6, 7)
# datasets stopped after a number of pivots, their tableau held against
# plain_solve's: kb2 (SecInt(560), 19 limbs) after 12 of its 154 (a cut
# for time: 0.37 s a pivot, PERF.md section 2), and after
# LP_KB2_PARTIES[1] at (t, m) = LP_KB2_PARTIES[0] in phase "parties"
LP_KB2 = 6
LP_PIVOTS = {LP_KB2: 12}
LP_KB2_PARTIES = ((2, 5), 2)
# the datasets traced by torch.profiler, each over its pivots window[0]
# .. window[1] - 1: LPExample's 11 and 12 (of 175), kb2's 2
LP_PROFILES = ((7, (11, 13)), (LP_KB2, (2, 3)))
LP_FIELDS = {                  # l -> (m + n, the widest comparison)
    8: (5, 3), 6: (5, 3), 70: (40, 20), 104: (118, 70), 110: (490, 288)}
LP_UPDATE = {70: 21 * 21, 104: 71 * 49, 110: 203 * 289}  # rank-1 update
LP_NO07_BITS = 30
# the fixed-point LP solver (demos/np_lpsolverfxp.py): the datasets the
# "lp fxp" phase solves, each at its own SecFxp(l) (f = l / 2: fields of
# two limbs at l = 18, three at 24 and 36, four at 52, six at 96), the
# dataset traced by torch.profiler and its window of pivots; per (l, f)
# the widest comparison of its path (max(m, n): the ratios' guard, the
# certificate's rows), and the rank-1 update's elements of uvlp (three
# limbs) and kb2 (six), truncated after each product
LPFXP_DATASETS = (0, 1, 2, 3, 4, 5, 6)
LPFXP_PROFILE = 6
# kb2's 173 pivots took about 170 s of the script's 1,100 (0.97 s a
# pivot, host-bound) and sc50b's 52 about 40: their solves stop after 16
# and 20, every instantiation they launch launched by then (kb2's
# certificate's comparisons are the pivots' K5 at l = 96, sc50b's
# LPExample_R20's at l = 52)
LPFXP_PIVOTS = {'sc50b': 20, 'kb2': 16}
LPFXP_WINDOW = (2, 3)          # early: the traced solve stops there
LPFXP_CMP = {(18, 9): 2, (24, 12): 3, (36, 18): 3, (52, 26): 70,
             (96, 48): 68}
LPFXP_UPDATE = {(24, 12): 3 * 4, (96, 48): 69 * 42}
# the survival test (demos/kmsurvival.py), each run with --agg (whose
# compaction tests every time step for events: a zero test): (dataset,
# accuracy A for SecFxp(2A, A), 0 the demo's): btrial (SecFxp(56, 28),
# four limbs: zero tests by K5 in EQ mode), aml (SecFxp(64, 32), four
# limbs with 4p >= R: [NO07]'s zero tests, the canonical K6 and K7) and
# aml at A = 48 (SecFxp(96, 48), six limbs: K6 in its [NO07] zero tests'
# Legendre symbols); aml's 161 weeks a division, 32 bits each
KM_RUNS = ((0, 0, True), (2, 0, True), (2, 48, True))
ROOT = Path(__file__).resolve().parent
# datasets of "lp fxp" solved from a recorded state (file, line) in place
# of fixed_keys: sc50b from the first of 24 solves on fresh keys on the
# card (certificate true); line 1 of the file is the second (false), and
# the first fixed keys tried, fixed_keys('lp fxp sc50b'), were false too,
# in this port and in the JAX demo (PERF.md section 7)
LPFXP_RECORDED = {'sc50b': ('tools/data/lpfxp_sc50b.jsonl', 0)}
KM_AML_BITS = 161 * 32
# the binary-field paths (demos/np_sha3.py, demos/np_aes.py): SHA3-256 and
# SHAKE128 of 256 messages (bench.py:354), AES-128 and AES-256 of 2,048
# blocks (README.md's np_aes -b 2048); the fused products' shapes: SHA3's
# chi state (3, 256, 5, 5, 64) on its bucket of 2^19 in GF(4), AES's
# S-box powers (3, 2048, 4, 4) in GF(2^8), the key schedule's (3, 4) on a
# bucket of 64
N_SHA3 = 256
N_AES = 2048
SHA3_CHI = 1 << 19
AES_SBOX = N_AES * 16
AES_KEY = 64
GF4, GF256 = 0b111, 0x11B      # the moduli: x^2 + x + 1, AES's
# the secure aggregates and sorting (demos/id3gini.py, demos/sort.py) and
# the one-way hash chains (demos/np_onewayhashchains.py): the ID3 trees of
# the seven datasets of demos/data/id3 at the demo's bit lengths (KRKPA7,
# 3,196 samples x 36 attributes at SecInt(69), the widest; its root node
# traced); np_sort, np_amax and np_amin of 2^20 SecInt(32) values (210
# Batcher stages); sorted with key a**2 of the demo's 64 values shuffled
# by random.shuffle; hash chains of length 2^4 by AES and by SHAKE128
# (optimal pebbling, a random seed; 2^4, not 2^5, for the run's time) and
# 2^3 by AES (eager pebbling)
ID3_DATASETS = (0, 1, 2, 3, 4, 5, 6)
ID3_PROFILE = 4
ID3_WIDTHS = ((42, 3), (62, 3), (69, 4), (75, 4), (77, 4), (95, 4))
N_SORT = 1 << 20
N_SORTED = 64
HC_RUNS = (('AES, k = 4', 4, False, False),
           ('SHAKE128, k = 4', 4, False, True),
           ('AES, k = 3, eager', 3, True, False))
# the co-located demos of demos/run-all.sh (secretsanta,
# SecretSantaExplained, indextounitvector, unanimous, PrefixOrExplained and
# sort's secure list) at their defaults, then at sizes users run: a Secret
# Santa of 64 (an office's draw), unit vectors of 1,024 over GF(1031) =
# SecFld(min_order=1024) and SecInt(32), a secure list of 1,024 SecInt(32)
# values, and the secure prime fields GF(1031) (4p < 2^32: the lazy
# one-limb K6 and K7) and GF(2^31 - 1) (canonical) at 1,024 elements
N_SANTA = 64
N_UNIT = 1024
N_SECLIST = 1024
N_FLD = 1024
FLD_PRIMES = (1031, (1 << 31) - 1)
# the linear-algebra phase (ridge regression, the pseudoinverse,
# multilateration): the limbs of the wide fields its paths take, each with
# the d of its d x d system (ridge regression's synthetic set at
# accuracies 4-7: 7, 8, 9, 9 limbs, d = 11; the wine data 10 and 12, d =
# 12; student-mat 42, d = 57; multilateration 12, d = 3; the 20 x 20
# pseudoinverse 7), the shapes of the kernels' calls there: K3 fused on
# the bucket of 64 (det R's diagonal products, (adj A) B = (A^-1 B) det
# A), K3 without the product on the bucket of d^2 (R A's reshare), K9 on
# the conversion's d (d + 1) values, K6 on det R's reciprocal
LINALG_WIDE = {7: 11, 8: 11, 9: 11, 10: 12, 12: 12, 42: 57}
LINALG_ALPHAS = (4, 5, 6, 7)   # the synthetic set's accuracies
LINALG_DATASETS = (2, 3, 1)    # winequality-red, -white, student-mat
# the pseudoinverses: (m, n, rank, bits of the entries, seed): the demo's
# 5 x 5 (SecInt(31), two limbs) and a 20 x 20 of rank 16 (SecInt(163),
# seven limbs: its zero tests [NO07]'s, K7 and K6 at seven limbs)
PINV_RUNS = ((5, 5, 5, 4, 1), (20, 20, 16, 6, 1))
N_MLAT = 8                     # multilateration's measurements (of 615;
#                                a cut for the run's time)
LINALG_SEED = 31
# comparisons over wide prime fields (csrc/sgn_wide.cu): phase "wide
# comparison" compares (np_less, np_sgn, and at WIDE_EQUAL_BITS np_equal)
# random values at each (bits of SecInt, values) of WIDE_CMP, 7, 19 and
# 48 limbs, and at SecInt(560) at (t, m) = (2, 5) too, the median of
# WIDE_CMP_CALLS calls
WIDE_CMP = ((192, 1 << 14), (560, 1 << 14), (1504, 1 << 10))
WIDE_CMP_PARTIES = (560, 1 << 14, 2, 5)
WIDE_CMP_CALLS = 3
WIDE_EQUAL_BITS = 192
# the wide K5 held against its plain version (check_wide_sgn_kernels):
# (bits of SecInt, or 0 for kb2's field; its limbs; l; modes; (t, m);
# elements: 68, kb2's widest call (its ratios' rows), as np_sgn makes it
# (on its bucket of 128), else 8 in one call of their own: the plain
# version's time grows with the elements, at 48 limbs and l = 1504 from
# 5-10 s a mode on a bucket of 64)
WIDE_SGN_CHECK = (
    (192, 7, 192, pipelines.SGN_MODES, (1, 3), 8),
    (192, 7, 192, ('LT',), (2, 5), 8), (192, 7, 192, ('LT',), (4, 9), 8),
    (560, 19, 64, pipelines.SGN_MODES, (1, 3), 8),
    (0, 19, 560, ('LT',), (1, 3), 68),
    (560, 19, 560, ('sgn', 'EQ'), (1, 3), 8),
    (560, 19, 560, pipelines.SGN_MODES, (2, 5), 8),
    (1504, 48, 32, pipelines.SGN_MODES, (1, 3), 8),
    (1504, 48, 1504, pipelines.SGN_MODES, (1, 3), 8))
# the wide K5 at the paths' shapes, one launch each, its first and last
# chunk held against the plain version (bits of SecInt, or 0 for kb2's
# field; mode; (t, m); elements; chunk, 0 for np_sgn's 1,024): phase
# "wide comparison"'s 2^14 at 7 and 19 limbs (16 chunks: 1,024 CTAs of 16
# elements each) and 2^10 at 48 (a full grid of 1,024 CTAs, in chunks of
# 32: the plain version of a 1,024-element call at l = 1504 does not fit
# in the card's memory), kb2's 68 at (2, 5); l the field's bits, one mode
# a shape, the modes in turn
WIDE_SGN_PATHS = ((192, 'sgn', (1, 3), 1 << 14, 0),
                  (560, 'LT', (1, 3), 1 << 14, 0),
                  (1504, 'EQ', (1, 3), 1 << 10, 32),
                  (0, 'LT', (2, 5), 68, 0))
# the wide K3 (fused and not) and K7 at (t, m) other than (1, 3): K3 at
# SecInt(bits) of L limbs for each (bits, L) (7, 8, 9, 12, 19, 42 limbs:
# the fields phase "parties" and kb2 take at (2, 5), and 7, 12, 42 at
# (4, 9)) on WIDE_PARTIES_N elements, K7 at 7 and 12 limbs (at 42 its
# plain version's 1,300-bit power takes about 20 s on the card: the
# host build holds it, tests/test_torch_kernels_host.py)
WIDE_PARTIES_CHECK = {
    (2, 5): ((192, 7), (220, 8), (250, 9), (335, 12), (560, 19),
             (1300, 42)),
    (4, 9): ((192, 7), (335, 12), (1300, 42))}
WIDE_TAIL_BITS = (192, 335)
WIDE_PARTIES_N = 64
# phase "parties" over wide fields at PARTIES_NET: ridge regression's
# synthetic set at accuracies LINALG_ALPHAS, multilateration's first
# N_MLAT_PARTIES measurements
N_MLAT_PARTIES = 2
# the (1, 3) rows of PERF.md section 6 that the wide K3 and K7 own, ms on
# NVIDIA H100 80GB HBM3, 700 W, measured before they took every (t, m):
# phase "kernels" prints this tree's beside them
WIDE_MS_BEFORE = {
    'reshare_mul<L=7, fused>': 0.0953, 'reshare_mul<L=8, fused>': 0.1017,
    'reshare_mul<L=9, fused>': 0.1046, 'reshare_mul<L=10, fused>': 0.1189,
    'reshare_mul<L=12, fused>': 0.1398, 'reshare_mul<L=42, fused>': 0.7946,
    'reshare_mul<L=7>': 0.0812, 'reshare_mul<L=8>': 0.0867,
    'reshare_mul<L=9>': 0.0880, 'reshare_mul<L=10>': 0.1032,
    'reshare_mul<L=12>': 0.1157, 'reshare_mul<L=42>': 0.6617,
    'random_bits_tail<L=7>': 1.2087}
DEADLINE_S = 1100              # hard stop, inside the 1200 s limit

# Peaks for bound_ms (H100 SXM, 700 W; see PERF.md). Integer work is
# counted in 32-bit instructions of three classes, a vector (mul, add,
# logic): multiplies run only on the FMA pipe, logic ops (three-input
# LOP3, funnel shifts) only on the integer ALU pipe, adds, subtractions
# and selects on either (IADD3 or IMAD.IADD). Each pipe retires 64
# instructions a clock per SM (132 SMs x 64 x 1.98 GHz = 16.7e12/s) and
# the SM issues at most 128 a clock, so the least time is the largest of
# mul, logic and (mul + add + logic) / 2 over that rate
# (``int_lane_ops``).
HBM_BYTES_PER_S = 3.35e12
INT_OPS_PER_S = 132 * 64 * 1.98e9
INT8_TENSOR_OPS_PER_S = 1979e12   # dense int8 tensor-core peak
# Counted at their fewest: a Keccak-f round is 20 three-input XORs (column
# parities) + 10 funnel shifts (theta rotations) + 50 XORs (theta) + 48
# funnel shifts (rho) + 50 three-input chi ops + 2 (iota) on the 32-bit
# halves, all logic. An L-limb Montgomery product (CIOS, csrc/limb.cuh
# mont_mul): in each of its L steps 2 L + 1 multiplies (a_j b_i and m p_j
# one wide multiply each, m = t_0 n0inv its low word) and 3 L adds of the
# carries, then L subtractions and L selects: 2 L^2 + L multiplies and
# 3 L^2 + 2 L adds, (10, 16) at L = 2 and (21, 33) at L = 3. A modular add
# (add_mod): L adds, L subtractions, L selects and 2 for the carry and
# borrow: 3 L + 2 adds, 8 at L = 2 and 11 at L = 3.
KECCAK_F_OPS = np.array([0, 0, 24 * 180])


def mont_mul_ops(L: int) -> np.ndarray:
    return np.array([2 * L * L + L, 3 * L * L + 2 * L, 0])


def add_mod_ops(L: int) -> np.ndarray:
    return np.array([0, 3 * L + 2, 0])


# A lazy Montgomery square (csrc/limb.cuh mont_sqr_lazy, the cheapest
# product K6 and K7 use): L (L - 1) / 2 cross products and L squares, one
# wide multiply and one add each (the square's add into the next word
# too), 2 L - 1 funnel shifts to double the cross products, and L rows of
# reduction of L + 1 multiplies (m and m p_j) and L + 1 adds; no final
# subtraction: (9, 11, 3) at L = 2, (18, 21, 5) at L = 3.
def mont_sqr_lazy_ops(L: int) -> np.ndarray:
    cross = L * (L - 1) // 2
    return np.array([cross + L + L * (L + 1), cross + 2 * L + L * (L + 1),
                     2 * L - 1])


def int_lane_ops(ops) -> float:
    """Instructions a lane of one pipe retires at the least for the
    (mul, add, logic) counts ops: the busier of the two pipes, with the
    adds spread between them."""
    mul, add, logic = np.broadcast_to(np.asarray(ops, dtype=np.float64), 3)
    return float(max(mul, logic, (mul + add + logic) / 2))


SOURCE = 'mpyc_tpu_torch/csrc/kernels.cu'
KERNELS = {
    'keccak_ctr': dict(replaces='mpyc_tpu/ops/keccak.py:215',
                       wrapper=keccak.keccak_ctr, source=SOURCE),
    'squeeze_mont': dict(replaces='mpyc_tpu/ops/rng.py:99',
                         wrapper=rng.squeeze_mont, source=SOURCE),
    'reshare_mul': dict(replaces='mpyc_tpu/models/pipelines.py:87',
                        wrapper=pipelines.reshare_mul, source=SOURCE),
    'split_recombine': dict(replaces='mpyc_tpu/models/pipelines.py:378',
                            wrapper=pipelines.split_recombine,
                            source=SOURCE),
    'sgn_step': dict(replaces='mpyc_tpu/models/pipelines.py:503',
                     wrapper=pipelines.sgn_step,
                     source='mpyc_tpu_torch/csrc/sgn.cuh'),
    # no Pallas kernel: XLA runs the JAX package's power ladder, and the
    # tail of its random bits
    'mont_pow': dict(replaces='mpyc_tpu/ops/limb.py:330',
                     wrapper=fieldops.mont_pow,
                     source='mpyc_tpu_torch/csrc/pow.cuh'),
    'random_bits_tail': dict(
        replaces='mpyc_tpu/parallel/simulator.py:732',
        wrapper=pipelines.random_bits_tail,
        source='mpyc_tpu_torch/csrc/pow.cuh'),
    # an XLA program around K1 (its stream), which K8 squeezes itself
    'reshare2': dict(replaces='mpyc_tpu/models/pipelines.py:1065',
                     wrapper=pipelines.reshare2,
                     source='mpyc_tpu_torch/csrc/gf2.cu'),
    # no Pallas kernel: XLA fuses the JAX package's limb arithmetic
    'field_op': dict(replaces='mpyc_tpu/ops/limb.py:247',
                     wrapper=fieldops.field_op, source=SOURCE),
}
# Every instantiation that a path launches, as the kernels line lists it:
# entry name -> (kernel, key of its wrapper's ``by_key`` count, or None for
# a kernel of one instantiation). Keys: K2 (limbs, words a draw), K3
# (limbs, fused), K5 (mode, l, limbs, f: the width and the fixed-point
# scale are parameters of the launch), K6 and K7 (limbs, lazy: 4p < R).
# The LP solver launches K6 at two, four and five limbs (its reciprocals'
# public inverses, its zero tests' Legendre symbols).
ENTRIES = {
    'keccak_ctr': ('keccak_ctr', None),
    'squeeze_mont<L=2, W=6>': ('squeeze_mont', (2, 6)),
    'squeeze_mont<L=3, W=7>': ('squeeze_mont', (3, 7)),
    'reshare_mul<L=2, fused>': ('reshare_mul', (2, True)),
    'reshare_mul<L=2>': ('reshare_mul', (2, False)),
    'reshare_mul<L=3, fused>': ('reshare_mul', (3, True)),
    'reshare_mul<L=3>': ('reshare_mul', (3, False)),
    'split_recombine': ('split_recombine', (T, M)),
    **{f'sgn_step<{mode}, l=32, L=2>': ('sgn_step', (mode, 32, 2, 0))
       for mode in pipelines.SGN_MODES},
    **{f'sgn_step<LT, l={l}, L=2>': ('sgn_step', ('LT', l, 2, 0))
       for l in (14, 10)},
    **{f'sgn_step<LT, l={l}, L=3>': ('sgn_step', ('LT', l, 3, 0))
       for l in CNN_WIDTHS},
    'sgn_step<LT, l=14, L=2, f=6>': ('sgn_step', ('LT', FXP_L, 2, FXP_F)),
    # the LP solver: two limbs at l = 6 and 8, four at l = 70, five at
    # l = 104 and 110 (no EQ mode there: [NO07], K7 and K6)
    **{f'sgn_step<{mode}, l={l}, L=2>': ('sgn_step', (mode, l, 2, 0))
       for l in (8, 6) for mode in ('LT', 'EQ')},
    **{f'sgn_step<LT, l={l}, L={L}>': ('sgn_step', ('LT', l, L, 0))
       for l, L in ((70, 4), (104, 5), (110, 5))},
    **{f'reshare_mul<L={L}{s}>': ('reshare_mul', (L, fused))
       for L in (4, 5) for fused, s in ((True, ', fused'), (False, ''))},
    'mont_pow<L=2, lazy>': ('mont_pow', (2, True)),
    **{f'mont_pow<L={L}, lazy>': ('mont_pow', (L, True)) for L in (4, 5)},
    'random_bits_tail<L=2, lazy>': ('random_bits_tail', (2, True)),
    **{f'random_bits_tail<L={L}, lazy>': ('random_bits_tail', (L, True))
       for L in (4, 5)},
    # the fixed-point LP solver and the survival test: K5 at each
    # SecFxp(l, f)'s width and scale (LT; EQ at btrial's zero tests), K3
    # at six limbs, K6 and K7 at six limbs and on SecFxp(64, 32)'s field,
    # four limbs with 4p >= R (canonical), K7 at three limbs
    **{f'sgn_step<LT, l={l}, L={L}, f={f}>': ('sgn_step', ('LT', l, L, f))
       for l, L, f in ((18, 2, 9), (24, 3, 12), (36, 3, 18), (52, 4, 26),
                       (96, 6, 48))},
    'sgn_step<EQ, l=56, L=4, f=28>': ('sgn_step', ('EQ', 56, 4, 28)),
    'reshare_mul<L=6, fused>': ('reshare_mul', (6, True)),
    'reshare_mul<L=6>': ('reshare_mul', (6, False)),
    'mont_pow<L=4>': ('mont_pow', (4, False)),
    'mont_pow<L=6, lazy>': ('mont_pow', (6, True)),
    'random_bits_tail<L=3, lazy>': ('random_bits_tail', (3, True)),
    'random_bits_tail<L=4>': ('random_bits_tail', (4, False)),
    'random_bits_tail<L=6, lazy>': ('random_bits_tail', (6, True)),
    # K8 (d, fused): SHA3's chi in GF(4), AES's S-box powers in GF(2^8)
    'reshare2<d=2, fused>': ('reshare2', (2, True)),
    'reshare2<d=8, fused>': ('reshare2', (8, True)),
    # K9 (limbs): every product, add and subtraction of field arrays
    # between the kernels above, on every prime-field path
    **{f'field_op<L={L}>': ('field_op', L) for L in (2, 3, 4, 5, 6)},
    # the ID3 trees: K5 in LT mode at each dataset's width (the argmax of
    # the class sizes, the stop test, the Gini fractions' comparisons), in
    # EQ mode at SecInt(42)'s (mx == sizeT; from SecInt(62) on [NO07]); K6
    # at three limbs (the reciprocals' inverses, SecInt(62)'s Legendre
    # symbols)
    **{f'sgn_step<LT, l={l}, L={L}>': ('sgn_step', ('LT', l, L, 0))
       for l, L in ID3_WIDTHS},
    'sgn_step<EQ, l=42, L=3>': ('sgn_step', ('EQ', 42, 3, 0)),
    'mont_pow<L=3, lazy>': ('mont_pow', (3, True)),
    # SecInt(32)'s 64-bit field has 4p >= R: K6 canonical at two limbs
    # (tennis's reciprocals), K7 too (the shuffle's random bits)
    'mont_pow<L=2>': ('mont_pow', (2, False)),
    'random_bits_tail<L=2>': ('random_bits_tail', (2, False)),
    # the co-located demos: the secure prime fields' one-limb K3, K6 and
    # K7 (lazy for GF(1031), canonical for GF(2^31 - 1)) and K9; K5 at
    # SecFxp(32, 16)'s width and scale (unit_vector's zero tests,
    # seclist.sort's comparisons); K8 without its product (all() of
    # SecFld(2) votes: a product and a reshare)
    'reshare_mul<L=1, fused>': ('reshare_mul', (1, True)),
    'reshare_mul<L=1>': ('reshare_mul', (1, False)),
    'mont_pow<L=1, lazy>': ('mont_pow', (1, True)),
    'mont_pow<L=1>': ('mont_pow', (1, False)),
    'random_bits_tail<L=1, lazy>': ('random_bits_tail', (1, True)),
    'random_bits_tail<L=1>': ('random_bits_tail', (1, False)),
    'field_op<L=1>': ('field_op', 1),
    'sgn_step<EQ, l=32, L=3, f=16>': ('sgn_step', ('EQ', 32, 3, 16)),
    'sgn_step<LT, l=32, L=3, f=16>': ('sgn_step', ('LT', 32, 3, 16)),
    'reshare2<d=2>': ('reshare2', (2, False)),
    # the linear algebra: the wide kernels (csrc/wide.cu, one compiled
    # kernel each, L a launch parameter; no lazy form) at each field's
    # limbs; K7 at the 20 x 20 pseudoinverse's seven ([NO07]'s bits); K5
    # in EQ mode at the 5 x 5's SecInt(31) (its leaves' d == 0)
    **{f'reshare_mul<L={L}{s}>': ('reshare_mul', (L, fused))
       for L in LINALG_WIDE for fused, s in ((True, ', fused'), (False, ''))},
    **{f'field_op<L={L}>': ('field_op', L) for L in LINALG_WIDE},
    **{f'mont_pow<L={L}>': ('mont_pow', (L, False)) for L in LINALG_WIDE},
    'random_bits_tail<L=7>': ('random_bits_tail', (7, False)),
    'sgn_step<EQ, l=31, L=2>': ('sgn_step', ('EQ', 31, 2, 0)),
    # the integer LP's kb2 (SecInt(560), 19 limbs): its tableau's encoding
    # and arithmetic (K9), its products (K3), its reciprocals' public
    # inverses (K6), its comparisons (the wide K5, LT at l = 560)
    'field_op<L=19>': ('field_op', 19),
    'reshare_mul<L=19, fused>': ('reshare_mul', (19, True)),
    'reshare_mul<L=19>': ('reshare_mul', (19, False)),
    'mont_pow<L=19>': ('mont_pow', (19, False)),
    # phase "wide comparison": K9 at 48 limbs (SecInt(1504)'s input and
    # differences)
    'field_op<L=48>': ('field_op', 48),
}


def parties_entries() -> dict:
    """The instantiations of K3 (fused and not), K4, K5 (three modes, l =
    32) and K7 (SecFxp(14, 6)'s lazy field) at each (t, m) of
    PARTIES_CHECK, and K5 at the networks' widths at PARTIES_NET, as the
    kernels line lists them: t and m launch parameters (t a template
    parameter only at t = 1), each (t, m) an entry."""
    res = {}
    for t, m in PARTIES_CHECK:
        at = f't={t}, m={m}'
        res[f'reshare_mul<L=2, fused, {at}>'] = ('reshare_mul',
                                                 (2, True, t, m))
        res[f'reshare_mul<L=2, {at}>'] = ('reshare_mul', (2, False, t, m))
        res[f'split_recombine<{at}>'] = ('split_recombine', (t, m))
        for mode in pipelines.SGN_MODES:
            res[f'sgn_step<{mode}, l=32, L=2, {at}>'] = (
                'sgn_step', (mode, 32, 2, 0, t, m))
        res[f'random_bits_tail<L=2, lazy, {at}>'] = ('random_bits_tail',
                                                     (2, True, t, m))
    t, m = PARTIES_NET
    for l in (14, 10):
        res[f'sgn_step<LT, l={l}, L=2, t={t}, m={m}>'] = (
            'sgn_step', ('LT', l, 2, 0, t, m))
    res[f'sgn_step<LT, l={FXP_L}, L=2, f={FXP_F}, t={t}, m={m}>'] = (
        'sgn_step', ('LT', FXP_L, 2, FXP_F, t, m))
    return res


ENTRIES.update(parties_entries())


def wide_entries() -> dict:
    """The wide K5's instantiations (csrc/sgn_wide.cu, one compiled kernel:
    the keys name the launch's parameters) of WIDE_SGN_CHECK, and the wide
    K3 and K7 at the (t, m) of WIDE_PARTIES_CHECK, as the kernels line
    lists them."""
    res = {}
    for bits, L, l, modes, (t, m), _ in WIDE_SGN_CHECK:
        at = '' if (t, m) == (T, M) else f', t={t}, m={m}'
        for mode in modes:
            res[f'sgn_step<{mode}, l={l}, L={L}{at}>'] = (
                'sgn_step', (mode, l, L, 0) + pipelines.parties_key(t, m))
    for (t, m), fields in WIDE_PARTIES_CHECK.items():
        for bits, L in fields:
            for fused, s in ((True, ', fused'), (False, '')):
                res[f'reshare_mul<L={L}{s}, t={t}, m={m}>'] = (
                    'reshare_mul', (L, fused, t, m))
            if bits in WIDE_TAIL_BITS:
                res[f'random_bits_tail<L={L}, t={t}, m={m}>'] = (
                    'random_bits_tail', (L, False, t, m))
    return res


ENTRIES.update(wide_entries())
WIDE_SOURCE = 'mpyc_tpu_torch/csrc/wide.cu'
SGN_WIDE_SOURCE = 'mpyc_tpu_torch/csrc/sgn_wide.cu'
# K5's instantiations on three to six limbs whose paths call it on few
# elements, (mode, l, limbs, f): the LP solver's, the fixed-point LP's and
# the survival test's, the ID3 trees', the co-located demos', the CNN's
# argmax (at most 500 elements a call, N_CNN_ARGMAX). Their calls
# take K5's CTA route (csrc/sgn_wide.cu, ``mtt_sgn_cta``; the key's last
# element ``pipelines.SGN_CTA``); the narrow kernel's entry of each stays
# beside it, held and timed at the same shape (forced onto that route).
CTA_K5 = ((('LT', 70, 4, 0), ('LT', 104, 5, 0), ('LT', 110, 5, 0))
          + tuple(('LT', l, L, f) for l, L, f in ((24, 3, 12), (36, 3, 18),
                                                  (52, 4, 26), (96, 6, 48)))
          + (('EQ', 56, 4, 28),)
          + tuple(('LT', l, L, 0) for l, L in ID3_WIDTHS)
          + (('EQ', 42, 3, 0), ('EQ', 32, 3, 16), ('LT', 32, 3, 16),
             ('LT', 37, 3, 0)))
N_CNN_ARGMAX = 5 * N_CNN


def k5_name(mode: str, l: int, L: int, f: int = 0, t: int = T, m: int = M,
            cta: bool = False) -> str:
    """A K5 entry's name in the kernels line."""
    at = '' if (t, m) == (T, M) else f', t={t}, m={m}'
    return (f'sgn_step<{mode}, l={l}, L={L}{f", f={f}" if f else ""}{at}'
            f'{", cta" if cta else ""}>')


def cta_name(name: str) -> str:
    """The CTA route's entry beside a K5 entry of the narrow kernel."""
    return name[:-1] + ', cta>'


ENTRIES.update({k5_name(*key, cta=True): ('sgn_step', key + (
    pipelines.SGN_CTA,)) for key in CTA_K5})
# the CTA route at (t, m) past the narrow kernel's random bits
# (``_build.sgn_lb_fit``: the fixed-point kb2's width at (4, 9)) and K3 at
# kb2's rank-1 update at (2, 5), held by ``check_small_calls``
ENTRIES[k5_name('LT', 96, 6, 48, 4, 9, cta=True)] = (
    'sgn_step', ('LT', 96, 6, 48, 4, 9, pipelines.SGN_CTA))
ENTRIES['reshare_mul<L=6, fused, t=2, m=5>'] = ('reshare_mul',
                                                (6, True, 2, 5))


def entry_source(name: str, key) -> str:
    """The source of an instantiation of the kernels line: the wide
    kernels' for a field of 7 to 48 limbs."""
    from mpyc_tpu_torch import _build
    L = key if isinstance(key, int) else None
    if name in ('reshare_mul', 'mont_pow', 'random_bits_tail'):
        L = key[0]
    if name == 'sgn_step' and (_build.wide(key[2])
                               or key[-1] == pipelines.SGN_CTA):
        return SGN_WIDE_SOURCE
    return WIDE_SOURCE if L is not None and _build.wide(L) else \
        KERNELS[name]['source']
# the instantiations each path must launch
PATH_ENTRIES = {
    'main path': ('keccak_ctr', 'squeeze_mont<L=2, W=6>',
                  'reshare_mul<L=2, fused>', 'field_op<L=2>'),
    'comparison': ('squeeze_mont<L=2, W=6>', 'reshare_mul<L=2, fused>',
                   'sgn_step<sgn, l=32, L=2>', 'sgn_step<LT, l=32, L=2>',
                   'sgn_step<EQ, l=32, L=2>'),
    'split/recombine': ('split_recombine',),
    'bnn': ('reshare_mul<L=2>', 'reshare_mul<L=2, fused>',
            'sgn_step<LT, l=14, L=2>', 'sgn_step<LT, l=10, L=2>'),
    'selftest': ('keccak_ctr', 'reshare_mul<L=2>', 'reshare_mul<L=2, fused>',
                 'sgn_step<LT, l=14, L=2>'),
    'wide product': ('squeeze_mont<L=3, W=7>', 'reshare_mul<L=3, fused>'),
    # the products (K3), the maxpools' and ReLUs' comparisons (K5), the
    # argmax's (l = 37, at most 500 elements a call: K5's CTA route)
    'cnn': ('reshare_mul<L=3>', 'reshare_mul<L=3, fused>',
            *(f'sgn_step<LT, l={l}, L=3>' for l in CNN_WIDTHS[:-1]),
            'sgn_step<LT, l=37, L=3, cta>'),
    'cnn selftest': ('keccak_ctr', 'reshare_mul<L=3>',
                     'reshare_mul<L=3, fused>',
                     *(f'sgn_step<LT, l={l}, L=3>'
                       for l in CNN_WIDTHS[:-1]),
                     'sgn_step<LT, l=37, L=3, cta>'),
    # PRSS streams (K1), every product's reshare (by a comparison's
    # integral bit, or a matmul's before its truncation: K3 without the
    # product), the comparisons at 2^6 (K5), the random bits' tails with
    # their inverse square roots (K7)
    'cnn fxp': ('keccak_ctr', 'reshare_mul<L=2>',
                'sgn_step<LT, l=14, L=2, f=6>',
                'random_bits_tail<L=2, lazy>'),
    # every secure product and matmul's reshare (K3), the comparisons
    # (K5; EQ at l = 6 and 8 for the certificate's c.x == y.b), the
    # reciprocals' public inverses and the zero tests' Legendre symbols
    # (K6), the zero tests' random bits (K7); the PRSS draws are of 256
    # blocks or fewer, which the host squeezes (no K1)
    'lp': ('reshare_mul<L=2, fused>', 'reshare_mul<L=2>',
           *(f'reshare_mul<L={L}{s}>' for L in (4, 5)
             for s in (', fused', '')),
           *(f'sgn_step<{mode}, l={l}, L=2>' for l in (8, 6)
             for mode in ('LT', 'EQ')),
           'sgn_step<LT, l=70, L=4, cta>', 'sgn_step<LT, l=104, L=5, cta>',
           'sgn_step<LT, l=110, L=5, cta>',
           *(f'mont_pow<L={L}, lazy>' for L in (2, 4, 5)),
           *(f'random_bits_tail<L={L}, lazy>' for L in (4, 5)),
           'field_op<L=19>', 'reshare_mul<L=19, fused>', 'reshare_mul<L=19>',
           'sgn_step<LT, l=560, L=19>', 'mont_pow<L=19>'),
    # every truncated product (K3 fused) and every product by an integral
    # operand (K3 without the product), the comparisons at each type's
    # width and scale 2^f (K5), the truncations' random bits (K7)
    'lp fxp': (*(f'reshare_mul<L={L}{s}>' for L in (2, 3, 4, 6)
                 for s in (', fused', '')),
               'sgn_step<LT, l=18, L=2, f=9>',
               *(f'sgn_step<LT, l={l}, L={L}, f={f}, cta>' for l, L, f in
                 ((24, 3, 12), (36, 3, 18), (52, 4, 26), (96, 6, 48))),
               *(f'random_bits_tail<L={L}, lazy>' for L in (2, 3, 4, 6)),
           *(f'field_op<L={L}>' for L in (2, 3, 4, 6))),
    # the maximum time (SecInt(32) comparisons), btrial's zero tests (K5
    # in EQ mode), aml's [NO07] zero tests (their random bits, K7, and
    # Legendre symbols, K6) on the canonical four-limb field and at six
    # limbs, the divisions' truncations (K7), every product (K3)
    'km': ('reshare_mul<L=4, fused>', 'reshare_mul<L=4>',
           'reshare_mul<L=6, fused>', 'reshare_mul<L=6>',
           'sgn_step<LT, l=32, L=2>', 'sgn_step<EQ, l=56, L=4, f=28, cta>',
           'mont_pow<L=4>', 'mont_pow<L=6, lazy>',
           'random_bits_tail<L=4, lazy>', 'random_bits_tail<L=4>',
           'random_bits_tail<L=6, lazy>', 'field_op<L=4>',
           'field_op<L=6>'),
    # every chi round's product (K8 in GF(4), squeezing its own stream;
    # the messages' input draws come from the pool that earlier phases
    # filled, so SHA3 launches no K1 here)
    'sha3': ('reshare2<d=2, fused>',),
    # the S-box powers' products (K8 in GF(2^8)), and the bit
    # decompositions' PRSS random bits (K1 above 256 blocks)
    'aes': ('keccak_ctr', 'reshare2<d=8, fused>'),
    # every product and matrix product's reshare (K3 at two to four
    # limbs), the comparisons at each width (K5), the equality at
    # SecInt(32) and (42) (K5 EQ), SecInt(62)-(95)'s [NO07] zero tests
    # (K7, K6's Legendre symbols), the reciprocals' inverses (K6), the
    # field arithmetic between them (K9)
    'id3': (*(f'reshare_mul<L={L}{s}>' for L in (2, 3, 4)
              for s in (', fused', '')),
            'sgn_step<LT, l=32, L=2>', 'sgn_step<EQ, l=32, L=2>',
            *(f'sgn_step<LT, l={l}, L={L}, cta>' for l, L in ID3_WIDTHS),
            'sgn_step<EQ, l=42, L=3, cta>',
            'mont_pow<L=2>', 'mont_pow<L=3, lazy>',
            'mont_pow<L=4, lazy>', 'mont_pow<L=4>',
            'random_bits_tail<L=3, lazy>', 'random_bits_tail<L=4, lazy>',
            'random_bits_tail<L=4>',
            *(f'field_op<L={L}>' for L in (2, 3, 4))),
    # the input's draws (K2), each Batcher stage's and tournament level's
    # comparison (K5) and product (K3), the shuffle's random bits (K7)
    # and its dot products' reshares (K3 without the product)
    'sort': ('squeeze_mont<L=2, W=6>', 'reshare_mul<L=2, fused>',
             'reshare_mul<L=2>', 'sgn_step<LT, l=32, L=2>',
             'random_bits_tail<L=2>', 'field_op<L=2>'),
    # AES's S-box products (K8 in GF(2^8)) and SHAKE128's chi (K8 in
    # GF(4))
    'hash chains': ('reshare2<d=8, fused>', 'reshare2<d=2, fused>'),
    # the secure prime fields' products and Fermat tests (K3 fused at one
    # limb), the reciprocals' reshares (K3) and public inverses (K6, lazy
    # and canonical), randrange's random bits (K7, lazy and canonical),
    # their arithmetic between (K9); the zero tests and comparisons at
    # SecFxp(32, 16) (K5) and the AND of SecFld(2) votes (K8 without the
    # product)
    'co-located demos': ('reshare_mul<L=1, fused>', 'reshare_mul<L=1>',
                         'mont_pow<L=1, lazy>', 'mont_pow<L=1>',
                         'random_bits_tail<L=1, lazy>',
                         'random_bits_tail<L=1>', 'field_op<L=1>',
                         'sgn_step<EQ, l=32, L=3, f=16, cta>',
                         'sgn_step<LT, l=32, L=3, f=16, cta>',
                         'reshare2<d=2>'),
    # every wide field's products and reshares (K3), its arithmetic and
    # its draws' reduction (K9), det R's public inverse (K6); the 20 x 20
    # pseudoinverse's zero tests (K7 at seven limbs); the 5 x 5's (K5 EQ)
    'linear algebra': (*(f'reshare_mul<L={L}{s}>' for L in LINALG_WIDE
                         for s in (', fused', '')),
                       *(f'field_op<L={L}>' for L in LINALG_WIDE),
                       *(f'mont_pow<L={L}>' for L in LINALG_WIDE),
                       'random_bits_tail<L=7>', 'sgn_step<EQ, l=31, L=2>'),
}



def parties_path_entries() -> dict:
    """The instantiations each path of phase "parties" must launch."""
    res = {}
    for t, m in PARTIES_MAIN:
        res[f'main path ({t}, {m})'] = (
            'squeeze_mont<L=2, W=6>',
            f'reshare_mul<L=2, fused, t={t}, m={m}>', 'field_op<L=2>')
    for t, m in PARTIES_CMP:
        res[f'comparison ({t}, {m})'] = (
            f'reshare_mul<L=2, fused, t={t}, m={m}>',
            *(f'sgn_step<{mode}, l=32, L=2, t={t}, m={m}>'
              for mode in pipelines.SGN_MODES))
    t, m = PARTIES_NET
    at = f't={t}, m={m}'
    res[f'split/recombine ({t}, {m})'] = (f'split_recombine<{at}>',)
    res[f'bnn ({t}, {m})'] = (f'reshare_mul<L=2, {at}>',
                              f'reshare_mul<L=2, fused, {at}>',
                              f'sgn_step<LT, l=14, L=2, {at}>',
                              f'sgn_step<LT, l=10, L=2, {at}>')
    res[f'cnn fxp ({t}, {m})'] = (
        'keccak_ctr', f'reshare_mul<L=2, {at}>',
        f'sgn_step<LT, l={FXP_L}, L=2, f={FXP_F}, {at}>',
        f'random_bits_tail<L=2, lazy, {at}>')
    return res


PATH_ENTRIES.update(parties_path_entries())


def wide_path_entries() -> dict:
    """The instantiations each path over wide fields at other (t, m), and
    each of phase "wide comparison", must launch."""
    t, m = PARTIES_NET
    at = f't={t}, m={m}'
    res = {
        # kb2's pivots: products (K3), comparisons (the wide K5), the
        # reciprocals' public inverses (K6), the arithmetic between (K9)
        f'lp kb2 ({t}, {m})': (
            f'reshare_mul<L=19, fused, {at}>', f'reshare_mul<L=19, {at}>',
            f'sgn_step<LT, l=560, L=19, {at}>', 'mont_pow<L=19>',
            'field_op<L=19>'),
        # ridge regression's synthetic set (7, 8, 9 limbs) and
        # multilateration (12): products and reshares (K3), det R's
        # inverse (K6), the arithmetic (K9)
        f'linear algebra ({t}, {m})': (
            *(f'reshare_mul<L={L}{s}, {at}>' for L in (7, 8, 9, 12)
              for s in (', fused', '')),
            *(f'mont_pow<L={L}>' for L in (7, 8, 9, 12)),
            *(f'field_op<L={L}>' for L in (7, 8, 9, 12))),
        # the three comparisons at each width (the wide K5), the inputs'
        # draws reduced and the differences (K9); np_equal at SecInt(192):
        # [NO07]'s random bits (K7), Legendre symbols (K6) and products
        # (K3)
        'wide comparison': (
            'random_bits_tail<L=7>', 'mont_pow<L=7>', 'reshare_mul<L=7>',
            *(f'sgn_step<{mode}, l={l}, L={L}>' for l, L in
              ((192, 7), (560, 19), (1504, 48))
              for mode in pipelines.SGN_MODES),
            'field_op<L=7>', 'field_op<L=19>', 'field_op<L=48>'),
        f'wide comparison ({t}, {m})': (
            *(f'sgn_step<{mode}, l=560, L=19, {at}>'
              for mode in pipelines.SGN_MODES), 'field_op<L=19>'),
    }
    return res


PATH_ENTRIES.update(wide_path_entries())


def say(msg: str) -> None:
    print(msg, flush=True)


class Phase:
    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        say(f'[{self.name}] start')
        return self

    def __exit__(self, exc_type, exc, tb):
        dt = time.perf_counter() - self.t0
        status = 'ok' if exc_type is None else f'FAILED ({exc_type.__name__})'
        say(f'[{self.name}] {status} in {dt:.3f} s')
        return False


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def reset_counts() -> None:
    for k in KERNELS.values():
        k['wrapper'].launches = 0
        if hasattr(k['wrapper'], 'by_key'):
            k['wrapper'].by_key.clear()


def counts() -> dict:
    """Launches of each instantiation of ENTRIES since reset_counts."""
    res = {}
    for entry, (name, key) in ENTRIES.items():
        w = KERNELS[name]['wrapper']
        res[entry] = w.launches if key is None else w.by_key[key]
    return res


def bound(n_bytes: float, n_ops):
    """The least ms for n_bytes moved and the integer instructions n_ops
    ((mul, add, logic) counts), and which of the two bounds it."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = int_lane_ops(n_ops) / INT_OPS_PER_S * 1e3
    return (t_ops, 'operations') if t_ops >= t_bytes else (t_bytes, 'bytes')


SMS = 132                      # the H100 SXM's SMs


def sm_bound(n_bytes: float, n_ops, sms: int) -> float:
    """The least ms for n_bytes and the integer instructions n_ops on the
    sms SMs that a launch can fill (its CTAs, at most SMS): the operations
    at those SMs' share of the card's integer rate, the bytes at the whole
    card's. A one-element wide K6 launch fills one SM."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = int_lane_ops(n_ops) / INT_OPS_PER_S * 1e3 * SMS / min(sms, SMS)
    return max(t_bytes, t_ops)


def wide_ctas(name: str, spec_or_ctx, n: int, route: str = 'wide') -> int:
    """CTAs of a wide K5 (``sgn_step``; its CTA route with ``route``
    'cta') or K6 (``mont_pow``) launch on n elements: the K5's persistent
    grid (``_build.sgn_wide_grid``), the K6's groups of
    ``_build.wide_group`` lanes, 128 threads a CTA."""
    from mpyc_tpu_torch import _build
    if name == 'sgn_step':
        params = spec_or_ctx.cta_params((0, 0), n) if route == 'cta' else \
            spec_or_ctx.wide_params((0, 0))
        return _build.sgn_wide_grid(n, params.ws_stride)
    return -(-n // (128 // _build.wide_group(spec_or_ctx.L)))


def wide_fn(fn: str, L: int) -> str:
    """The ptxas name of the wide K5's or K6's instantiation at L limbs
    (csrc/wide.cuh wide_dispatch: words a lane, and whether a group is a
    whole warp: <1,0> to 16 limbs, <1,1> to 32, <2,1> above; the wide K5
    also its CTA of 512 and groups of wide_group(L) lanes, 0)."""
    sw = "1,0" if L <= 16 else "1,1" if L <= 32 else "2,1"
    return f'{fn}<{sw},512,0>' if fn == 'sgn_wide_kernel' else f'{fn}<{sw}>'


def draw_ops(n_draws: int, W: int, L: int = 2) -> np.ndarray:
    """Montgomery work to map n_draws W-word draws into GF(p)."""
    nc = -(-W // L)
    return n_draws * (nc * mont_mul_ops(L) + (nc - 1) * add_mod_ops(L))


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of fn over iters calls (after one warm-up call)."""
    fn()
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    ev0.record()
    for _ in range(iters):
        fn()
    ev1.record()
    torch.cuda.synchronize()
    return ev0.elapsed_time(ev1) / iters


def once_ms(fn) -> float:
    """Device time of one call of fn (CUDA events, no warm-up call): a
    plain version, timed once after the check that called it on the same
    inputs; a second warm-up call of a plain version taking seconds would
    double its cost and tell nothing more."""
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    ev0.record()
    fn()
    ev1.record()
    torch.cuda.synchronize()
    return ev0.elapsed_time(ev1)


def graph_ms(fn, iters: int) -> float:
    """Mean device time of fn over iters calls captured in one CUDA graph
    and replayed (after a warm-up call): the kernels' own time, where CUDA
    events around launches shorter than their host calls would time the
    host."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    ev0.record()
    graph.replay()
    ev1.record()
    torch.cuda.synchronize()
    return ev0.elapsed_time(ev1) / iters


def short_name(mangled: str) -> str:
    """name<args> of a mangled kernel name of the port (``_ZN3mtt10sgn_
    kernelILi1E...``); of a demangled one (a profiler's), the name without
    its return type and parameters, cut to 100 characters."""
    m = re.match(r'_ZN3mtt(\d+)', mangled)
    if not m:
        name = mangled.removeprefix('void ').replace(
            '(anonymous namespace)::', '')
        return name.partition('(')[0].strip()[:100]
    k = m.end()
    name = mangled[k:k + int(m.group(1))]
    rest = mangled[k + int(m.group(1)):]
    if rest.startswith('I'):
        args = re.findall(r'L[ib](\d+)E', rest[:rest.find('EE') + 2])
        name += f'<{",".join(args)}>'
    return name


def ptxas_report(log: str) -> dict:
    """Per function of nvcc's -Xptxas -v report: registers, stack frame,
    spill stores and loads, and static shared memory, in bytes."""
    res, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties "
                      r"for )(\w+)", line)
        if m:
            fn = short_name(m.group(1))
            res.setdefault(fn, {})
            continue
        if fn is None:
            continue
        m = re.search(r'(\d+) bytes stack frame, (\d+) bytes spill stores, '
                      r'(\d+) bytes spill loads', line)
        if m:
            res[fn].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                           spill_loads=int(m.group(3)))
        m = re.search(r'Used (\d+) registers', line)
        if m:
            res[fn]['registers'] = int(m.group(1))
            sm = re.search(r'(\d+) bytes smem', line)
            res[fn]['smem'] = int(sm.group(1)) if sm else 0
    return res


# elements a thread of K6 and K7 (csrc/pow.cuh pow_ept): two, and at six
# limbs MTT_POW_EPT6, read from the source
POW_EPT6 = int(re.search(r'#define MTT_POW_EPT6 (\d+)', (
    Path(__file__).resolve().parent / 'mpyc_tpu_torch' / 'csrc' /
    'pow.cuh').read_text()).group(1))


def pow_ept(L: int) -> int:
    return 2 if L <= 5 else POW_EPT6

# SASS opcodes by class: the wide and plain multiplies (the FMA pipe), the
# moves and adds the compiler puts on the FMA pipe, three-input adds with
# their carries, logic and funnel shifts (the ALU pipe), compares and
# selects, and the rest (loads, stores, branches, ...)
SASS_CLASSES = (
    ('IMAD/IMAD.WIDE/IMAD.HI', lambda op: op.startswith('IMAD') and not
     op.startswith(('IMAD.MOV', 'IMAD.IADD', 'IMAD.SHL'))),
    ('IMAD.MOV/IADD/SHL', lambda op: op.startswith('IMAD')),
    ('IADD3', lambda op: op.startswith('IADD3')),
    ('LOP3/SHF', lambda op: op.startswith(('LOP3', 'SHF'))),
    ('ISETP/SEL', lambda op: op.startswith(('ISETP', 'SEL'))),
    ('rest', lambda op: True))


def sass_classes(ops) -> dict:
    res = dict.fromkeys([c for c, _ in SASS_CLASSES], 0)
    for op in ops:
        res[next(c for c, f in SASS_CLASSES if f(op))] += 1
    return res


def sass_report(*paths,
                prefixes=('mont_pow_kernel', 'random_bits_tail_kernel')
                ) -> dict:
    """Per instantiation of the kernels named by ``prefixes`` in the
    objects or libraries ``paths``, from ``cuobjdump -sass``: its SASS
    instructions by class, and those of its innermost loop that multiplies
    (the squaring loop of a power's step: a squaring for each of a
    thread's ``pow_ept`` elements and the loop's count), by class and per
    product."""
    from mpyc_tpu_torch import _build
    exe = shutil.which('cuobjdump') or str(
        Path(_build._nvcc()).with_name('cuobjdump'))
    out = '\n'.join(subprocess.run(
        [exe, '-sass', str(path)], capture_output=True, text=True,
        timeout=300, check=True).stdout for path in paths)
    funcs, name = {}, None
    for line in out.splitlines():
        m = 'Function : ' in line and re.search(r'Function : (\S+)', line)
        if m:
            name = short_name(m.group(1))
            if name.startswith(prefixes):
                funcs[name] = []
            continue
        if name not in funcs:
            continue
        m = re.match(r'\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?'
                     r'([A-Z][A-Z0-9_.]*)([^;]*);', line)
        if m:
            funcs[name].append((int(m.group(1), 16), m.group(2),
                                m.group(3)))
    res = {}
    for fn, ins in funcs.items():
        loops = []
        for addr, op, args in ins:
            t = re.search(r'0x([0-9a-f]+)', args) if op == 'BRA' else None
            if t and int(t.group(1), 16) < addr:
                body = [o for a, o, _ in ins
                        if int(t.group(1), 16) <= a <= addr]
                if any(o.startswith('IMAD.WIDE') for o in body):
                    loops.append(body)
        inner = min(loops, key=len) if loops else []
        res[fn] = dict(total=len(ins), classes=sass_classes(
            o for _, o, _ in ins), loop=len(inner),
            loop_classes=sass_classes(inner),
            per_product=len(inner) / pow_ept(int(fn.split('<')[1][0])))
    return res


def sgn_squeezes(spec, n: int, threads: int) -> tuple:
    """Model of K5's stage (csrc/sgn.cuh, csrc/stage.cuh) on n elements in
    thread blocks (CTAs) of ``threads``: each CTA squeezes every block of
    each of its ranges once, block b of a range by thread b % threads, so
    a warp runs a permutation in every round of the range that gives any
    of its lanes a block. Ranges: the CTA's words of stream A, then per
    call of stream B (``SgnSpec.draw_calls``) and per set its draws.
    Returns (blocks squeezed, permutations per warp of 32 elements as the
    warps serialise them)."""
    rate_words = keccak.RATE // 4
    epb = keccak.RATE // spec.l_bytes    # fused draws a block
    squeezed = warp_perms = 0
    for e0 in range(0, n, threads):
        cnt = min(threads, n - e0)
        spans = [(e0 * spec.wpe, cnt * spec.wpe, rate_words)]
        off = 0
        for sets, c in spec.draw_calls():
            spans += [(off + kk * n * c + e0 * c, cnt * c, epb)
                      for kk in range(sets)]
            off += sets * n * c
        for first, count, per in spans:
            nb = (first + count - 1) // per - first // per + 1
            squeezed += nb
            for k0 in range(0, nb, threads):
                warp_perms += -(-min(threads, nb - k0) // 32)
    return squeezed, warp_perms * 32 / n


def profile_calls(fn, calls: int, top: int | None = None) -> list:
    """One try of torch.profiler over ``calls`` calls of fn: lines of
    device time by kernel (the ``top`` largest and the rest summed, if
    given) and the device's idle share over the traced window (first to
    last event), or "no device time"; with ``top``, also the 8 operators
    with the most self CPU time (the host's share of the window)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return trace_lines(prof, top)


def trace_lines(prof, top: int | None = None) -> list:
    """profile_calls' lines of a finished torch.profiler run."""
    events = list(prof.events())
    dev = [e for e in events
           if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev:
        return ['no device time']
    by_name = {}
    for e in dev:
        name = short_name(e.name)
        by_name[name] = by_name.get(name, 0.0) + (e.time_range.end
                                                  - e.time_range.start)
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev)
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s0, e0 in spans[1:]:
        if s0 > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s0, e0
        else:
            cur_e = max(cur_e, e0)
    busy += cur_e - cur_s
    window = (max(e.time_range.end for e in events)
              - min(e.time_range.start for e in events))
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])
    lines = [f'{name}: {us / 1e3:.4f} ms device time'
             for name, us in ranked[:top]]
    if top is not None and len(ranked) > top:
        rest = sum(us for _, us in ranked[top:])
        lines.append(f'{len(ranked) - top} other kernels: {rest / 1e3:.4f} '
                     'ms device time')
        lines += [f'{name}: {us / 1e3:.4f} ms device time (a kernel of the '
                  'port outside the top)' for name, us in ranked[top:]
                  if name.startswith('mtt::')]
    lines.append(f'device busy {busy / 1e3:.4f} ms of a {window / 1e3:.4f} '
                 f'ms window: idle share {1 - busy / window:.4f}')
    if top is not None:    # where the host's time went
        host = sorted(prof.key_averages(),
                      key=lambda e: -e.self_cpu_time_total)
        lines += [f'host: {e.key[:60]}: {e.self_cpu_time_total / 1e3:.4f} ms '
                  f'self CPU time in {e.count} calls' for e in host[:8]]
    return lines


def trace_steps(run, window) -> tuple:
    """One try of torch.profiler over the steps window[0] .. window[1] - 1
    of ``run`` (a solve or a learning, called with the hook its runner
    calls with a step's number before each step; it stops at window[1]):
    the window's seconds (host clock, between synchronizes) and
    ``trace_lines``' lines."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as profiler
    prof = profiler(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    t0 = []

    class Window(Exception):
        pass

    def on_step(k):
        if k in window:
            torch.cuda.synchronize()
            t0.append(time.perf_counter())
        if k == window[0]:
            prof.start()
        elif k == window[1]:
            prof.stop()
            raise Window
    try:
        run(on_step)
    except Window:
        pass
    return t0[1] - t0[0], trace_lines(prof, top=12)


def max_abs_err(x: torch.Tensor, y: torch.Tensor) -> int:
    """Largest difference of two uint32 word tensors (held as int32)."""
    xa = x.to(torch.int64) & 0xFFFFFFFF
    ya = y.to(torch.int64) & 0xFFFFFFFF
    return int((xa - ya).abs().max().item()) if x.numel() else 0


def random_field(p: int, shape, gen: np.random.Generator) -> torch.Tensor:
    """Canonical (< p) random field data of any limb count, as stored
    limbs on the card."""
    L = prime_field_ctx(p).L
    words = gen.integers(0, 1 << 32, tuple(shape) + (L,), dtype=np.uint64)
    words[..., -1] = gen.integers(0, p >> 32 * (L - 1), tuple(shape))
    return torch.from_numpy(words.astype(np.uint32).view(np.int32)).cuda()


def k1_bound(n: int) -> dict:
    """K1's bound on n blocks: 168 bytes written a block (the state read
    once), a permutation's logic ops a block."""
    b, o = bound(n * 168 + 200, n * KECCAK_F_OPS)
    return dict(bound_ms=b, bound_by=o)


def k1_shape(n: int) -> str:
    """n blocks and the CTAs K1's launcher picks for them."""
    from mpyc_tpu_torch import _build
    per = _build.library().lib.mtt_keccak_ctr_cta(n)
    how = 'five threads a sponge' if per == 24 else 'a thread a sponge'
    return f'{n} blocks, {-(-n // per)} CTAs of {per} sponges ({how})'


def empty_ms() -> float:
    """The launch floor: an empty kernel's replayed launch (graph_ms)."""
    from mpyc_tpu_torch import _build
    dev = torch.device('cuda')   # the stream at call time: a capture's
    return graph_ms(lambda: _build.call('mtt_empty', _build.stream_of(dev)),
                    20)


def check_kernels(p: int) -> dict:
    """Phase 3: each kernel against its plain version at the main path's
    sizes; returns per-kernel measurements."""
    gen = np.random.default_rng(7)
    res = {}
    key = bytes(gen.integers(0, 256, 32, dtype=np.uint8))

    # K1 at the main path's shape, the pool refill of 512 blocks for the
    # small input draws, and at the blocks of one 2^22-element draw of 24
    # bytes (7 a block): instance j is shake_128(key || nonce || pad8 || j)
    l_in = ((p - 1).bit_length() + 7 >> 3) + 16
    n_pool = rng._POOL_BLOCKS
    n1 = rng.blocks_needed(N_BIG, l_in)
    prefix = key + (5).to_bytes(8, 'little')
    st_np, lane = keccak.ctr_state(prefix)
    st = keccak.state_tensor(st_np, 'cuda')
    err1 = 0
    for n in (n_pool, n1):
        out_k = keccak.keccak_ctr(st, n, lane)
        out_p = keccak._keccak_ctr_plain(st, n, lane)
        torch.cuda.synchronize()
        err1 = max(err1, max_abs_err(out_k, out_p))
        check(err1 == 0, f'K1 ({n} blocks) differs from its plain version')
    head = out_k[:256].cpu().numpy().view(np.uint32)
    for j in range(256):
        msg = prefix + j.to_bytes(8, 'little')
        check(head[j].astype('<u4').tobytes() == shake_128(msg).digest(168),
              f'K1 instance {j} differs from hashlib')
    say(f'  K1 keccak_ctr: {n_pool} and {n1} blocks, equal to plain and '
        'hashlib')

    def k1_meas(n):
        run = lambda: keccak.keccak_ctr(st, n, lane)  # noqa: E731
        return dict(
            shape=k1_shape(n), max_abs_err=err1, ms=graph_ms(run, 20),
            call_ms=cuda_ms(run, 20),
            plain_ms=cuda_ms(lambda: keccak._keccak_ctr_plain(st, n, lane),
                             2), **k1_bound(n))
    res['keccak_ctr'] = k1_meas(n_pool)
    res['keccak_ctr (one 2^22-element draw)'] = k1_meas(n1)

    # K2 at the main path's input draws (4096 and 2^22 draws of 24 bytes),
    # and at the reshare stream's 16-byte draws
    err2 = 0
    for n, l_bytes in ((N_SMALL, l_in), (N_BIG, l_in),
                       (N_BIG, rng.fused_draw_bytes(p))):
        out_k = rng.squeeze_mont(st, n, l_bytes, p, lane)
        out_p = rng._squeeze_mont_plain(st, n, l_bytes, p, lane)
        torch.cuda.synchronize()
        err2 = max(err2, max_abs_err(out_k, out_p))
        check(err2 == 0, f'K2 ({n} draws of {l_bytes} bytes) differs from '
              'plain')
        say(f'  K2 squeeze_mont: {n} draws of {l_bytes} bytes, '
            'equal to plain')
    res['squeeze_mont<L=2, W=6>'] = squeeze_meas(st, lane, N_BIG, l_in, p,
                                                 err2)

    # A draw too large for the pool (the 4096-element input's 586 blocks)
    # squeezes into the field with K2; the other way to the same elements
    # is K1 and a reduction in torch, as the JAX package draws them
    ctx = prime_field_ctx(p)
    ms_k2 = cuda_ms(lambda: rng.squeeze_mont(st, N_SMALL, l_in, p, lane), 20)
    nb_small = rng.blocks_needed(N_SMALL, l_in)
    ms_k1 = cuda_ms(lambda: ctx.reduce_chunks(rng.words_to_elements(
        keccak.keccak_ctr(st, nb_small, lane), N_SMALL, l_in, ctx.L)), 20)
    say(f'  {N_SMALL} draws of {l_in} bytes ({nb_small} blocks): K2 '
        f'{ms_k2:.4f} ms, K1 + torch reduction {ms_k1:.4f} ms')

    # K3 on (3, 2^22, 2) shares, fused product
    spec = pipelines.ReshareSpec(p, T, M)
    a = random_field(p, (M, N_BIG), gen)
    bb = random_field(p, (M, N_BIG), gen)
    nonce = (0xFFFFFFFF, 3)
    out_k = pipelines.reshare_mul(a, bb, st, nonce, spec)
    out_p = pipelines._reshare_mul_plain(a, bb, st, nonce, spec)
    torch.cuda.synchronize()
    err3 = max_abs_err(out_k, out_p)
    check(err3 == 0, 'K3 differs from its plain version')
    out_k = pipelines.reshare_mul(a, None, st, nonce, spec)
    out_p = pipelines._reshare_mul_plain(a, None, st, nonce, spec)
    torch.cuda.synchronize()
    check(max_abs_err(out_k, out_p) == 0,
          'K3 (without the product) differs from its plain version')
    for b_r in (bb[:, :N_RAGGED].contiguous(), None):
        a_r = a[:, :N_RAGGED].contiguous()
        out_k = pipelines.reshare_mul(a_r, b_r, st, nonce, spec)
        out_p = pipelines._reshare_mul_plain(a_r, b_r, st, nonce, spec)
        torch.cuda.synchronize()
        err3 = max(err3, max_abs_err(out_k, out_p))
        check(err3 == 0, f'K3 at {N_RAGGED} elements differs from its plain '
              'version')
    del out_k, out_p, a_r, b_r
    res['reshare_mul<L=2, fused>'] = reshare_meas(spec, a, bb, st, nonce,
                                                  err3)
    res['reshare_mul<L=2>'] = reshare_meas(spec, a, None, st, nonce, err3)
    say(f'  K3 reshare_mul: ({M}, {N_BIG}, 2) and ({M}, {N_RAGGED}, 2), '
        'fused and unfused, equal to plain')
    return res


def check_slice_kernels(p: int) -> dict:
    """Phase 3, second part: K4 and K5 against their plain versions (bit
    for bit) at 2^16 elements and at the paths' shapes, K4 at the round's
    3,010,560 elements and K5 in each of its three modes at 2^20, each
    timed, K5 (LT, np_less's mode) and K4 also with their plain versions.
    Returns per-kernel measurements."""
    gen = np.random.default_rng(8)
    res = {}
    st_np = keccak._absorb_host(bytes(gen.integers(0, 256, 32,
                                                   dtype=np.uint8))
                                + bytes(8))
    st = keccak.state_tensor(st_np, 'cuda')

    # K4 with its shares
    spec4 = pipelines.SplitSpec(p, T, M)
    err4 = 0
    for n in (N_KCHECK, N_SPLIT):
        sec = random_field(p, (n,), gen)
        sh = torch.empty((M, n, 2), dtype=torch.int32, device='cuda')
        out = pipelines.split_recombine(sec, st, spec4, shares=sh)
        want, want_sh = pipelines._split_recombine_plain(sec, st, spec4)
        torch.cuda.synchronize()
        err4 = max(err4, max_abs_err(out, want), max_abs_err(sh, want_sh),
                   max_abs_err(out, sec))
        check(err4 == 0, f'K4 ({n} elements) differs from its plain version')
        say(f'  K4 split_recombine: {n} elements, output and shares equal '
            'to plain, output equal to input')
    del sh, want_sh
    mont, adds = spec4.field_ops()
    ops4 = (rng.blocks_needed(T * N_SPLIT, spec4.l_bytes) * KECCAK_F_OPS
            + draw_ops(T * N_SPLIT, spec4.l_bytes // 4)
            + N_SPLIT * (mont * mont_mul_ops(2) + adds * add_mod_ops(2)))
    b, o = bound(N_SPLIT * 2 * 8, ops4)
    res['split_recombine'] = dict(
        shape=f'{N_SPLIT} secrets', max_abs_err=err4,
        ms=cuda_ms(lambda: pipelines.split_recombine(sec, st, spec4), 20),
        plain_ms=cuda_ms(
            lambda: pipelines._split_recombine_plain(sec, st, spec4), 2),
        bound_ms=b, bound_by=o)
    del sec, out, want

    # K5 in each mode at 2^16 and at the comparison's 2^20 elements
    err5 = 0
    nonce = (0xFFFFFFFF, 5)
    for mode in pipelines.SGN_MODES:
        spec5 = pipelines.SgnSpec(p, T, M, 32, 30, LT=mode == 'LT',
                                  EQ=mode == 'EQ')
        torch.cuda.reset_peak_memory_stats()
        for n in (N_KCHECK, N_CMP):
            a = random_field(p, (M, n), gen)
            out = pipelines.sgn_step(a, st, nonce, spec5)
            want, plain = timed_once(
                lambda: pipelines._sgn_step_plain(a, st, nonce, spec5))
            err5 = max(err5, max_abs_err(out, want))
            check(err5 == 0, f'K5 ({mode}, {n} elements) differs from its '
                  'plain version')
            del out, want
        mont, adds, ops5 = sgn_ops(spec5, N_CMP)
        b, o = bound(N_CMP * M * 2 * 4 * 2, ops5)
        iters = 10 if mode == 'LT' else 5
        ms = cuda_ms(lambda: pipelines.sgn_step(a, st, nonce, spec5), iters)
        params = spec5.params(nonce)   # alive across the call
        sgn_threads = _build_lib().mtt_sgn_threads(ctypes.addressof(params))
        squeezed, per_warp = sgn_squeezes(spec5, N_CMP, sgn_threads)
        say(f'  K5 sgn_step {mode} stage model at {N_CMP} elements, B = '
            f'{sgn_threads}: {squeezed} blocks squeezed against '
            f'{spec5.blocks(N_CMP)} in the stream, {per_warp:.4f} '
            'permutations per warp of 32 elements')
        say(f'  K5 sgn_step {mode}: {N_KCHECK} and {N_CMP} elements equal '
            f'to plain (peak {torch.cuda.max_memory_allocated() / 2**30:.1f}'
            f' GiB allocated); per element {mont} Montgomery products, '
            f'{adds:.0f} modular adds/subs, {spec5.draws_per_element()} '
            'draws, '
            f'{spec5.blocks(N_CMP) / N_CMP:.4f} stream blocks; {ms:.4f} ms '
            f'at {N_CMP} elements, bound {b:.4f} ms ({o}), {ms / b:.2f}x')
        res[f'sgn_step<{mode}, l=32, L=2>'] = dict(
            shape=f'({M}, {N_CMP}, 2) shares, {mode}', ms=ms,
            plain_ms=plain,
            bound_ms=b, bound_by=o)
        del a
    for mode in pipelines.SGN_MODES:
        res[f'sgn_step<{mode}, l=32, L=2>']['max_abs_err'] = err5

    # K5 (LT) at the BNN's widths, on SecInt(14)'s field: l = 14 (fc1, the
    # argmax) and l = 10 (fc2, fc3), one call at 2^16, and a layer's
    # comparison as np_sgn makes it (409,600 elements: one chunk, launched
    # on its bucket of 2^19), held and timed against the plain version on
    # the zero-padded bucket
    p14 = sectypes.SecInt(14, 'cuda').field.modulus
    for l in (14, 10):
        spec5 = pipelines.SgnSpec(p14, T, M, l, 30, LT=True)
        a = random_field(p14, (M, N_KCHECK), gen)
        out = pipelines.sgn_step(a, st, nonce, spec5)
        want = pipelines._sgn_step_plain(a, st, nonce, spec5)
        torch.cuda.synchronize()
        err = max_abs_err(out, want)
        check(err == 0, f'K5 (LT, l = {l}, {N_KCHECK} elements) differs '
              'from its plain version')
        del out, want
        a = random_field(p14, (M, N_BNN_CMP), gen)
        err_c, plain = sgn_chunks_check(spec5, a, st, nonce,
                                        SimRuntime._SGN_CHUNK)
        r = res[f'sgn_step<LT, l={l}, L=2>'] = sgn_meas(
            spec5, a, st, nonce, SimRuntime._SGN_CHUNK, max(err, err_c),
            plain)
        say(f'  K5 sgn_step LT at l = {l}: {N_KCHECK} elements and a '
            f'layer\'s call ({r["shape"]}) equal to plain; per element '
            f'{r["mont"]} Montgomery products, {r["adds"]:.0f} modular '
            f'adds/subs; {r["ms"]:.4f} ms, plain {r["plain_ms"]:.4f} ms, '
            f'bound {r["bound_ms"]:.4f} ms ({r["bound_by"]}), '
            f'{r["ms"] / r["bound_ms"]:.2f}x')
        del a
    return res


def sgn_ops(spec, n: int, chunk: int | None = None,
            route: str | None = None) -> tuple:
    """(field products, adds/subs per element, integer instructions) of
    K5 on n elements as the kernel of ``route`` (the launch's,
    ``pipelines.sgn_route``, by default) does them: its field operations
    (SgnSpec.field_ops, with the wide K5's groups from 7 limbs on and the
    CTA route's on its calls, held against the source by
    tests/test_torch_kernels_host.py and test_torch_small_calls_host.py),
    with c mod 2^l uniform, the reduction of its draws and the stream's
    blocks, these of each call when the n elements are cut into chunks of
    ``chunk``."""
    from mpyc_tpu_torch import _build
    L = spec.ctx.L
    route = route or pipelines.sgn_route(L, n)
    draws = n * spec.draws_per_element()
    mont, adds = spec.field_ops(
        spec.l / 2, _build.sgn_wide_groups(L) if route == 'wide' else
        _build.sgn_cta_groups(n) if route == 'cta' else None)
    sizes = [n] if chunk is None else \
        [min(chunk, n - j0) for j0 in range(0, n, chunk)]
    # the wide K5 takes a draw's top two words by a product of two rows
    draw = draws * (mont_mul_ops(L) * (1 + 2 / L) + add_mod_ops(L)) \
        if route != 'narrow' else draw_ops(draws, spec.l_bytes // 4, L)
    ops = (sum(spec.blocks(c) for c in sizes) * KECCAK_F_OPS + draw
           + n * (mont * mont_mul_ops(L) + adds * add_mod_ops(L)))
    return mont, adds, ops


def sgn_chunks_check(spec, a, st, ctr, chunk: int, route=None,
                     plain=None) -> tuple:
    """K5's launch of a's chunks ((m, n, L) shares cut into chunks of
    ``chunk`` as np_sgn cuts them: ``pipelines.sgn_chunks``, on ``route``
    or the launch's) against its plain version chunk by chunk
    (``pipelines._sgn_chunks_plain``, or ``plain``: its output, counter
    and ms from an earlier check): raises unless the outputs are equal bit
    for bit and both counters are ctr advanced by the number of chunks.
    Returns the error (0) and the plain version's ms (host clock, between
    synchronizes) in that check."""
    n = a.shape[1]
    out, ctr_k = pipelines.sgn_chunks(a, st, ctr, spec, chunk, route)
    (want, ctr_p), ms = plain or timed_once(
        lambda: pipelines._sgn_chunks_plain(a, st, ctr, spec, chunk))
    err = max_abs_err(out, want)
    chunks = -(-n // chunk)
    v = (int(ctr[0]) | int(ctr[1]) << 32) + chunks
    check(err == 0 and list(ctr_k) == list(ctr_p)
          == [v & 0xFFFFFFFF, v >> 32],
          f'K5 ({spec.mode}, l = {spec.l}, L = {spec.ctx.L}) in one launch '
          f'of {chunks} chunks of {chunk} ({n} elements, route '
          f'{route or pipelines.sgn_route(spec.ctx.L, n)}) differs from its '
          'plain version chunk by chunk')
    return err, ms


def sgn_ends_check(spec, a, st, chunk: int) -> dict:
    """K5's launch of a's chunks (``pipelines.sgn_chunks``; from chunk 8
    on the counter carries into its high word) at a path's shape, its
    first and last chunk each held bit for bit against that chunk's call
    of the plain version (counter ctr + c): a check of a launch too large
    to hold whole against the plain version. Raises on a difference;
    returns the plain version's ms (host clock, between synchronizes) by
    chunk."""
    n, ctr = a.shape[1], (0xFFFFFFF8, 4)
    out, _ = pipelines.sgn_chunks(a, st, ctr, spec, chunk)
    res = {}
    for c in sorted({0, (n - 1) // chunk}):
        part = slice(c * chunk, (c + 1) * chunk)
        (want, _), res[c] = timed_once(lambda: pipelines._sgn_chunks_plain(
            a[:, part], st, pipelines._add_ctr(ctr, c), spec, chunk))
        check(max_abs_err(out[:, part], want) == 0,
              f'K5 ({spec.mode}, l = {spec.l}, L = {spec.ctx.L}, '
              f'({spec.t}, {spec.m})): chunk {c} of one launch on {n} '
              'elements differs from its plain version')
    return res


def sgn_meas(spec, a, st, nonce, chunk: int, err: int,
             plain_ms: float | None = None, route: str | None = None) -> dict:
    """K5's time on a's chunks ((m, n, L) shares in chunks of ``chunk``:
    one launch, on ``route`` or the launch's), its plain version's on the
    same chunks (``pipelines._sgn_chunks_plain``) and its bound."""
    L, n = spec.ctx.L, a.shape[1]
    route = route or pipelines.sgn_route(L, n)
    mont, adds, ops = sgn_ops(spec, n, chunk, route)
    b, o = bound(n * spec.m * L * 4 * 2, ops)
    chunks = -(-n // chunk)
    where = f' in {chunks} chunks of {chunk}' if chunks > 1 else \
        f' on a bucket of {pipelines.bucket(n, chunk)}'
    if (spec.t, spec.m) != (T, M):
        where += f' at (t, m) = ({spec.t}, {spec.m})'
    extra = {}
    if route != 'narrow':   # an element a CTA: the SMs its CTAs fill
        ctas = wide_ctas('sgn_step', spec, n, route)
        extra = dict(ctas=ctas, sm_bound_ms=sm_bound(
            n * spec.m * L * 4 * 2, ops, ctas))
    if route == 'cta':
        where += ', the CTA route'
    return dict(
        shape=f'({spec.m}, {n}, {L}) shares, {spec.mode}, l = {spec.l}'
        f'{where}',
        max_abs_err=err, mont=mont, adds=adds, **extra,
        ms=cuda_ms(lambda: pipelines.sgn_chunks(a, st, nonce, spec, chunk,
                                                route), 10),
        plain_ms=plain_ms if plain_ms is not None else once_ms(
            lambda: pipelines._sgn_chunks_plain(a, st, nonce, spec, chunk)),
        bound_ms=b, bound_by=o)


def sgn_rows(name: str, spec, a, st, nonce, chunk: int) -> dict:
    """K5's rows of the kernels line at a's shape, each launch held bit for
    bit against the plain version (computed once): where the launch takes
    the CTA route (``pipelines.sgn_route``), that route's row
    (``cta_name(name)``) and the narrow kernel's forced onto the same
    shape (``name``; none where its random bits run out,
    ``_build.sgn_lb_fit``), else the launch's row (``name``)."""
    n, L = a.shape[1], spec.ctx.L
    plain = timed_once(lambda: pipelines._sgn_chunks_plain(a, st, nonce,
                                                          spec, chunk))
    if pipelines.sgn_route(L, n) != 'cta':
        err, ms = sgn_chunks_check(spec, a, st, nonce, chunk, plain=plain)
        return {name: sgn_meas(spec, a, st, nonce, chunk, err, ms)}
    res = {}
    for route, key in (('cta', cta_name(name)), ('narrow', name)):
        try:
            err, ms = sgn_chunks_check(spec, a, st, nonce, chunk, route,
                                       plain)
        except NotImplementedError:
            continue
        res[key] = sgn_meas(spec, a, st, nonce, chunk, err, ms, route)
    return res


def reshare_meas(spec, a, b, st, nonce, err: int,
                 plain_ms: float | None = None) -> dict:
    """K3's time on (m, n, L) shares a (times b's when b is given: replayed
    from a CUDA graph, as a small call's launch is shorter than its host
    call), its plain version's (``plain_ms`` if given) and its bound: the
    stream's
    blocks and the reduction of its draws, the products (the local one
    when fused, the Lagrange sum, Horner at m points), against the shares
    read and written."""
    L, n, m, t = spec.ctx.L, a.shape[1], spec.m, spec.t
    W = spec.l_bytes // 4
    mont, adds = spec.field_ops(b is not None)
    ops = (rng.blocks_needed(t * n, spec.l_bytes) * KECCAK_F_OPS
           + draw_ops(t * n, W, L) + n * mont * mont_mul_ops(L)
           + n * adds * add_mod_ops(L))
    reads = 2 if b is not None else 1
    bd, o = bound(n * m * L * 4 * (reads + 1), ops)
    what = 'fused product' if b is not None else 'no product'
    at = '' if (t, m) == (T, M) else f' at (t, m) = ({t}, {m})'
    return dict(
        shape=f'({m}, {n}, {L}) shares, {what}{at}', max_abs_err=err,
        ms=graph_ms(lambda: pipelines.reshare_mul(a, b, st, nonce, spec),
                    10),
        plain_ms=plain_ms if plain_ms is not None else once_ms(
            lambda: pipelines._reshare_mul_plain(a, b, st, nonce, spec)),
        bound_ms=bd, bound_by=o)


def squeeze_meas(st, lane, n: int, l_bytes: int, p: int, err: int) -> dict:
    """K2's time on n draws of l_bytes into GF(p), its plain version's and
    its bound (the blocks' permutations and the draws' reduction, against
    the draws written)."""
    L = prime_field_ctx(p).L
    ops = (rng.blocks_needed(n, l_bytes) * KECCAK_F_OPS
           + draw_ops(n, l_bytes // 4, L))
    b, o = bound(n * L * 4 + 200, ops)
    return dict(
        shape=f'{n} draws of {l_bytes} bytes, L = {L}', max_abs_err=err,
        ms=cuda_ms(lambda: rng.squeeze_mont(st, n, l_bytes, p, lane), 10),
        plain_ms=cuda_ms(lambda: rng._squeeze_mont_plain(
            st, n, l_bytes, p, lane), 1),
        bound_ms=b, bound_by=o)


def check_three_limb_kernels() -> dict:
    """Phase 3, third part: K2, K3 (both modes) and K5 (LT at the CNN's
    l = 16, 23, 30, 37) on three-limb fields against their plain versions
    (bit for bit): K2 at the 28-byte input draws of SecInt(64)'s field;
    K3 on SecInt(37)'s field at conv1's reshare bucket and at a ragged
    size; K5 at 2^14 elements in one call, and in one launch of many
    chunks of 1024 against the plain version chunk by chunk: 7 chunks
    with a ragged tail, and each width's largest comparison in the CNN.
    Each timed at the paths' shapes beside its plain version and bound.
    Returns per-instantiation measurements."""
    gen = np.random.default_rng(10)
    res = {}
    p69 = sectypes.SecInt(37, 'cuda').field.modulus
    p96 = sectypes.SecInt(64, 'cuda').field.modulus
    key = bytes(gen.integers(0, 256, 32, dtype=np.uint8))
    st_np, lane = keccak.ctr_state(key + (9).to_bytes(8, 'little'))
    st = keccak.state_tensor(st_np, 'cuda')

    # K2: SecInt(64)'s input draws (28 bytes)
    err = 0
    for n in (N_KCHECK + 3, N_WIDE):
        out_k = rng.squeeze_mont(st, n, 28, p96, lane)
        out_p = rng._squeeze_mont_plain(st, n, 28, p96, lane)
        torch.cuda.synchronize()
        err = max(err, max_abs_err(out_k, out_p))
        check(err == 0, f'K2 ({n} draws of 28 bytes, L = 3) differs from '
              'its plain version')
    del out_k, out_p
    say(f'  K2 squeeze_mont at L = 3: {N_KCHECK + 3} and {N_WIDE} draws of '
        '28 bytes, equal to plain')
    res['squeeze_mont<L=3, W=7>'] = squeeze_meas(st, lane, N_WIDE, 28, p96,
                                                 err)

    # K3 on SecInt(37)'s field, fused and not, at conv1's reshare bucket
    spec3 = pipelines.ReshareSpec(p69, T, M)
    nb = pipelines.bucket(N_CNN * 784 * 32)
    a = random_field(p69, (M, nb), gen)
    b = random_field(p69, (M, nb), gen)
    nonce = (0xFFFFFFFF, 11)
    err3 = 0
    for n in (N_RAGGED, nb):
        for bb in (b, None):
            a_n = a[:, :n].contiguous()
            b_n = bb[:, :n].contiguous() if bb is not None else None
            out_k = pipelines.reshare_mul(a_n, b_n, st, nonce, spec3)
            out_p = pipelines._reshare_mul_plain(a_n, b_n, st, nonce, spec3)
            torch.cuda.synchronize()
            err3 = max(err3, max_abs_err(out_k, out_p))
            check(err3 == 0, f'K3 (L = 3, {n} elements, '
                  f'{"fused" if bb is not None else "unfused"}) differs '
                  'from its plain version')
            del out_k, out_p, a_n, b_n
    say(f'  K3 reshare_mul at L = 3: ({M}, {N_RAGGED}, 3) and ({M}, {nb}, '
        '3), fused and unfused, equal to plain')
    res['reshare_mul<L=3, fused>'] = reshare_meas(spec3, a, b, st, nonce,
                                                  err3)
    res['reshare_mul<L=3>'] = reshare_meas(spec3, a, None, st, nonce, err3)
    del a, b

    # K5 (LT) at the CNN's widths: bit for bit at 2^14 elements (l = 16
    # and 37) in one call; one launch of 7 chunks with a ragged tail and
    # one of the width's largest comparison, each against the plain
    # version chunk by chunk, the counter carried into its high word; the
    # width timed at that comparison
    chunk = SimRuntime._SGN_CHUNK_WIDE
    for l in CNN_WIDTHS:
        spec5 = pipelines.SgnSpec(p69, T, M, l, 30, LT=True)
        err5 = 0
        if l in (16, 37):
            a = random_field(p69, (M, N_K5_WIDE), gen)
            out = pipelines.sgn_step(a, st, nonce, spec5)
            want = pipelines._sgn_step_plain(a, st, nonce, spec5)
            torch.cuda.synchronize()
            err5 = max_abs_err(out, want)
            check(err5 == 0, f'K5 (LT, l = {l}, L = 3, {N_K5_WIDE} '
                  'elements) differs from its plain version')
            del out, want
        a = random_field(p69, (M, N_CHUNKED), gen)
        err5 = max(err5, sgn_chunks_check(spec5, a, st, (0xFFFFFFFD, 4),
                                          chunk)[0])
        n = CNN_CMP[l]
        a = random_field(p69, (M, n), gen)
        err_c, plain = sgn_chunks_check(spec5, a, st, (0xFFFFFFF8, 4),
                                        chunk)
        err5 = max(err5, err_c)
        r = res[f'sgn_step<LT, l={l}, L=3>'] = sgn_meas(
            spec5, a, st, nonce, chunk, err5, plain)
        say(f'  K5 sgn_step LT at l = {l}, L = 3: '
            + (f'{N_K5_WIDE} elements, ' if l in (16, 37) else '')
            + f'one launch of {-(-N_CHUNKED // chunk)} chunks of {chunk} '
            f'({N_CHUNKED} elements, the last {N_CHUNKED % chunk} on a '
            f'bucket of {pipelines.bucket(N_CHUNKED % chunk, chunk)}) and '
            f'one of {r["shape"]} equal to plain chunk by chunk; per '
            f'element {r["mont"]} Montgomery products, {r["adds"]:.0f} '
            f'modular adds/subs, {spec5.draws_per_element()} draws; '
            f'{r["ms"]:.4f} ms, plain {r["plain_ms"]:.4f} ms, bound '
            f'{r["bound_ms"]:.4f} ms ({r["bound_by"]}), '
            f'{r["ms"] / r["bound_ms"]:.2f}x')
        del a
    return res


def parties_kernel(entry: str) -> str:
    """The compiled kernel (ptxas's short name) of an entry of
    parties_entries: K3 and K4 at a run-time (t, m), K5 at its t, K7 at
    every (t, m)."""
    name, key = ENTRIES[entry]
    if name == 'reshare_mul':
        return f'reshare_kernel<2,{int(key[1])},0,0>'
    if name == 'split_recombine':
        return 'split_recombine_kernel<0,0>'
    if name == 'sgn_step':
        mode = pipelines.SGN_MODES.index(key[0])
        return f'sgn_kernel<{mode},{key[4]},2>'
    return 'random_bits_tail_kernel<2,1>'


def split_meas(spec4, sec, st, err: int, plain_ms: float) -> dict:
    """K4's time on the n secrets sec at spec4's (t, m), beside its plain
    version's ``plain_ms`` and its bound: t draws, the split at m points
    and the recombination from t + 1, against the secrets read and the
    output written."""
    n, t, m = sec.shape[0], spec4.t, spec4.m
    mont, adds = spec4.field_ops()
    ops = (rng.blocks_needed(t * n, spec4.l_bytes) * KECCAK_F_OPS
           + draw_ops(t * n, spec4.l_bytes // 4)
           + n * (mont * mont_mul_ops(2) + adds * add_mod_ops(2)))
    bd, o = bound(n * 2 * 8, ops)
    return dict(
        shape=f'{n} secrets at (t, m) = ({t}, {m})', max_abs_err=err,
        ms=cuda_ms(lambda: pipelines.split_recombine(sec, st, spec4), 20),
        plain_ms=plain_ms, bound_ms=bd, bound_by=o)


def check_parties_kernels(p: int, ptx: dict) -> dict:
    """Phase 3, the parties' part, each kernel bit for bit against its
    plain version on the same inputs (tolerance: exact), with its kernel's
    ptxas report (``ptx``). At each (t, m) of PARTIES_CHECK on 2^16
    elements (N_KCHECK: fewer CTAs than the card has SMs for K3, K4 and K7,
    so their times there are bound by occupancy): K3 (fused and not), K4
    with its shares, K5 in its three modes (l = 32, SecInt(32)'s field)
    and K7 (SecFxp(14, 6)'s field, one r in 1,000 planted to 0: bits,
    flags and count). Then at the shapes phase "parties" launches them
    (``check_parties_paths``), where each on a path is timed. Returns
    per-instantiation measurements: on a path at its shape there, else
    at 2^16."""
    from mpyc_tpu_torch import finfields
    gen = np.random.default_rng(18)
    res = {}
    st = keccak.state_tensor(keccak._absorb_host(bytes(gen.integers(
        0, 256, 32, dtype=np.uint8)) + bytes(8)), 'cuda')
    nonce = (0xFFFFFFFF, 7)
    n = N_KCHECK
    p52 = fxp_field(FXP_L, FXP_F)
    field52 = finfields.GF(p52)
    for t, m in PARTIES_CHECK:
        at = f't={t}, m={m}'
        spec = pipelines.ReshareSpec(p, t, m)
        a = random_field(p, (m, n), gen)
        b = random_field(p, (m, n), gen)
        for bb, s in ((b, ', fused'), (None, '')):
            got = pipelines.reshare_mul(a, bb, st, nonce, spec)
            want, plain = timed_once(
                lambda: pipelines._reshare_mul_plain(a, bb, st, nonce, spec))
            err = max_abs_err(got, want)
            check(err == 0, f'K3{s} at ({t}, {m}) differs from its plain '
                  'version')
            res[f'reshare_mul<L=2{s}, {at}>'] = reshare_meas(
                spec, a, bb, st, nonce, err, plain)
        spec4 = pipelines.SplitSpec(p, t, m)
        sec = random_field(p, (n,), gen)
        sh = torch.empty((m, n, 2), dtype=torch.int32, device='cuda')
        out = pipelines.split_recombine(sec, st, spec4, shares=sh)
        (want, want_sh), plain = timed_once(
            lambda: pipelines._split_recombine_plain(sec, st, spec4))
        err = max(max_abs_err(out, want), max_abs_err(sh, want_sh),
                  max_abs_err(out, sec))
        check(err == 0, f'K4 at ({t}, {m}) differs from its plain version')
        res[f'split_recombine<{at}>'] = split_meas(spec4, sec, st, err,
                                                   plain)
        for mode in pipelines.SGN_MODES:
            spec5 = pipelines.SgnSpec(p, t, m, 32, 30, LT=mode == 'LT',
                                      EQ=mode == 'EQ')
            a5 = random_field(p, (m, n), gen)
            got = pipelines.sgn_step(a5, st, nonce, spec5)
            want, plain = timed_once(
                lambda: pipelines._sgn_step_plain(a5, st, nonce, spec5))
            err = max_abs_err(got, want)
            check(err == 0, f'K5 ({mode}) at ({t}, {m}) differs from its '
                  'plain version')
            res[f'sgn_step<{mode}, l=32, L=2, {at}>'] = sgn_meas(
                spec5, a5, st, nonce, n, err, plain)
        r, z = tail_shares(p52, n, gen, 1000, m)
        got = pipelines.random_bits_tail(r, z, field52, False, 0, t)
        want, plain = timed_once(lambda: pipelines._random_bits_tail_plain(
            r, z, field52, False, 0, t))
        err = max_abs_err(got[0], want[0])
        check(err == 0 and torch.equal(got[1], want[1])
              and got[2].item() == want[2].item() == -(-n // 1000),
              f'K7 at ({t}, {m}) differs from its plain version')
        res[f'random_bits_tail<L=2, lazy, {at}>'] = tail_meas(
            field52, r, z, err, t, plain)
        say(f'  ({t}, {m}): K3 fused and not, K4 with its shares, K5 in '
            f'three modes at l = 32, K7 with its flags and count at {n} '
            'elements, equal to plain')
        del a, b, sec, sh, a5, r, z, got, want
        torch.cuda.empty_cache()
    res.update(check_parties_paths(p, st, gen))
    for entry, r in res.items():
        fn = parties_kernel(entry)
        rep_ = ', '.join(f'{k} {v}' for k, v in ptx.get(fn, {}).items())
        say(f'  {entry} [{r["shape"]}]: {r["ms"]:.4f} ms, plain '
            f'{r["plain_ms"]:.3f} ms, bound {r["bound_ms"]:.4f} ms '
            f'({r["bound_by"]}), {r["ms"] / r["bound_ms"]:.2f}x; ptxas {fn}: '
            f'{rep_ or "not in the report"}')
    return res


def check_parties_paths(p: int, st, gen) -> dict:
    """The run-time (t, m) kernels at the shapes phase "parties" launches
    them, each bit for bit against its plain version on the same inputs
    and timed there beside the plain call that checked it: K3 (fused and
    not) on the main path's (m, 2^22, 2) at each (t, m) of PARTIES_MAIN;
    K5 in its three modes at the comparison's 2^20 (one chunk) at each of
    PARTIES_CMP; and at PARTIES_NET K4 at the round's 3,010,560 secrets
    with its shares, K5 (LT) at a BNN layer's comparison (409,600
    elements, one chunk on its bucket of 2^19) at l = 14 and 10, and at
    the fixed-point CNN's maxpool1 (l = 14, f = 6: two chunks of 2^20 in
    one launch, chunk by chunk, counters too), and K7 at conv1's
    15,052,800 random bits with one r in 1,000 planted to 0 (bits, flags
    and count; the plain version in slices of TAIL_SLICE elements)."""
    from mpyc_tpu_torch import finfields
    res = {}
    nonce = (0xFFFFFFFF, 9)
    for t, m in PARTIES_MAIN:
        at = f't={t}, m={m}'
        spec = pipelines.ReshareSpec(p, t, m)
        a = random_field(p, (m, N_BIG), gen)
        b = random_field(p, (m, N_BIG), gen)
        for bb, s in ((b, ', fused'), (None, '')):
            got = pipelines.reshare_mul(a, bb, st, nonce, spec)
            want, plain = timed_once(
                lambda: pipelines._reshare_mul_plain(a, bb, st, nonce, spec))
            err = max_abs_err(got, want)
            check(err == 0, f'K3{s} at ({t}, {m}) on {N_BIG} elements '
                  'differs from its plain version')
            del got, want
            res[f'reshare_mul<L=2{s}, {at}>'] = reshare_meas(
                spec, a, bb, st, nonce, err, plain)
        del a, b
        torch.cuda.empty_cache()
        say(f'  ({t}, {m}): K3 fused and not on ({m}, {N_BIG}, 2) shares, '
            'equal to plain')
    for t, m in PARTIES_CMP:
        for mode in pipelines.SGN_MODES:
            spec5 = pipelines.SgnSpec(p, t, m, 32, 30, LT=mode == 'LT',
                                      EQ=mode == 'EQ')
            a = random_field(p, (m, N_CMP), gen)
            got = pipelines.sgn_step(a, st, nonce, spec5)
            want, plain = timed_once(
                lambda: pipelines._sgn_step_plain(a, st, nonce, spec5))
            err = max_abs_err(got, want)
            check(err == 0, f'K5 ({mode}) at ({t}, {m}) on {N_CMP} '
                  'elements differs from its plain version')
            del got, want
            res[f'sgn_step<{mode}, l=32, L=2, t={t}, m={m}>'] = sgn_meas(
                spec5, a, st, nonce, N_CMP, err, plain)
            del a
            torch.cuda.empty_cache()
        say(f'  ({t}, {m}): K5 in three modes at l = 32 on ({m}, {N_CMP}, '
            '2) shares, equal to plain')
    t, m = PARTIES_NET
    at = f't={t}, m={m}'
    spec4 = pipelines.SplitSpec(p, t, m)
    sec = random_field(p, (N_SPLIT,), gen)
    sh = torch.empty((m, N_SPLIT, 2), dtype=torch.int32, device='cuda')
    out = pipelines.split_recombine(sec, st, spec4, shares=sh)
    (want, want_sh), plain = timed_once(
        lambda: pipelines._split_recombine_plain(sec, st, spec4))
    err = max(max_abs_err(out, want), max_abs_err(sh, want_sh),
              max_abs_err(out, sec))
    check(err == 0, f'K4 at ({t}, {m}) on {N_SPLIT} secrets differs from '
          'its plain version')
    del out, want, sh, want_sh
    res[f'split_recombine<{at}>'] = split_meas(spec4, sec, st, err, plain)
    del sec
    p14 = sectypes.SecInt(14, 'cuda').field.modulus
    p52 = fxp_field(FXP_L, FXP_F)
    chunk = SimRuntime._SGN_CHUNK
    for q, l, f, n in ((p14, 14, 0, N_BNN_CMP), (p14, 10, 0, N_BNN_CMP),
                       (p52, FXP_L, FXP_F, FXP_POOL1)):
        spec5 = pipelines.SgnSpec(q, t, m, l, 30, LT=True, f=f)
        a = random_field(q, (m, n), gen)
        err, plain = sgn_chunks_check(spec5, a, st, nonce, chunk)
        fs = f', f={f}' if f else ''
        res[f'sgn_step<LT, l={l}, L=2{fs}, {at}>'] = sgn_meas(
            spec5, a, st, nonce, chunk, err, plain)
        del a
        torch.cuda.empty_cache()
    say(f'  ({t}, {m}): K4 with its shares on {N_SPLIT} secrets; K5 (LT) '
        f'at l = 14 and 10 (SecInt(14)) on {N_BNN_CMP} elements and at l '
        f'= 14, f = 6 (SecFxp(14, 6)) on {FXP_POOL1} in chunks of {chunk}, '
        'equal to plain')
    field = finfields.GF(p52)
    r, z = tail_shares(p52, FXP_BITS, gen, 1000, m)
    got = pipelines.random_bits_tail(r, z, field, False, 0, t)
    torch.cuda.synchronize()
    err, zeros, plain = 0, 0, 0.0
    for j0 in range(0, FXP_BITS, TAIL_SLICE):
        rj = r[:, j0:j0 + TAIL_SLICE].contiguous()
        zj = z[:, j0:j0 + TAIL_SLICE].contiguous()
        want, ms = timed_once(lambda: pipelines._random_bits_tail_plain(
            rj, zj, field, False, 0, t))
        plain += ms
        err = max(err, max_abs_err(got[0][:, j0:j0 + TAIL_SLICE], want[0]))
        check(err == 0 and torch.equal(got[1][j0:j0 + TAIL_SLICE], want[1]),
              f'K7 at ({t}, {m}) on {FXP_BITS} elements differs from its '
              f'plain version from element {j0}')
        zeros += want[2].item()
        del rj, zj, want
    check(got[2].item() == zeros == -(-FXP_BITS // 1000),
          f'K7 at ({t}, {m}): {got[2].item()} zero openings, plain {zeros}')
    del got
    res[f'random_bits_tail<L=2, lazy, {at}>'] = tail_meas(
        field, r, z, err, t, plain)
    say(f'  ({t}, {m}): K7 on {FXP_BITS} elements, one r in 1000 planted to '
        f'0: bits, flags and count ({zeros} zeros) equal to plain')
    del r, z
    torch.cuda.empty_cache()
    return res


def run_main_path(device, n_small=N_SMALL, n_big=N_BIG, rounds=ROUNDS,
                  sample=SAMPLE, seed=0, m=M, t=T) -> dict:
    """The port's main path through the user's entry points at m parties
    and threshold t; raises on a wrong result. Returns the field modulus
    and, on the card, the device time of each chained np_multiply (ms,
    CUDA events)."""
    rt = SimRuntime(m, device=device, threshold=t)
    rt.start()
    secint = rt.SecInt(32)
    p = secint.field.modulus

    # bench.py:58-65: a small secure product, opened and compared; at
    # N_POOL values the input draws come from the pooled stream (K1), at
    # n_small they squeeze straight into the field (K2)
    for n in (N_POOL, n_small):
        a = np.arange(n, dtype=object)
        b = (a * 7 + 1) % 9999
        A = rt.input(secint.array(a))[0]
        B = rt.input(secint.array(b))[0]
        got = rt.output(rt.np_multiply(A, B))
        check(got.shape == (n,) and (got.astype(object) == a * b).all(),
              f'secure product of {n} values wrong')

    gen = np.random.default_rng(seed)
    vals = gen.integers(-(1 << 31), 1 << 31, n_big, dtype=np.int64)
    bvals = gen.integers(-(1 << 31), 1 << 31, n_big, dtype=np.int64)
    A = rt.input(secint.array(vals))[0]
    B = rt.input(secint.array(bvals))[0]
    X = rt.np_multiply(A, B)
    per_call_ms = []
    on_card = torch.device(device).type == 'cuda'
    for _ in range(rounds):
        if on_card:
            ev0 = torch.cuda.Event(enable_timing=True)
            ev1 = torch.cuda.Event(enable_timing=True)
            ev0.record()
            X = rt.np_multiply(X, B)
            ev1.record()
            per_call_ms.append((ev0, ev1))
        else:
            X = rt.np_multiply(X, B)
    opened = rt.output(X)
    if on_card:
        torch.cuda.synchronize()
        per_call_ms = [e0.elapsed_time(e1) for e0, e1 in per_call_ms]
    check(opened.shape == (n_big,), 'opened product has the wrong shape')
    idx = gen.choice(n_big, size=min(sample, n_big), replace=False)
    for i in idx:
        want = int(vals[i]) * pow(int(bvals[i]), rounds + 1, p) % p
        check(int(opened[i]) % p == want, f'product {i} wrong')
    rt.shutdown()
    return dict(p=p, per_call_ms=per_call_ms)


def run_compare(device, n=N_CMP, calls=CMP_CALLS, seed=1,
                profile=False, m=M, t=T) -> dict:
    """Secure comparison through the user's entry points at n elements, m
    parties and threshold t; raises on a wrong result. Returns, on the
    card, the device time of each timed np_less call (ms, CUDA events) and,
    with ``profile``, the lines of ``profile_calls`` over PROFILE_CALLS
    more."""
    rt = SimRuntime(m, device=device, threshold=t)
    rt.start()
    secint = rt.SecInt(32)
    gen = np.random.default_rng(seed)
    half = 1 << 30      # a - b must fit the 32 bits that np_less compares
    a = gen.integers(-half, half, n, dtype=np.int64)
    b = gen.integers(-half, half, n, dtype=np.int64)
    same = gen.choice(n, n // 8, replace=False)
    b[same] = a[same]
    ends = [(-half, half - 1), (half - 1, -half), (-half, -half),
            (half - 1, half - 1), (0, 0)]
    for i, (x, y) in enumerate(ends[:n]):
        a[i], b[i] = x, y
    A = rt.input(secint.array(a))[0]
    B = rt.input(secint.array(b))[1]
    cases = {
        'np_less': (lambda: rt.np_less(A, B), a < b),
        'np_equal': (lambda: rt.np_equal(A, B), a == b),
        'np_sgn': (lambda: rt.np_sgn(A - B), np.sign(a - b)),
        'np_maximum': (lambda: rt.np_maximum(A, B), np.maximum(a, b)),
        'bnn_sign': (lambda: rt.np_sgn(A, LT=True) * -2 + 1,
                     np.where(a < 0, -1, 1)),
    }
    for name, (secure, want) in cases.items():
        got = rt.output(secure())
        check(got.shape == (n,), f'{name}: wrong shape')
        bad = np.flatnonzero(got != want)
        check(bad.size == 0, f'{name}: {bad.size} of {n} outputs wrong, '
              f'first at {bad[:5].tolist()}')
    per_call_ms = []
    if torch.device(device).type == 'cuda':
        for _ in range(calls):
            ev0 = torch.cuda.Event(enable_timing=True)
            ev1 = torch.cuda.Event(enable_timing=True)
            ev0.record()
            rt.np_less(A, B)
            ev1.record()
            per_call_ms.append((ev0, ev1))
        torch.cuda.synchronize()
        per_call_ms = [e0.elapsed_time(e1) for e0, e1 in per_call_ms]
    trace = []
    if profile:
        try:   # one try: the profiler's tracing of the card is untried
            trace = profile_calls(lambda: rt.np_less(A, B), PROFILE_CALLS)
        except Exception as exc:  # noqa: BLE001 (reported, not a check)
            trace = [f'torch.profiler failed: {exc!r}']
    rt.shutdown()
    return dict(per_call_ms=per_call_ms, checked=list(cases), trace=trace)


def run_split_recombine(device, n=N_SPLIT, rounds=SPLIT_ROUNDS,
                        seed=2, m=M, t=T) -> dict:
    """bench.py:88's round trip on n secrets at m parties and threshold t,
    chained rounds; raises unless the output equals the input. Returns, on
    the card, ms per round."""
    p = sectypes.SecInt(32, device).field.modulus
    ctx = prime_field_ctx(p)
    step = pipelines.make_split_recombine(p, t, m)
    state = keccak.state_tensor(
        keccak._absorb_host(b'\x42' * 32 + b'bench-coef-stream'), device)
    gen = np.random.default_rng(seed)
    secrets = ctx.encode(gen.integers(0, 1 << 62, n, dtype=np.int64),
                         device)
    on_card = torch.device(device).type == 'cuda'
    if on_card:
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        ev0.record()
    x = secrets
    for _ in range(rounds):
        x = step(x, state)
    ms = None
    if on_card:
        ev1.record()
        torch.cuda.synchronize()
        ms = ev0.elapsed_time(ev1) / rounds
    check(torch.equal(x, secrets), 'split/recombine changed its input')
    return dict(ms_per_round=ms)


def runner_runtime(device, m: int, t: int) -> SimRuntime:
    """The runtime a runner makes of ``-M m -T t`` (``demos/parties.py``)
    on device."""
    from mpyc_tpu_torch.demos import parties
    args = parties.parse_args(argparse.ArgumentParser(),
                              ['-M', str(m), '-T', str(t)])
    args.device = device
    return parties.runtime(args)


def run_bnn(device, batch=N_BNN, passes=1 + WARM, profile=False,
            m=M, t=T) -> dict:
    """The runner's MNIST flow on test images 0..batch-1 through the user's
    entry points at m parties and threshold t (the runner's ``-M``,
    ``-T``), ``passes`` times (the first cold); raises unless every
    pass's predictions equal the plaintext model of the protocol. Returns
    the count correct against the labels, the set-up seconds (weights
    loaded and encoded on the device), the seconds of each pass and, with
    ``profile``, the lines of ``profile_calls`` over one more pass."""
    from mpyc_tpu_torch.demos import np_bnnmnist as bnn
    rt = runner_runtime(device, m, t)
    rt.start()
    secint = rt.SecInt(bnn.L_IN)
    labels, images = bnn.load_mnist(0, batch)
    on_card = torch.device(device).type == 'cuda'
    t0 = time.perf_counter()
    layers = {name: bnn.load_layer(name) for name in bnn.LAYERS}
    slayers = bnn.secure_layers(secint, layers)
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    stats = {}
    model = bnn.plain_forward(images, layers, stats)
    pass_s = []
    for _ in range(passes):
        t0 = time.perf_counter()
        preds = bnn.secure_forward(rt, secint, images, slayers)
        pass_s.append(time.perf_counter() - t0)   # output is on the host
        bad = np.flatnonzero(preds != model)
        check(preds.shape == (batch,) and bad.size == 0,
              f'bnn: {bad.size} of {batch} predictions differ from the '
              f'plaintext model, first at {bad[:5].tolist()}')
    trace = []
    if profile:
        try:   # one try, as in the comparison phase
            trace = profile_calls(
                lambda: bnn.secure_forward(rt, secint, images, slayers), 1,
                top=20)
        except Exception as exc:  # noqa: BLE001 (reported, not a check)
            trace = [f'torch.profiler failed: {exc!r}']
    rt.shutdown()
    return dict(correct=int((preds == labels).sum()), setup_s=setup_s,
                pass_s=pass_s, trace=trace, stats=stats)


def bnn_components(batch=N_BNN) -> list:
    """Device ms of each BNN layer's parts at the flow's shapes (CUDA
    events, random shares of SecInt(14)'s field): the plane GEMM alone
    (``torch._int_mm``), the planes and the GEMM (``plane_gemm``), the
    bucket sums, carry and fold (``fold_planes``), K3 without the product
    on the layer's bucket of 3 x B x N shares, and K5 (LT) at the sign's
    l on the B x N sums (one launch on their bucket); for fc4 K5 at the
    argmax's four calls (5, 2, 1 and 1 columns). Each layer's matmul
    bound: its plane contractions' int8 operations over the dense int8
    peak, or its bytes (operands read, product written) over the memory
    rate."""
    from mpyc_tpu_torch.demos import np_bnnmnist as bnn
    from mpyc_tpu_torch.ops import fieldops
    p = sectypes.SecInt(bnn.L_IN, 'cuda').field.modulus
    ctx = prime_field_ctx(p)
    gen = np.random.default_rng(9)
    st = keccak.state_tensor(keccak._absorb_host(b'\x07' * 40), 'cuda')
    nonce = (1, 0)
    spec3 = pipelines.ReshareSpec(p, T, M)
    P = 8 * ctx.L

    def bucket(n):
        return max(64, 1 << (n - 1).bit_length())

    rows = []
    shapes = {'fc1': (batch, 784, 4096), 'fc2': (M * batch, 4096, 4096),
              'fc3': (M * batch, 4096, 4096), 'fc4': (M * batch, 4096, 10)}
    for name, (rows_a, K, N) in shapes.items():
        a = random_field(p, (rows_a, K), gen)
        b = random_field(p, (K, N), gen)
        pa = fieldops._nibble_planes(a).reshape(P * rows_a, K)
        pb = fieldops._nibble_planes(b.transpose(0, 1)).reshape(P * N, K)
        gemm = cuda_ms(lambda: fieldops._int8_gemm(pa, pb), 5)
        del pa, pb
        planes = cuda_ms(lambda: ctx.plane_gemm(a, b), 3)
        prod = ctx.plane_gemm(a, b)
        fold = cuda_ms(lambda: ctx.fold_planes(prod), 3)
        del prod
        nb = bucket(batch * N)
        x = random_field(p, (M, nb), gen)
        k3 = cuda_ms(lambda: pipelines.reshare_mul(x, None, st, nonce,
                                                   spec3), 10)
        if name == 'fc4':
            k5 = 0.0
            for cols in (5, 2, 1, 1):
                spec5 = pipelines.SgnSpec(p, T, M, bnn.L_IN, 30, LT=True)
                y = random_field(p, (M, batch * cols), gen)
                k5 += cuda_ms(lambda: pipelines.sgn_chunks(
                    y, st, nonce, spec5, SimRuntime._SGN_CHUNK), 10)
        else:
            l = bnn.L_IN if name == 'fc1' else bnn.L_HIDDEN
            spec5 = pipelines.SgnSpec(p, T, M, l, 30, LT=True)
            y = random_field(p, (M, batch * N), gen)
            k5 = cuda_ms(lambda: pipelines.sgn_chunks(
                y, st, nonce, spec5, SimRuntime._SGN_CHUNK), 5)
        ops = 2 * (P * rows_a) * K * (P * N)
        b_ms, b_by = bound((rows_a * K + K * N + rows_a * N) * ctx.L * 4, 0)
        t_ops = ops / INT8_TENSOR_OPS_PER_S * 1e3
        if t_ops >= b_ms:
            b_ms, b_by = t_ops, 'operations'
        rows.append(dict(layer=name, M=rows_a, K=K, N=N, gemm_ms=gemm,
                         planes_gemm_ms=planes, fold_ms=fold, k3_ms=k3,
                         k5_ms=k5, matmul_bound_ms=b_ms,
                         matmul_bound_by=b_by))
        del a, b, x
        torch.cuda.empty_cache()
    return rows


def run_selftest(device, batch=N_SELFTEST) -> None:
    """The runner's selftest network through ``rt.input`` (SecInt(14)):
    raises unless its predictions equal the plaintext forward pass."""
    from mpyc_tpu_torch.demos import np_bnnmnist as bnn
    rt = SimRuntime(M, device=device)
    rt.start()
    got, expect = bnn.selftest(rt, rt.SecInt(bnn.L_IN), batch)
    rt.shutdown()
    check(got.shape == (batch,) and (got == expect).all(),
          f'selftest: predictions {got.tolist()} differ from {expect.tolist()}')


def run_wide(device, n=N_WIDE, seed=3) -> None:
    """A secure product at SecInt(64) (the 96-bit, three-limb field):
    n values input by party 1 and n by party 2 (28-byte draws: K2 at three
    limbs), np_multiply (K3, fused, at three limbs), every output opened
    and checked."""
    rt = SimRuntime(M, device=device)
    rt.start()
    s64 = rt.SecInt(64)
    gen = np.random.default_rng(seed)
    a = gen.integers(-(1 << 31), 1 << 31, n, dtype=np.int64)
    b = gen.integers(-(1 << 31), 1 << 31, n, dtype=np.int64)
    A = rt.input(s64.array(a), senders=0)
    B = rt.input(s64.array(b), senders=1)
    got = rt.output(rt.np_multiply(A, B))
    rt.shutdown()
    bad = np.flatnonzero(got != a * b)
    check(got.shape == (n,) and bad.size == 0,
          f'wide product: {bad.size} of {n} outputs wrong')


def run_cnn(device, batch=N_CNN, passes=1 + WARM, profile=False) -> dict:
    """The CNN runner's MNIST flow on test images 0..batch-1 through the
    user's entry points, ``passes`` times (the first cold; a pass is the
    pixels in as public values to the predictions opened); raises unless
    every pass's predictions equal the plaintext model of the protocol.
    Then one more pass with the layers marked: each layer's device ms
    (CUDA events at the runner's barriers), its peak memory, and the
    comparisons' chunks of 1024 against K5's launches (the counts of
    ``sgn_step``); with ``profile``,
    the lines of ``profile_calls`` over one more pass. Returns the counts
    against the labels and the float model, the set-up seconds and the
    seconds of each pass, and the host seconds of encoding a pass's
    pixels and all the weights into the field: the encoder of int64
    values against its general path of Python ints."""
    from mpyc_tpu_torch.demos import np_cnnmnist as cnn
    from mpyc_tpu_torch.ops import limb
    rt = SimRuntime(M, device=device)
    rt.start()
    secint = rt.SecInt(cnn.L_TYPE)
    labels, images = cnn.load_mnist(0, batch)
    on_card = torch.device(device).type == 'cuda'
    t0 = time.perf_counter()
    weights = cnn.load_weights()
    sweights = cnn.scaled_weights(weights)
    slayers = cnn.secure_layers(secint, sweights)
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    ctx = prime_field_ctx(secint.field.modulus)
    encode_s = {}
    for what, arrays in (('pixels', [cnn.images_int(images)]),
                         ('weights', [w for wb in sweights.values()
                                      for w in wb])):
        t0 = time.perf_counter()
        fast = [ctx._standard_limbs(x) for x in arrays]
        t1 = time.perf_counter()
        general = [limb.ints_to_limbs(np.asarray(x, dtype=object) % ctx.p,
                                      ctx.L) for x in arrays]
        t2 = time.perf_counter()
        check(all(np.array_equal(u, v) for u, v in zip(fast, general)),
              f'cnn: the {what} encode other than by the general path')
        encode_s[what] = dict(int64=t1 - t0, general=t2 - t1)
    stats = {}
    model = cnn.plain_forward(cnn.images_int(images), sweights, stats)
    floats = np.argmax(cnn.float_forward(
        images.reshape(-1, 1, 28, 28) / 255, weights), axis=1)

    def one_pass(barrier=None):
        x = secint.array(cnn.images_int(images))
        return cnn.secure_forward(rt, secint, x, slayers, barrier)

    pass_s = []
    for _ in range(passes):
        t0 = time.perf_counter()
        preds = one_pass()
        pass_s.append(time.perf_counter() - t0)   # output is on the host
        bad = np.flatnonzero(preds != model)
        check(preds.shape == (batch,) and bad.size == 0,
              f'cnn: {bad.size} of {batch} predictions differ from the '
              f'plaintext model, first at {bad[:5].tolist()}')
    layers, k5, chunks = {}, None, None
    if on_card:
        marks = []

        def mark(name):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append((name, ev, torch.cuda.max_memory_allocated()))
            torch.cuda.reset_peak_memory_stats()

        k5, chunks = pipelines.sgn_step.launches, pipelines.sgn_step.chunks
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        mark('start')
        check((one_pass(mark) == model).all(), 'cnn: marked pass wrong')
        torch.cuda.synchronize()
        k5 = pipelines.sgn_step.launches - k5
        chunks = pipelines.sgn_step.chunks - chunks
        for (_, e0, _), (name, e1, peak) in zip(marks, marks[1:]):
            layers[name.removeprefix('after-')] = dict(
                ms=e0.elapsed_time(e1), peak_gib=peak / 2**30)
    trace = []
    if profile:
        try:   # one try, as in the comparison phase
            trace = profile_calls(one_pass, 1, top=25)
        except Exception as exc:  # noqa: BLE001 (reported, not a check)
            trace = [f'torch.profiler failed: {exc!r}']
    rt.shutdown()
    return dict(correct=int((preds == labels).sum()),
                floats=int((preds == floats).sum()), setup_s=setup_s,
                pass_s=pass_s, trace=trace, stats=stats, layers=layers,
                k5_launches=k5, chunks=chunks, encode_s=encode_s)


def matmul_parts(ctx, a, b, reps: int = 1) -> tuple:
    """Device ms of the field matmul a @ b ((M, K, L) @ (K, N, L)) in the
    row blocks the runtime cuts it into: (planes + GEMM, carry and
    fold), times ``reps`` (the parties' products of a batched call)."""
    from mpyc_tpu_torch.ops import fieldops
    M_, K, L = a.shape
    rows = max(1, fieldops._MATMUL_BLOCK_BYTES // (64 * L * L * b.shape[1]
                                                   * 4))
    gemm = fold = 0.0
    for r0 in range(0, M_, rows):
        blk = a[r0:r0 + rows]
        gemm += cuda_ms(lambda: ctx.plane_gemm(blk, b), 2)
        prod = ctx.plane_gemm(blk, b)
        fold += cuda_ms(lambda: ctx.fold_planes(prod), 2)
        del prod
    return gemm * reps, fold * reps


def cnn_components(batch=N_CNN) -> list:
    """Device ms of each CNN layer's parts at the flow's shapes (CUDA
    events, random shares of SecInt(37)'s field): the field matmul's
    planes + GEMM and carry and fold (conv1 and conv2 as the runtime does
    them, one product a party; fc1 and fc2 as one), K3 without the product
    on the layer's reshare bucket and fused at the buckets of its secure
    products (maxpool's np_where, ReLU; the argmax's after fc2), and K5
    (LT) at each of its comparisons, one launch each. Each layer's matmul
    bound: its plane contractions' int8 operations over the dense int8
    peak, or its bytes over the memory rate."""
    from mpyc_tpu_torch.demos import np_cnnmnist as cnn
    p = sectypes.SecInt(cnn.L_TYPE, 'cuda').field.modulus
    ctx = prime_field_ctx(p)
    gen = np.random.default_rng(11)
    st = keccak.state_tensor(keccak._absorb_host(b'\x09' * 40), 'cuda')
    nonce = (1, 0)
    spec3 = pipelines.ReshareSpec(p, T, M)
    chunk = SimRuntime._SGN_CHUNK_WIDE
    B = batch
    pool1, pool2 = (B * 32 * 14 * 28, B * 32 * 14 * 14), \
        (B * 64 * 7 * 14, B * 64 * 7 * 7)
    argmax = (5 * B, 2 * B, B, B)      # the tournament's calls over 10
    # (rows a party, K, N, parties' products, reshare n, products, (l,
    # comparisons))
    shapes = {
        'conv1': (B * 784, 25, 32, M, B * 784 * 32,
                  (pool1[0], pool1[1], pool1[1]),
                  (16, (pool1[0], pool1[1], pool1[1]))),
        'conv2': (B * 196, 800, 64, M, B * 196 * 64,
                  (pool2[0], pool2[1], pool2[1]),
                  (23, (pool2[0], pool2[1], pool2[1]))),
        'fc1': (M * B, 3136, 1024, 1, B * 1024, (B * 1024,),
                (30, (B * 1024,))),
        'fc2': (M * B, 1024, 10, 1, B * 10, argmax + argmax,
                (37, argmax))}
    rows = []
    for name, (rows_a, K, N, reps, n_sh, prods, (l, cmps)) in shapes.items():
        a = random_field(p, (rows_a, K), gen)
        b = random_field(p, (K, N), gen)
        gemm, fold = matmul_parts(ctx, a, b, reps)
        del a, b
        x = random_field(p, (M, pipelines.bucket(n_sh)), gen)
        k3 = cuda_ms(lambda: pipelines.reshare_mul(x, None, st, nonce,
                                                   spec3), 5)
        for n in prods:
            y = random_field(p, (M, pipelines.bucket(n)), gen)
            k3 += cuda_ms(lambda: pipelines.reshare_mul(y, y, st, nonce,
                                                        spec3), 5)
        spec5 = pipelines.SgnSpec(p, T, M, l, 30, LT=True)
        k5 = 0.0
        for n in cmps:
            y = random_field(p, (M, n), gen)
            k5 += cuda_ms(lambda: pipelines.sgn_chunks(y, st, nonce, spec5,
                                                       chunk), 3)
        P = 8 * ctx.L
        ops = reps * 2 * (P * rows_a) * K * (P * N)
        b_ms, b_by = bound(reps * (rows_a * K + K * N + rows_a * N)
                           * ctx.L * 4, 0)
        t_ops = ops / INT8_TENSOR_OPS_PER_S * 1e3
        if t_ops >= b_ms:
            b_ms, b_by = t_ops, 'operations'
        rows.append(dict(layer=name, M=rows_a, K=K, N=N, reps=reps,
                         planes_gemm_ms=gemm, fold_ms=fold, k3_ms=k3,
                         k5_ms=k5, matmul_bound_ms=b_ms,
                         matmul_bound_by=b_by))
        del x, y
        torch.cuda.empty_cache()
    return rows


def run_cnn_selftest(device, batch=N_CNN_SELFTEST) -> None:
    """The CNN runner's selftest network through ``rt.input`` at
    SecInt(37): raises unless its predictions equal the plaintext model."""
    from mpyc_tpu_torch.demos import np_cnnmnist as cnn
    rt = SimRuntime(M, device=device)
    rt.start()
    got, expect = cnn.selftest(rt, rt.SecInt(cnn.L_TYPE), batch)
    rt.shutdown()
    check(got.shape == (batch,) and (got == expect).all(),
          f'cnn selftest: predictions {got.tolist()} differ from '
          f'{expect.tolist()}')


def chain_products(e: int) -> int:
    """The fewest Montgomery products that any addition chain for x^e
    takes: Schoenhage's lower bound on the length of an addition chain,
    log2 e + log2 v(e) - 2.13 with v(e) the number of set bits (Knuth,
    TAOCP 2, 4.6.3), and never fewer than log2 e."""
    if e < 2:
        return 0
    lg = math.log2(e)
    return max(math.ceil(lg),
               math.ceil(lg + math.log2(bin(e).count('1')) - 2.13))


# K6's time as a binary ladder, before its redesign, on this phase's
# inputs (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md's kernel table)
K6_LADDER_MS = {2: 3.3170, 3: 2.4700}


def least_product_ops(ctx) -> np.ndarray:
    """The instructions of the cheapest Montgomery product K6 and K7 use
    on ctx's field: a lazy square where 4p < R, else the square with its
    final subtraction (L subtractions and L selects more)."""
    ops = mont_sqr_lazy_ops(ctx.L)
    return ops if ctx.lazy else ops + np.array([0, 2 * ctx.L, 0])


def pow_meas(ctx, x, e: int, err: int,
             plain_ms: float | None = None) -> dict:
    """K6's time on the elements x ((n, L) Montgomery limbs) at exponent e,
    its plain version's (``plain_ms`` if given) and its bound: the
    fewest products any addition chain for e takes (``chain_products``),
    each at the cost of the cheapest product the kernel uses
    (``least_product_ops``), against the elements read and written. The
    kernel runs e's plan (``fieldops.plan_products``, held against the
    source by tests/test_torch_kernels_host.py); the plain version the
    ladder (``fieldops.pow_products``)."""
    n = x.shape[0]
    k, least = fieldops.plan_products(e), chain_products(e)
    b, o = bound(n * ctx.L * 4 * 2, n * least * least_product_ops(ctx))
    return dict(
        shape=f'{n} elements, L = {ctx.L}, a {e.bit_length()}-bit exponent: '
        f'the plan\'s {k} products (the ladder\'s '
        f'{fieldops.pow_products(e)}; any chain {least} at the least)',
        max_abs_err=err, ms=cuda_ms(lambda: fieldops.mont_pow(x, e, ctx), 10),
        plain_ms=plain_ms if plain_ms is not None else once_ms(
            lambda: fieldops._mont_pow_plain(x, e, ctx)),
        bound_ms=b, bound_by=o, products=k, least=least)


def tail_shares(p: int, n: int, gen, every: int = 0, m: int = M) -> tuple:
    """(m, n, L) random shares r and z on the card; with ``every``, each
    every-th element's r set to 0 and z to a sharing of 0 of degree 2 (x +
    x^2 at 1..m), so that r^2 + z opens to 0 there."""
    r = random_field(p, (m, n), gen)
    z = random_field(p, (m, n), gen)
    if every:
        r[:, ::every] = 0
        z[:, ::every] = prime_field_ctx(p).encode(
            np.array([[x + x * x] for x in range(1, m + 1)]), 'cuda')
    return r, z


def tail_meas(field, r, z, err: int, t: int = T,
              plain_ms: float | None = None) -> dict:
    """K7's time on shares r and z (bits in {0, 1}, f = 0: the runtime's
    call), its plain version's and its bound: r and z read, the bits and
    flags written; every product
    (``pipelines.random_bits_tail_ops``, the power's at the fewest any
    chain takes) at the cost of the cheapest product the kernel uses, and
    its modular adds."""
    p, ctx = field.modulus, field.array.ctx
    m, n, L = r.shape[0], r.shape[1], ctx.L
    e = (3 * p - 5) // 4
    mont, adds = pipelines.random_bits_tail_ops(p, False, 0, t, m)
    least = mont - fieldops.plan_products(e) + chain_products(e)
    # r and z of the 2t + 1 senders read, r of the other parties, the
    # bits and flags written
    b, o = bound(n * ((2 * (2 * t + 1) + (m - 2 * t - 1) + m) * L * 4 + 1),
                 n * (least * least_product_ops(ctx) + adds * add_mod_ops(L)))
    at = '' if (t, m) == (T, M) else f' at (t, m) = ({t}, {m})'
    return dict(
        shape=f'({m}, {n}, {L}) shares{at}: {mont} products an element ('
        f'{least} at the least), {adds} modular adds', max_abs_err=err,
        ms=cuda_ms(lambda: pipelines.random_bits_tail(r, z, field, False, 0,
                                                      t), 10),
        plain_ms=plain_ms if plain_ms is not None else once_ms(
            lambda: pipelines._random_bits_tail_plain(r, z, field, False, 0,
                                                      t)),
        bound_ms=b, bound_by=o)


def check_fxp_kernels() -> dict:
    """Phase 12's kernels against their plain versions (bit for bit): K6 at
    the inverse square root's exponent (3p - 5) / 4 on SecFxp(14, 6)'s
    field at conv1's random bits (15,052,800 elements) and on SecInt(37)'s
    three-limb field at 2^22, with 0 and 1 among the inputs, against the
    ladder; K7 at conv1's random bits on random shares and on shares with
    one r in 1,000 planted to 0 (bits, flags and count); K5 (LT, l = 14) with
    the scale 2^6 at maxpool1's first comparison in one launch of two
    chunks of 2^20 against the plain version chunk by chunk, outputs and
    counters. Each timed beside its plain version and bound. Returns
    per-instantiation measurements."""
    from mpyc_tpu_torch import finfields
    gen = np.random.default_rng(12)
    res = {}
    st = keccak.state_tensor(keccak._absorb_host(bytes(gen.integers(
        0, 256, 32, dtype=np.uint8)) + bytes(8)), 'cuda')
    p52 = sectypes.SecFxp(FXP_L, FXP_F, 'cuda').field.modulus
    p69 = sectypes.SecInt(37, 'cuda').field.modulus
    for p, n in ((p52, FXP_BITS), (p69, N_POW_WIDE)):
        ctx = prime_field_ctx(p)
        x = random_field(p, (n,), gen)
        x[0] = 0
        x[1] = torch.tensor(ctx.one_mont, dtype=torch.int64).to(torch.int32)
        e = (3 * p - 5) // 4
        want, plain = timed_once(lambda: fieldops._mont_pow_plain(x, e, ctx))
        got = fieldops.mont_pow(x, e, ctx)
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        check(err == 0, f'K6 ({n} elements, L = {ctx.L}) differs from the '
              'ladder')
        del got, want
        r = res[f'mont_pow<L={ctx.L}, lazy>'] = pow_meas(ctx, x, e, err,
                                                         plain)
        say(f'  K6 mont_pow: {r["shape"]} equal to the ladder; '
            f'{r["ms"]:.4f} ms (ladder kernel before: '
            f'{K6_LADDER_MS[ctx.L]:.4f} ms), plain {r["plain_ms"]:.4f} ms, '
            f'bound {r["bound_ms"]:.4f} ms ({r["bound_by"]}), '
            f'{r["ms"] / r["bound_ms"]:.2f}x')
        del x
        torch.cuda.empty_cache()

    field = finfields.GF(p52)
    for every in (0, 1000):
        r, z = tail_shares(p52, FXP_BITS, gen, every)
        want, plain = timed_once(lambda: pipelines._random_bits_tail_plain(
            r, z, field, False, 0, T))
        got = pipelines.random_bits_tail(r, z, field, False, 0, T)
        torch.cuda.synchronize()
        err = max_abs_err(got[0], want[0])
        check(err == 0 and torch.equal(got[1], want[1])
              and got[2].item() == want[2].item(),
              f'K7 ({FXP_BITS} elements, planted {every}) differs from its '
              'plain version')
        del got
        zeros = want[2].item()
        check(zeros == (-(-FXP_BITS // every) if every else 0),
              f'K7: {zeros} zero openings')
        del want
        if not every:
            res['random_bits_tail<L=2, lazy>'] = tail_meas(field, r, z, err,
                                                           T, plain)
        say(f'  K7 random_bits_tail at {FXP_BITS} elements, '
            + ('random shares' if not every
               else f'one r in {every} planted to 0')
            + f': bits, flags and count ({zeros} zeros) equal to plain')
        del r, z
        torch.cuda.empty_cache()
    r = res['random_bits_tail<L=2, lazy>']
    say(f'  K7 random_bits_tail: {r["shape"]}; {r["ms"]:.4f} ms, plain '
        f'(the tail before K7) {r["plain_ms"]:.4f} ms, bound '
        f'{r["bound_ms"]:.4f} ms ({r["bound_by"]}), '
        f'{r["ms"] / r["bound_ms"]:.2f}x')

    spec5 = pipelines.SgnSpec(p52, T, M, FXP_L, 30, LT=True, f=FXP_F)
    chunk = SimRuntime._SGN_CHUNK
    a = random_field(p52, (M, FXP_POOL1), gen)
    err5, plain = sgn_chunks_check(spec5, a, st, (0xFFFFFFFF, 6), chunk)
    r = res['sgn_step<LT, l=14, L=2, f=6>'] = sgn_meas(
        spec5, a, st, (3, 0), chunk, err5, plain)
    say(f'  K5 sgn_step LT at l = {FXP_L}, f = {FXP_F} (SecFxp({FXP_L}, '
        f'{FXP_F})\'s field): one launch of {r["shape"]} equal to plain '
        f'chunk by chunk, counters too; per element {r["mont"]} Montgomery '
        f'products, {r["adds"]:.0f} modular adds/subs; {r["ms"]:.4f} ms, '
        f'plain {r["plain_ms"]:.4f} ms, bound {r["bound_ms"]:.4f} ms '
        f'({r["bound_by"]}), {r["ms"] / r["bound_ms"]:.2f}x')
    del a
    torch.cuda.empty_cache()
    return res


def _timed(fn, on_card: bool):
    """fn()'s result, its host seconds (to a synchronize) and, on the card,
    its device ms (CUDA events)."""
    if on_card:
        torch.cuda.synchronize()
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        ev0.record()
    t0 = time.perf_counter()
    out = fn()
    ms = None
    if on_card:
        ev1.record()
        torch.cuda.synchronize()
        ms = ev0.elapsed_time(ev1)
    return out, time.perf_counter() - t0, ms


def random_bits_split(n=FXP_BITS, reps=3) -> dict:
    """Device ms of the parts of one ``np_random_bits`` round of n bits at
    SecFxp(14, 6)'s field on the card, CUDA events around each: the PRSS
    draw of r and the PRSS zero-sharing z (``_stacked_prss`` twice), then
    the tail on those r and z as the runtime runs it (K7,
    ``pipelines.random_bits_tail``) and as its plain version (the tail
    before K7: plain torch, K6 for the power). After a warm-up round, the
    least of ``reps`` rounds each."""
    rt = SimRuntime(M, device='cuda')
    rt.start()
    field = rt.SecFxp(FXP_L, FXP_F).field
    prfs = rt.prfs(field.modulus)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    res = {k: [] for k in ('r', 'z', 'tail', 'tail_plain')}
    for rep in range(reps + 1):
        torch.cuda.synchronize()
        ev[0].record()
        r = rt._stacked_prss(field, prfs, rt._prss_uci(), n)
        ev[1].record()
        z = rt._stacked_prss(field, prfs, rt._prss_uci(), n, zero=True)
        ev[2].record()
        pipelines.random_bits_tail(r.data, z.data, field, False, 0, T)
        ev[3].record()
        pipelines._random_bits_tail_plain(r.data, z.data, field, False, 0, T)
        ev[4].record()
        torch.cuda.synchronize()
        if rep:
            for k, (e0, e1) in zip(res, zip(ev, ev[1:])):
                res[k].append(e0.elapsed_time(e1))
        del r, z
        torch.cuda.empty_cache()
    rt.shutdown()
    return {k: min(v) for k, v in res.items()}


def run_fxp_rounds(device, n=FXP_CONV1, seed=13) -> dict:
    """Phase 12's protocol rounds through the runtime at SecFxp(14, 6):
    ``np_random_bits`` of 6 n bits (conv1's truncations' bits), every
    opened value 0 or 1; ``np_trunc`` of n values x in [-2^19, 2^19) (the
    range of a product at 2^12 that the truncation takes, l = 20), every
    opened value floor(x / 2^6) or one more. Returns the host seconds and
    device ms of each, the share of ones and of values rounded up."""
    rt = SimRuntime(M, device=device)
    rt.start()
    sfx = rt.SecFxp(FXP_L, FXP_F)
    on_card = torch.device(device).type == 'cuda'
    bits, bits_s, bits_ms = _timed(
        lambda: rt.np_random_bits(sfx.field, FXP_F * n), on_card)
    vals = rt.output(bits).value
    check(vals.shape == (FXP_F * n,) and np.isin(vals, (0, 1)).all(),
          'np_random_bits: an opened bit other than 0 or 1')
    ones = float(vals.mean())
    sd = 0.5 / math.sqrt(vals.size)
    check(abs(ones - 0.5) < 6 * sd, f'np_random_bits: {ones:.6f} of the '
          f'bits are 1, more than 6 standard deviations ({sd:.2e}) from 0.5')
    del bits, vals
    gen = np.random.default_rng(seed)
    half = 1 << (FXP_L + FXP_F - 1)
    x = gen.integers(-half, half, n)
    X = rt.input(sfx.array(x / (1 << FXP_F)), senders=0)
    Y, trunc_s, trunc_ms = _timed(lambda: rt.np_trunc(X), on_card)
    d = np.round(rt.output(Y) * (1 << FXP_F)).astype(np.int64) \
        - np.floor_divide(x, 1 << FXP_F)
    bad = np.flatnonzero((d != 0) & (d != 1))
    check(bad.size == 0, f'np_trunc: {bad.size} of {n} opened values not '
          f'floor(x / 2^{FXP_F}) or one more, first at {bad[:5].tolist()}')
    # x is rounded up with probability q = (x mod 2^f) / 2^f
    q = np.mod(x, 1 << FXP_F) / (1 << FXP_F)
    up, want = float((d == 1).mean()), float(q.mean())
    sd = math.sqrt(float((q * (1 - q)).mean()) / n)
    check(abs(up - want) < 6 * sd, f'np_trunc: {up:.6f} of the values '
          f'rounded up, more than 6 standard deviations ({sd:.2e}) from '
          f'{want:.6f}')
    rt.shutdown()
    return dict(bits_s=bits_s, bits_ms=bits_ms, ones=ones, trunc_s=trunc_s,
                trunc_ms=trunc_ms, up=up, up_want=want)


def run_cnn_fxp(device, batch=N_FXP, passes=1 + WARM,
                profile=False, m=M, t=T) -> dict:
    """The CNN runner's fixed-point flow (``--fxp``: SecFxp(14, 6)) on
    MNIST test images 0..batch-1 through the user's entry points,
    ``passes`` times (the first cold; a pass is the float pixels in as
    public values to the predictions opened). Every pass keeps its stages,
    opened after it, and raises unless each passes the runner's
    stage-local check (``check_fxp_stages``). Then one more pass with the
    layers marked: each layer's device ms (CUDA events at the runner's
    barriers) and peak memory; with ``profile``, the lines of
    ``profile_calls`` over one more pass. Returns per pass the seconds and
    the counts against the labels and the float model, the images where
    the predictions and the float model differ, the layers' ranges, and
    K5's, K6's and K7's launches a pass. At m parties and threshold t
    (the runner's ``-M``, ``-T``)."""
    from mpyc_tpu_torch.demos import np_cnnmnist as cnn
    rt = runner_runtime(device, m, t)
    rt.start()
    sfx = rt.SecFxp(cnn.L_FXP, cnn.F)
    labels, images = cnn.load_mnist(0, batch)
    xf = images.reshape(-1, 1, 28, 28) / 255
    on_card = torch.device(device).type == 'cuda'
    t0 = time.perf_counter()
    weights = cnn.load_weights()
    slayers = cnn.secure_layers(sfx, weights)
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    floats = np.argmax(cnn.float_forward(xf, weights), axis=1)

    def checked_pass(barrier=None):
        kept = {}
        preds = cnn.secure_forward(rt, sfx, sfx.array(xf), slayers,
                                   barrier, kept)
        return preds, kept

    def verify(preds, kept, what):
        opened = cnn.open_stages(rt, kept, preds)
        checks = cnn.check_fxp_stages(xf, weights, opened)
        bad = {k: c['bad'] for k, c in checks.items() if c['bad']}
        check(preds.shape == (batch,) and not bad,
              f'cnn fxp: {what}: stages fail the stage-local check: {bad}')
        return checks, cnn.fxp_ranges(opened)

    runs = []
    for i in range(passes):
        n5, n6 = pipelines.sgn_step.launches, fieldops.mont_pow.launches
        n7 = pipelines.random_bits_tail.launches
        t0 = time.perf_counter()
        preds, kept = checked_pass()
        dt = time.perf_counter() - t0        # output is on the host
        k5 = pipelines.sgn_step.launches - n5
        k6 = fieldops.mont_pow.launches - n6
        k7 = pipelines.random_bits_tail.launches - n7
        checks, ranges = verify(preds, kept, f'pass {i}')
        del kept
        runs.append(dict(s=dt, correct=int((preds == labels).sum()),
                         floats=int((preds == floats).sum()),
                         differ=np.flatnonzero(preds != floats).tolist(),
                         k5=k5, k6=k6, k7=k7))
    layers = {}
    if on_card:
        marks = []

        def mark(name):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append((name, ev, torch.cuda.max_memory_allocated()))
            torch.cuda.reset_peak_memory_stats()

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        mark('start')
        preds, kept = checked_pass(mark)
        torch.cuda.synchronize()
        verify(preds, kept, 'marked pass')
        del kept
        for (_, e0, _), (name, e1, peak) in zip(marks, marks[1:]):
            layers[name.removeprefix('after-')] = dict(
                ms=e0.elapsed_time(e1), peak_gib=peak / 2**30)
    trace = []
    if profile:
        try:   # one try, as in the comparison phase
            trace = profile_calls(lambda: cnn.secure_forward(
                rt, sfx, sfx.array(xf), slayers), 1, top=25)
        except Exception as exc:  # noqa: BLE001 (reported, not a check)
            trace = [f'torch.profiler failed: {exc!r}']
    rt.shutdown()
    return dict(runs=runs, checks=checks, ranges=ranges, setup_s=setup_s,
                layers=layers, trace=trace)


def lp_field(l: int) -> int:
    """The LP solver's prime for SecInt(l) with a root of unity of order
    at least m + n (``SimRuntime.SecInt(l, n=m + n)``)."""
    return sectypes.SecInt(l, 'cuda', n=LP_FIELDS[l][0]).field.modulus


def check_lp_kernels() -> dict:
    """Phase "kernels", the LP solver's part: each instantiation its path
    launches that no earlier path did, bit for bit against its plain
    version (tolerance: exact) and timed at the path's shapes beside its
    plain version and bound. K3 (fused and not) at the rank-1 update of
    LPExample_R20 (four limbs, 441 elements) and of LPExample (five, 58,667:
    no multiple of its block); K5 in LT and EQ mode at each dataset's width
    on its field (l = 8 and 6 at two limbs, 70 at four, 104 and 110 at
    five) at the widest comparison of its path, and at widths that no
    instantiation took before the width became a launch parameter (l =
    20 at two limbs, 45 at three), checked only; K6 at four and five
    limbs at e = p - 2 (the reciprocal's public inverse, one element;
    checked at 1,000 too) and (p - 1) / 2 (the Legendre symbols of a
    [NO07] test, 30 elements); K7 at four and five limbs on a zero test's
    30 bits and on 1,000 shares, one element in 7 planted to open to 0
    (bits, flags and count). Returns per-instantiation measurements."""
    from mpyc_tpu_torch import finfields
    gen = np.random.default_rng(14)
    res = {}
    st = keccak.state_tensor(keccak._absorb_host(bytes(gen.integers(
        0, 256, 32, dtype=np.uint8)) + bytes(8)), 'cuda')
    nonce = (0xFFFFFFFE, 3)
    # K3 at the rank-1 updates
    for l in (70, 110):
        p = lp_field(l)
        spec = pipelines.ReshareSpec(p, T, M)
        L, n = spec.ctx.L, LP_UPDATE[l]
        a, b = random_field(p, (M, n), gen), random_field(p, (M, n), gen)
        for bb, s in ((b, ', fused'), (None, '')):
            out = pipelines.reshare_mul(a, bb, st, nonce, spec)
            want = pipelines._reshare_mul_plain(a, bb, st, nonce, spec)
            torch.cuda.synchronize()
            err = max_abs_err(out, want)
            check(err == 0, f'K3 (L = {L}, {n} elements{s}) differs from '
                  'its plain version')
            res[f'reshare_mul<L={L}{s}>'] = reshare_meas(spec, a, bb, st,
                                                         nonce, err)
        say(f'  K3 reshare_mul at L = {L}: ({M}, {n}, {L}), fused and '
            'unfused, equal to plain')
    # K5 at each width of the path, and at widths new to the kernel
    chunk = SimRuntime._SGN_CHUNK_WIDE
    cases = [(lp_field(l), l, LP_FIELDS[l][1], mode, True)
             for l in (8, 6) for mode in ('LT', 'EQ')]
    cases += [(lp_field(l), l, LP_FIELDS[l][1], mode, mode == 'LT')
              for l in (70, 104, 110) for mode in ('LT', 'EQ')]
    cases += [(sectypes.SecInt(32, 'cuda').field.modulus, 20, 300, mode,
               False) for mode in ('LT', 'EQ')]
    cases += [(sectypes.SecInt(64, 'cuda').field.modulus, 45, 300, mode,
               False) for mode in ('LT', 'EQ')]
    for p, l, n, mode, entry in cases:
        spec = pipelines.SgnSpec(p, T, M, l, 30, LT=mode == 'LT',
                                 EQ=mode == 'EQ')
        L = spec.ctx.L
        ch = SimRuntime._SGN_CHUNK if L <= 2 else chunk
        a = random_field(p, (M, n), gen)
        if entry:
            res.update(sgn_rows(f'sgn_step<{mode}, l={l}, L={L}>', spec, a,
                                st, nonce, ch))
        else:
            sgn_chunks_check(spec, a, st, nonce, ch)
        params = spec.params(nonce)
        threads = _build_lib().mtt_sgn_threads(ctypes.addressof(params))
        say(f'  K5 sgn_step {mode} at l = {l}, L = {L}: ({M}, {n}, {L}) on '
            f'a bucket of {pipelines.bucket(n, ch)}, route '
            f'{pipelines.sgn_route(L, n)}, equal to plain; the narrow '
            f'kernel\'s CTAs of {threads} elements')
    # K6: the reciprocal's inverse and the Legendre symbols
    for l in (70, 110):
        p = lp_field(l)
        ctx = prime_field_ctx(p)
        x = random_field(p, (1000,), gen)
        x[0] = 0
        for e in (p - 2, (p - 1) // 2):
            out = fieldops.mont_pow(x, e, ctx)
            want = fieldops._mont_pow_plain(x, e, ctx)
            torch.cuda.synchronize()
            err = max_abs_err(out, want)
            check(err == 0, f'K6 (L = {ctx.L}, e of {e.bit_length()} bits) '
                  'differs from its plain version')
        r = res[f'mont_pow<L={ctx.L}, lazy>'] = pow_meas(
            ctx, x[:LP_NO07_BITS].contiguous(), (p - 1) // 2, err)
        r['inverse_ms'] = cuda_ms(lambda: fieldops.mont_pow(
            x[:1].contiguous(), p - 2, ctx), 10)
        say(f'  K6 mont_pow at L = {ctx.L}: 1,000 elements, e = p - 2 and '
            f'(p - 1) / 2, equal to the ladder; {r["ms"]:.4f} ms at '
            f'{LP_NO07_BITS} Legendre symbols, {r["inverse_ms"]:.4f} ms at '
            'one inverse (launch-bound)')
        # K7: a zero test's random bits
        field = finfields.GF(p)
        for n in (1000, LP_NO07_BITS):   # timed at the last
            rr, zz = tail_shares(p, n, gen, every=7)
            got = pipelines.random_bits_tail(rr, zz, field, False, 0, T)
            want, plain = timed_once(lambda: pipelines._random_bits_tail_plain(
                rr, zz, field, False, 0, T))
            err = max(max_abs_err(got[0], want[0]),
                      int((got[1] != want[1]).sum()),
                      abs(int(got[2].item()) - int(want[2].item())))
            check(err == 0 and int(got[2].item()) == -(-n // 7),
                  f'K7 (L = {ctx.L}, {n} elements) differs from its plain '
                  'version')
        res[f'random_bits_tail<L={ctx.L}, lazy>'] = tail_meas(
            field, rr, zz, err, T, plain)
        say(f'  K7 random_bits_tail at L = {ctx.L}: {LP_NO07_BITS} and '
            '1,000 shares, one in 7 planted to 0, equal to plain')
    return res


# the small calls' part of phase "kernels" (``check_small_calls``): each
# limb count's path width for the crossovers (limbs, l, f, field: 'int'
# SecInt(l), 'lp' the LP solver's, 'fxp' SecFxp(l, f)); K3's fields of
# one to six limbs and its elements (the fixed-point kb2's rank-1
# update); K5's elements at (t, m)
CROSS_K5 = ((3, 42, 0, 'int'), (4, 70, 0, 'lp'), (5, 110, 0, 'lp'),
            (6, 96, 48, 'fxp'))
SMALL_K3_FIELDS = ((1, 'prime', 1031, 0), (2, 'int', 32, 0),
                   (3, 'int', 42, 0), (4, 'lp', 70, 0), (5, 'lp', 110, 0),
                   (6, 'fxp', 96, 48))
N_SMALL_K3 = 69 * 42
N_SMALL_K5 = 5


def small_field(kind: str, l: int, f: int) -> int:
    """The prime of a field named by kind: 'lp' the LP solver's SecInt(l),
    'fxp' SecFxp(l, f), 'prime' p = l, 'int' SecInt(l) (CROSS_K5,
    SMALL_K3_FIELDS)."""
    return lp_field(l) if kind == 'lp' else fxp_field(l, f) \
        if kind == 'fxp' else l if kind == 'prime' else \
        sectypes.SecInt(l, 'cuda').field.modulus


def check_small_calls(ptx: dict) -> dict:
    """Phase "kernels", the small calls' part. K5's route by limb count
    (``_build.SGN_CTA_MAX``, ``SGN_CTA_SHAPE``: the crossovers and the
    CTA route's shapes, with their instantiations' ptxas report from
    ``ptx``, printed), each crossover timed
    again at each limb count's path width (CROSS_K5): the narrow kernel and
    the CTA route at SGN_CTA_MAX[L] and twice as many elements, held equal
    to each other; at two limbs both routes at the LP solvers' calls (l =
    8 and 6 on 3 elements, SecFxp(18, 9) on 2), held against the plain
    version and timed (the narrow kernel keeps them); the CTA route at the
    CNN's argmax (l = 37 on 500 elements), an entry. K5's CTA route bit for
    bit against its plain version at the fixed-point kb2's width (l = 96,
    f = 48, six limbs) on 5 elements, in its three modes at (2, 5) and LT
    at (4, 9), where the narrow kernel's random bits run out
    (``_build.sgn_lb_fit``): timed there, an entry (tests/
    test_torch_small_calls_host.py holds the source at more (t, m) and
    modes). K3 bit for bit against its plain version at one to six limbs,
    fused and not, at (1, 3), (2, 5) and (4, 9) on kb2's 2,898 elements
    (CTAs of 32), and timed at (2, 5) on six limbs, an entry. Returns
    per-entry measurements."""
    from mpyc_tpu_torch import _build
    gen = np.random.default_rng(23)
    res = {}
    st = keccak.state_tensor(keccak._absorb_host(bytes(gen.integers(
        0, 256, 32, dtype=np.uint8)) + bytes(8)), 'cuda')
    nonce = (0xFFFFFFFF, 6)
    chunk = SimRuntime._SGN_CHUNK_WIDE
    say('  K5 routes: the CTA route (csrc/sgn_wide.cu, mtt_sgn_cta) on calls '
        'of at most ' + ', '.join(
            f'{_build.SGN_CTA_MAX[L]} elements at L = {L}'
            for L in _build.SGN_CTA_NL)
        + '; the narrow kernel (csrc/sgn.cuh) above; the CTA route\'s CTAs '
        + ', '.join(f'{t} threads in groups of {g} lanes to {most} '
                    'elements' if most else f'{t} in groups of {g} above'
                    for most, t, g in _build.SGN_CTA_SHAPE))
    for _, threads, group in _build.SGN_CTA_SHAPE:
        fn = f'sgn_wide_kernel<1,{int(group == 32)},{threads},{group}>'
        say(f'  ptxas {fn} (the CTA route): ' + (', '.join(
            f'{k} {v}' for k, v in ptx.get(fn, {}).items())
            or 'not in the report'))
    for L, l, f, kind in CROSS_K5:
        p = small_field(kind, l, f)
        spec = pipelines.SgnSpec(p, T, M, l, 30, LT=True, f=f)
        check(spec.ctx.L == L, f'{kind} {l} has not {L} limbs')
        times = []
        for n in (_build.SGN_CTA_MAX[L], 2 * _build.SGN_CTA_MAX[L]):
            a = random_field(p, (M, n), gen)
            outs = {r: pipelines.sgn_chunks(a, st, nonce, spec, chunk, r)[0]
                    for r in ('narrow', 'cta')}
            check(max_abs_err(outs['narrow'], outs['cta']) == 0,
                  f'K5\'s two routes differ at L = {L} on {n} elements')
            for r in ('narrow', 'cta'):
                ms = cuda_ms(lambda: pipelines.sgn_chunks(a, st, nonce, spec,
                                                          chunk, r), 5)
                times.append(f'{r} {ms:.4f} ms')
        say(f'  K5 crossover at L = {L} (LT, l = {l}): at '
            f'{_build.SGN_CTA_MAX[L]} elements {times[0]}, {times[1]}; at '
            f'{2 * _build.SGN_CTA_MAX[L]} {times[2]}, {times[3]}; the two '
            'routes equal')
    # two limbs: the LP solvers' calls of 2 and 3 elements
    times = []
    for l, f, n in ((8, 0, 3), (6, 0, 3), (18, 9, 2)):
        p = fxp_field(l, f) if f else lp_field(l)
        spec = pipelines.SgnSpec(p, T, M, l, 30, LT=True, f=f)
        a = random_field(p, (M, n), gen)
        for r in ('narrow', 'cta'):
            sgn_chunks_check(spec, a, st, nonce, SimRuntime._SGN_CHUNK, r)
            ms = cuda_ms(lambda: pipelines.sgn_chunks(
                a, st, nonce, spec, SimRuntime._SGN_CHUNK, r), 10)
            times.append(f'l = {l}{f", f = {f}" if f else ""} on {n} '
                         f'{r} {ms:.4f} ms')
    say('  K5 at two limbs (SGN_CTA_MAX[2] = 0: the narrow kernel), both '
        'routes equal to plain: ' + ', '.join(times))
    p = sectypes.SecInt(37, 'cuda').field.modulus
    spec = pipelines.SgnSpec(p, T, M, 37, 30, LT=True)
    a = random_field(p, (M, N_CNN_ARGMAX), gen)
    err, plain = sgn_chunks_check(spec, a, st, nonce, chunk, 'cta')
    res[k5_name('LT', 37, 3, cta=True)] = sgn_meas(spec, a, st, nonce, chunk,
                                                   err, plain, 'cta')
    say(f'  K5 CTA route at the CNN\'s argmax (l = 37, L = 3, '
        f'{N_CNN_ARGMAX} elements), equal to plain')
    p = fxp_field(96, 48)
    for (t, m), modes in (((2, 5), pipelines.SGN_MODES), ((4, 9), ('LT',))):
        for mode in modes:
            spec = pipelines.SgnSpec(p, t, m, 96, 30, LT=mode == 'LT',
                                     EQ=mode == 'EQ', f=48)
            a = random_field(p, (m, N_SMALL_K5), gen)
            err, plain = sgn_chunks_check(spec, a, st, nonce, chunk, 'cta')
            if (t, m, mode) == (4, 9, 'LT'):
                check(spec.lb > _build.sgn_lb_fit(t, 6),
                      'kb2\'s width fits the narrow kernel at (4, 9)')
                res[k5_name('LT', 96, 6, 48, t, m, cta=True)] = sgn_meas(
                    spec, a, st, nonce, chunk, err, plain, 'cta')
    say(f'  K5 CTA route at SecFxp(96, 48), l = 96, f = 48, L = 6: sgn, LT, '
        f'EQ at (2, 5), LT at (4, 9) (past the narrow kernel\'s random '
        f'bits) on {N_SMALL_K5} elements, equal to plain')
    n = N_SMALL_K3
    for L, kind, l, f in SMALL_K3_FIELDS:
        p = small_field(kind, l, f)
        for t, m in ((T, M), (2, 5), (4, 9)):
            spec = pipelines.ReshareSpec(p, t, m)
            check(spec.ctx.L == L, f'{kind} {l} has not {L} limbs')
            a, b = random_field(p, (m, n), gen), random_field(p, (m, n), gen)
            for bb in (b, None):
                out = pipelines.reshare_mul(a, bb, st, nonce, spec)
                want = pipelines._reshare_mul_plain(a, bb, st, nonce, spec)
                torch.cuda.synchronize()
                err = max_abs_err(out, want)
                check(err == 0, f'K3 at ({m}, {n}, {L}) at (t, m) = ({t}, '
                      f'{m}){" fused" if bb is not None else ""} differs '
                      'from its plain version')
            if (L, t, m) == (6, 2, 5):
                res['reshare_mul<L=6, fused, t=2, m=5>'] = reshare_meas(
                    spec, a, b, st, nonce, err)
    say(f'  K3 at one to six limbs, fused and not, at (1, 3), (2, 5) and '
        f'(4, 9) on {n} elements (CTAs of '
        f'{_build_lib().mtt_reshare_cta(n, 1, 6)}), equal to plain')
    return res


def fxp_field(l: int, f: int) -> int:
    """The prime of SecFxp(l, f) (the JAX package's field: l + f + 32
    bits)."""
    return sectypes.SecFxp(l, f, 'cuda').field.modulus


def _entry(kernel: str, L: int, lazy: bool) -> str:
    return f'{kernel}<L={L}{", lazy" if lazy else ""}>'


def check_fxp_lp_kernels() -> dict:
    """Phase "kernels", the part of the fixed-point LP solver and the
    survival test: each instantiation their paths launch that no earlier
    path did, bit for bit against its plain version (tolerance: exact)
    and timed at the path's shapes beside its plain version and bound. K3
    (fused and not) at six limbs at kb2's rank-1 update (69 x 42
    elements); K5 in LT mode at each SecFxp(l, f)'s width and scale at the
    widest comparison of its path (``LPFXP_CMP``), and in EQ mode at
    btrial's zero test (SecFxp(56, 28), one element); K6 at six limbs and
    on SecFxp(64, 32)'s canonical four-limb field at e = p - 2, (p - 1) /
    2 and (3p - 5) / 4 on 1,000 elements, timed at a [NO07] test's 30
    Legendre symbols; K7 at uvlp's (three limbs), kb2's (six) and aml's
    (canonical four) truncations, one element in 7 planted to open to 0
    (bits, flags and count). Returns per-instantiation measurements."""
    from mpyc_tpu_torch import finfields
    gen = np.random.default_rng(15)
    res = {}
    st = keccak.state_tensor(keccak._absorb_host(bytes(gen.integers(
        0, 256, 32, dtype=np.uint8)) + bytes(8)), 'cuda')
    nonce = (0xFFFFFFFE, 4)
    p = fxp_field(96, 48)
    spec = pipelines.ReshareSpec(p, T, M)
    L, n = spec.ctx.L, LPFXP_UPDATE[96, 48]
    a, b = random_field(p, (M, n), gen), random_field(p, (M, n), gen)
    for bb, sfx in ((b, ', fused'), (None, '')):
        out = pipelines.reshare_mul(a, bb, st, nonce, spec)
        want = pipelines._reshare_mul_plain(a, bb, st, nonce, spec)
        torch.cuda.synchronize()
        err = max_abs_err(out, want)
        check(err == 0, f'K3 (L = {L}, {n} elements{sfx}) differs from its '
              'plain version')
        res[f'reshare_mul<L={L}{sfx}>'] = reshare_meas(spec, a, bb, st,
                                                       nonce, err)
    say(f'  K3 reshare_mul at L = {L}: ({M}, {n}, {L}), fused and unfused, '
        'equal to plain')
    cases = [(l, f, n, 'LT') for (l, f), n in LPFXP_CMP.items()]
    cases.append((56, 28, 1, 'EQ'))
    for l, f, n, mode in cases:
        p = fxp_field(l, f)
        spec = pipelines.SgnSpec(p, T, M, l, 30, LT=mode == 'LT',
                                 EQ=mode == 'EQ', f=f)
        L = spec.ctx.L
        ch = SimRuntime._SGN_CHUNK if L <= 2 else SimRuntime._SGN_CHUNK_WIDE
        a = random_field(p, (M, n), gen)
        res.update(sgn_rows(f'sgn_step<{mode}, l={l}, L={L}, f={f}>', spec,
                            a, st, nonce, ch))
        params = spec.params(nonce)
        threads = _build_lib().mtt_sgn_threads(ctypes.addressof(params))
        say(f'  K5 sgn_step {mode} at l = {l}, f = {f}, L = {L}: ({M}, {n}, '
            f'{L}), route {pipelines.sgn_route(L, n)}, equal to plain; the '
            f'narrow kernel\'s CTAs of {threads} elements')
    for l, f in ((96, 48), (64, 32)):
        p = fxp_field(l, f)
        ctx = prime_field_ctx(p)
        x = random_field(p, (1000,), gen)
        x[0] = 0
        for e in (p - 2, (p - 1) // 2, (3 * p - 5) // 4):
            out = fieldops.mont_pow(x, e, ctx)
            want = fieldops._mont_pow_plain(x, e, ctx)
            torch.cuda.synchronize()
            err = max_abs_err(out, want)
            check(err == 0, f'K6 (L = {ctx.L}, e of {e.bit_length()} bits) '
                  'differs from its plain version')
        r = res[_entry('mont_pow', ctx.L, ctx.lazy)] = pow_meas(
            ctx, x[:LP_NO07_BITS].contiguous(), (p - 1) // 2, err)
        say(f'  K6 mont_pow at L = {ctx.L} ({"lazy" if ctx.lazy else "4p >= R"}'
            f'): 1,000 elements, e = p - 2, (p - 1) / 2 and (3p - 5) / 4, '
            f'equal to plain; {r["ms"]:.4f} ms at {LP_NO07_BITS} Legendre '
            'symbols')
    for (l, f), n in ((24, 12), LPFXP_UPDATE[24, 12] * 12), \
            ((96, 48), LPFXP_UPDATE[96, 48] * 48), ((64, 32), KM_AML_BITS):
        p = fxp_field(l, f)
        field = finfields.GF(p)
        ctx = field.array.ctx
        rr, zz = tail_shares(p, n, gen, every=7)
        got = pipelines.random_bits_tail(rr, zz, field, False, 0, T)
        want, plain = timed_once(lambda: pipelines._random_bits_tail_plain(
            rr, zz, field, False, 0, T))
        err = max(max_abs_err(got[0], want[0]),
                  int((got[1] != want[1]).sum()),
                  abs(int(got[2].item()) - int(want[2].item())))
        check(err == 0 and int(got[2].item()) == -(-n // 7),
              f'K7 (L = {ctx.L}, {n} elements) differs from its plain '
              'version')
        res[_entry('random_bits_tail', ctx.L, ctx.lazy)] = tail_meas(
            field, rr, zz, err, T, plain)
        say(f'  K7 random_bits_tail at L = {ctx.L} ('
            f'{"lazy" if ctx.lazy else "4p >= R"}): {n} shares, one in 7 '
            'planted to 0, equal to plain')
    return res


# K9's fields: SecInt(32)'s two limbs, SecInt(37)'s three, SecFxp(52)'s
# four, SecInt(110)'s five, SecFxp(96)'s six
def field_op_fields() -> dict:
    return {2: sectypes.SecInt(32, 'cuda').field.modulus,
            3: sectypes.SecInt(37, 'cuda').field.modulus,
            4: fxp_field(52, 26), 5: lp_field(110), 6: fxp_field(96, 48)}


def check_field_ops() -> dict:
    """Phase "kernels", K9: at each limb count, each op (product, add,
    subtraction) on kb2's rank-1 update's shares ((3, 69 x 42)) with both
    operands arrays and with either one a constant, and the product of a
    draw's chunks (below R) by a constant, bit for bit against its plain
    version (tolerance: exact); the product timed (device time, replayed
    from a CUDA graph: a launch is shorter than its host call) beside its
    plain version and its bound (two shares read, one written; a CIOS
    product an element)."""
    gen = np.random.default_rng(16)
    res = {}
    n = M * LPFXP_UPDATE[96, 48]
    for L, p in field_op_fields().items():
        ctx = prime_field_ctx(p)
        a, b = random_field(p, (M, n // M), gen), random_field(
            p, (M, n // M), gen)
        c = random_field(p, (1,), gen)
        wide = torch.randint(-2**31, 2**31, (M, n // M, L), dtype=torch.int32,
                             device='cuda')
        err = 0
        for op in fieldops._FIELD_OPS:
            cases = [(a, b), (a, c), (c, a)] + [(wide, c)] * (op == 'mul')
            for x, y in cases:
                got = fieldops.field_op(x, y, op, ctx)
                want = fieldops._field_op_plain(x, y, op, ctx)
                torch.cuda.synchronize()
                err = max(err, max_abs_err(got, want))
        check(err == 0, f'K9 (L = {L}) differs from its plain version')
        bd, o = bound(n * L * 4 * 3, n * mont_mul_ops(L))
        big_a, big_b = (random_field(p, (M, 1 << 20), gen) for _ in 'ab')
        big_bd, big_o = bound(M * (1 << 20) * L * 4 * 3,
                              M * (1 << 20) * mont_mul_ops(L))
        big_ms = graph_ms(lambda: fieldops.field_op(big_a, big_b, 'mul',
                                                    ctx), 10)
        res[f'field_op<L={L}>'] = dict(
            shape=f'({M}, {n // M}, {L}) shares, a Montgomery product',
            max_abs_err=err,
            ms=graph_ms(lambda: fieldops.field_op(a, b, 'mul', ctx), 20),
            plain_ms=cuda_ms(lambda: fieldops._field_op_plain(
                a, b, 'mul', ctx), 3),
            bound_ms=bd, bound_by=o)
        say(f'  K9 field_op at L = {L}: products, adds and subtractions of '
            f'({M}, {n // M}, {L}) shares, constants either side, chunks '
            f'below R, equal to plain; a product of ({M}, 2^20, {L}) shares '
            f'{big_ms:.4f} ms, bound {big_bd:.4f} ms ({big_o}), '
            f'{big_ms / big_bd:.2f}x')
    return res


def _build_lib():
    from mpyc_tpu_torch import _build
    return _build.library().lib


def per_pivot(r: dict) -> dict:
    """A stopped solve's launches (``run_lp``) a pivot, by instantiation."""
    return {k: round(v / r['pivots'], 2) for k, v in r['launches'].items()}


def run_lp(device, datasets=LP_DATASETS, pivots=LP_PIVOTS, profiles=(),
           m=M, t=T) -> dict:
    """Phase "lp": the secure LP solver (``mpyc_tpu_torch.demos.
    np_lpsolver``, SimRuntime(m, threshold=t)) on each dataset: the
    pivots must be the demo's count (``DATASETS``), the opened max,
    common denominator and solution those of the plain exact solver
    (``plain_solve``, Python ints), and the certificate true; a dataset of
    ``pivots`` stopped after its pivots there, its opened tableau and
    denominator plain_solve's after as many. Per dataset: seconds a solve
    (host clock, after a synchronize) and a pivot, launches by
    instantiation. ``profiles``: (dataset, window) pairs, each dataset
    solved once more under torch.profiler over its pivots window[0] ..
    window[1] - 1 only (``trace_steps``; the solve stops there): under
    'traces', by name, the window's seconds and the trace's lines."""
    from mpyc_tpu_torch.demos import np_lpsolver as lp
    res = {}
    for i in datasets:
        name, _, scale, n_iter = lp.DATASETS[i]
        stop = pivots.get(i, 0)
        before = counts()
        rt = SimRuntime(m, device=device, threshold=t)
        sync = torch.cuda.synchronize if rt.device.type == 'cuda' else \
            (lambda: None)
        sync()
        t0 = time.perf_counter()
        got = lp.solve(rt, i, out=lambda s: None, max_pivots=stop)
        sync()
        s = time.perf_counter() - t0
        after = counts()
        launches = {k: after[k] - before[k] for k in after
                    if after[k] != before[k]}
        if stop:
            want = lp.plain_solve(lp.tableau_ints(name, scale), stop)
            check(got.get('stopped') and (got['iterations'], got['T'],
                                          got['cd']) == want,
                  f'lp {name} at ({t}, {m}): the tableau after {stop} '
                  'pivots differs from the plain exact solver\'s')
            res[name] = dict(s=s, pivots=stop, s_pivot=s / stop,
                             stopped=True, of=n_iter, cd=got['cd'],
                             launches=launches)
            continue
        want = lp.plain_solve(lp.tableau_ints(name, scale))
        check(got['iterations'] == n_iter, f'lp {name}: {got["iterations"]} '
              f'pivots, not {n_iter}')
        check((got['iterations'], got['mx'], got['cd'], got['x']) == want,
              f'lp {name}: the opened results differ from the plain exact '
              'solver\'s')
        check(got['ok'], f'lp {name}: the certificate is false')
        res[name] = dict(
            s=s, pivots=n_iter, s_pivot=s / max(n_iter, 1),
            mx=got['mx'], cd=got['cd'], value=got['mx'] / got['cd'] / scale,
            launches=launches)
    res['traces'] = {lp.DATASETS[i][0]: trace_steps(
        lambda on_pivot, i=i: lp.solve(
            SimRuntime(m, device=device, threshold=t), i, out=lambda s: None,
            on_pivot=on_pivot), window) for i, window in profiles}
    return res


def fixed_keys(rt, label: str):
    """Start rt from keys derived from ``label`` (SHAKE128 of the label
    and the key's name): its PRSS keys, reshare key and input generator,
    counters and program counter at 0. The values a run opens depend on
    its PRSS keys and program counter only, so a phase on fixed keys opens
    the same values in every run, on the card and on the CPU
    (``tools/lpfxp_certificates.py --label``)."""
    def key(name, n):
        return shake_128(f'{label}/{name}'.encode()).digest(n)
    rt.load_state(key('reshare', 32), (0, 0), key('input', 32), 0,
                  prss_keys={S: key(','.join(map(str, S)), 16)
                             for S in rt._prss_keys}, pc=0)
    return rt


def recorded_keys(rt, path, line: int):
    """Start rt from the state on line ``line`` of a JSON-lines record of
    ``tools/lpfxp_certificates.py --keys-out`` (its ``state``: PRSS keys,
    reshare key and counter, input generator and nonce, program counter,
    in hex)."""
    st = json.loads(Path(path).read_text().splitlines()[line])['state']
    rt.load_state(bytes.fromhex(st['fused_key']), st['ctr'],
                  bytes.fromhex(st['rng_key']), st['rng_nonce'],
                  prss_keys={tuple(map(int, S.split(','))): bytes.fromhex(k)
                             for S, k in st['prss_keys'].items()},
                  pc=st['pc'])
    return rt


def lpfxp_runtime(device, name: str):
    """The runtime phase "lp fxp" solves dataset ``name`` on: from the
    recorded state ``LPFXP_RECORDED`` names for it, else from
    ``fixed_keys`` with the label 'lp fxp <name>'."""
    rt = SimRuntime(M, device=device)
    if name in LPFXP_RECORDED:
        return recorded_keys(rt, ROOT / LPFXP_RECORDED[name][0],
                             LPFXP_RECORDED[name][1])
    return fixed_keys(rt, f'lp fxp {name}')


def run_lp_fxp(device, datasets=LPFXP_DATASETS, profile=None,
               window=LPFXP_WINDOW) -> dict:
    """Phase "lp fxp": the fixed-point LP solver (``mpyc_tpu_torch.demos.
    np_lpsolverfxp``, SimRuntime(3)) on each dataset at its SecFxp(l):
    the certificate must be true, the opened max within ``REL_ERROR`` of
    the exact optimum and the opened solution within ``solution_tol`` of
    the plain float solver's (``check_solution``); a dataset of
    ``LPFXP_PIVOTS`` (sc50b, kb2) stops after its number of pivots, its
    opened tableau held against its opened basis's (``plain_tableau``).
    Each solve starts from fixed keys (``lpfxp_runtime``): on fresh keys
    sc50b's certificate, when its solve runs whole, is false in about one
    solve in six, in this port and in the JAX demo alike (PERF.md section
    7). Per dataset: seconds a
    solve (host clock, after a synchronize) and a pivot, launches by
    instantiation. ``profile``: a dataset solved
    once more, under torch.profiler over its pivots window[0] ..
    window[1] - 1 only (the solve stops there)."""
    from mpyc_tpu_torch.demos import np_lpsolverfxp as lpf
    res = {}
    for i in datasets:
        name, l, _ = lpf.DATASETS[i]
        before = counts()
        rt = lpfxp_runtime(device, name)
        sync = torch.cuda.synchronize if rt.device.type == 'cuda' else \
            (lambda: None)
        cap = LPFXP_PIVOTS.get(name, 0)
        sync()
        t0 = time.perf_counter()
        got = lpf.solve(rt, i, out=lambda s: None, max_pivots=cap)
        sync()
        s = time.perf_counter() - t0
        after = counts()
        if cap:
            # stopped after cap pivots: the opened tableau against the
            # tableau of its opened basis in float64 (``plain_tableau``,
            # whatever pivots reached it: fixed point may break a tie of
            # ratios another way), entry by entry within solution_tol of
            # its largest entry
            T = lpf.plain_tableau(lpf.read_csv(name), got['basis'],
                                  got['cobasis'])
            err = float(np.max(np.abs(got['T'] - T)))
            tol = lpf.solution_tol(l, T.reshape(-1))
            check(got['iterations'] == cap and err <= tol,
                  f'lp fxp {name}: the tableau after {cap} pivots is {err} '
                  'off its basis\'s')
            res[name] = dict(
                s=s, l=l, pivots=cap, plain_pivots=None, s_pivot=s / cap,
                mx=float(got['T'][0, -1]), rel_error=None,
                solution_err=err, tol=tol, stopped=True,
                launches={k: after[k] - before[k] for k in after
                          if after[k] != before[k]})
            continue
        iters, err, tol = lpf.check_solution(name, l, got['iterations'],
                                             got['x'])
        check(got['ok'], f'lp fxp {name}: the certificate is false: '
              f'{", ".join(got["failed"])} fail')
        check(abs(got['rel_error']) <= lpf.REL_ERROR, f'lp fxp {name}: max '
              f'{got["mx"]} off the optimum by {got["rel_error"]:.3%}')
        check(err <= tol, f'lp fxp {name}: the solution is {err} off the '
              'float solver\'s')
        n_iter = got['iterations']
        res[name] = dict(
            s=s, l=l, pivots=n_iter, plain_pivots=iters,
            s_pivot=s / max(n_iter, 1), mx=got['mx'],
            rel_error=got['rel_error'], solution_err=err, tol=tol,
            launches={k: after[k] - before[k] for k in after
                      if after[k] != before[k]})
    if profile is not None:
        res['window_s'], res['trace'] = trace_steps(
            lambda on_pivot: lpf.solve(
                lpfxp_runtime(device, lpf.DATASETS[profile][0]), profile,
                out=lambda s: None, on_pivot=on_pivot), window)
    return res


def run_km(device, runs=KM_RUNS) -> dict:
    """Phase "km": the survival test (``mpyc_tpu_torch.demos.
    np_kmsurvival``, SimRuntime(3)) for each (dataset, accuracy, --agg) of
    ``runs``: the secure statistic, and the aggregated one, within 1e-3
    (relative) of the plain one, as the demo asserts. Seconds a run (host
    clock), the statistics, launches by instantiation."""
    from mpyc_tpu_torch.demos import np_kmsurvival as km
    res = {}
    for ds, acc, agg in runs:
        name = km.SETTINGS[ds][0].removesuffix('.csv')
        acc = acc or km.SETTINGS[ds][2]
        label = f'{name} SecFxp({2 * acc}, {acc}){" --agg" if agg else ""}'
        before = counts()
        rt = fixed_keys(SimRuntime(M, device=device), f'km {label}')
        sync = torch.cuda.synchronize if rt.device.type == 'cuda' else \
            (lambda: None)
        sync()
        t0 = time.perf_counter()
        got = km.run(rt, ds, accuracy=acc, agg=agg, out=lambda s: None)
        sync()
        s = time.perf_counter() - t0
        after = counts()
        check(km.close(got['chi'], got['chi_ref']), f'km {label}: chi2 '
              f'{got["chi"]} against the plain {got["chi_ref"]}')
        if agg:
            check(km.close(got['chi_agg'], got['chi_ref']), f'km {label}: '
                  f'aggregated chi2 {got["chi_agg"]} against the plain '
                  f'{got["chi_ref"]}')
        res[label] = dict(s=s, chi=got['chi'], chi_ref=got['chi_ref'],
                          chi_agg=got['chi_agg'], maxT=got['maxT'],
                          launches={k: after[k] - before[k] for k in after
                                    if after[k] != before[k]})
    return res


# -- binary fields: K8 and the SHA3 and AES paths ----------------------------

# GF(2^d) work counted at its fewest, all of it logic (one op a shift, a
# one-op mask of a bit, one LOP3 for each AND-XOR). A product of two
# shares: step i of d XORs b << i under the mask of bit i of a (3 ops, 2
# at i = 0); in 32-bit lanes while d + i <= 32 (all steps at d <= 16),
# else on two words (5: two shifts, the mask, two LOP3s); then d - 1
# reduction steps of a mask of bit d + j and a LOP3 with x^(d + j) mod f,
# and one AND to d bits (none at d = 32).
def gf2_mul_ops(d: int) -> int:
    narrow = min(d, 33 - d)
    return 3 * narrow - 1 + 5 * (d - narrow) + 2 * (d - 1) + (d < 32)


# A product by a constant c known at launch: none for 0 and 1; else the
# fewer of c's shift-and-add (a shift for each set bit above bit 0, a
# LOP3 for each two XORs, deg(c) reduction steps, the AND; in 32-bit lanes
# when d + deg(c) <= 32) and the linear map of d columns c x^i mod f (a
# mask and a LOP3 each).
def gf2_const_ops(c: int, d: int) -> int:
    if c in (0, 1):
        return 0
    k, w = c.bit_length() - 1, bin(c).count('1')
    cost = 2 * d
    if d + k <= 32:
        cost = min(cost, w - (c & 1) + w // 2 + 2 * k + (d < 32))
    return cost


def reshare2_ops(spec, fused: bool) -> np.ndarray:
    """The (mul, add, logic) ops an element of K8's function needs at
    their fewest, for this spec's constants (at the points 1, x, x + 1
    every Lagrange coefficient is 1, so only the local product and the
    Horner products by x and x + 1 cost anything): the products, the
    three-input XORs of the 2t + 1 shares and of each coefficient's 2t + 1
    draws, a draw's extra bytes merged (one op each), the mask of a
    coefficient to d bits, and the m XORs of S into the rows."""
    d, t, m, ns = spec.d, spec.t, spec.m, spec.n_send
    lag = sum(gf2_const_ops(c, d) for c in spec.lag)
    xors = ns // 2
    ops = (ns * gf2_mul_ops(d) if fused else 0) + lag + xors
    ops += t * (lag + xors + ns * (spec.l_bytes - 1) + (d % 8 != 0))
    ops += sum(t * gf2_const_ops(x, d) + (t - 1) for x in spec.xs) + m
    return np.array([0, 0, ops])


def gf2_field(d: int, shape, gen: np.random.Generator) -> torch.Tensor:
    """Random GF(2^d) elements as stored on the card: (..., 1) int32."""
    v = gen.integers(0, 1 << d, tuple(shape) + (1,), dtype=np.uint64)
    return torch.from_numpy(v.astype(np.uint32).view(np.int32)).cuda()


def reshare2_meas(spec, a, b, st, nonce, err: int) -> dict:
    """K8's time on (m, n, 1) GF(2^d) shares a (times b's when b is given)
    from the state st and the call counter nonce, its plain version's and
    its bound: the shares read and written against the function's fewest
    ops an element (``reshare2_ops``) and the stream's permutations, each
    block once (the stream never leaves the chip: no bytes)."""
    from mpyc_tpu_torch import _build
    n = a.shape[1]
    fused = b is not None
    ops = n * reshare2_ops(spec, fused) + spec.n_blocks(n) * KECCAK_F_OPS
    reads = 2 if fused else 1
    bd, o = bound(n * M * 4 * (reads + 1), ops)
    what = 'fused product' if fused else 'no product'
    elems = _build.library().lib.mtt_reshare2_elems(n)
    run = lambda: pipelines.reshare2(a, b, st, nonce, spec)  # noqa: E731
    return dict(
        shape=f'({M}, {n}) GF(2^{spec.d}) shares, {what}, '
              f'{spec.n_blocks(n)} blocks of stream, {-(-n // elems)} CTAs '
              f'of {elems} elements',
        max_abs_err=err, ms=graph_ms(run, 10),
        call_ms=cuda_ms(run, 10),
        plain_ms=cuda_ms(lambda: pipelines._reshare2_plain(
            a, b, st, nonce, spec), 1),
        bound_ms=bd, bound_by=o)


def check_gf2_kernels() -> dict:
    """Phase "gf2 kernels": K8 at SHA3's chi (3, 2^19) in GF(4) and at
    AES's S-box products (3, 32,768) in GF(2^8), fused and not, and at the
    key schedule's bucket (3, 64), each squeezing the call's stream
    itself, equal bit for bit to its plain version from the same state and
    counter (tolerance: exact) and one launch with no K1 launch; K1 at the
    9,363 blocks a chi round took while K8 read K1's blocks, equal to its
    plain version and, from a hashlib-shaped state, every instance to
    hashlib's;
    each timed beside its plain version and its bound (K1 at 9,363
    blocks is the kernels line's K1), and an empty kernel (the launch
    floor). A launch here is shorter than its host call, so ``ms`` is the
    kernel's device time (``graph_ms``: the launches replayed from a CUDA
    graph), and ``call_ms`` the CUDA events' time of a call."""
    gen = np.random.default_rng(12)
    res = {}
    key = bytes(gen.integers(0, 256, 32, dtype=np.uint8))
    st = keccak.state_tensor(keccak._absorb_host(key + bytes(8)), 'cuda')
    nonce = (0xFFFFFFFF, 2)
    for name, md, ns in (('reshare2<d=2, fused>', GF4, (SHA3_CHI,)),
                         ('reshare2<d=8, fused>', GF256,
                          (AES_SBOX, AES_KEY))):
        spec = pipelines.Reshare2Spec(md, T, M)
        err = 0
        for n in ns:
            a = gf2_field(spec.d, (M, n), gen)
            b = gf2_field(spec.d, (M, n), gen)
            for bb in (b, None):
                n1 = keccak.keccak_ctr.launches
                n8 = pipelines.reshare2.launches
                out_k = pipelines.reshare2(a, bb, st, nonce, spec)
                check(keccak.keccak_ctr.launches == n1 and
                      pipelines.reshare2.launches == n8 + 1,
                      'K8 is not one launch without K1')
                out_p = pipelines._reshare2_plain(a, bb, st, nonce, spec)
                torch.cuda.synchronize()
                err = max(err, max_abs_err(out_k, out_p))
                check(err == 0, f'K8 at ({M}, {n}) GF(2^{spec.d}) differs '
                      'from its plain version')
            say(f'  K8 reshare2: ({M}, {n}) GF(2^{spec.d}), fused and not, '
                'one launch, no K1, equal to plain')
            if n == ns[0]:
                res[name] = reshare2_meas(spec, a, b, st, nonce, err)
    # K1 at 9,363 blocks (3 x 2^19 one-byte draws), the chi round's stream
    # while K8 read K1's blocks: against the plain version and hashlib
    nb = pipelines.Reshare2Spec(GF4, T, M).n_blocks(SHA3_CHI)
    prefix = key + (7).to_bytes(8, 'little')
    st_np, lane = keccak.ctr_state(prefix)
    st1 = keccak.state_tensor(st_np, 'cuda')
    out_k = keccak.keccak_ctr(st1, nb, lane)
    err1 = max_abs_err(out_k, keccak._keccak_ctr_plain(st1, nb, lane))
    check(err1 == 0, f'K1 ({nb} blocks) differs from its plain version')
    words = out_k.cpu().numpy().view(np.uint32)
    for j in range(nb):
        msg = prefix + j.to_bytes(8, 'little')
        check(words[j].astype('<u4').tobytes() == shake_128(msg).digest(168),
              f'K1 instance {j} of {nb} differs from hashlib')
    say(f'  K1 keccak_ctr: {nb} blocks, equal to plain and, all {nb}, to '
        'hashlib')
    run = lambda: keccak.keccak_ctr(st1, nb, lane)  # noqa: E731
    res['keccak_ctr'] = dict(
        shape=f'{k1_shape(nb)} (a SHA3 chi round\'s stream at b = '
              f'{N_SHA3} while K8 read K1\'s blocks)', max_abs_err=err1,
        ms=graph_ms(run, 20), call_ms=cuda_ms(run, 20),
        plain_ms=cuda_ms(lambda: keccak._keccak_ctr_plain(st1, nb, lane), 2),
        **k1_bound(nb))
    return res


def run_sha3(device, b=N_SHA3, passes=1 + WARM, profile=False) -> dict:
    """SHA3-256 of the demo's b messages through the port's runner
    (``np_sha3.run``), cold and warm, then SHAKE128 (256 bits): every
    digest equal to hashlib's; K8's and K1's launches a batch; with
    ``profile`` one try of torch.profiler over a warm SHA3-256 batch."""
    from mpyc_tpu_torch.demos import np_sha3
    rt = SimRuntime(M, device=device)
    rt.start()
    res = dict(pass_s=[])
    for i in range(passes + 1):
        shake = i == passes
        k8, k1 = pipelines.reshare2.launches, keccak.keccak_ctr.launches
        r = np_sha3.run(rt, b, shake=shake)
        bad = sum(g != e for g, e in zip(r['got'], r['expect']))
        check(bad == 0, f'{r["name"]}: {bad} of {b} digests differ from '
              'hashlib')
        if shake:
            res['shake_s'] = r['s']
        else:
            res['pass_s'].append(r['s'])
        res['k8'] = pipelines.reshare2.launches - k8
        res['k1'] = keccak.keccak_ctr.launches - k1
        res['digest0'] = r['got'][0].hex()
    if profile:
        res['trace'] = profile_calls(lambda: np_sha3.run(rt, b), 1, top=8)
    rt.shutdown()
    return res


def run_aes(device, nb=N_AES, passes=2, only128=False,
            profile=False) -> dict:
    """The AES demo's main through the port's runner (``np_aes.run``) on
    nb blocks, ``passes`` times (cold, then warm): FIPS-197 C.1 and C.3 on
    block 0 and every block decrypted back, for AES-128 and AES-256 (with
    ``only128`` AES-128 encryption only); K8's and K1's launches a pass;
    with ``profile`` one try of torch.profiler over one AES-128
    encryption of the nb blocks."""
    from mpyc_tpu_torch.demos import np_aes
    rt = SimRuntime(M, device=device)
    rt.start()
    runs = []
    for _ in range(passes):
        k8, k1 = pipelines.reshare2.launches, keccak.keccak_ctr.launches
        r = np_aes.run(rt, nb, only128)
        for what in ('aes128_ok', 'aes128_dec_ok', 'aes256_ok',
                     'aes256_dec_ok'):
            check(r.get(what, only128), f'aes: {what} is false')
        r['k8'] = pipelines.reshare2.launches - k8
        r['k1'] = keccak.keccak_ctr.launches - k1
        runs.append(r)
    res = dict(runs=runs)
    if profile:
        res['trace'] = profile_calls(lambda: np_aes.run(rt, nb, True), 1,
                                     top=8)
    rt.shutdown()
    return res


def clmul_meas(device, nb=N_AES) -> dict:
    """The plain carry-less products (``ops/binary.py``
    ``BinaryFieldCtx.clmul_reduce``, the port of ``mpyc_tpu/ops/binary.py:
    256 _clmul_reduce``) of one AES-128 encryption of nb blocks
    (``np_aes.run`` with ``only128``: the key schedule, the encryption and
    its opening), after a warm one: their calls and elementwise products,
    and their bound. At their fewest, a product whose operand is broadcast
    (a public matrix, weight or coefficient: a constant c at each place)
    costs ``gf2_const_ops(c, d)``, a product of two full operands
    ``gf2_mul_ops(d)``; the bytes are each operand read once and the
    product written once. On the card also their device time, the
    recorded calls replayed from a CUDA graph."""
    from mpyc_tpu_torch.demos import np_aes
    from mpyc_tpu_torch.ops import binary
    rt = SimRuntime(M, device=device)
    rt.start()
    np_aes.run(rt, nb, True)
    calls = []
    cls = binary.BinaryFieldCtx
    orig = cls.clmul_reduce

    def recording(self, a, b):
        calls.append((self, a, b))
        return orig(self, a, b)
    cls.clmul_reduce = cls.mul = recording
    try:
        np_aes.run(rt, nb, True)
    finally:
        cls.clmul_reduce = cls.mul = orig
    rt.shutdown()
    products = ops = nbytes = 0
    for ctx, a, b in calls:
        n = math.prod(torch.broadcast_shapes(a.shape, b.shape))
        products += n
        nbytes += 4 * (a.numel() + b.numel() + n)
        small = a if a.numel() <= b.numel() else b
        if small.numel() < n:       # a broadcast constant at each place
            vals, reps = torch.unique(small.cpu(), return_counts=True)
            ops += sum(int(r) * n // small.numel() * gf2_const_ops(
                int(v) & ctx.mask, ctx.d) for v, r in zip(vals, reps))
        else:
            ops += n * gf2_mul_ops(ctx.d)
    bd, by = bound(nbytes, np.array([0, 0, ops]))
    res = dict(calls=len(calls), products=products, ops=ops, bytes=nbytes,
               bound_ms=bd, bound_by=by)
    if torch.device(device).type == 'cuda':
        res['ms'] = graph_ms(lambda: [orig(ctx, a, b)
                                      for ctx, a, b in calls], 1)
    return res


def check_id3_kernels() -> dict:
    """Phase "kernels", the ID3 trees' part: each instantiation their path
    launches that no earlier path did, bit for bit against its plain
    version (tolerance: exact) and timed at the path's shape beside its
    plain version and bound: K5 in LT mode at each dataset's width and in
    EQ mode at SecInt(42)'s, on one element (a Gini fraction comparison,
    the stop test: a bucket of 64), checked at 300 too; K6 at three limbs
    (SecInt(62)'s field) at e = p - 2 and (p - 1) / 2 on 1,000 elements,
    timed at a [NO07] test's 30 Legendre symbols; K6 and K7 canonical at
    two limbs (SecInt(32)'s field, 4p >= R): K6 at e = p - 2 on 1,000
    elements, timed at a Gini fraction's three reciprocals, K7 on 1,000
    shares, one element in 7 planted to open to 0 (bits, flags and
    count), timed at a shuffle's six random bits. Returns
    per-instantiation measurements."""
    from mpyc_tpu_torch import finfields
    gen = np.random.default_rng(17)
    res = {}
    st = keccak.state_tensor(keccak._absorb_host(bytes(gen.integers(
        0, 256, 32, dtype=np.uint8)) + bytes(8)), 'cuda')
    nonce = (0xFFFFFFFE, 5)
    chunk = SimRuntime._SGN_CHUNK_WIDE
    cases = [(l, 'LT') for l, _ in ID3_WIDTHS] + [(42, 'EQ')]
    for l, mode in cases:
        p = sectypes.SecInt(l, 'cuda').field.modulus
        spec = pipelines.SgnSpec(p, T, M, l, 30, LT=mode == 'LT',
                                 EQ=mode == 'EQ')
        L = spec.ctx.L
        sgn_chunks_check(spec, random_field(p, (M, 300), gen), st, nonce,
                         chunk)
        res.update(sgn_rows(f'sgn_step<{mode}, l={l}, L={L}>', spec,
                            random_field(p, (M, 1), gen), st, nonce, chunk))
        say(f'  K5 sgn_step {mode} at l = {l}, L = {L}: ({M}, 300, {L}) and '
            f'({M}, 1, {L}), equal to plain')
    p = sectypes.SecInt(62, 'cuda').field.modulus
    ctx = prime_field_ctx(p)
    x = random_field(p, (1000,), gen)
    x[0] = 0
    for e in (p - 2, (p - 1) // 2):
        out = fieldops.mont_pow(x, e, ctx)
        want = fieldops._mont_pow_plain(x, e, ctx)
        torch.cuda.synchronize()
        err = max_abs_err(out, want)
        check(err == 0, f'K6 (L = {ctx.L}, e of {e.bit_length()} bits) '
              'differs from its plain version')
    r = res[_entry('mont_pow', ctx.L, ctx.lazy)] = pow_meas(
        ctx, x[:LP_NO07_BITS].contiguous(), (p - 1) // 2, err)
    say(f'  K6 mont_pow at L = {ctx.L}: 1,000 elements, e = p - 2 and '
        f'(p - 1) / 2, equal to plain; {r["ms"]:.4f} ms at {LP_NO07_BITS} '
        'Legendre symbols')
    p = sectypes.SecInt(32, 'cuda').field.modulus
    field = finfields.GF(p)
    ctx = field.array.ctx
    check(not ctx.lazy, 'SecInt(32)\'s field takes the lazy kernels')
    x = random_field(p, (1000,), gen)
    x[0] = 0
    out = fieldops.mont_pow(x, p - 2, ctx)
    want = fieldops._mont_pow_plain(x, p - 2, ctx)
    torch.cuda.synchronize()
    err = max_abs_err(out, want)
    check(err == 0, 'K6 (L = 2, canonical) differs from its plain version')
    res['mont_pow<L=2>'] = pow_meas(ctx, x[1:4].contiguous(), p - 2, err)
    for n in (1000, 6):
        rr, zz = tail_shares(p, n, gen, every=7)
        got = pipelines.random_bits_tail(rr, zz, field, False, 0, T)
        want, plain = timed_once(lambda: pipelines._random_bits_tail_plain(
            rr, zz, field, False, 0, T))
        err = max(max_abs_err(got[0], want[0]),
                  int((got[1] != want[1]).sum()),
                  abs(int(got[2].item()) - int(want[2].item())))
        check(err == 0 and int(got[2].item()) == -(-n // 7),
              f'K7 (L = 2, canonical, {n} elements) differs from its plain '
              'version')
    res['random_bits_tail<L=2>'] = tail_meas(field, rr, zz, err, T, plain)
    say('  K6 mont_pow and K7 random_bits_tail at L = 2 (4p >= R): 1,000 '
        'elements, equal to plain')
    return res


def run_id3(device, datasets=ID3_DATASETS, profile=None) -> dict:
    """Phase "id3": the secure ID3 trees (``mpyc_tpu_torch.demos.
    np_id3gini``, SimRuntime(3)) of each dataset at the demo's bit length;
    each tree must equal ``plain_id3``'s (Python ints). Per dataset:
    seconds a tree (host clock, after a synchronize), nodes, seconds and
    launches a node. ``profile``: a dataset learnt once more under
    torch.profiler over its root node only (the learning stops at node
    1): device busy ms and idle share."""
    from mpyc_tpu_torch.demos import np_id3gini as id3
    res = {}
    for i in datasets:
        name, l = id3.SETTINGS[i]
        before = counts()
        rt = SimRuntime(M, device=device)
        tree, nodes, s = id3.build(rt, i, out=lambda s: None)
        after = counts()
        check(tree == id3.plain_id3(i), f'id3 {name}: the secure tree '
              'differs from the plain one')
        res[name] = dict(
            l=l, L=rt.SecInt(l).field.array.ctx.L, nodes=nodes,
            depth=id3.depth(tree), size=id3.size(tree), s=s,
            s_node=s / nodes,
            launches={k: round((after[k] - before[k]) / nodes, 1)
                      for k in after if after[k] != before[k]})
    if profile is not None:
        res['window_s'], res['trace'] = trace_steps(
            lambda on_node: id3.build(SimRuntime(M, device=device), profile,
                                      out=lambda s: None, on_node=on_node),
            (0, 1))
    return res


def run_sort(device, n=N_SORT, n_sorted=N_SORTED, seed=21,
             profile=False) -> dict:
    """Phase "sort": n SecInt(32) values in [-2^30, 2^30) from a seed,
    input, sorted by ``np_sort`` (Batcher's merge-exchange, every stage
    one batched comparison and one product), their maximum and minimum
    (``np_amax``, ``np_amin``), each opened and held to numpy's; then the
    sorting demo's ``demo_sorted_with_key`` on its n_sorted values
    (``random.shuffle``, ``sorted`` by a**2), held to Python's sorted.
    Seconds on the host clock after a synchronize; with ``profile`` the
    np_sort once more under torch.profiler (device time by kernel, idle
    share)."""
    from mpyc_tpu_torch.demos import sort as demo
    rt = SimRuntime(M, device=device)
    sync = torch.cuda.synchronize if rt.device.type == 'cuda' else \
        (lambda: None)
    secint = rt.SecInt(32)
    vals = np.random.default_rng(seed).integers(-2**30, 2**30, n)
    a = rt.input(secint.array(vals), senders=0)
    t = (n - 1).bit_length()
    res = dict(n=n, stages=t * (t + 1) // 2)
    sync()
    t0 = time.perf_counter()
    b = rt.np_sort(a)
    sync()
    res['sort_s'] = time.perf_counter() - t0
    res['ms_stage'] = 1e3 * res['sort_s'] / res['stages']
    check(np.array_equal(np.asarray(rt.output(b)), np.sort(vals)),
          f'sort: np_sort of {n} values differs from numpy\'s sort')
    if profile:
        res['trace'] = profile_calls(lambda: rt.np_sort(a), 1, top=8)
    t0 = time.perf_counter()
    hi, lo = rt.np_amax(a), rt.np_amin(a)
    sync()
    res['amax_amin_s'] = time.perf_counter() - t0
    check((rt.output(hi), rt.output(lo)) == (vals.max(), vals.min()),
          f'sort: np_amax/np_amin of {n} values differ from numpy\'s')
    t0 = time.perf_counter()
    ok = demo.demo_sorted_with_key(rt, demo.ramp(n_sorted),
                                   out=lambda s: None)
    sync()
    res['sorted_s'] = time.perf_counter() - t0
    check(ok, f'sort: sorted by a**2 of {n_sorted} shuffled values differs '
          'from Python\'s sorted')
    return res


def run_hash_chains(device, runs=HC_RUNS) -> dict:
    """Phase "hash chains": the one-way hash chains of
    ``mpyc_tpu_torch.demos.np_onewayhashchains`` (SimRuntime(3), a random
    seed), each of its ``runs`` (label, k, eager, SHAKE128): every
    revealed value must equal the plain chain's from the opened seed, and
    the hashes k 2^(k-1). Seconds a hash (host clock)."""
    from mpyc_tpu_torch.demos import np_onewayhashchains as hc
    res = {}
    for label, k, eager, sha3 in runs:
        before = counts()
        rt = SimRuntime(M, device=device)
        r = hc.run(rt, k, eager, sha3, out=lambda s: None)
        after = counts()
        check(r['ok'], f'hash chains {label}: a revealed value differs from '
              'the plain chain')
        check(r['hashes'] == k << (k - 1), f'hash chains {label}: '
              f'{r["hashes"]} hashes, not {k << (k - 1)}')
        res[label] = dict(
            k=k, hashes=r['hashes'], peak=r['peak'], s=r['s'],
            s_hash=r['s'] / r['hashes'],
            launches={key: after[key] - before[key] for key in after
                      if after[key] != before[key]})
    return res


def check_one_limb_kernels() -> dict:
    """Phase "kernels", the co-located demos' part: each instantiation
    their path launches that no earlier path did, bit for bit against its
    plain version (tolerance: exact) and timed at the path's shape beside
    its plain version and bound. The one-limb fields of the secure prime
    fields: K3 fused and not at (3, 1,024, 1) (a product of 1,024
    GF(1031) values; a reciprocal's reshare), checked at a ragged 6,407
    too; K6 lazy on GF(1031) and canonical on GF(2^31 - 1) at e = p - 2
    (the reciprocals of 1,024 opened values) and (p - 1) / 2; K7 lazy and
    canonical on 1,000 shares with one element in 7 planted to open to 0
    (bits, flags, count), timed at ``randrange(1000)``'s ten random bits;
    K9 at (3, 1,024, 1), products, adds and subtractions, constants
    either side. And on
    SecFxp(32, 16)'s three-limb field, K5 at l = 32, f = 16: EQ mode on
    ten elements (unit_vector, n = 10), LT on one (seclist.sort); K8
    without its product in GF(4) (``all`` of SecFld(2) votes), at the
    bucket of 64."""
    from mpyc_tpu_torch import finfields
    gen = np.random.default_rng(23)
    res = {}
    st = keccak.state_tensor(keccak._absorb_host(bytes(gen.integers(
        0, 256, 32, dtype=np.uint8)) + bytes(8)), 'cuda')
    nonce = (0xFFFFFFFD, 6)
    for p in FLD_PRIMES:
        ctx = prime_field_ctx(p)
        field = finfields.GF(p)
        lazy = ', lazy' if ctx.lazy else ''
        if p == FLD_PRIMES[0]:
            spec = pipelines.ReshareSpec(p, T, M)
            for fused in (True, False):
                err = 0
                for n in (6407, N_FLD):
                    a = random_field(p, (M, n), gen)
                    b = random_field(p, (M, n), gen) if fused else None
                    out = pipelines.reshare_mul(a, b, st, nonce, spec)
                    want = pipelines._reshare_mul_plain(a, b, st, nonce,
                                                        spec)
                    torch.cuda.synchronize()
                    err = max(err, max_abs_err(out, want))
                check(err == 0, f'K3 (L = 1, fused {fused}) differs from '
                      'its plain version')
                res[f'reshare_mul<L=1{", fused" if fused else ""}>'] = \
                    reshare_meas(spec, a, b, st, nonce, err)
            a, b = random_field(p, (M, N_FLD), gen), random_field(
                p, (M, N_FLD), gen)
            c = random_field(p, (1,), gen)
            err = 0
            for op in fieldops._FIELD_OPS:
                for x, y in ((a, b), (a, c), (c, a)):
                    got = fieldops.field_op(x, y, op, ctx)
                    torch.cuda.synchronize()
                    err = max(err, max_abs_err(
                        got, fieldops._field_op_plain(x, y, op, ctx)))
            check(err == 0, 'K9 (L = 1) differs from its plain version')
            bd, o = bound(M * N_FLD * 4 * 3, M * N_FLD * mont_mul_ops(1))
            res['field_op<L=1>'] = dict(
                shape=f'({M}, {N_FLD}, 1) shares, a Montgomery product',
                max_abs_err=err,
                ms=graph_ms(lambda: fieldops.field_op(a, b, 'mul', ctx), 20),
                plain_ms=cuda_ms(lambda: fieldops._field_op_plain(
                    a, b, 'mul', ctx), 3),
                bound_ms=bd, bound_by=o)
            say(f'  K3 reshare_mul and K9 field_op at L = 1 (GF({p})): '
                f'({M}, 6407) and ({M}, {N_FLD}), equal to plain')
        x = random_field(p, (N_FLD,), gen)
        x[0] = 0
        err = 0
        for e in (p - 2, (p - 1) // 2):
            out = fieldops.mont_pow(x, e, ctx)
            torch.cuda.synchronize()
            err = max(err, max_abs_err(out, fieldops._mont_pow_plain(
                x, e, ctx)))
        check(err == 0, f'K6 (L = 1{lazy}) differs from its plain version')
        res[f'mont_pow<L=1{lazy}>'] = pow_meas(ctx, x, p - 2, err)
        for n in (1000, 10):
            rr, zz = tail_shares(p, n, gen, every=7)
            got = pipelines.random_bits_tail(rr, zz, field, False, 0, T)
            want = pipelines._random_bits_tail_plain(rr, zz, field, False,
                                                     0, T)
            torch.cuda.synchronize()
            err = max(max_abs_err(got[0], want[0]),
                      int((got[1] != want[1]).sum()),
                      abs(int(got[2].item()) - int(want[2].item())))
            check(err == 0 and int(got[2].item()) >= n // 7,
                  f'K7 (L = 1{lazy}, {n} elements) differs from its plain '
                  'version')
        res[f'random_bits_tail<L=1{lazy}>'] = tail_meas(field, rr, zz, err)
        say(f'  K6 mont_pow and K7 random_bits_tail at L = 1{lazy} '
            f'(GF({p})): {N_FLD} and 1,000 elements, equal to plain')
    p = sectypes.SecFxp(32, 16, 'cuda').field.modulus
    chunk = SimRuntime._SGN_CHUNK_WIDE
    for mode, n in (('EQ', 10), ('LT', 1)):
        spec = pipelines.SgnSpec(p, T, M, 32, 30, LT=mode == 'LT',
                                 EQ=mode == 'EQ', f=16)
        L = spec.ctx.L
        sgn_chunks_check(spec, random_field(p, (M, 300), gen), st, nonce,
                         chunk)
        res.update(sgn_rows(f'sgn_step<{mode}, l=32, L={L}, f=16>', spec,
                            random_field(p, (M, n), gen), st, nonce, chunk))
        say(f'  K5 sgn_step {mode} at l = 32, L = {L}, f = 16: ({M}, 300) '
            f'and ({M}, {n}), equal to plain')
    spec = pipelines.Reshare2Spec(GF4, T, M)
    a = gf2_field(spec.d, (M, 64), gen)
    out = pipelines.reshare2(a, None, st, nonce, spec)
    want = pipelines._reshare2_plain(a, None, st, nonce, spec)
    torch.cuda.synchronize()
    err = max_abs_err(out, want)
    check(err == 0, 'K8 (d = 2, no product) differs from its plain version')
    res['reshare2<d=2>'] = reshare2_meas(spec, a, None, st, nonce, err)
    say(f'  K8 reshare2 in GF(4) without the product: ({M}, 64), equal to '
        'plain')
    return res


def run_colocated(device, n_santa=N_SANTA, n_unit=N_UNIT, n_list=N_SECLIST,
                  n_fld=N_FLD, defaults=True, seed=29, profile=False) -> dict:
    """Phase "co-located demos": the runners of ``demos/run-all.sh``'s
    co-located demos on SimRuntime(3), each checking itself, at their JAX
    demos' defaults (``defaults``): secretsanta (n = 5, three
    derangements), SecretSantaExplained (n = 5), indextounitvector (n =
    10: GF(11), SecInt(32), SecFxp(32, 16), unit_vector and bit_kron),
    unanimous (two voters, yes-yes and yes-no: SecFld(2)),
    PrefixOrExplained (the five circuits on all 256 vectors of 8 bits,
    their depth and work), sort (n = 5, with its secure list); then at
    sizes users run: a Secret Santa of n_santa at SecInt(32),
    ``unit_vector`` of n_unit over SecFld(min_order=n_unit) and
    SecInt(32) at three indices, a ``seclist`` of n_list SecInt(32)
    values read, written and inserted into at a secret index, and the
    secure prime fields GF(1031) and GF(2^31 - 1) at n_fld elements
    (input, product, ``==`` by Fermat's test, division by a secure
    value, ``randrange(1000)``), every result opened and checked against
    Python. Seconds a call on the host clock, after a synchronize; with
    ``profile`` one more write into the secure list under torch.profiler
    (device time by kernel, idle share, the host's operators)."""
    from mpyc_tpu_torch import random as srandom
    from mpyc_tpu_torch import seclists
    from mpyc_tpu_torch.demos import (PrefixOrExplained, SecretSantaExplained,
                                      indextounitvector, secretsanta, sort,
                                      unanimous)
    rt = SimRuntime(M, device=device)
    on_card = rt.device.type == 'cuda'
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    quiet = lambda s: None   # noqa: E731
    gen = np.random.default_rng(seed)
    res = {}

    def timed(name, fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        res[name] = time.perf_counter() - t0
        return out

    if defaults:
        r = timed('secretsanta n=5 (3 draws)',
                  lambda: secretsanta.run(rt, 5, 3, out=quiet))
        check(r['ok'], 'secretsanta: a draw is no derangement')
        r = timed('SecretSantaExplained n=5',
                  lambda: SecretSantaExplained.run(rt, 5, out=quiet))
        check(r['ok'], 'SecretSantaExplained: a stage failed its check')
        check(timed('indextounitvector n=10', lambda: indextounitvector.run(
            rt, 10, out=quiet)), 'indextounitvector: a vector is not the '
            'unit vector of its index')
        for votes in ([1, 1], [1, 0]):
            check(timed(f'unanimous {votes}', lambda: unanimous.run(
                rt, votes, out=quiet)), f'unanimous {votes}: the verdict '
                'differs from the plain AND')
        r = timed('PrefixOrExplained n=8',
                  lambda: PrefixOrExplained.run(rt, 8, out=quiet))
        check(r['ok'], 'PrefixOrExplained: a circuit differs from '
              'itertools.accumulate')
        res['prefix_or'] = [row[:3] for row in r['rows']]
        vals = sort.ramp(5)
        check(timed('sort n=5', lambda: all((
            sort.demo_sorted_with_key(rt, vals, out=quiet),
            sort.demo_seclist_descending(rt, vals, out=quiet),
            sort.demo_np_sort(rt, vals, out=quiet)))),
            'sort: a result differs from Python\'s sorted')
    r = timed(f'secretsanta n={n_santa}',
              lambda: secretsanta.run(rt, n_santa, 1, out=quiet))
    check(r['ok'], f'secretsanta n = {n_santa}: no derangement')
    secint = rt.SecInt(32)
    for sectype in (rt.SecFld(min_order=n_unit), secint):
        idx = sorted({0, n_unit // 2 + 5 if n_unit > 10 else 1, n_unit - 1})
        name = f'unit_vector n={n_unit} {sectype.__name__}'
        vecs = timed(name, lambda: [[int(v) for v in rt.output(
            rt.unit_vector(sectype(i), n_unit))] for i in idx])
        res[name] /= len(idx)
        check(all(v == [int(j == i) for j in range(n_unit)]
                  for i, v in zip(idx, vecs)),
              f'{name}: a vector is not the unit vector of its index')
    vals = [int(v) for v in gen.integers(-2**30, 2**30, n_list)]
    lst = seclists.seclist(vals, secint)
    i, j = int(gen.integers(n_list)), int(gen.integers(n_list))
    got = timed(f'seclist n={n_list} read', lambda: rt.output(
        lst[secint(i)]))
    check(got == vals[i], 'seclist: a read at a secret index')
    timed(f'seclist n={n_list} write', lambda: lst.__setitem__(
        secint(j), 12345))
    vals[j] = 12345
    timed(f'seclist n={n_list} insert', lambda: lst.insert(secint(i), -7))
    vals.insert(i, -7)
    if profile:
        res['trace'] = profile_calls(lambda: lst.__setitem__(secint(i), 777),
                                     1, top=8)
        vals[i] = 777
    check([int(v) for v in rt.output(list(lst))] == vals,
          'seclist: the list after a write and an insertion at secret '
          'indices')
    for p in FLD_PRIMES:
        secfld = rt.SecFld(p)
        x = [int(v) for v in gen.integers(0, p, n_fld)]
        y = [int(v) for v in gen.integers(1, p, n_fld)]
        y[:n_fld // 8] = x[:n_fld // 8]
        y = [v or 1 for v in y]
        a = rt.input(secfld.array(np.array(x, dtype=object)), senders=0)
        b = rt.input(secfld.array(np.array(y, dtype=object)), senders=1)
        name = f'GF({p}) n={n_fld}'
        prod = timed(f'{name} product', lambda: rt.output(a * b))
        eq = timed(f'{name} ==', lambda: rt.output(a == b))
        quo = timed(f'{name} /', lambda: rt.output(a / b))
        r = timed(f'{name} randrange(1000)', lambda: rt.output(
            srandom.randrange(secfld, 1000)))
        check([int(v) for v in prod.value] ==
              [u * v % p for u, v in zip(x, y)], f'{name}: a product')
        check([int(v) for v in eq.value] == [int(u == v) for u, v in
                                               zip(x, y)], f'{name}: ==')
        check([int(v) for v in quo.value] ==
              [u * pow(v, -1, p) % p for u, v in zip(x, y)],
              f'{name}: a quotient')
        check(0 <= int(r) < 1000, f'{name}: randrange(1000) gave {r}')
    return res


def linalg_fields() -> dict:
    """The wide fields of the linear-algebra phase by limb count, each
    one of its paths' (``LINALG_WIDE``): the 20 x 20 pseudoinverse's
    SecInt(163) (Springer's bound of its matrix; seven limbs, where its
    zero tests launch K7: a Blum prime), multilateration's SecInt(335),
    ridge regression's SecFld at each accuracy and dataset
    (``ridgeregression.field_sizes``) at the other limb counts."""
    from mpyc_tpu_torch.demos import pseudoinverse, ridgeregression
    fields = {}
    m, n, r, b, seed = PINV_RUNS[1]
    A = pseudoinverse.random_matrix(m, n, r, b, np.random.default_rng(seed))
    for l in (pseudoinverse.secint_bits(A, r), 335):
        p = sectypes.SecInt(l, 'cpu').field.modulus
        fields.setdefault(prime_field_ctx(p).L, p)
    runs = [(0, a) for a in LINALG_ALPHAS] + [
        (ds, ridgeregression.DATASETS[ds][1]) for ds in LINALG_DATASETS]
    for ds, alpha in runs:
        n1, d = ridgeregression.training_sizes(ds, seed=LINALG_SEED)
        _, order = ridgeregression.field_sizes(n1, d, alpha, 1.0)
        p = sectypes.SecFld(min_order=order, signed=True,
                            device='cpu').field.modulus
        fields.setdefault(prime_field_ctx(p).L, p)
    check(sorted(fields) == sorted(LINALG_WIDE), f'the linear algebra\'s '
          f'fields have {sorted(fields)} limbs, not {sorted(LINALG_WIDE)}')
    return fields


def timed_once(fn) -> tuple:
    """(fn's result, its ms on the host clock between synchronizes): a
    plain version too slow to call twice."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def check_wide_kernels() -> dict:
    """Phase "kernels", the linear algebra's part: each wide instantiation
    (csrc/wide.cu) at each field the phase's paths take (``linalg_fields``:
    7, 8, 9, 10, 12 and 42 limbs), at the path's shapes (``LINALG_WIDE``),
    bit for bit against its plain version (tolerance: exact) and timed
    beside it and its bound: K3 fused on (3, 64, L), without the product
    on (3, bucket of d^2, L), both also on 7 and 300 elements (checked
    only); K9's product on d (d + 1) elements; K6 at e = p - 2 on one
    element (det R's reciprocal; its plain version timed once, on the
    host clock: a 1,314-bit ladder of whole-vector products); K7 at seven
    limbs on (3, 30, 7) with one element in 7 planted to open to 0 (the
    20 x 20 pseudoinverse's [NO07] bits); K9 at kb2's 19 limbs (its
    tableau's encoding, before its first comparison refuses 19 limbs). And
    K5 in EQ mode at l = 31 (the 5 x 5 pseudoinverse's zero tests) on one
    element."""
    from mpyc_tpu_torch import finfields
    gen = np.random.default_rng(37)
    res = {}
    st = keccak.state_tensor(keccak._absorb_host(bytes(gen.integers(
        0, 256, 32, dtype=np.uint8)) + bytes(8)), 'cuda')
    nonce = (0xFFFFFFF0, 3)
    for L, p in sorted(linalg_fields().items()):
        d = LINALG_WIDE[L]
        ctx = prime_field_ctx(p)
        spec = pipelines.ReshareSpec(p, T, M)
        for fused in (True, False):
            err = 0
            n = 64 if fused else pipelines.bucket(d * d)
            for nn in (7, 300, n):
                a = random_field(p, (M, nn), gen)
                b = random_field(p, (M, nn), gen) if fused else None
                out = pipelines.reshare_mul(a, b, st, nonce, spec)
                want = pipelines._reshare_mul_plain(a, b, st, nonce, spec)
                torch.cuda.synchronize()
                err = max(err, max_abs_err(out, want))
            check(err == 0, f'wide K3 (L = {L}, fused {fused}) differs '
                  'from its plain version')
            res[f'reshare_mul<L={L}{", fused" if fused else ""}>'] = \
                reshare_meas(spec, a, b, st, nonce, err)
        n = d * (d + 1)
        x, y = random_field(p, (n,), gen), random_field(p, (n,), gen)
        err = max_abs_err(fieldops.field_op(x, y, 'mul', ctx),
                          fieldops._field_op_plain(x, y, 'mul', ctx))
        for op in ('add', 'sub'):
            err = max(err, max_abs_err(fieldops.field_op(x, y, op, ctx),
                                       fieldops._field_op_plain(x, y, op,
                                                                ctx)))
        check(err == 0, f'wide K9 (L = {L}) differs from its plain version')
        bd, o = bound(n * 3 * L * 4, n * mont_mul_ops(L))
        res[f'field_op<L={L}>'] = dict(
            shape=f'({n}, {L}), a Montgomery product', max_abs_err=err,
            ms=graph_ms(lambda: fieldops.field_op(x, y, 'mul', ctx), 20),
            plain_ms=cuda_ms(lambda: fieldops._field_op_plain(
                x, y, 'mul', ctx), 1), bound_ms=bd, bound_by=o)
        z = random_field(p, (1,), gen)
        e = p - 2
        want, plain_ms = timed_once(lambda: fieldops._mont_pow_plain(
            z, e, ctx))
        err = max_abs_err(fieldops.mont_pow(z, e, ctx), want)
        check(err == 0, f'wide K6 (L = {L}) differs from its plain version')
        k, least = fieldops.plan_products(e), chain_products(e)
        bd, o = bound(L * 4 * 2, least * least_product_ops(ctx))
        res[f'mont_pow<L={L}>'] = dict(
            shape=f'1 element, L = {L}, a {e.bit_length()}-bit exponent: '
            f'the plan\'s {k} products (any chain {least} at the least)',
            max_abs_err=err, ms=cuda_ms(lambda: fieldops.mont_pow(z, e, ctx),
                                        3),
            plain_ms=plain_ms, bound_ms=bd, bound_by=o, ctas=1,
            sm_bound_ms=sm_bound(L * 4 * 2, least * least_product_ops(ctx),
                                 wide_ctas('mont_pow', ctx, 1)))
        if L == 7:
            field = finfields.GF(p)
            rr, zz = tail_shares(p, 30, gen, every=7)
            got = pipelines.random_bits_tail(rr, zz, field, False, 0, T)
            want, plain = timed_once(lambda: pipelines._random_bits_tail_plain(
                rr, zz, field, False, 0, T))
            err = max(max_abs_err(got[0], want[0]),
                      int((got[1] != want[1]).sum()),
                      abs(int(got[2].item()) - int(want[2].item())))
            check(err == 0 and int(got[2].item()) >= 30 // 7,
                  'wide K7 (L = 7) differs from its plain version')
            res['random_bits_tail<L=7>'] = tail_meas(field, rr, zz, err, T,
                                                     plain)
        say(f'  wide K3, K9, K6{", K7" if L == 7 else ""} at L = {L} '
            f'({p.bit_length()}-bit field): equal to plain')
    from mpyc_tpu_torch.demos import np_lpsolver as lp
    probe = lp.read_csv(lp.DATASETS[LP_KB2][0])   # m + 1 rows, n + 1 cols
    p = sectypes.SecInt(560, 'cuda', n=sum(probe.shape) - 2).field.modulus
    ctx = prime_field_ctx(p)
    x, y = random_field(p, (69 * 42,), gen), random_field(p, (1,), gen)
    err = max_abs_err(fieldops.field_op(x, y, 'mul', ctx),
                      fieldops._field_op_plain(x, y, 'mul', ctx))
    check(ctx.L == 19 and err == 0, 'wide K9 (L = 19) differs from its '
          'plain version')
    bd, o = bound((2 * x.shape[0] + 1) * ctx.L * 4,
                  x.shape[0] * mont_mul_ops(ctx.L))
    res['field_op<L=19>'] = dict(
        shape=f'({x.shape[0]}, 19) by a constant, a Montgomery product',
        max_abs_err=err,
        ms=graph_ms(lambda: fieldops.field_op(x, y, 'mul', ctx), 20),
        plain_ms=cuda_ms(lambda: fieldops._field_op_plain(x, y, 'mul', ctx),
                         1), bound_ms=bd, bound_by=o)
    say('  wide K9 at L = 19 (kb2\'s SecInt(560)): (2898, 19) by a constant, '
        'equal to plain')
    p = sectypes.SecInt(31, 'cuda').field.modulus
    spec = pipelines.SgnSpec(p, T, M, 31, 30, EQ=True)
    for nn in (300, 1):
        a = random_field(p, (M, nn), gen)
        err, plain = sgn_chunks_check(spec, a, st, nonce,
                                      SimRuntime._SGN_CHUNK)
    res['sgn_step<EQ, l=31, L=2>'] = sgn_meas(spec, a, st, nonce,
                                              SimRuntime._SGN_CHUNK, err,
                                              plain)
    say(f'  K5 sgn_step EQ at l = 31, L = 2: ({M}, 300) and ({M}, 1), '
        'equal to plain')
    return res


def wide_field(bits: int) -> int:
    """The prime of SecInt(bits) (bits + 32 bits: 7 limbs at 192, 19 at
    560, 48 at 1504), or at 0 kb2's (SecInt(560) with a root of unity of
    order m + n)."""
    if bits == 0:
        from mpyc_tpu_torch.demos import np_lpsolver as lp
        probe = lp.read_csv(lp.DATASETS[LP_KB2][0])
        return sectypes.SecInt(560, 'cpu', n=sum(probe.shape) - 2).field \
            .modulus
    return sectypes.SecInt(bits, 'cpu').field.modulus


def check_wide_sgn_kernels(ptx: dict) -> dict:
    """Phase "kernels", the wide comparison's part (csrc/sgn_wide.cu): the
    wide K5 at each (field, l, mode, (t, m), elements) of WIDE_SGN_CHECK
    (kb2's 68 as np_sgn calls them, ``sgn_chunks_check``; else one call
    of 8), bit for bit against its plain version (tolerance: exact; each
    plain call's seconds printed) and timed beside it and its bound
    (``sgn_meas``: SgnSpec.field_ops at L limbs through int_lane_ops); at
    seven limbs in all three modes at l = 192 (SecInt(192)) and in LT mode
    at (2, 5) and (4, 9); at 19 limbs in all three modes at l = 64 and at
    l = 560 (LT on kb2's own field, the others on SecInt(560)'s), and at
    (2, 5); at 48 limbs in all three modes at l = 32 and 1504. Then one
    launch at each path shape of WIDE_SGN_PATHS, its first and last chunk
    each held bit for bit against the plain version of that chunk's call
    (counter ctr + c), each plain call's seconds printed. Then the
    wide K3 (fused and not) and K7 at the (t, m) of WIDE_PARTIES_CHECK
    on (m, WIDE_PARTIES_N, L) shares (K7 with one element in 7 planted to
    open to 0), and at kb2's 19 limbs at (1, 3) K3 on its rank-1 update
    (2,898 elements) and K6 at e = p - 2 on one element (its reciprocals'
    public inverses), and K9 at 48 limbs on 1,024 elements (phase "wide
    comparison"'s inputs at SecInt(1504)). Each row gets its kernel's
    ptxas report."""
    from mpyc_tpu_torch import finfields
    gen = np.random.default_rng(41)
    res = {}
    st = keccak.state_tensor(keccak._absorb_host(bytes(gen.integers(
        0, 256, 32, dtype=np.uint8)) + bytes(8)), 'cuda')
    nonce = (0xFFFFFFF0, 3)
    chunk = SimRuntime._SGN_CHUNK_WIDE
    entries = wide_entries()
    for bits, L, l, modes, (t, m), n in WIDE_SGN_CHECK:
        p = wide_field(bits)
        check(prime_field_ctx(p).L == L, f'SecInt({bits}) has not {L} limbs')
        at = '' if (t, m) == (T, M) else f', t={t}, m={m}'
        for mode in modes:
            spec = pipelines.SgnSpec(p, t, m, l, 30, LT=mode == 'LT',
                                     EQ=mode == 'EQ')
            a = random_field(p, (m, n), gen)
            name = f'sgn_step<{mode}, l={l}, L={L}{at}>'
            if bits == 0:
                err, plain = sgn_chunks_check(spec, a, st, nonce, chunk)
                call = chunk
            else:
                got = pipelines.sgn_step(a, st, nonce, spec)
                want, plain = timed_once(
                    lambda: pipelines._sgn_step_plain(a, st, nonce, spec))
                err = max_abs_err(got, want)
                check(err == 0, f'wide K5 {name} differs from its plain '
                      'version')
                call = n
            res[name] = sgn_meas(spec, a, st, nonce, call, err, plain)
            say(f'  wide K5 {name}: ({m}, {n}, {L}) shares equal '
                f'to plain; plain {plain / 1e3:.3f} s, kernel '
                f'{res[name]["ms"]:.4f} ms')
    for bits, mode, (t, m), n, ch in WIDE_SGN_PATHS:
        p = wide_field(bits)
        spec = pipelines.SgnSpec(p, t, m, bits or 560, 30, LT=mode == 'LT',
                                 EQ=mode == 'EQ')
        a = random_field(p, (m, n), gen)
        ch = ch or chunk
        for c, plain in sgn_ends_check(spec, a, st, ch).items():
            say(f'  wide K5 {mode}, l = {spec.l}, L = {spec.ctx.L} at ({t}, '
                f'{m}), one launch on {n} elements in chunks of {ch}: '
                f'chunk {c} (counter + {c}) equal to plain; plain '
                f'{plain / 1e3:.3f} s')
    for (t, m), fields in WIDE_PARTIES_CHECK.items():
        for bits, L in fields:
            p = wide_field(bits)
            check(prime_field_ctx(p).L == L, f'SecInt({bits}) has not {L} '
                  'limbs')
            spec = pipelines.ReshareSpec(p, t, m)
            n = WIDE_PARTIES_N
            for fused, s in ((True, ', fused'), (False, '')):
                a = random_field(p, (m, n), gen)
                b = random_field(p, (m, n), gen) if fused else None
                got = pipelines.reshare_mul(a, b, st, nonce, spec)
                want, plain = timed_once(lambda: pipelines._reshare_mul_plain(
                    a, b, st, nonce, spec))
                err = max_abs_err(got, want)
                check(err == 0, f'wide K3{s} (L = {L}) at ({t}, {m}) '
                      'differs from its plain version')
                res[f'reshare_mul<L={L}{s}, t={t}, m={m}>'] = reshare_meas(
                    spec, a, b, st, nonce, err, plain)
            if bits in WIDE_TAIL_BITS:
                field = finfields.GF(p)
                r, z = tail_shares(p, 30, gen, every=7, m=m)
                got = pipelines.random_bits_tail(r, z, field, False, 0, t)
                want, plain = timed_once(
                    lambda: pipelines._random_bits_tail_plain(
                        r, z, field, False, 0, t))
                err = max(max_abs_err(got[0], want[0]),
                          int((got[1] != want[1]).sum()),
                          abs(int(got[2].item()) - int(want[2].item())))
                check(err == 0 and int(got[2].item()) >= 30 // 7,
                      f'wide K7 (L = {L}) at ({t}, {m}) differs from its '
                      'plain version')
                res[f'random_bits_tail<L={L}, t={t}, m={m}>'] = tail_meas(
                    field, r, z, err, t, plain)
            k7 = ', K7' if bits in WIDE_TAIL_BITS else ''
            say(f'  wide K3 fused and not{k7} at L = {L}, ({t}, {m}): equal '
                'to plain')
    p = wide_field(0)
    ctx = prime_field_ctx(p)
    spec = pipelines.ReshareSpec(p, T, M)
    n = 69 * 42    # kb2's rank-1 update: its tableau, 69 x 42
    for fused, s in ((True, ', fused'), (False, '')):
        a = random_field(p, (M, n), gen)
        b = random_field(p, (M, n), gen) if fused else None
        got = pipelines.reshare_mul(a, b, st, nonce, spec)
        want, plain = timed_once(lambda: pipelines._reshare_mul_plain(
            a, b, st, nonce, spec))
        err = max_abs_err(got, want)
        check(err == 0, f'wide K3{s} (L = 19) differs from its plain '
              'version')
        res[f'reshare_mul<L=19{s}>'] = reshare_meas(spec, a, b, st, nonce,
                                                    err, plain)
    z = random_field(p, (1,), gen)
    e = p - 2
    want, plain_ms = timed_once(lambda: fieldops._mont_pow_plain(z, e, ctx))
    err = max_abs_err(fieldops.mont_pow(z, e, ctx), want)
    check(err == 0, 'wide K6 (L = 19) differs from its plain version')
    k, least = fieldops.plan_products(e), chain_products(e)
    bd, o = bound(ctx.L * 4 * 2, least * least_product_ops(ctx))
    res['mont_pow<L=19>'] = dict(
        shape=f'1 element, L = 19, a {e.bit_length()}-bit exponent: the '
        f'plan\'s {k} products (any chain {least} at the least)',
        max_abs_err=err, ms=cuda_ms(lambda: fieldops.mont_pow(z, e, ctx), 3),
        plain_ms=plain_ms, bound_ms=bd, bound_by=o, ctas=1,
        sm_bound_ms=sm_bound(ctx.L * 4 * 2, least * least_product_ops(ctx),
                             wide_ctas('mont_pow', ctx, 1)))
    say('  wide K3 fused and not on (3, 2898, 19), K6 at L = 19 (kb2): '
        'equal to plain')
    p = wide_field(1504)
    ctx = prime_field_ctx(p)
    x, y = random_field(p, (1024,), gen), random_field(p, (1024,), gen)
    err = max(max_abs_err(fieldops.field_op(x, y, op, ctx),
                          fieldops._field_op_plain(x, y, op, ctx))
              for op in ('mul', 'add', 'sub'))
    check(ctx.L == 48 and err == 0, 'wide K9 (L = 48) differs from its '
          'plain version')
    bd, o = bound(3 * 1024 * 48 * 4, 1024 * mont_mul_ops(48))
    res['field_op<L=48>'] = dict(
        shape='(1024, 48), a Montgomery product (SecInt(1504)\'s 2^10 '
        'inputs)', max_abs_err=err,
        ms=graph_ms(lambda: fieldops.field_op(x, y, 'mul', ctx), 20),
        plain_ms=cuda_ms(lambda: fieldops._field_op_plain(x, y, 'mul', ctx),
                         1), bound_ms=bd, bound_by=o)
    say('  wide K9 at L = 48 (SecInt(1504)): (1024, 48), its three ops, '
        'equal to plain')
    check(set(entries) <= set(res),
          'check_wide_sgn_kernels: an entry without a row')
    for name, r in res.items():
        L = int(re.search(r'L=(\d+)', name).group(1))
        fn = (wide_fn('sgn_wide_kernel', L) if name.startswith('sgn_step')
              else 'reshare_wide_kernel' if name.startswith('reshare_mul')
              else 'random_bits_tail_wide_kernel'
              if name.startswith('random_bits') else
              wide_fn('mont_pow_wide_kernel', L)
              if name.startswith('mont_pow') else 'field_op_wide_kernel')
        rep_ = ', '.join(f'{k} {v}' for k, v in ptx.get(fn, {}).items())
        fill = f', on its {r["ctas"]} CTAs\' SMs {r["sm_bound_ms"]:.4f} ' \
            f'ms ({r["ms"] / r["sm_bound_ms"]:.2f}x)' if 'ctas' in r else ''
        say(f'  {name} [{r["shape"]}]: {r["ms"]:.4f} ms, plain '
            f'{r["plain_ms"]:.3f} ms, bound {r["bound_ms"]:.4f} ms '
            f'({r["bound_by"]}), {r["ms"] / r["bound_ms"]:.2f}x{fill}; '
            f'ptxas {fn}: {rep_ or "not in the report"}')
    return res


def rand_ints(gen, bits: int, n: int) -> np.ndarray:
    """n random signed Python ints in [-2^(bits - 1), 2^(bits - 1)) (object
    array), from 62-bit draws of gen."""
    words = -(-bits // 62)
    raw = gen.integers(0, 1 << 62, (n, words), dtype=np.int64)
    vals = [sum(int(w) << 62 * k for k, w in enumerate(row))
            % (1 << bits) - (1 << bits - 1) for row in raw]
    return np.array(vals, dtype=object)


def run_wide_compare(device, cases=WIDE_CMP, calls=WIDE_CMP_CALLS, seed=43,
                     m=M, t=T) -> dict:
    """Phase "wide comparison": for each (bits, n) of ``cases``, SecInt(bits)
    values A and B (n each, |a|, |b| < 2^(bits - 2), so that a - b fits
    the bits compared; one pair in 8 equal, 0 and the range's ends
    planted) input by two parties at m parties and threshold t; np_less,
    np_sgn(A - B) and np_sgn(A - B, EQ=True) (the wide K5 in its three
    modes), and at WIDE_EQUAL_BITS np_equal too (above 60 bits [NO07]'s
    zero test: K7, K6 and K3, not K5), each output opened and held against
    Python's comparison of the inputs; then on the card each timed over
    ``calls`` calls (device time, CUDA events). Returns per case and op
    the ms of each call."""
    rt = SimRuntime(m, device=device, threshold=t)
    rt.start()
    gen = np.random.default_rng(seed)
    on_card = rt.device.type == 'cuda'
    res = {}
    for bits, n in cases:
        secint = rt.SecInt(bits)
        a = rand_ints(gen, bits - 2, n)
        b = rand_ints(gen, bits - 2, n)
        same = gen.choice(n, max(n // 8, 1), replace=False)
        b[same] = a[same]
        lim = (1 << bits - 3) - 1
        for i, (x, y) in enumerate([(0, 0), (-lim, lim), (lim, -lim),
                                    (lim, lim)][:n]):
            a[i], b[i] = x, y
        A = rt.input(secint.array(a))[0]
        B = rt.input(secint.array(b))[1]
        eq = [int(x == y) for x, y in zip(a, b)]
        ops = {
            'np_less': (lambda: rt.np_less(A, B),
                        [int(x < y) for x, y in zip(a, b)]),
            'np_sgn': (lambda: rt.np_sgn(A - B),
                       [(x > y) - (x < y) for x, y in zip(a, b)]),
            'np_sgn EQ': (lambda: rt.np_sgn(A - B, EQ=True), eq),
        }
        if bits == WIDE_EQUAL_BITS:
            ops['np_equal'] = (lambda: rt.np_equal(A, B), eq)
        for name, (secure, want) in ops.items():
            got = [int(v) for v in np.asarray(rt.output(secure())).tolist()]
            bad = [i for i, (g, w) in enumerate(zip(got, want)) if g != w]
            check(len(got) == n and not bad, f'{name} at SecInt({bits}), '
                  f'({t}, {m}): {len(bad)} of {n} outputs wrong, first at '
                  f'{bad[:5]}')
            ms = []
            for _ in range(calls if on_card else 0):
                ev0 = torch.cuda.Event(enable_timing=True)
                ev1 = torch.cuda.Event(enable_timing=True)
                ev0.record()
                secure()
                ev1.record()
                torch.cuda.synchronize()
                ms.append(ev0.elapsed_time(ev1))
            res[f'{name} of {n} at SecInt({bits}) (L = '
                f'{secint.field.array.ctx.L}), ({t}, {m})'] = ms
    rt.shutdown()
    return res


def run_linalg(device, alphas=LINALG_ALPHAS, datasets=LINALG_DATASETS,
               pinv=PINV_RUNS, k_mlat=N_MLAT, n=1000, d=10,
               seed=LINALG_SEED) -> dict:
    """Phase "linear algebra": the runners of ``demos/run-all.sh``'s
    helloworld, oneliners, parallelsort and ot at m = 3; ridge regression
    (``run_ridge``: the synthetic set at each accuracy of ``alphas``, and
    ``datasets``); the pseudoinverse of each of ``pinv`` ((m, n, rank,
    bits, seed)); multilateration (``run_mlat``) on ``k_mlat``
    measurements. Every runner checks its results itself (the
    pseudoinverse: the Penrose equations mod p, the denominators, numpy's
    pinv) and fails the phase otherwise. Seconds a call, a solve or a
    measurement, on the host clock after a synchronize."""
    from mpyc_tpu_torch.demos import (helloworld, oneliners, ot,
                                      parallelsort, pseudoinverse)
    rt = SimRuntime(M, device=device)
    on_card = rt.device.type == 'cuda'
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    quiet = lambda s: None   # noqa: E731
    res = {}
    for name, fn in (('helloworld', lambda: helloworld.run(rt, out=quiet)),
                     ('oneliners', lambda: oneliners.run(rt, out=quiet)),
                     ('parallelsort', lambda: parallelsort.run(
                         rt, out=quiet)),
                     ('ot', lambda: ot.run(rt, seed=seed, out=quiet))):
        sync()
        t0 = time.perf_counter()
        ok = fn()
        sync()
        res[name] = time.perf_counter() - t0
        check(ok, f'{name}: a result differs from Python\'s')
    res.update(run_ridge(rt, alphas, datasets, n, d, seed))
    for m, n_, r_, b, sd in pinv:
        r = pseudoinverse.run(rt, m, n_, r_, b, sd, out=quiet)
        check(r['ok'], f'pseudoinverse {m} x {n_}: a check failed')
        res[f'pseudoinverse {m} x {n_} of rank {r_}, SecInt({r["l"]}) '
            f'(L = {r["L"]}): s'] = r['s']
    res.update(run_mlat(rt, k_mlat))
    return res


def run_ridge(rt, alphas=LINALG_ALPHAS, datasets=LINALG_DATASETS, n=1000,
              d=10, seed=LINALG_SEED) -> dict:
    """Ridge regression (``mpyc_tpu_torch/demos/ridgeregression.py``) on
    runtime rt: the synthetic set (n samples, d features, one target) at
    each accuracy of ``alphas``, and ``datasets`` (winequality-red,
    -white, student-mat). Each solve checks itself ((adj A) B and det A
    exactly against a plain integer Bareiss, the train error within 0.2 of
    a plain ridge solve) and fails the phase otherwise. Seconds a solve."""
    from mpyc_tpu_torch.demos import ridgeregression
    res = {}
    for ds in (0,) + tuple(datasets):
        r = ridgeregression.run(rt, ds, alphas if ds == 0 else None, n=n,
                                d=d, seed=seed, out=lambda s: None)
        name = 'synthetic' if ds == 0 else ridgeregression.DATASETS[ds][0]
        for alpha, sol in r['solves'].items():
            check(sol['ok'], f'ridge regression, {name} at alpha {alpha}: '
                  f'exact {sol["exact"]}, relative train error '
                  f'{sol["rel"]}')
            res[f'ridge {name} ({r["n"]} samples, d = {sol["d"]}), alpha '
                f'{alpha}, {sol["bits"]}-bit field (L = {sol["L"]}): s a '
                f'solve; relative train error {sol["rel"][0]:.6f}'] = \
                sol['s']
    return res


def run_mlat(rt, k: int) -> dict:
    """Multilateration (``mpyc_tpu_torch/demos/multilateration.py``) at
    SecInt(335) on runtime rt, on the first k measurements of sets 1 and
    3: each solve exact and the median error under 2,000 m, else the
    phase fails. Seconds a measurement (median)."""
    from mpyc_tpu_torch.demos import multilateration
    r = multilateration.run(rt, k=k, out=lambda s: None)
    check(r['ok'], f'multilateration: exact solves and median error '
          f'{r["median"]:.3f} m')
    return {f'multilateration of {r["n"]} measurements, SecInt({r["bits"]}) '
            f'(L = {r["L"]}): s a measurement (median); median error '
            f'{r["median"]:.3f} m': float(np.median(r['s_each']))}


def warm_stats(pass_s: list) -> tuple:
    """(median, least, largest) of the warm passes (all but the first)."""
    warm = sorted(pass_s[1:])
    return warm[len(warm) // 2], warm[0], warm[-1]


def main() -> int:
    faulthandler.dump_traceback_later(DEADLINE_S, exit=True)
    t_all = time.perf_counter()
    if not torch.cuda.is_available():
        print('chip_smoke: torch sees no CUDA device; the port runs on the '
              'card', file=sys.stderr)
        return 1
    with Phase('probe'):
        kind = torch.cuda.get_device_name(0)
        smi = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
        say(f'  torch {torch.__version__}, CUDA {torch.version.cuda}, '
            f'device {kind}, {torch.cuda.device_count()} visible')
        say(f'  nvidia-smi: {smi}')

    p = sectypes.SecInt(32, 'cuda').field.modulus
    with Phase('build'):
        from mpyc_tpu_torch import _build
        lib = _build.library()
        for line in lib.log.splitlines():   # all but ptxas' report
            if line.strip() and not line.startswith('ptxas info') and \
                    'bytes stack frame' not in line:
                say(f'  nvcc: {line.strip()}')
        ptx = ptxas_report(lib.log)
        for fn, r in ptx.items():
            say(f'  ptxas {fn}: ' + ', '.join(f'{k} {v}'
                                              for k, v in r.items()))
        for what, spec in (('SecInt(32), l = 32', pipelines.SgnSpec(
                p, T, M, 32, LT=True)), ('SecInt(110), l = 110', pipelines.
                SgnSpec(lp_field(110), T, M, 110, LT=True)),
                ('SecFxp(96), l = 96', pipelines.SgnSpec(
                    fxp_field(96, 48), T, M, 96, LT=True, f=48))):
            params = spec.params((0, 0))   # alive across the call
            say(f'  K5 thread block at {what}: B = '
                f'{lib.lib.mtt_sgn_threads(ctypes.addressof(params))}'
                ' elements')
        model = {L: int(mont_sqr_lazy_ops(L).sum())
                 for L in (1, 2, 3, 4, 5, 6)}
        t_sass = time.perf_counter()
        kept = [lib.path.with_name(f'{u}.o') for u in _build.KEPT_UNITS]
        if not all(k.exists() for k in kept):   # built by an older tree
            kept = [lib.path]
        sass = sass_report(*kept)
        for fn, r in sass.items():
            say(f'  SASS {fn}: {r["total"]} instructions, ' + ', '.join(
                f'{k} {v}' for k, v in r['classes'].items()))
            say(f'    its squaring loop: {r["loop"]} instructions ('
                + ', '.join(f'{k} {v}' for k, v in r['loop_classes'].items())
                + f'), {r["per_product"]:.1f} a product (the bound model\'s '
                f'lazy square: {model[int(fn.split("<")[1][0])]})')
        say(f'  SASS of {", ".join(k.name for k in kept)} read in '
            f'{time.perf_counter() - t_sass:.3f} s')
        say(f'  library {lib.path.name}: '
            f'{"built" if lib.built else "found"} in {lib.seconds:.3f} s')
        if lib.unit_s:
            say('  nvcc -c seconds to each unit\'s exit, all started '
                'together: ' + ', '.join(
                    f'{k} {v:.1f}' for k, v in lib.unit_s.items()))

    with Phase('kernels'):
        meas, part_s = {}, {}
        for part, args in ((check_kernels, (p,)), (check_slice_kernels, (p,)),
                           (check_three_limb_kernels, ()),
                           (check_lp_kernels, ()), (check_fxp_lp_kernels, ()),
                           (check_small_calls, (ptx,)),
                           (check_field_ops, ()), (check_id3_kernels, ()),
                           (check_one_limb_kernels, ()),
                           (check_wide_kernels, ()),
                           (check_wide_sgn_kernels, (ptx,)),
                           (check_parties_kernels, (p, ptx))):
            t_part = time.perf_counter()
            meas.update(part(*args))
            part_s[part.__name__] = time.perf_counter() - t_part
        say('  seconds to check and time each part: ' + ', '.join(
            f'{k} {v:.1f}' for k, v in part_s.items()))
        for name, pr in WIDE_MS_BEFORE.items():
            r = meas[name]
            say(f'  (1, 3) {name} [{r["shape"]}]: {r["ms"]:.4f} ms on this '
                f'tree (the wide K3 and K7 at every (t, m)), {pr:.4f} ms in '
                f'PERF.md ({r["ms"] / pr:.3f}x) on {smi}')
        for name, r in meas.items():
            fill = f', on its {r["ctas"]} CTAs\' SMs ' \
                f'{r["sm_bound_ms"]:.4f} ms' if 'ctas' in r else ''
            say(f'  {name} [{r["shape"]}]: {r["ms"]:.4f} ms, plain '
                f'{r["plain_ms"]:.3f} ms, bound {r["bound_ms"]:.4f} ms '
                f'({r["bound_by"]}){fill} on {smi}')
        torch.cuda.empty_cache()

    launches = dict.fromkeys(ENTRIES, 0)
    k1_blocks = {}      # path -> Counter of K1's launches by block count

    def drive(path, fn):
        reset_counts()
        hist = k1_blocks[path] = collections.Counter()
        call = _build.call

        def recording(name, *args):   # K1's blocks: its third argument
            if name == 'mtt_keccak_ctr':
                hist[args[2]] += 1
            return call(name, *args)
        _build.call = recording
        try:
            res = fn()
        finally:
            _build.call = call
        torch.cuda.synchronize()
        got = counts()
        say(f'  launches: {({k: v for k, v in got.items() if v})}')
        say(f'  K1 launches by blocks: {dict(sorted(hist.items()))}')
        for name in PATH_ENTRIES[path]:
            check(got[name] > 0, f'kernel {name} was not launched on the '
                  f'{path}')
        listed = {(n, k) for n, k in ENTRIES.values()}
        for kname, k in KERNELS.items():
            for key, c in getattr(k['wrapper'], 'by_key', {}).items():
                check(c == 0 or (kname, key) in listed, f'the {path} '
                      f'launched {kname} {key}, which the kernels line does '
                      'not list')
        for name, c in got.items():
            launches[name] += c
        return res

    with Phase('main path'):
        res = drive('main path', lambda: run_main_path('cuda'))
        ms = sorted(res['per_call_ms'])
        med = ms[len(ms) // 2]
        say(f'  np_multiply of {N_BIG} elements: median {med:.4f} ms '
            f'(calls: {", ".join(f"{x:.4f}" for x in res["per_call_ms"])}),'
            f' {N_BIG / (med / 1e3):.6g} multiplications/s on {smi}')
        torch.cuda.empty_cache()

    with Phase('comparison'):
        res = drive('comparison', lambda: run_compare('cuda', profile=True))
        ms = sorted(res['per_call_ms'])
        med_cmp = ms[len(ms) // 2]
        say(f'  all {N_CMP} outputs correct: {", ".join(res["checked"])}')
        say(f'  np_less of {N_CMP} elements: median {med_cmp:.4f} ms '
            f'(calls: {", ".join(f"{x:.4f}" for x in res["per_call_ms"])}),'
            f' {N_CMP / (med_cmp / 1e3):.6g} comparisons/s on {smi}')
        say(f'  torch.profiler over {PROFILE_CALLS} np_less calls of {N_CMP} '
            'elements:')
        for line in res['trace']:
            say(f'    {line}')
        torch.cuda.empty_cache()

    with Phase('split/recombine'):
        res = drive('split/recombine', lambda: run_split_recombine('cuda'))
        ms_round = res['ms_per_round']
        say(f'  {SPLIT_ROUNDS} chained rounds of {N_SPLIT} secrets, output '
            f'equal to input: {ms_round:.4f} ms per round, '
            f'{N_SPLIT / (ms_round / 1e3):.6g} secrets/s on {smi}')

    with Phase('bnn'):
        res_bnn = res = drive('bnn', lambda: run_bnn('cuda', profile=True))
        cold = res['pass_s'][0]
        warm, warm_lo, warm_hi = warm_stats(res['pass_s'])
        say(f'  MNIST images 0-{N_BNN - 1}, fc 784-4096-4096-4096-10, '
            f'SecInt(14), m = {M}: all {N_BNN} predictions equal the '
            f'plaintext model; {res["correct"]}/{N_BNN} correct against the '
            'labels')
        for name, (lo, hi, wide) in res['stats'].items():
            say(f'  plaintext model, {name}: sums in [{lo}, {hi}], {wide} '
                f'of {N_BNN * 4096} activations not +-1')
        say(f'  weights loaded and encoded in {res["setup_s"]:.3f} s; pass '
            f'cold {cold:.4f} s, warm median {warm:.4f} s of {WARM} (least '
            f'{warm_lo:.4f}, largest {warm_hi:.4f}): {N_BNN / warm:.6g} '
            f'images/s on {smi}')
        layers = bnn_components()
        for r in layers:
            say(f'  {r["layer"]} ({r["M"]} x {r["K"]} @ {r["K"]} x '
                f'{r["N"]}): plane GEMM {r["gemm_ms"]:.4f} ms (bound '
                f'{r["matmul_bound_ms"]:.4f} ms, {r["matmul_bound_by"]}), '
                f'planes + GEMM {r["planes_gemm_ms"]:.4f} ms, carry and fold '
                f'{r["fold_ms"]:.4f} ms, K3 {r["k3_ms"]:.4f} ms, K5 '
                f'{r["k5_ms"]:.4f} ms')
        say('  torch.profiler over one warm pass:')
        for line in res['trace']:
            say(f'    {line}')
        torch.cuda.empty_cache()

    with Phase('selftest'):
        drive('selftest', lambda: run_selftest('cuda'))
        say(f'  {N_SELFTEST} x 64 -> 32 -> 10 with rt.input at SecInt(14): '
            'predictions equal the plaintext forward pass')

    with Phase('wide product'):
        drive('wide product', lambda: run_wide('cuda'))
        say(f'  {N_WIDE} x {N_WIDE} SecInt(64) values input (28-byte draws) '
            'and multiplied on the 96-bit field: every output correct')
        torch.cuda.empty_cache()

    with Phase('cnn'):
        res_cnn = res = drive('cnn', lambda: run_cnn('cuda', profile=True))
        cold_c = res['pass_s'][0]
        warm_c, warm_c_lo, warm_c_hi = warm_stats(res['pass_s'])
        say(f'  MNIST images 0-{N_CNN - 1}, conv 5x5x32, maxpool, conv '
            f'5x5x64, maxpool, fc 3136x1024, fc 1024x10, SecInt(37), m = '
            f'{M}: all {N_CNN} predictions equal the plaintext model; '
            f'{res["correct"]}/{N_CNN} correct against the labels, '
            f'{res["floats"]}/{N_CNN} equal to the float model')
        for name, (lo, hi) in res['stats'].items():
            say(f'  plaintext model, {name}: outputs in [{lo}, {hi}]')
        say(f'  weights loaded and encoded in {res["setup_s"]:.3f} s; pass '
            f'cold {cold_c:.4f} s, warm median {warm_c:.4f} s of {WARM} '
            f'(least {warm_c_lo:.4f}, largest {warm_c_hi:.4f}): '
            f'{N_CNN / warm_c:.6g} images/s on {smi}')
        say(f'  K5 per pass: {res["k5_launches"]} launches for '
            f'{CNN_COMPARISONS} comparisons in {res["chunks"]} chunks of '
            f'{SimRuntime._SGN_CHUNK_WIDE}')
        for what, r in res['encode_s'].items():
            say(f'  {what} encoded on the host in {r["int64"]:.4f} s as '
                f'int64 values, {r["general"]:.4f} s by the general path '
                'of Python ints')
        for name, r in res['layers'].items():
            say(f'  {name} in a marked pass: {r["ms"]:.4f} ms device time '
                f'between the barriers, peak {r["peak_gib"]:.3f} GiB '
                'allocated')
        check(res['k5_launches'] == CNN_COMPARISONS < res['chunks'],
              'cnn: K5 launched other than once per comparison')
        cnn_layers = cnn_components()
        for r in cnn_layers:
            say(f'  {r["layer"]} ({r["reps"]} x {r["M"]} x {r["K"]} @ '
                f'{r["K"]} x {r["N"]}): planes + GEMM '
                f'{r["planes_gemm_ms"]:.4f} ms (bound '
                f'{r["matmul_bound_ms"]:.4f} ms, {r["matmul_bound_by"]}), '
                f'carry and fold {r["fold_ms"]:.4f} ms, K3 '
                f'{r["k3_ms"]:.4f} ms, K5 {r["k5_ms"]:.4f} ms')
        say('  torch.profiler over one warm pass:')
        for line in res['trace']:
            say(f'    {line}')
        torch.cuda.empty_cache()

    with Phase('cnn selftest'):
        drive('cnn selftest', lambda: run_cnn_selftest('cuda'))
        say(f'  {N_CNN_SELFTEST} random 8 x 8 images through a random CNN '
            'with rt.input at SecInt(37): predictions equal the plaintext '
            'model')

    with Phase('fxp kernels'):
        fxp_meas = check_fxp_kernels()
        for name, r in fxp_meas.items():
            say(f'  {name} [{r["shape"]}]: {r["ms"]:.4f} ms, plain '
                f'{r["plain_ms"]:.3f} ms, bound {r["bound_ms"]:.4f} ms '
                f'({r["bound_by"]}) on {smi}')
        # an instantiation a path of phase 3 measured keeps that path's
        # shape (K6 at three limbs: the ID3 trees' 30 Legendre symbols,
        # not the 2^22 elements here)
        meas.update({k: v for k, v in fxp_meas.items() if k not in meas})
        split = random_bits_split()
        say(f'  one round of np_random_bits\' {FXP_BITS} bits, device ms '
            f'(least of 3): PRSS draw of r {split["r"]:.4f}, zero-sharing z '
            f'{split["z"]:.4f}, tail: K7 {split["tail"]:.4f} (plain, the '
            f'tail before K7: {split["tail_plain"]:.4f}), on {smi}')
        res = run_fxp_rounds('cuda')
        say(f'  np_random_bits of {FXP_BITS} bits at SecFxp({FXP_L}, '
            f'{FXP_F}) (conv1\'s truncations): {res["bits_ms"]:.4f} ms on the '
            f'device, {res["bits_s"]:.4f} s on the host clock; every opened '
            f'bit 0 or 1, {res["ones"]:.6f} of them 1 (expected 0.5), on '
            f'{smi}')
        say(f'  np_trunc of {FXP_CONV1} values (conv1\'s products): '
            f'{res["trunc_ms"]:.4f} ms on the device, {res["trunc_s"]:.4f} s '
            f'on the host clock; every opened value floor(x / 2^{FXP_F}) or '
            f'one more, {res["up"]:.6f} of them one more (expected '
            f'{res["up_want"]:.6f}), on {smi}')
        res_fxp_rounds = res
        torch.cuda.empty_cache()

    with Phase('cnn fxp'):
        res_fxp = res = drive('cnn fxp',
                              lambda: run_cnn_fxp('cuda', profile=True))
        runs = res['runs']
        cold_f = runs[0]['s']
        warm_f, warm_f_lo, warm_f_hi = warm_stats([r['s'] for r in runs])
        say(f'  MNIST images 0-{N_FXP - 1}, the CNN at SecFxp({FXP_L}, '
            f'{FXP_F}), m = {M}: every layer of all {len(runs) + 1} passes '
            'passes the stage-local check')
        for i, r in enumerate(runs):
            say(f'  pass {i} ({"cold" if i == 0 else "warm"}): {r["s"]:.4f} '
                f's, {r["correct"]}/{N_FXP} correct against the labels, '
                f'{r["floats"]}/{N_FXP} equal to the float model (differ on '
                f'images {r["differ"]}); K5 {r["k5"]} launches, K6 '
                f'{r["k6"]}, K7 {r["k7"]}')
        for name, c in res['checks'].items():
            up = f', {c["up"]} rounded up' if 'up' in c else ''
            say(f'  {name} (last pass): {c["n"]} elements pass the '
                f'stage-local check{up}')
        for name, r in res['ranges'].items():
            say(f'  {name} outputs (last pass) in [{r["lo"]}, {r["hi"]}] at '
                f'2^{FXP_F}: {"within" if r["fits"] else "BEYOND"} the '
                f'comparison\'s {FXP_L} bits')
            check(r['fits'], f'cnn fxp: {name} outputs beyond the '
                  'comparison\'s width')
        say(f'  weights loaded and encoded in {res["setup_s"]:.3f} s; pass '
            f'cold {cold_f:.4f} s, warm median {warm_f:.4f} s of {WARM} '
            f'(least {warm_f_lo:.4f}, largest {warm_f_hi:.4f}): '
            f'{N_FXP / warm_f:.6g} images/s on {smi}')
        for name, r in res['layers'].items():
            say(f'  {name} in a marked pass: {r["ms"]:.4f} ms device time '
                f'between the barriers, peak {r["peak_gib"]:.3f} GiB '
                'allocated')
        say(f'  torch.profiler over one warm pass on {smi}:')
        for line in res['trace']:
            say(f'    {line}')
        torch.cuda.empty_cache()

    with Phase('parties'):
        res_parties = {}
        for t_, m_ in PARTIES_MAIN:
            res = drive(f'main path ({t_}, {m_})',
                        lambda: run_main_path('cuda', m=m_, t=t_))
            ms = sorted(res['per_call_ms'])
            med_p = ms[len(ms) // 2]
            res_parties[f'np_multiply ({t_}, {m_})'] = med_p
            say(f'  ({t_}, {m_}): np_multiply of {N_BIG} elements, every '
                f'sampled output correct: median {med_p:.4f} ms (calls: '
                f'{", ".join(f"{x:.4f}" for x in res["per_call_ms"])}), '
                f'{N_BIG / (med_p / 1e3):.6g} multiplications/s on {smi}; '
                f'(1, 3): {med:.4f} ms')
            torch.cuda.empty_cache()
        for t_, m_ in PARTIES_CMP:
            res = drive(f'comparison ({t_}, {m_})',
                        lambda: run_compare('cuda', m=m_, t=t_))
            ms = sorted(res['per_call_ms'])
            med_p = ms[len(ms) // 2]
            res_parties[f'np_less ({t_}, {m_})'] = med_p
            say(f'  ({t_}, {m_}): all {N_CMP} outputs correct: '
                f'{", ".join(res["checked"])}; np_less median {med_p:.4f} ms'
                f' (calls: {", ".join(f"{x:.4f}" for x in res["per_call_ms"])}'
                f'), {N_CMP / (med_p / 1e3):.6g} comparisons/s on {smi}; '
                f'(1, 3): {med_cmp:.4f} ms')
            torch.cuda.empty_cache()
        t_, m_ = PARTIES_NET
        res = drive(f'split/recombine ({t_}, {m_})',
                    lambda: run_split_recombine('cuda', m=m_, t=t_))
        res_parties[f'split/recombine ({t_}, {m_})'] = res['ms_per_round']
        say(f'  ({t_}, {m_}): {SPLIT_ROUNDS} chained rounds of {N_SPLIT} '
            f'secrets, output equal to input: {res["ms_per_round"]:.4f} ms a '
            f'round on {smi}; (1, 3): {ms_round:.4f} ms')
        res = drive(f'bnn ({t_}, {m_})', lambda: run_bnn(
            'cuda', passes=1 + PARTIES_WARM, m=m_, t=t_))
        warm_p, lo_p, hi_p = warm_stats(res['pass_s'])
        res_parties[f'bnn ({t_}, {m_})'] = dict(
            cold_s=res['pass_s'][0], warm_s=warm_p, warm_range_s=[lo_p, hi_p],
            correct=res['correct'])
        say(f'  ({t_}, {m_}): BNN (np_bnnmnist -M {m_}) on MNIST images '
            f'0-{N_BNN - 1}: all {N_BNN} predictions equal the plaintext '
            f'model, {res["correct"]}/{N_BNN} correct; pass cold '
            f'{res["pass_s"][0]:.4f} s, warm median {warm_p:.4f} s of '
            f'{PARTIES_WARM} (least {lo_p:.4f}, largest {hi_p:.4f}): '
            f'{N_BNN / warm_p:.6g} images/s on {smi}; (1, 3): {warm:.4f} s, '
            f'{N_BNN / warm:.6g} images/s')
        torch.cuda.empty_cache()
        res = drive(f'cnn fxp ({t_}, {m_})', lambda: run_cnn_fxp(
            'cuda', passes=1 + PARTIES_WARM, m=m_, t=t_))
        runs = res['runs']
        warm_p, lo_p, hi_p = warm_stats([r['s'] for r in runs])
        res_parties[f'cnn fxp ({t_}, {m_})'] = dict(
            cold_s=runs[0]['s'], warm_s=warm_p, warm_range_s=[lo_p, hi_p],
            passes=runs)
        say(f'  ({t_}, {m_}): fixed-point CNN (np_cnnmnist --fxp -M {m_}) '
            f'on MNIST images 0-{N_FXP - 1}: every layer of all '
            f'{len(runs) + 1} passes passes the stage-local check; pass cold '
            f'{runs[0]["s"]:.4f} s, warm median {warm_p:.4f} s of '
            f'{PARTIES_WARM} (least {lo_p:.4f}, largest {hi_p:.4f}): '
            f'{N_FXP / warm_p:.6g} images/s, K5 {runs[-1]["k5"]}, K7 '
            f'{runs[-1]["k7"]} launches a pass, {runs[-1]["correct"]}/'
            f'{N_FXP} correct, on {smi}; (1, 3): {warm_f:.4f} s, '
            f'{N_FXP / warm_f:.6g} images/s')
        for name, r in res['layers'].items():
            say(f'  ({t_}, {m_}): {name} in a marked pass: {r["ms"]:.4f} ms '
                'device time between the barriers')
        t_s = time.perf_counter()
        (t_, m_), k_ = LP_KB2_PARTIES
        res = drive(f'lp kb2 ({t_}, {m_})', lambda: run_lp(
            'cuda', datasets=(LP_KB2,), pivots={LP_KB2: k_}, m=m_,
            t=t_))['kb2']
        res_parties[f'lp kb2 ({t_}, {m_})'] = res
        say(f'  ({t_}, {m_}): kb2 (np_lpsolver -i 6 -M {m_} -T {t_}) at '
            f'SecInt(560), 19 limbs: stopped after {k_} pivots, its opened '
            f'tableau equal to the plain exact solver\'s; {res["s"]:.4f} s, '
            f'{res["s_pivot"]:.4f} s a pivot on {smi}; launches a pivot: '
            f'{per_pivot(res)}')
        rt_w = SimRuntime(m_, device='cuda', threshold=t_)
        res = drive(f'linear algebra ({t_}, {m_})', lambda: {
            **run_ridge(rt_w, datasets=()), **run_mlat(rt_w, N_MLAT_PARTIES)})
        res_parties[f'linear algebra ({t_}, {m_})'] = res
        say(f'  ({t_}, {m_}): ridge regression\'s synthetic set and '
            f'{N_MLAT_PARTIES} multilateration measurements, each checked; '
            f'seconds on {smi}:')
        for name, v in res.items():
            say(f'    {name}: {v:.4f}')
        say(f'  the wide paths at ({t_}, {m_}) in '
            f'{time.perf_counter() - t_s:.3f} s')
        torch.cuda.empty_cache()
        for name, pr in PR_MS.items():
            r = meas[name]
            say(f'  (1, 3) {name} [{r["shape"]}]: {r["ms"]:.4f} ms on this '
                f'tree, {pr:.4f} ms in PERF.md ({r["ms"] / pr:.3f}x) on '
                f'{smi}')
        torch.cuda.empty_cache()

    with Phase('lp'):
        res_lp = res = drive('lp', lambda: run_lp('cuda',
                                                  profiles=LP_PROFILES))
        traces = res.pop('traces')
        for name, r in res.items():
            if r.get('stopped'):
                say(f'  {name}: stopped after {r["pivots"]} of {r["of"]} '
                    'pivots (a cut for time), its opened tableau and '
                    f'denominator ({r["cd"]}) equal to the plain exact '
                    f'solver\'s after as many; {r["s"]:.4f} s, '
                    f'{r["s_pivot"]:.4f} s a pivot on {smi}')
                say(f'    launches a pivot: {per_pivot(r)}')
                continue
            say(f'  {name}: {r["pivots"]} pivots, max = {r["mx"]} / '
                f'{r["cd"]} / scale = {r["value"]!r}, equal to the plain '
                f'exact solver, certificate true; {r["s"]:.4f} s a solve, '
                f'{r["s_pivot"]:.4f} s a pivot on {smi}')
            say(f'    launches a solve: {r["launches"]}')
        for (_, window), (name, (s_w, lines)) in zip(LP_PROFILES,
                                                     traces.items()):
            first, last = window[0], window[1] - 1
            pivots = f'pivot {first}' if first == last else \
                f'pivots {first}-{last}'
            say(f'  torch.profiler over {pivots} of {name} ({s_w:.4f} s on '
                f'the host clock, traced) on {smi}:')
            for line in lines:
                say(f'    {line}')
        torch.cuda.empty_cache()

    with Phase('lp fxp'):
        res_lpf = res = drive('lp fxp', lambda: run_lp_fxp(
            'cuda', profile=LPFXP_PROFILE))
        for name, r in res.items():
            if not isinstance(r, dict):
                continue
            pivot_launches = {k: round(v / max(r['pivots'], 1), 1)
                              for k, v in r['launches'].items()}
            if r.get('stopped'):
                say(f'  {name} at SecFxp({r["l"]}): stopped after '
                    f'{r["pivots"]} pivots (a cut for time), its tableau '
                    f'within {r["solution_err"]:.3g} of its basis\'s in '
                    f'float64 (tolerance {r["tol"]:.3g}; objective '
                    f'{r["mx"]!r}); {r["s"]:.4f} s, {r["s_pivot"]:.4f} s '
                    f'a pivot on {smi}')
                say(f'    launches a pivot: {pivot_launches}')
                continue
            say(f'  {name} at SecFxp({r["l"]}): {r["pivots"]} pivots (the '
                f'float solver {r["plain_pivots"]}), max = {r["mx"]!r} '
                '(relative error '
                f'{r["rel_error"]:.3e}), certificate true, solution within '
                f'{r["solution_err"]:.3g} of the float solver\'s (tolerance '
                f'{r["tol"]:.3g}); {r["s"]:.4f} s a solve, '
                f'{r["s_pivot"]:.4f} s a pivot on {smi}')
            say(f'    launches a pivot: {pivot_launches}')
        say(f'  torch.profiler over pivot {LPFXP_WINDOW[0]} of dataset '
            f'{LPFXP_PROFILE} ({res["window_s"]:.4f} s on the host clock, '
            f'traced) on {smi}:')
        for line in res['trace']:
            say(f'    {line}')
        torch.cuda.empty_cache()

    with Phase('km'):
        res_km = res = drive('km', lambda: run_km('cuda'))
        for label, r in res.items():
            agg = '' if r['chi_agg'] is None else \
                f', aggregated {r["chi_agg"]:.6f}'
            say(f'  {label}: chi2 = {r["chi"]:.6f}{agg}, plain '
                f'{r["chi_ref"]:.6f}, within 1e-3; {r["maxT"]} time steps; '
                f'{r["s"]:.4f} s on {smi}')
            say(f'    launches: {r["launches"]}')
        torch.cuda.empty_cache()

    with Phase('gf2 kernels'):
        gf2_meas = check_gf2_kernels()
        floor_ms = empty_ms()
        for name, r in gf2_meas.items():
            say(f'  {name} [{r["shape"]}]: {r["ms"]:.4f} ms device time '
                f'(a call {r["call_ms"]:.4f} ms by CUDA events), plain '
                f'{r["plain_ms"]:.3f} ms, bound {r["bound_ms"]:.4f} ms '
                f'({r["bound_by"]}), {r["ms"] / r["bound_ms"]:.2f}x the bound '
                f'on {smi}')
        say(f'  launch floor (an empty kernel, replayed): {floor_ms:.4f} ms '
            f'on {smi}')
        meas.update(gf2_meas)
        torch.cuda.empty_cache()

    with Phase('sha3'):
        res_sha3 = res = drive('sha3', lambda: run_sha3('cuda', profile=True))
        cold_h = res['pass_s'][0]
        warm_h, warm_h_lo, warm_h_hi = warm_stats(res['pass_s'])
        say(f'  SHA3-256 of {N_SHA3} messages, SecFld(2) in GF(4), m = {M}: '
            f'all {N_SHA3} digests equal hashlib\'s (digest[0] of SHAKE128 '
            f'{res["digest0"]}); SHAKE128 (256 bits) too')
        say(f'  SHA3-256 batch cold {cold_h:.4f} s ({1e3 * cold_h / N_SHA3:.4f}'
            f' ms a digest), warm median {warm_h:.4f} s of {WARM} (least '
            f'{warm_h_lo:.4f}, largest {warm_h_hi:.4f}): '
            f'{1e3 * warm_h / N_SHA3:.4f} ms a digest; SHAKE128 '
            f'{res["shake_s"]:.4f} s; K8 {res["k8"]} launches a batch, K1 '
            f'{res["k1"]}, on {smi}')
        say('  torch.profiler over one warm SHA3-256 batch:')
        for line in res['trace']:
            say(f'    {line}')
        torch.cuda.empty_cache()

    with Phase('aes'):
        res_aes = res = drive('aes', lambda: run_aes('cuda', profile=True))
        for i, r in enumerate(res['runs']):
            say(f'  pass {i} ({"cold" if i == 0 else "warm"}), {N_AES} blocks:'
                f' AES-128 {r["aes128_s"]:.4f} s ({1e3 * r["aes128_s"] / N_AES:.4f}'
                f' ms a block), decrypt {r["aes128_dec_s"]:.4f} s; AES-256 '
                f'{r["aes256_s"]:.4f} s ({1e3 * r["aes256_s"] / N_AES:.4f} ms a '
                f'block), decrypt {r["aes256_dec_s"]:.4f} s; K8 {r["k8"]} '
                f'launches, K1 {r["k1"]}, on {smi}')
        say(f'  FIPS-197 C.1 {res["runs"][0]["aes128_ct0"]} and C.3 '
            f'{res["runs"][0]["aes256_ct0"]} on block 0, all {N_AES} blocks '
            'decrypt back, AES-128 and AES-256, every pass')
        say('  torch.profiler over one AES-128 encryption:')
        for line in res['trace']:
            say(f'    {line}')
        cm = clmul_meas('cuda')
        say(f'  the plain carry-less products of one AES-128 encryption of '
            f'{N_AES} blocks: {cm["calls"]} calls, {cm["products"]} '
            f'products, {cm["ops"]} logic ops and {cm["bytes"]} bytes at '
            f'their fewest: bound {cm["bound_ms"]:.4f} ms ({cm["bound_by"]}); '
            f'{cm["ms"]:.4f} ms device time, the calls replayed from a CUDA '
            f'graph, on {smi}')
        torch.cuda.empty_cache()

    with Phase('id3'):
        res_id3 = res = drive('id3', lambda: run_id3('cuda',
                                                     profile=ID3_PROFILE))
        for name, r in res.items():
            if not isinstance(r, dict):
                continue
            say(f'  {name} at SecInt({r["l"]}) ({r["L"]} limbs): a tree of '
                f'depth {r["depth"]} and size {r["size"]}, equal to the plain '
                f'tree; {r["s"]:.4f} s a tree, {r["nodes"]} nodes, '
                f'{r["s_node"]:.4f} s a node on {smi}')
            say(f'    launches a node: {r["launches"]}')
        say(f'  torch.profiler over the root node of dataset {ID3_PROFILE} '
            f'({res["window_s"]:.4f} s on the host clock, traced) on {smi}:')
        for line in res['trace']:
            say(f'    {line}')
        torch.cuda.empty_cache()

    with Phase('sort'):
        res_sort = res = drive('sort', lambda: run_sort('cuda',
                                                        profile=True))
        say(f'  np_sort of {N_SORT} SecInt(32) values, equal to numpy\'s: '
            f'{res["sort_s"]:.4f} s a sort, {res["stages"]} Batcher stages, '
            f'{res["ms_stage"]:.4f} ms a stage on {smi}')
        say(f'  np_amax and np_amin of {N_SORT}, equal to numpy\'s: '
            f'{res["amax_amin_s"]:.4f} s on {smi}')
        say(f'  sorted by a**2 of {N_SORTED} values shuffled by '
            f'random.shuffle, equal to Python\'s sorted: '
            f'{res["sorted_s"]:.4f} s on {smi}')
        say(f'  torch.profiler over one np_sort of {N_SORT} on {smi}:')
        for line in res.pop('trace'):
            say(f'    {line}')
        torch.cuda.empty_cache()

    with Phase('hash chains'):
        res_hc = res = drive('hash chains', lambda: run_hash_chains('cuda'))
        for label, r in res.items():
            say(f'  {label}: {r["hashes"]} hashes (k 2^(k-1)), peak '
                f'{r["peak"]} in a round, every value equal to the plain '
                f'chain\'s; {r["s"]:.4f} s, {r["s_hash"]:.4f} s a hash on '
                f'{smi}')
            say(f'    launches: {r["launches"]}')
        torch.cuda.empty_cache()

    with Phase('co-located demos'):
        res_co = res = drive('co-located demos',
                             lambda: run_colocated('cuda', profile=True))
        say(f'  every runner and size checked against Python; seconds a '
            f'call on {smi}:')
        trace = res.pop('trace')
        for name, v in res.items():
            if name == 'prefix_or':
                say(f'    PrefixOrExplained (name, depth, work): {v}')
            else:
                say(f'    {name}: {v:.4f} s')
        say(f'  torch.profiler over one write into the secure list of '
            f'{N_SECLIST} at a secret index on {smi}:')
        for line in trace:
            say(f'    {line}')
        torch.cuda.empty_cache()

    with Phase('linear algebra'):
        res_la = drive('linear algebra', lambda: run_linalg('cuda'))
        say(f'  every runner and solve checked; seconds on {smi}:')
        for name, v in res_la.items():
            say(f'    {name}: {v:.4f}')
        torch.cuda.empty_cache()

    with Phase('wide comparison'):
        t_, m_ = WIDE_CMP_PARTIES[2:]
        res_wc = drive('wide comparison', lambda: run_wide_compare('cuda'))
        res_wc.update(drive(f'wide comparison ({t_}, {m_})',
                            lambda: run_wide_compare(
                                'cuda', cases=(WIDE_CMP_PARTIES[:2],),
                                m=m_, t=t_)))
        for name, ms in res_wc.items():
            med_w = sorted(ms)[len(ms) // 2]
            n_w = int(name.split(' of ')[1].split(' ')[0])
            say(f'  {name}: every output equal to Python\'s; median '
                f'{med_w:.4f} ms of {len(ms)} calls ('
                f'{", ".join(f"{x:.4f}" for x in ms)}), '
                f'{n_w / (med_w / 1e3):.6g} comparisons/s on {smi}')
        torch.cuda.empty_cache()

    with Phase('k1 shapes'):
        shapes = collections.Counter()
        for path, hist in k1_blocks.items():
            if hist:
                say(f'  K1 on the {path}: {sum(hist.values())} launches, by '
                    f'blocks {dict(sorted(hist.items()))}')
            shapes.update(hist)
        st, lane = keccak.ctr_state(bytes(range(40)))
        st = keccak.state_tensor(st, 'cuda')
        for nb, c in sorted(shapes.items()):
            r = k1_bound(nb)
            ms_nb = graph_ms(lambda: keccak.keccak_ctr(st, nb, lane), 20)
            say(f'  K1 at {k1_shape(nb)} ({c} launches over the paths): '
                f'{ms_nb:.4f} ms device time, bound {r["bound_ms"]:.4f} ms '
                f'({r["bound_by"]}), {ms_nb / r["bound_ms"]:.2f}x; launch '
                f'floor {floor_ms:.4f} ms, on {smi}')

    say(f'  launches over the paths: {launches}')
    kernels = []
    for entry, (name, key) in ENTRIES.items():
        k, r = KERNELS[name], meas[entry]
        kernels.append(dict(
            name=entry, route='cuda', source=entry_source(name, key),
            replaces=k['replaces'], launches=launches[entry],
            max_abs_err=r['max_abs_err'], ms=r['ms'],
            plain_ms=r['plain_ms'], bound_ms=r['bound_ms'],
            bound_by=r['bound_by'], library_ms=None))
    say(json.dumps({'kernels': kernels}))
    say(json.dumps({'np_multiply_median_ms': med, 'elements': N_BIG,
                    'mul_per_s': N_BIG / (med / 1e3),
                    'np_less_median_ms': med_cmp, 'cmp_elements': N_CMP,
                    'cmp_per_s': N_CMP / (med_cmp / 1e3),
                    'split_recombine_ms_per_round': ms_round,
                    'split_elements': N_SPLIT,
                    'bnn_images': N_BNN, 'bnn_correct': res_bnn['correct'],
                    'bnn_cold_s': cold, 'bnn_warm_s': warm,
                    'bnn_warm_range_s': [warm_lo, warm_hi],
                    'bnn_images_per_s': N_BNN / warm, 'bnn_layers': layers,
                    'cnn_images': N_CNN, 'cnn_correct': res_cnn['correct'],
                    'cnn_equal_to_float': res_cnn['floats'],
                    'cnn_cold_s': cold_c, 'cnn_warm_s': warm_c,
                    'cnn_warm_range_s': [warm_c_lo, warm_c_hi],
                    'cnn_images_per_s': N_CNN / warm_c,
                    'cnn_k5_launches': res_cnn['k5_launches'],
                    'cnn_chunks': res_cnn['chunks'],
                    'cnn_encode_s': res_cnn['encode_s'],
                    'cnn_marked_layers': res_cnn['layers'],
                    'cnn_layers': cnn_layers,
                    'fxp_images': N_FXP, 'fxp_cold_s': cold_f,
                    'fxp_warm_s': warm_f,
                    'fxp_warm_range_s': [warm_f_lo, warm_f_hi],
                    'fxp_images_per_s': N_FXP / warm_f,
                    'fxp_passes': res_fxp['runs'],
                    'fxp_ranges': res_fxp['ranges'],
                    'fxp_marked_layers': res_fxp['layers'],
                    'fxp_rounds': res_fxp_rounds, 'random_bits_split': split,
                    'lp': {k: v for k, v in res_lp.items()
                           if isinstance(v, dict)},
                    'lp_fxp': {k: v for k, v in res_lpf.items()
                               if isinstance(v, dict)},
                    'km': res_km,
                    'sha3_batch': N_SHA3, 'sha3_pass_s': res_sha3['pass_s'],
                    'sha3_ms_per_digest_warm': 1e3 * warm_h / N_SHA3,
                    'sha3_ms_per_digest_cold': 1e3 * cold_h / N_SHA3,
                    'shake128_s': res_sha3['shake_s'],
                    'sha3_k8_per_batch': res_sha3['k8'],
                    'aes_blocks': N_AES,
                    'aes_runs': [{k: v for k, v in r.items()}
                                 for r in res_aes['runs']],
                    'id3': {k: v for k, v in res_id3.items()
                            if isinstance(v, dict)},
                    'sort': res_sort, 'hash_chains': res_hc,
                    'colocated': res_co, 'linear_algebra': res_la,
                    'wide_comparison': res_wc,
                    'parties': res_parties,
                    'card': smi}))
    say(f'total {time.perf_counter() - t_all:.3f} s')
    say(smi)
    say(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': kind,
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
