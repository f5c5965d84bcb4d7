"""Demo: privacy-preserving multilateration by Schmidt's method, on the
port.

    python -m mpyc_tpu_torch.demos.multilateration [-i I [I ...]] [-a A]
        [-l L] [-k K] [--device cuda|cpu]

The co-located path of ``demos/multilateration.py`` (D. Moser, the
oblivious sensor network) on ``SimRuntime(3)``: five sensors secret-share
their earth-centred positions and the times of arrival of an aircraft's
signal (sensor i's values input by party i mod m); the aircraft's
position is the least-squares solution of Schmidt's (5 choose 3) = 10
linear equations, all formed by one batched secure matrix product, and
solved by ridge regression's blinded Bareiss ``linear_solve``, over
SecInt(200 + 45 A) (A = 3 decimal places: SecInt(335), a 367-bit field
of 12 limbs; on the card its products, reshares, reciprocal and draws run
the wide kernels, ``csrc/wide.cu``).

The sensors and measurements are read with ``csv`` from
``demos/data/mlat`` (sets 1 and 3 by default, 615 measurements; ``-k``
takes the first K). Each solve is checked exactly, (adj A) b and det A
against a plain integer solve of the same equations (Python ints from
the same scaled inputs), and the median location error at the reported
altitude against the JAX demo's 2,000 m; the runner exits 1 otherwise.
"""

from __future__ import annotations

import argparse
import ast
import csv
import itertools
import os
import sys
import time
from math import atan2, cos, degrees, dist, hypot, radians, sin, sqrt

import numpy as np
import torch

from mpyc_tpu_torch.demos.ridgeregression import linear_solve, plain_adj_det
from mpyc_tpu_torch.demos import parties

DATA = os.path.join(os.path.dirname(__file__), '..', '..', 'demos', 'data',
                    'mlat')
SPEED_OF_LIGHT = 299792458.0  # m/s
_WGS84_A = 6378137.0             # equatorial radius [m]
_WGS84_B = 6356752.31424518      # polar radius [m]
_ECC2 = 1 - (_WGS84_B / _WGS84_A) ** 2
_ECC2P = (_WGS84_A / _WGS84_B) ** 2 - 1
COMBOS = list(itertools.combinations(range(5), 3))


def wgs84_to_ecef(lat_deg, lon_deg, height):
    """Geodetic coordinates -> earth-centred earth-fixed XYZ [m]."""
    lat, lon = radians(lat_deg), radians(lon_deg)
    nv = _WGS84_A / sqrt(1 - _ECC2 * sin(lat) ** 2)
    rho = (nv + height) * cos(lat)
    return (rho * cos(lon), rho * sin(lon),
            (nv * (1 - _ECC2) + height) * sin(lat))


def ecef_to_wgs84(x, y, z):
    """ECEF XYZ [m] -> geodetic (lat, lon, height), by Bowring's closed
    form."""
    rho = hypot(x, y)
    beta = atan2(z * _WGS84_A, rho * _WGS84_B)
    lat = atan2(z + _ECC2P * _WGS84_B * sin(beta) ** 3,
                rho - _ECC2 * _WGS84_A * cos(beta) ** 3)
    nv = _WGS84_A / sqrt(1 - _ECC2 * sin(lat) ** 2)
    return degrees(lat), degrees(atan2(y, x)), rho / cos(lat) - nv


def read_sensors():
    """serial -> (latitude, longitude, height)."""
    with open(os.path.join(DATA, 'sensors.csv'), newline='') as fh:
        return {int(r['serial']): (float(r['latitude']),
                                   float(r['longitude']), float(r['height']))
                for r in csv.DictReader(fh)}


def read_measurements(sets, k=0):
    """The rows of the given sets in order (the first k with k > 0):
    (measurements [(sensor, toa_ns, ...), ...], latitude, longitude,
    geoAltitude)."""
    rows = []
    for i in sets:
        with open(os.path.join(DATA, f'set_{i}.csv'), newline='') as fh:
            for r in csv.DictReader(fh):
                rows.append((ast.literal_eval(r['measurements']),
                             float(r['latitude']), float(r['longitude']),
                             float(r['geoAltitude'])))
    return rows[:k] if k else rows


def scaled_inputs(measurement, sensors, scale):
    """Each sensor's scaled ECEF position and its time of arrival as a
    scaled distance, rounded to integers."""
    pos, toas = [], []
    for sensor_id, toa_ns, *_ in measurement:
        lat, lon, h = sensors[sensor_id]
        pos.append([round(c * scale) for c in wgs84_to_ecef(lat, lon, h)])
        toas.append(round(toa_ns * (SPEED_OF_LIGHT / 1e9) * scale))
    return pos, toas


def _selections():
    """Per combination (i, j, k): the rows of Delta = [t_j - t_k, t_k -
    t_i, t_i - t_j] and of its sensors' picks."""
    C = len(COMBOS)
    sel = np.zeros((C, 3, 5), dtype=np.int64)
    pick = np.zeros((C, 3, 5), dtype=np.int64)
    for c, (i, j, k) in enumerate(COMBOS):
        sel[c, 0, j], sel[c, 0, k] = 1, -1
        sel[c, 1, k], sel[c, 1, i] = 1, -1
        sel[c, 2, i], sel[c, 2, j] = 1, -1
        pick[c, 0, i] = pick[c, 1, j] = pick[c, 2, k] = 1
    return sel, pick


def schmidt_equations(mpc, secint, P, T):
    """Schmidt's normal equations (A^T A, A^T b) from the secure (5, 3)
    positions P and (5,) times T: Delta (C, 3) = sel T, XYZN (C, 3, 4) =
    pick [P | |P|^2], r_c = Delta_c XYZN_c, one batched product for all C
    combinations; A = 2 r[:, :3], b = prod Delta_c + r[:, 3]."""
    sel, pick = _selections()
    C = len(COMBOS)
    N = mpc.np_sum(P * P, axis=1)
    Delta = mpc.np_matmul(secint.array(sel.astype(object)), T)
    PN = mpc.np_concatenate((P, mpc.np_transpose(mpc.np_reshape(N, (1, 5)))),
                            axis=1)
    XYZN = mpc.np_matmul(secint.array(pick.astype(object)), PN)
    R = mpc.np_reshape(mpc.np_matmul(mpc.np_reshape(Delta, (C, 1, 3)), XYZN),
                       (C, 4))
    A = mpc.np_getitem(R, (slice(None), slice(0, 3))) * 2
    b = mpc.np_prod(Delta, axis=1) + mpc.np_getitem(R, (slice(None), 3))
    AT = mpc.np_transpose(A)
    return (mpc.np_matmul(AT, A),
            mpc.np_matmul(AT, mpc.np_transpose(mpc.np_reshape(b, (1, C)))))


def plain_equations(pos, toas):
    """The same equations in Python ints: -> (A^T A, A^T b) lists."""
    A, b = [], []
    for i, j, k in COMBOS:
        d = [toas[j] - toas[k], toas[k] - toas[i], toas[i] - toas[j]]
        rows = [pos[i] + [sum(v * v for v in pos[i])],
                pos[j] + [sum(v * v for v in pos[j])],
                pos[k] + [sum(v * v for v in pos[k])]]
        r = [sum(d[q] * rows[q][c] for q in range(3)) for c in range(4)]
        A.append([2 * v for v in r[:3]])
        b.append(d[0] * d[1] * d[2] + r[3])
    ata = [[sum(A[c][i] * A[c][j] for c in range(len(A))) for j in range(3)]
           for i in range(3)]
    atb = [[sum(A[c][i] * b[c] for c in range(len(A)))] for i in range(3)]
    return ata, atb


def locate(mpc, secint, pos, toas):
    """One measurement: the sensors' inputs (sensor i by party i mod m),
    the equations and the blinded solve. -> ((adj A) b as 3 ints, det)."""
    m = len(mpc.parties)
    locations = [mpc.input([secint(c) for c in p], senders=i % m)
                 for i, p in enumerate(pos)]
    times = [mpc.input(secint(t), senders=i % m) for i, t in enumerate(toas)]
    P = mpc.np_reshape(mpc.np_fromlist([a for p in locations for a in p]),
                       (5, 3))
    T = mpc.np_fromlist(times)
    ata, atb = schmidt_equations(mpc, secint, P, T)
    adj_b, det = linear_solve(mpc, ata, atb)
    xyz = [int(v) for v in np.asarray(mpc.output(adj_b),
                                      dtype=object).reshape(-1)]
    return xyz, int(mpc.output(det))


def run(mpc, sets=('1', '3'), accuracy=3, bits=None, k=0,
        out=print) -> dict:
    """The JAX demo's run, every solve checked: -> {'ok', 'n', 'median',
    's_each', 'L', ...}."""
    sensors = read_sensors()
    rows = read_measurements(sets, k)
    bits = bits or 200 + accuracy * 45
    scale = 10 ** accuracy
    secint = mpc.SecInt(bits)
    out(f'Using secure {bits}-bit integers: {secint.__name__} ('
        f'{secint.field.array.ctx.L} limbs, scale factor {scale}); '
        f'{len(rows)} measurements from sets {"+".join(sets)}')
    sync = torch.cuda.synchronize if mpc.device.type == 'cuda' else \
        (lambda: None)
    errors, secs, exact = [], [], True
    for measurement, lat, lon, alt in rows:
        pos, toas = scaled_inputs(measurement, sensors, scale)
        sync()
        t0 = time.perf_counter()
        xyz, det = locate(mpc, secint, pos, toas)
        sync()
        secs.append(time.perf_counter() - t0)
        want_adj, want_det = plain_adj_det(*plain_equations(pos, toas))
        exact &= det == want_det and xyz == [row[0] for row in want_adj]
        est_lat, est_lon, _ = ecef_to_wgs84(*(c / det / scale for c in xyz))
        errors.append(dist(wgs84_to_ecef(est_lat, est_lon, alt),
                           wgs84_to_ecef(lat, lon, alt)))
    med = float(np.median(errors))
    out(f'location error [m]: median {med:.3f}, mean '
        f'{float(np.mean(errors)):.3f}, max {max(errors):.3f}; every solve '
        f'equal to the plain integer solve: {exact}; '
        f'{float(np.median(secs)):.4f} s a measurement (median)')
    return dict(ok=bool(exact and med < 2000), n=len(rows), median=med,
                s_each=secs, L=secint.field.array.ctx.L, bits=bits)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('-i', '--datasets', nargs='+', default=['1', '3'],
                        help='datasets (default 1 3)')
    parser.add_argument('-a', '--accuracy', type=int, default=3,
                        help='decimal places (default 3)')
    parser.add_argument('-l', '--bit-length', type=int, default=None,
                        help='bit length (default 200 + 45 A)')
    parser.add_argument('-k', '--rows', type=int, default=0,
                        help='the first K measurements (default: all)')
    parser.add_argument('--device', default='cuda',
                        help='device of the shares (default: the card)')
    args = parties.parse_args(parser, argv)
    mpc = parties.runtime(args)
    mpc.run(mpc.start())
    res = run(mpc, args.datasets, args.accuracy, args.bit_length, args.rows)
    mpc.run(mpc.shutdown())
    return 0 if res['ok'] else 1


if __name__ == '__main__':
    sys.exit(main())
