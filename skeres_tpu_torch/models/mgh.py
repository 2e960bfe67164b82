"""The More-Garbow-Hillstrom test-function registry (35 problems, 42 cases).

PyTorch counterpart of ``skeres_tpu/models/mgh.py`` (reference lineage:
``examples/more_garbow_hillstrom.cc``): every test function of More,
Garbow & Hillstrom, "Testing Unconstrained Optimization Software" (TOMS
1981), with the paper's starting point and certified minimum F*
(sum-of-squares convention; a solver's ``final_cost`` is F/2). Problems
with documented local minima reachable from the standard start carry every
acceptable certified value, as the reference's tables do.

Each residual takes one (n,) tensor and uses torch ops in its dtype and on
its device: the data tables are numpy float64 arrays, made a tensor of the
parameter's dtype and device at first use (``_Const``), and every
``arange`` takes the parameter's dtype and device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Sequence

import numpy as np
import torch

__all__ = ["MGHProblem", "PROBLEMS"]


@dataclasses.dataclass
class MGHProblem:
    number: int
    name: str
    residual: Callable  # p (n,) -> r (m,)
    x0: np.ndarray
    m: int
    # acceptable F* values (0.0 = certified zero minimum); a reached F is
    # certified if it matches ANY entry within (atol + rtol*F*), or is
    # below zero_atol for the 0.0 entry
    fstars: Sequence[float] = (0.0,)
    zero_atol: float = 2e-12
    rtol: float = 1e-4
    atol: float = 0.0
    max_iterations: int = 400
    expected_x: Optional[np.ndarray] = None
    x_atol: float = 1e-5

    def certified(self, f: float) -> bool:
        for fs in self.fstars:
            if fs == 0.0:
                if f <= self.zero_atol:
                    return True
            elif abs(f - fs) <= self.atol + self.rtol * fs:
                return True
        return False


class _Const:
    """A float64 numpy table, as a tensor of a parameter's dtype and device
    (made once for each)."""

    def __init__(self, a):
        self.a = np.asarray(a, dtype=np.float64)
        self._on = {}

    def __call__(self, p):
        key = (p.dtype, p.device)
        if key not in self._on:
            self._on[key] = torch.as_tensor(self.a, dtype=p.dtype, device=p.device)
        return self._on[key]


def _arange(start, end, p, step=1.0):
    return torch.arange(start, end, step, dtype=p.dtype, device=p.device)


PROBLEMS: dict[int, MGHProblem] = {}


def _reg(p: MGHProblem):
    PROBLEMS[p.number] = p


_reg(MGHProblem(
    1, "rosenbrock",
    lambda p: torch.stack([10.0 * (p[1] - p[0] ** 2), 1.0 - p[0]]),
    np.array([-1.2, 1.0]), 2, expected_x=np.array([1.0, 1.0]),
))

_reg(MGHProblem(
    2, "freudenstein_roth",
    lambda p: torch.stack([
        -13.0 + p[0] + ((5.0 - p[1]) * p[1] - 2.0) * p[1],
        -29.0 + p[0] + ((p[1] + 1.0) * p[1] - 14.0) * p[1],
    ]),
    np.array([0.5, -2.0]), 2,
    # local minimum F = 48.9842... reached by most descent methods
    fstars=(0.0, 48.98425), rtol=1e-4,
))

_reg(MGHProblem(
    3, "powell_badly_scaled",
    lambda p: torch.stack([
        1e4 * p[0] * p[1] - 1.0,
        torch.exp(-p[0]) + torch.exp(-p[1]) - 1.0001,
    ]),
    np.array([0.0, 1.0]), 2,
))

_reg(MGHProblem(
    4, "brown_badly_scaled",
    lambda p: torch.stack([p[0] - 1e6, p[1] - 2e-6, p[0] * p[1] - 2.0]),
    np.array([1.0, 1.0]), 3, zero_atol=2e-10,
    expected_x=np.array([1e6, 2e-6]), x_atol=1e-1,
))

_reg(MGHProblem(
    5, "beale",
    lambda p: torch.stack([
        1.5 - p[0] * (1.0 - p[1]),
        2.25 - p[0] * (1.0 - p[1] ** 2),
        2.625 - p[0] * (1.0 - p[1] ** 3),
    ]),
    np.array([1.0, 1.0]), 3, expected_x=np.array([3.0, 0.5]),
))


def _jennrich_sampson(p):
    i = _arange(1.0, 11.0, p)
    return 2.0 + 2.0 * i - (torch.exp(i * p[0]) + torch.exp(i * p[1]))


_reg(MGHProblem(
    6, "jennrich_sampson", _jennrich_sampson,
    np.array([0.3, 0.4]), 10, fstars=(124.362,),
))


def _helical(p):
    theta = torch.atan2(p[1], p[0]) / (2.0 * math.pi)
    return torch.stack([
        10.0 * (p[2] - 10.0 * theta),
        10.0 * (torch.sqrt(p[0] ** 2 + p[1] ** 2) - 1.0),
        p[2],
    ])


_reg(MGHProblem(
    7, "helical_valley", _helical, np.array([-1.0, 0.0, 0.0]), 3,
    expected_x=np.array([1.0, 0.0, 0.0]),
))

_Y8 = _Const([0.14, 0.18, 0.22, 0.25, 0.29, 0.32, 0.35, 0.39, 0.37,
              0.58, 0.73, 0.96, 1.34, 2.10, 4.39])
_U8 = _Const(np.arange(1.0, 16.0))
_V8 = _Const(16.0 - np.arange(1.0, 16.0))
_W8 = _Const(np.minimum(np.arange(1.0, 16.0), 16.0 - np.arange(1.0, 16.0)))
_reg(MGHProblem(
    8, "bard",
    lambda p: _Y8(p) - (p[0] + _U8(p) / (_V8(p) * p[1] + _W8(p) * p[2])),
    np.array([1.0, 1.0, 1.0]), 15,
    fstars=(8.21487e-3, 17.4286),  # second entry: documented local min
))

_Y9 = _Const([0.0009, 0.0044, 0.0175, 0.0540, 0.1295, 0.2420, 0.3521,
              0.3989, 0.3521, 0.2420, 0.1295, 0.0540, 0.0175, 0.0044,
              0.0009])
_T9 = _Const((8.0 - np.arange(1.0, 16.0)) / 2.0)
_reg(MGHProblem(
    9, "gaussian",
    lambda p: p[0] * torch.exp(-p[1] * (_T9(p) - p[2]) ** 2 / 2.0) - _Y9(p),
    np.array([0.4, 1.0, 0.0]), 15, fstars=(1.12793e-8,), rtol=1e-3,
))

_T10 = _Const(45.0 + 5.0 * np.arange(1.0, 17.0))
_Y10 = _Const([34780.0, 28610.0, 23650.0, 19630.0, 16370.0, 13720.0,
               11540.0, 9744.0, 8261.0, 7030.0, 6005.0, 5147.0, 4427.0,
               3820.0, 3307.0, 2872.0])
_reg(MGHProblem(
    10, "meyer",
    lambda p: p[0] * torch.exp(p[1] / (_T10(p) + p[2])) - _Y10(p),
    np.array([0.02, 4000.0, 250.0]), 16, fstars=(87.9458,), rtol=1e-5,
    max_iterations=800,
))

_t11 = np.arange(1.0, 100.0) / 100.0
_T11 = _Const(_t11)
_Y11 = _Const(25.0 + (-50.0 * np.log(_t11)) ** (2.0 / 3.0))
_reg(MGHProblem(
    11, "gulf",
    lambda p: torch.exp(-(torch.abs(_Y11(p) - p[1]) ** p[2]) / p[0]) - _T11(p),
    np.array([5.0, 2.5, 0.15]), 99, zero_atol=2e-10, max_iterations=800,
    expected_x=np.array([50.0, 25.0, 1.5]), x_atol=0.1,
))

_t12 = 0.1 * np.arange(1.0, 11.0)
_T12 = _Const(_t12)
_E12 = _Const(np.exp(-_t12) - np.exp(-10.0 * _t12))
_reg(MGHProblem(
    12, "box_3d",
    lambda p: (torch.exp(-_T12(p) * p[0]) - torch.exp(-_T12(p) * p[1]) - p[2] * _E12(p)),
    np.array([0.0, 10.0, 20.0]), 10,
))

_reg(MGHProblem(
    13, "powell_singular",
    lambda p: torch.stack([
        p[0] + 10.0 * p[1],
        math.sqrt(5.0) * (p[2] - p[3]),
        (p[1] - 2.0 * p[2]) ** 2,
        math.sqrt(10.0) * (p[0] - p[3]) ** 2,
    ]),
    np.array([3.0, -1.0, 0.0, 1.0]), 4,
    expected_x=np.zeros(4), x_atol=1e-2,
))

_reg(MGHProblem(
    14, "wood",
    lambda p: torch.stack([
        10.0 * (p[1] - p[0] ** 2),
        1.0 - p[0],
        math.sqrt(90.0) * (p[3] - p[2] ** 2),
        1.0 - p[2],
        math.sqrt(10.0) * (p[1] + p[3] - 2.0),
        (p[1] - p[3]) / math.sqrt(10.0),
    ]),
    np.array([-3.0, -1.0, -3.0, -1.0]), 6,
    fstars=(0.0, 15.753944), rtol=1e-3,  # local min: F = 2*7.876972
))

_Y15 = _Const([0.1957, 0.1947, 0.1735, 0.1600, 0.0844, 0.0627, 0.0456,
               0.0342, 0.0323, 0.0235, 0.0246])
_U15 = _Const([4.0, 2.0, 1.0, 0.5, 0.25, 0.167, 0.125, 0.1, 0.0833,
               0.0714, 0.0625])
_reg(MGHProblem(
    15, "kowalik_osborne",
    lambda p: _Y15(p) - p[0] * (_U15(p) ** 2 + _U15(p) * p[1])
    / (_U15(p) ** 2 + _U15(p) * p[2] + p[3]),
    np.array([0.25, 0.39, 0.415, 0.39]), 11,
    fstars=(3.07505e-4, 1.02734e-3),  # second: documented local min
))

_t16 = np.arange(1.0, 21.0) / 5.0
_T16, _EXP16, _SIN16, _COS16 = (_Const(a) for a in (_t16, np.exp(_t16), np.sin(_t16),
                                                    np.cos(_t16)))
_reg(MGHProblem(
    16, "brown_dennis",
    lambda p: ((p[0] + _T16(p) * p[1] - _EXP16(p)) ** 2
               + (p[2] + p[3] * _SIN16(p) - _COS16(p)) ** 2),
    np.array([25.0, 5.0, -5.0, -1.0]), 20, fstars=(85822.2,),
))

_Y17 = _Const([0.844, 0.908, 0.932, 0.936, 0.925, 0.908, 0.881, 0.850,
               0.818, 0.784, 0.751, 0.718, 0.685, 0.658, 0.628, 0.603,
               0.580, 0.558, 0.538, 0.522, 0.506, 0.490, 0.478, 0.467,
               0.457, 0.448, 0.438, 0.431, 0.424, 0.420, 0.414, 0.411,
               0.406])
_T17 = _Const(10.0 * np.arange(33.0))
_reg(MGHProblem(
    17, "osborne1",
    lambda p: _Y17(p) - (p[0] + p[1] * torch.exp(-_T17(p) * p[3])
                         + p[2] * torch.exp(-_T17(p) * p[4])),
    np.array([0.5, 1.5, -1.0, 0.01, 0.02]), 33, fstars=(5.46489e-5,),
))

_t18 = np.arange(1.0, 14.0) / 10.0
_T18 = _Const(_t18)
_Y18 = _Const(np.exp(-_t18) - 5.0 * np.exp(-10.0 * _t18) + 3.0 * np.exp(-4.0 * _t18))
_reg(MGHProblem(
    18, "biggs_exp6",
    lambda p: (p[2] * torch.exp(-_T18(p) * p[0]) - p[3] * torch.exp(-_T18(p) * p[1])
               + p[5] * torch.exp(-_T18(p) * p[4]) - _Y18(p)),
    np.array([1.0, 2.0, 1.0, 1.0, 1.0, 1.0]), 13,
    fstars=(0.0, 5.65565e-3), rtol=1e-3, max_iterations=600,
))

_Y19 = _Const([1.366, 1.191, 1.112, 1.013, 0.991, 0.885, 0.831, 0.847,
               0.786, 0.725, 0.746, 0.679, 0.608, 0.655, 0.616, 0.606,
               0.602, 0.626, 0.651, 0.724, 0.649, 0.649, 0.694, 0.644,
               0.624, 0.661, 0.612, 0.558, 0.533, 0.495, 0.500, 0.423,
               0.395, 0.375, 0.372, 0.391, 0.396, 0.405, 0.428, 0.429,
               0.523, 0.562, 0.607, 0.653, 0.672, 0.708, 0.633, 0.668,
               0.645, 0.632, 0.591, 0.559, 0.597, 0.625, 0.739, 0.710,
               0.729, 0.720, 0.636, 0.581, 0.428, 0.292, 0.162, 0.098,
               0.054])
_T19 = _Const(np.arange(65.0) / 10.0)


def _osborne2(p):
    t = _T19(p)
    return _Y19(p) - (p[0] * torch.exp(-t * p[4])
                      + p[1] * torch.exp(-((t - p[8]) ** 2) * p[5])
                      + p[2] * torch.exp(-((t - p[9]) ** 2) * p[6])
                      + p[3] * torch.exp(-((t - p[10]) ** 2) * p[7]))


_reg(MGHProblem(
    19, "osborne2", _osborne2,
    np.array([1.3, 0.65, 0.65, 0.7, 0.6, 3.0, 5.0, 7.0, 2.0, 4.5, 5.5]), 65,
    fstars=(4.01377e-2,),
))


def _watson(n):
    t = _Const(np.arange(1.0, 30.0) / 29.0)

    def r(p):
        powers = t(p)[:, None] ** _arange(0.0, n, p)
        s1 = powers[:, :-1] @ (_arange(1.0, n, p) * p[1:])
        s2 = powers @ p
        return torch.cat([
            s1 - s2 ** 2 - 1.0,
            torch.stack([p[0], p[1] - p[0] ** 2 - 1.0]),
        ])

    return r


for _n, _f, _num in ((6, 2.28767e-3, 201), (9, 1.39976e-6, 202),
                     (12, 4.72238e-10, 203)):
    _reg(MGHProblem(
        _num, f"watson_n{_n}", _watson(_n), np.zeros(_n), 31,
        fstars=(_f,), rtol=1e-3, atol=1e-12, max_iterations=800,
    ))


def _ext_rosenbrock(p):
    even = p[0::2]
    odd = p[1::2]
    return torch.cat([10.0 * (odd - even ** 2), 1.0 - even])


_reg(MGHProblem(
    21, "extended_rosenbrock", _ext_rosenbrock,
    np.tile([-1.2, 1.0], 5), 10, expected_x=np.ones(10),
))


def _ext_powell(p):
    a, b, c, d = p[0::4], p[1::4], p[2::4], p[3::4]
    return torch.cat([
        a + 10.0 * b,
        math.sqrt(5.0) * (c - d),
        (b - 2.0 * c) ** 2,
        math.sqrt(10.0) * (a - d) ** 2,
    ])


_reg(MGHProblem(
    22, "extended_powell_singular", _ext_powell,
    np.tile([3.0, -1.0, 0.0, 1.0], 3), 12,
))


def _penalty1(n):
    a = math.sqrt(1e-5)

    def r(p):
        return torch.cat([a * (p - 1.0), torch.sum(p ** 2)[None] - 0.25])

    return r


for _n, _f, _num in ((4, 2.24997e-5, 231), (10, 7.08765e-5, 232)):
    _reg(MGHProblem(
        _num, f"penalty1_n{_n}", _penalty1(_n),
        np.arange(1.0, _n + 1.0), _n + 1, fstars=(_f,),
        # the penalty structure forces thousands of tiny LM steps
        # (MINPACK needs the same order of work to certify n=10)
        max_iterations=20000,
    ))


def _penalty2(n):
    a = math.sqrt(1e-5)
    i = np.arange(2.0, n + 1.0)
    y = _Const(np.exp(i / 10.0) + np.exp((i - 1.0) / 10.0))
    w = _Const(np.arange(n, 0.0, -1.0))

    def r(p):
        return torch.cat([
            p[0:1] - 0.2,
            a * (torch.exp(p[1:] / 10.0) + torch.exp(p[:-1] / 10.0) - y(p)),
            a * (torch.exp(p[1:] / 10.0) - math.exp(-0.1)),
            torch.sum(w(p) * p ** 2)[None] - 1.0,
        ])

    return r


for _n, _f, _num in ((4, 9.37629e-6, 241), (10, 2.93660e-4, 242)):
    _reg(MGHProblem(
        _num, f"penalty2_n{_n}", _penalty2(_n), np.full(_n, 0.5), 2 * _n,
        fstars=(_f,), max_iterations=800,
    ))


def _variably_dimensioned(p):
    s = torch.sum(_arange(1.0, 11.0, p) * (p - 1.0))
    return torch.cat([p - 1.0, torch.stack([s, s ** 2])])


_reg(MGHProblem(
    25, "variably_dimensioned", _variably_dimensioned,
    1.0 - np.arange(1.0, 11.0) / 10.0, 12, expected_x=np.ones(10),
    x_atol=1e-6,
))

_reg(MGHProblem(
    26, "trigonometric",
    lambda p: (10.0 - torch.sum(torch.cos(p)) + _arange(1.0, 11.0, p) * (1.0 - torch.cos(p))
               - torch.sin(p)),
    np.full(10, 0.1), 10,
    # measured (and matching published MINPACK results): the standard 1/n
    # start lands in the documented small local minimum
    fstars=(0.0, 2.79506e-5), rtol=1e-3,
))

_reg(MGHProblem(
    27, "brown_almost_linear",
    lambda p: torch.cat([p[:-1] + torch.sum(p) - 11.0, torch.prod(p)[None] - 1.0]),
    np.full(10, 0.5), 10,
    fstars=(0.0, 1.0), rtol=1e-6,  # F = 1 documented local min
))

_H28 = 1.0 / 11.0
_t28 = _H28 * np.arange(1.0, 11.0)
_T28 = _Const(_t28)
_TRIL28 = _Const(np.tril(np.ones((10, 10))))


def _pad0(p):
    z = torch.zeros(1, dtype=p.dtype, device=p.device)
    return torch.cat([z, p, z])


def _dbv(p):
    pm = _pad0(p)
    return (2.0 * pm[1:-1] - pm[:-2] - pm[2:]
            + _H28 ** 2 * (pm[1:-1] + _T28(p) + 1.0) ** 3 / 2.0)


_reg(MGHProblem(
    28, "discrete_boundary_value", _dbv,
    _t28 * (_t28 - 1.0), 10, zero_atol=2e-18,
))


def _dint(p):
    t = _T28(p)
    cube = (p + t + 1.0) ** 3
    lower = _TRIL28(p) @ (t * cube)
    upper = _TRIL28(p) @ ((1.0 - t) * cube)
    total_u = torch.sum((1.0 - t) * cube)
    return p + _H28 * ((1.0 - t) * lower + t * (total_u - upper)) / 2.0


_reg(MGHProblem(
    29, "discrete_integral", _dint,
    _t28 * (_t28 - 1.0), 10, zero_atol=2e-20,
))


def _broyden_tri(p):
    pm = _pad0(p)
    return (3.0 - 2.0 * pm[1:-1]) * pm[1:-1] - pm[:-2] - 2.0 * pm[2:] + 1.0


_reg(MGHProblem(
    30, "broyden_tridiagonal", _broyden_tri, np.full(10, -1.0), 10,
    zero_atol=2e-20,
))


def _broyden_banded(p):
    n = 10
    out = []
    for i in range(n):
        lo = max(0, i - 5)
        s = sum(p[j] * (1.0 + p[j]) for j in range(lo, min(n, i + 2)) if j != i)
        out.append(p[i] * (2.0 + 5.0 * p[i] ** 2) + 1.0 - s)
    return torch.stack(out)


_reg(MGHProblem(
    31, "broyden_banded", _broyden_banded, np.full(10, -1.0), 10,
    zero_atol=2e-20,
))


def _linear_full_rank(p):
    n, m = 10, 20
    s = torch.sum(p)
    tail = (-2.0 * s / m - 1.0) * torch.ones(m - n, dtype=p.dtype, device=p.device)
    return torch.cat([p - 2.0 * s / m - 1.0, tail])


_reg(MGHProblem(
    32, "linear_full_rank", _linear_full_rank, np.ones(10), 20,
    fstars=(10.0,), rtol=1e-10,  # F* = m - n
    expected_x=-np.ones(10), x_atol=1e-8,
))

_reg(MGHProblem(
    33, "linear_rank1",
    lambda p: _arange(1.0, 21.0, p) * torch.sum(_arange(1.0, 11.0, p) * p) - 1.0,
    np.ones(10), 20,
    fstars=(20.0 * 19.0 / (2.0 * 41.0),), rtol=1e-10,  # m(m-1)/(2(2m+1))
))


def _linear_rank1_zero(p):
    minus1 = torch.full((1,), -1.0, dtype=p.dtype, device=p.device)
    return torch.cat([
        minus1,
        (_arange(2.0, 20.0, p) - 1.0) * torch.sum(_arange(2.0, 10.0, p) * p[1:-1]) - 1.0,
        minus1,
    ])


_reg(MGHProblem(
    34, "linear_rank1_zero_cols_rows", _linear_rank1_zero,
    np.ones(10), 20,
    fstars=((20.0 ** 2 + 3.0 * 20.0 - 6.0) / (2.0 * (2.0 * 20.0 - 3.0)),),
    rtol=1e-10,
))


def _chebyquad(n):
    k = np.arange(1, n + 1)
    integral = _Const(np.where(k % 2 == 1, 0.0, -1.0 / np.where(k == 1, 1.0, k ** 2 - 1.0)))

    def r(p):
        z = 2.0 * p - 1.0
        tprev = torch.ones_like(z)
        tcur = z
        rows = []
        for _ in range(n):
            rows.append(torch.mean(tcur))
            tprev, tcur = tcur, 2.0 * z * tcur - tprev
        return torch.stack(rows) - integral(p)

    return r


for _n, _f, _num in ((7, 0.0, 351), (8, 3.51687e-3, 352), (9, 0.0, 353),
                     (10, 6.50395e-3, 354)):
    _reg(MGHProblem(
        _num, f"chebyquad_n{_n}", _chebyquad(_n),
        np.arange(1.0, _n + 1.0) / (_n + 1.0), _n,
        fstars=(_f,) if _f else (0.0,), zero_atol=2e-16,
    ))
