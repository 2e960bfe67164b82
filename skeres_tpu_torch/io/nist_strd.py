"""NIST StRD nonlinear-regression problem registry (the 27-problem ladder).

PyTorch counterpart of ``skeres_tpu/io/nist_strd.py`` (reference lineage:
``examples/nist.cc``): every StRD nonlinear problem's model, both certified
starting points, and the certified parameters and residual sum of
squares, from the public NIST StRD pages (itl.nist.gov/div898/strd/nls).
The models are torch functions ``model(p, X)``; the data, the starts and
the certified values are the JAX package's, copied as they are (the port
imports nothing of it):

- 17 problems carry their data in this file; a fit reproducing the
  certified residual sum of squares to ~1e-6 checks each dataset.
- The Lanczos1/2/3 data is generated as NIST generated it:
  f(x) = 0.0951 e^-x + 0.8607 e^-3x + 1.5576 e^-5x on x = 0.00(0.05)1.15,
  rounded per dataset (``_lanczos_data``).
- The other 10 problems (Chwirut1/2, Gauss1/2/3, Hahn1, Kirby2, Nelson,
  ENSO, Bennett5) read their ``.dat`` files from ``data/nist/``
  (``load_dat``) and are skipped while it is absent.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

DATA_DIR = os.path.join(
    os.path.dirname(__file__), "..", "..", "data", "nist"
)


def _lanczos_data(decimals=None, sig_figs=None):
    """NIST's generated Lanczos data, regenerated exactly. Rounding
    conventions were determined EMPIRICALLY against the certified SSRs
    (each alternative is excluded by >10x SSR mismatch):

    - Lanczos3: 4 decimal places    -> certified SSR matched to 10 digits
    - Lanczos2: 6 significant figs  -> certified SSR matched to 10 digits
    - Lanczos1: 13 decimal places ("14 digits of accuracy"); the fit
      reaches the f64 noise floor (~1e-26), below the certified 1.43e-25
    """
    x = 0.05 * np.arange(24)
    y = (
        0.0951 * np.exp(-x)
        + 0.8607 * np.exp(-3.0 * x)
        + 1.5576 * np.exp(-5.0 * x)
    )
    if sig_figs is not None:
        mag = np.floor(np.log10(np.abs(y)))
        sc = 10.0 ** (sig_figs - 1 - mag)
        return x, np.round(y * sc) / sc
    return x, np.round(y, decimals)


def load_dat(path: str):
    """Parse a NIST StRD ``.dat`` file: returns (y, X) with X of shape
    (n, n_predictors). The data block is the numeric rows after the line
    beginning with ``Data:`` (column order in the files is response first,
    predictors after)."""
    rows: List[List[float]] = []
    in_data = False
    with open(path) as f:
        for line in f:
            s = line.strip()
            if not in_data:
                if s.lower().startswith("data:"):
                    in_data = True
                continue
            if not s:
                continue
            try:
                rows.append([float(tok) for tok in s.split()])
            except ValueError:
                continue
    arr = np.asarray(rows, dtype=np.float64)
    return arr[:, 0], arr[:, 1:]


@dataclass
class NISTProblem:
    name: str
    # model(p, X) with X (n, n_pred) -> predicted response (n,)
    model: Callable
    starts: Sequence[Sequence[float]]
    certified_params: Sequence[float]
    certified_ssr: float
    difficulty: str  # lower / average / higher (NIST's classification)
    y: Optional[np.ndarray] = None
    X: Optional[np.ndarray] = None  # (n, n_pred)
    data_file: Optional[str] = None
    # response transform applied to y before residuals (Nelson: log)
    log_response: bool = False

    def data(self):
        if self.y is not None:
            return self.y, self.X
        path = os.path.join(DATA_DIR, self.data_file)
        if not os.path.exists(path):
            return None
        return load_dat(path)


PROBLEMS: dict[str, NISTProblem] = {}


def _register(p: NISTProblem):
    PROBLEMS[p.name] = p


def _xy(x, y):
    return np.asarray(y, np.float64), np.asarray(x, np.float64).reshape(-1, 1)


# --------------------------------------------------------------------------
# Lower difficulty
# --------------------------------------------------------------------------

MISRA_X = [77.6, 114.9, 141.1, 190.8, 239.9, 289.0, 332.8, 378.4, 434.8,
           477.3, 536.8, 593.1, 689.1, 760.0]
MISRA_Y = [10.07, 14.73, 17.94, 23.93, 29.61, 35.18, 40.02, 44.82, 50.76,
           55.05, 61.01, 66.40, 75.47, 81.78]

_y, _X = _xy(MISRA_X, MISRA_Y)
_register(NISTProblem(
    "Misra1a",
    lambda p, X: p[0] * (1.0 - torch.exp(-p[1] * X[:, 0])),
    starts=[[500.0, 0.0001], [250.0, 0.0005]],
    certified_params=[2.3894212918e2, 5.5015643181e-4],
    certified_ssr=1.2455138894e-1,
    difficulty="lower", y=_y, X=_X,
))

_register(NISTProblem(
    "Chwirut1",
    lambda p, X: torch.exp(-p[0] * X[:, 0]) / (p[1] + p[2] * X[:, 0]),
    starts=[[0.1, 0.01, 0.02], [0.15, 0.008, 0.010]],
    certified_params=[1.9027818370e-1, 6.1314004477e-3, 1.0530908399e-2],
    certified_ssr=2.3844771393e3,
    difficulty="lower", data_file="Chwirut1.dat",
))

_register(NISTProblem(
    "Chwirut2",
    lambda p, X: torch.exp(-p[0] * X[:, 0]) / (p[1] + p[2] * X[:, 0]),
    starts=[[0.1, 0.01, 0.02], [0.15, 0.008, 0.010]],
    certified_params=[1.6657666537e-1, 5.1653291286e-3, 1.2150007096e-2],
    certified_ssr=5.1304802941e2,
    difficulty="lower", data_file="Chwirut2.dat",
))

_lx, _ly = _lanczos_data(4)
_register(NISTProblem(
    "Lanczos3",
    lambda p, X: (p[0] * torch.exp(-p[1] * X[:, 0])
                  + p[2] * torch.exp(-p[3] * X[:, 0])
                  + p[4] * torch.exp(-p[5] * X[:, 0])),
    starts=[[1.2, 0.3, 5.6, 5.5, 6.5, 7.6], [0.5, 0.7, 3.6, 4.2, 4.0, 6.3]],
    certified_params=[8.6816414977e-2, 9.5498101505e-1, 8.4400777463e-1,
                      2.9515951832, 1.5825685901, 4.9863565084],
    certified_ssr=1.6117193594e-8,
    difficulty="lower", y=_ly, X=_lx.reshape(-1, 1),
))

_gauss_model = lambda p, X: (
    p[0] * torch.exp(-p[1] * X[:, 0])
    + p[2] * torch.exp(-((X[:, 0] - p[3]) ** 2) / p[4] ** 2)
    + p[5] * torch.exp(-((X[:, 0] - p[6]) ** 2) / p[7] ** 2)
)

_register(NISTProblem(
    "Gauss1", _gauss_model,
    starts=[[97.0, 0.009, 100.0, 65.0, 20.0, 70.0, 178.0, 16.5],
            [94.0, 0.0105, 99.0, 63.0, 25.0, 71.0, 180.0, 20.0]],
    certified_params=[9.8778210871e1, 1.0497276517e-2, 1.0048990633e2,
                      6.7481111276e1, 2.3129773360e1, 7.1994503004e1,
                      1.7899805021e2, 1.8389389025e1],
    certified_ssr=1.3158222432e3,
    difficulty="lower", data_file="Gauss1.dat",
))

_register(NISTProblem(
    "Gauss2", _gauss_model,
    starts=[[96.0, 0.009, 103.0, 106.0, 18.0, 72.0, 151.0, 18.0],
            [98.0, 0.0105, 103.0, 105.0, 20.0, 73.0, 150.0, 20.0]],
    certified_params=[9.9018328406e1, 1.0994945399e-2, 1.0188022528e2,
                      1.0703095519e2, 2.3578584029e1, 7.2045589471e1,
                      1.5327010194e2, 1.9525972636e1],
    certified_ssr=1.2475282092e3,
    difficulty="lower", data_file="Gauss2.dat",
))

_register(NISTProblem(
    "DanWood",
    lambda p, X: p[0] * X[:, 0] ** p[1],
    starts=[[1.0, 5.0], [0.7, 4.0]],
    certified_params=[7.6886226176e-1, 3.8604055871],
    certified_ssr=4.3173084083e-3,
    difficulty="lower",
    y=np.array([2.138, 3.421, 3.597, 4.340, 4.882, 5.660]),
    X=np.array([1.309, 1.471, 1.490, 1.565, 1.611, 1.680]).reshape(-1, 1),
))

_register(NISTProblem(
    "Misra1b",
    lambda p, X: p[0] * (1.0 - (1.0 + p[1] * X[:, 0] / 2.0) ** (-2.0)),
    starts=[[500.0, 0.0001], [300.0, 0.0002]],
    certified_params=[3.3799746163e2, 3.9039091287e-4],
    certified_ssr=7.5464681533e-2,
    difficulty="lower", y=_y, X=_X,
))

# --------------------------------------------------------------------------
# Average difficulty
# --------------------------------------------------------------------------

_register(NISTProblem(
    "Kirby2",
    lambda p, X: ((p[0] + p[1] * X[:, 0] + p[2] * X[:, 0] ** 2)
                  / (1.0 + p[3] * X[:, 0] + p[4] * X[:, 0] ** 2)),
    starts=[[2.0, -0.1, 0.003, -0.001, 0.00001],
            [1.5, -0.15, 0.0025, -0.0015, 0.00002]],
    certified_params=[1.6745063063e0, -1.3927397867e-1, 2.5961181191e-3,
                      -1.7241811870e-3, 2.1664802578e-5],
    certified_ssr=3.9050739624e0,
    difficulty="average", data_file="Kirby2.dat",
))

_register(NISTProblem(
    "Hahn1",
    lambda p, X: ((p[0] + p[1] * X[:, 0] + p[2] * X[:, 0] ** 2
                   + p[3] * X[:, 0] ** 3)
                  / (1.0 + p[4] * X[:, 0] + p[5] * X[:, 0] ** 2
                     + p[6] * X[:, 0] ** 3)),
    starts=[[10.0, -1.0, 0.05, -0.00001, -0.05, 0.001, -0.000001],
            [1.0, -0.1, 0.005, -0.000001, -0.005, 0.0001, -0.0000001]],
    certified_params=[1.0776351733e0, -1.2269296921e-1, 4.0863750610e-3,
                      -1.4262662514e-6, -5.7609940901e-3, 2.4053735503e-4,
                      -1.2314450199e-7],
    certified_ssr=1.5324382854e0,
    difficulty="average", data_file="Hahn1.dat",
))

_register(NISTProblem(
    "Nelson",
    lambda p, X: p[0] - p[1] * X[:, 0] * torch.exp(-p[2] * X[:, 1]),
    starts=[[2.0, 0.0001, -0.01], [2.5, 0.000000005, -0.05]],
    certified_params=[2.5906836021e0, 5.6177717026e-9, -5.7701013174e-2],
    certified_ssr=3.7976833176e0,
    difficulty="average", data_file="Nelson.dat", log_response=True,
))

_register(NISTProblem(
    "MGH17",
    lambda p, X: (p[0] + p[1] * torch.exp(-X[:, 0] * p[3])
                  + p[2] * torch.exp(-X[:, 0] * p[4])),
    starts=[[50.0, 150.0, -100.0, 1.0, 2.0], [0.5, 1.5, -1.0, 0.01, 0.02]],
    certified_params=[3.7541005211e-1, 1.9358469127e0, -1.4646871366e0,
                      1.2867534640e-2, 2.2122699662e-2],
    certified_ssr=5.4648946975e-5,
    difficulty="average",
    y=np.array([0.844, 0.908, 0.932, 0.936, 0.925, 0.908, 0.881, 0.850,
                0.818, 0.784, 0.751, 0.718, 0.685, 0.658, 0.628, 0.603,
                0.580, 0.558, 0.538, 0.522, 0.506, 0.490, 0.478, 0.467,
                0.457, 0.448, 0.438, 0.431, 0.424, 0.420, 0.414, 0.411,
                0.406]),
    X=(10.0 * np.arange(33, dtype=np.float64)).reshape(-1, 1),
))

_lx1, _ly1 = _lanczos_data(decimals=13)
_register(NISTProblem(
    "Lanczos1",
    PROBLEMS["Lanczos3"].model,
    starts=PROBLEMS["Lanczos3"].starts,
    certified_params=[9.5100000027e-2, 1.0000000001e0, 8.6070000013e-1,
                      3.0000000002e0, 1.5575999998e0, 5.0000000001e0],
    certified_ssr=1.4307867721e-25,
    difficulty="average", y=_ly1, X=_lx1.reshape(-1, 1),
))

_lx2, _ly2 = _lanczos_data(sig_figs=6)
_register(NISTProblem(
    "Lanczos2",
    PROBLEMS["Lanczos3"].model,
    starts=PROBLEMS["Lanczos3"].starts,
    certified_params=[9.6251029939e-2, 1.0057332849e0, 8.6424689056e-1,
                      3.0078283915e0, 1.5529016879e0, 5.0028798100e0],
    certified_ssr=2.2299428125e-11,
    difficulty="average", y=_ly2, X=_lx2.reshape(-1, 1),
))

_register(NISTProblem(
    "Gauss3", _gauss_model,
    starts=[[94.9, 0.009, 90.1, 113.0, 20.0, 73.8, 140.0, 20.0],
            [96.0, 0.0096, 80.0, 110.0, 25.0, 74.0, 139.0, 25.0]],
    certified_params=[9.8940368970e1, 1.0945879335e-2, 1.0069553078e2,
                      1.1163619459e2, 2.3300500029e1, 7.3705031418e1,
                      1.4776164251e2, 1.9668221230e1],
    certified_ssr=1.2444846360e3,
    difficulty="average", data_file="Gauss3.dat",
))

_register(NISTProblem(
    "Misra1c",
    lambda p, X: p[0] * (1.0 - (1.0 + 2.0 * p[1] * X[:, 0]) ** (-0.5)),
    starts=[[500.0, 0.0001], [600.0, 0.0002]],
    certified_params=[6.3642725809e2, 2.0813627256e-4],
    certified_ssr=4.0966836971e-2,
    difficulty="average", y=_y, X=_X,
))

_register(NISTProblem(
    "Misra1d",
    lambda p, X: p[0] * p[1] * X[:, 0] / (1.0 + p[1] * X[:, 0]),
    starts=[[500.0, 0.0001], [450.0, 0.0003]],
    certified_params=[4.3736970754e2, 3.0227324449e-4],
    certified_ssr=5.6419295283e-2,
    difficulty="average", y=_y, X=_X,
))

_register(NISTProblem(
    "Roszman1",
    lambda p, X: (p[0] - p[1] * X[:, 0]
                  - torch.atan(p[2] / (X[:, 0] - p[3])) / math.pi),
    starts=[[0.1, -0.00001, 1000.0, -100.0], [0.2, -5e-6, 1200.0, -150.0]],
    certified_params=[2.0196866396e-1, -6.1953516256e-6, 1.2044556708e3,
                      -1.8134269537e2],
    certified_ssr=4.9484847331e-4,
    difficulty="average",
    y=np.array([0.252429, 0.252141, 0.251809, 0.297989, 0.296257, 0.295319,
                0.339603, 0.337731, 0.333820, 0.389510, 0.386998, 0.438864,
                0.434887, 0.427893, 0.471568, 0.461699, 0.461144, 0.513532,
                0.506641, 0.505062, 0.535648, 0.533726, 0.568064, 0.612886,
                0.624169]),
    X=np.array([-4868.68, -4868.09, -4867.41, -3375.19, -3373.14, -3372.03,
                -2473.74, -2472.35, -2469.45, -1894.65, -1893.40, -1497.24,
                -1495.85, -1493.41, -1208.68, -1206.18, -1206.04, -997.92,
                -996.61, -996.31, -834.94, -834.66, -710.03, -530.16,
                -464.17]).reshape(-1, 1),
))

_register(NISTProblem(
    "ENSO",
    lambda p, X: (p[0]
                  + p[1] * torch.cos(2 * math.pi * X[:, 0] / 12.0)
                  + p[2] * torch.sin(2 * math.pi * X[:, 0] / 12.0)
                  + p[4] * torch.cos(2 * math.pi * X[:, 0] / p[3])
                  + p[5] * torch.sin(2 * math.pi * X[:, 0] / p[3])
                  + p[7] * torch.cos(2 * math.pi * X[:, 0] / p[6])
                  + p[8] * torch.sin(2 * math.pi * X[:, 0] / p[6])),
    starts=[[11.0, 3.0, 0.5, 40.0, -0.7, -1.3, 25.0, -0.3, 1.4],
            [10.0, 3.0, 0.5, 44.0, -1.5, 0.5, 26.0, -0.1, 1.5]],
    certified_params=[1.0510749193e1, 3.0762128085e0, 5.3280138227e-1,
                      4.4311088700e1, -1.6231428586e0, 5.2554493756e-1,
                      2.6887614440e1, 2.1232288488e-1, 1.4966870418e0],
    certified_ssr=7.8853978668e2,
    difficulty="average", data_file="ENSO.dat",
))

# --------------------------------------------------------------------------
# Higher difficulty
# --------------------------------------------------------------------------

_register(NISTProblem(
    "MGH09",
    lambda p, X: (p[0] * (X[:, 0] ** 2 + X[:, 0] * p[1])
                  / (X[:, 0] ** 2 + X[:, 0] * p[2] + p[3])),
    starts=[[25.0, 39.0, 41.5, 39.0], [0.25, 0.39, 0.415, 0.39]],
    certified_params=[1.9280693458e-1, 1.9128232873e-1, 1.2305650693e-1,
                      1.3606233068e-1],
    certified_ssr=3.0750560385e-4,
    difficulty="higher",
    y=np.array([1.957e-1, 1.947e-1, 1.735e-1, 1.600e-1, 8.44e-2, 6.27e-2,
                4.56e-2, 3.42e-2, 3.23e-2, 2.35e-2, 2.46e-2]),
    X=np.array([4.0, 2.0, 1.0, 0.5, 0.25, 0.167, 0.125, 0.1, 0.0833,
                0.0714, 0.0625]).reshape(-1, 1),
))

_register(NISTProblem(
    "Thurber",
    lambda p, X: ((p[0] + p[1] * X[:, 0] + p[2] * X[:, 0] ** 2
                   + p[3] * X[:, 0] ** 3)
                  / (1.0 + p[4] * X[:, 0] + p[5] * X[:, 0] ** 2
                     + p[6] * X[:, 0] ** 3)),
    starts=[[1000.0, 1000.0, 400.0, 40.0, 0.7, 0.3, 0.03],
            [1300.0, 1500.0, 500.0, 75.0, 1.0, 0.4, 0.05]],
    certified_params=[1.2881396800e3, 1.4910792535e3, 5.8323836877e2,
                      7.5416644291e1, 9.6629502864e-1, 3.9797285797e-1,
                      4.9727297349e-2],
    certified_ssr=5.6427082397e3,
    difficulty="higher",
    y=np.array([80.574, 84.248, 87.264, 87.195, 89.076, 89.608, 89.868,
                90.101, 92.405, 95.854, 100.696, 101.060, 401.672, 390.724,
                567.534, 635.316, 733.054, 759.087, 894.206, 990.785,
                1090.109, 1080.914, 1122.643, 1178.351, 1260.531, 1273.514,
                1288.339, 1327.543, 1353.863, 1414.509, 1425.208, 1421.384,
                1442.962, 1464.350, 1468.705, 1447.894, 1457.628]),
    X=np.array([-3.067, -2.981, -2.921, -2.912, -2.840, -2.797, -2.702,
                -2.699, -2.633, -2.481, -2.363, -2.322, -1.501, -1.460,
                -1.274, -1.212, -1.100, -1.046, -0.915, -0.714, -0.566,
                -0.545, -0.400, -0.309, -0.109, -0.103, 0.010, 0.119,
                0.377, 0.790, 0.963, 1.006, 1.115, 1.572, 1.841, 2.047,
                2.200]).reshape(-1, 1),
))

_register(NISTProblem(
    "BoxBOD",
    lambda p, X: p[0] * (1.0 - torch.exp(-p[1] * X[:, 0])),
    starts=[[1.0, 1.0], [100.0, 0.75]],
    certified_params=[2.1380940889e2, 5.4723748542e-1],
    certified_ssr=1.1680088766e3,
    difficulty="higher",
    y=np.array([109.0, 149.0, 149.0, 280.0, 250.0, 560.0]),
    X=np.array([1.0, 2.0, 3.0, 5.0, 7.0, 10.0]).reshape(-1, 1),
))

_register(NISTProblem(
    "Rat42",
    lambda p, X: p[0] / (1.0 + torch.exp(p[1] - p[2] * X[:, 0])),
    starts=[[100.0, 1.0, 0.1], [75.0, 2.5, 0.07]],
    certified_params=[7.2462237576e1, 2.6180768402e0, 6.7359200066e-2],
    certified_ssr=8.0565229338e0,
    difficulty="higher",
    y=np.array([8.93, 10.80, 18.59, 22.33, 39.35, 56.11, 61.73, 64.62,
                67.08]),
    X=np.array([9.0, 14.0, 21.0, 28.0, 42.0, 57.0, 63.0, 70.0,
                79.0]).reshape(-1, 1),
))

_register(NISTProblem(
    "MGH10",
    lambda p, X: p[0] * torch.exp(p[1] / (X[:, 0] + p[2])),
    starts=[[2.0, 400000.0, 25000.0], [0.02, 4000.0, 250.0]],
    certified_params=[5.6096364710e-3, 6.1813463463e3, 3.4522363462e2],
    certified_ssr=8.7945855171e1,
    difficulty="higher",
    y=np.array([34780.0, 28610.0, 23650.0, 19630.0, 16370.0, 13720.0,
                11540.0, 9744.0, 8261.0, 7030.0, 6005.0, 5147.0, 4427.0,
                3820.0, 3307.0, 2872.0]),
    X=(50.0 + 5.0 * np.arange(16, dtype=np.float64)).reshape(-1, 1),
))

_register(NISTProblem(
    "Eckerle4",
    lambda p, X: (p[0] / p[1]) * torch.exp(
        -0.5 * ((X[:, 0] - p[2]) / p[1]) ** 2
    ),
    starts=[[1.0, 10.0, 500.0], [1.5, 5.0, 450.0]],
    certified_params=[1.5543827178e0, 4.0888321754e0, 4.5154121844e2],
    certified_ssr=1.4635887487e-3,
    difficulty="higher",
    y=np.array([0.0001575, 0.0001699, 0.0002350, 0.0003102, 0.0004917,
                0.0008710, 0.0017418, 0.0046400, 0.0065895, 0.0097302,
                0.0149002, 0.0237310, 0.0401683, 0.0712559, 0.1264458,
                0.2073413, 0.2902366, 0.3445623, 0.3698049, 0.3668534,
                0.3106727, 0.2078154, 0.1164354, 0.0616764, 0.0337200,
                0.0194023, 0.0117831, 0.0074357, 0.0022732, 0.0008800,
                0.0004579, 0.0002345, 0.0001586, 0.0001143, 0.0000710]),
    X=np.array([400.0, 405.0, 410.0, 415.0, 420.0, 425.0, 430.0, 435.0,
                436.5, 438.0, 439.5, 441.0, 442.5, 444.0, 445.5, 447.0,
                448.5, 450.0, 451.5, 453.0, 454.5, 456.0, 457.5, 459.0,
                460.5, 462.0, 463.5, 465.0, 470.0, 475.0, 480.0, 485.0,
                490.0, 495.0, 500.0]).reshape(-1, 1),
))

_register(NISTProblem(
    "Rat43",
    lambda p, X: p[0] / (1.0 + torch.exp(p[1] - p[2] * X[:, 0])) ** (1.0 / p[3]),
    starts=[[100.0, 10.0, 1.0, 1.0], [700.0, 5.0, 0.75, 1.3]],
    certified_params=[6.9964151270e2, 5.2771253025e0, 7.5962938329e-1,
                      1.2792483859e0],
    certified_ssr=8.7864049080e3,
    difficulty="higher",
    y=np.array([16.08, 33.83, 65.80, 97.20, 191.55, 326.20, 386.87, 520.53,
                590.03, 651.92, 724.93, 699.56, 689.96, 637.56, 717.41]),
    X=(1.0 + np.arange(15, dtype=np.float64)).reshape(-1, 1),
))

_register(NISTProblem(
    "Bennett5",
    lambda p, X: p[0] * (p[1] + X[:, 0]) ** (-1.0 / p[2]),
    starts=[[-2000.0, 50.0, 0.8], [-1500.0, 45.0, 0.85]],
    certified_params=[-2.5235058043e3, 4.6736564644e1, 9.3218483193e-1],
    certified_ssr=5.2404744073e-4,
    difficulty="higher", data_file="Bennett5.dat",
))

EMBEDDED = [n for n, p in PROBLEMS.items() if p.y is not None]
FILE_GATED = [n for n, p in PROBLEMS.items() if p.y is None]
assert len(PROBLEMS) == 27
