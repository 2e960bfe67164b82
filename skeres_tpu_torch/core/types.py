"""Enums and their string forms (reference lineage: ``include/ceres/types.h``,
``internal/ceres/types.cc``). Same names and values as
``skeres_tpu/core/types.py``; the port runs only part of them (see
``core/solver.py``)."""

from __future__ import annotations

import enum

__all__ = [
    "MinimizerType",
    "TrustRegionStrategyType",
    "DoglegType",
    "LinearSolverType",
    "PreconditionerType",
    "VisibilityClusteringType",
    "LineSearchDirectionType",
    "LineSearchType",
    "TerminationType",
    "CallbackReturnType",
    "LoggingType",
    "CovarianceAlgorithmType",
    "DumpFormatType",
]


class MinimizerType(enum.Enum):
    TRUST_REGION = "TRUST_REGION"
    LINE_SEARCH = "LINE_SEARCH"


class TrustRegionStrategyType(enum.Enum):
    LEVENBERG_MARQUARDT = "LEVENBERG_MARQUARDT"
    DOGLEG = "DOGLEG"


class DoglegType(enum.Enum):
    TRADITIONAL_DOGLEG = "TRADITIONAL_DOGLEG"
    SUBSPACE_DOGLEG = "SUBSPACE_DOGLEG"


class LinearSolverType(enum.Enum):
    DENSE_QR = "DENSE_QR"
    DENSE_NORMAL_CHOLESKY = "DENSE_NORMAL_CHOLESKY"
    SPARSE_NORMAL_CHOLESKY = "SPARSE_NORMAL_CHOLESKY"
    CGNR = "CGNR"
    DENSE_SCHUR = "DENSE_SCHUR"
    SPARSE_SCHUR = "SPARSE_SCHUR"
    ITERATIVE_SCHUR = "ITERATIVE_SCHUR"


class PreconditionerType(enum.Enum):
    IDENTITY = "IDENTITY"
    JACOBI = "JACOBI"
    SCHUR_JACOBI = "SCHUR_JACOBI"
    POWER_SERIES_EXPANSION = "POWER_SERIES_EXPANSION"
    CLUSTER_JACOBI = "CLUSTER_JACOBI"
    CLUSTER_TRIDIAGONAL = "CLUSTER_TRIDIAGONAL"
    SUBSET = "SUBSET"


class VisibilityClusteringType(enum.Enum):
    """How CLUSTER_JACOBI and CLUSTER_TRIDIAGONAL cluster the cameras
    (reference: ``visibility_clustering_type``; ``core/visibility.py``)."""

    CANONICAL_VIEWS = "CANONICAL_VIEWS"
    SINGLE_LINKAGE = "SINGLE_LINKAGE"


class LineSearchDirectionType(enum.Enum):
    STEEPEST_DESCENT = "STEEPEST_DESCENT"
    NONLINEAR_CONJUGATE_GRADIENT = "NONLINEAR_CONJUGATE_GRADIENT"
    LBFGS = "LBFGS"
    BFGS = "BFGS"


class LineSearchType(enum.Enum):
    ARMIJO = "ARMIJO"
    WOLFE = "WOLFE"


class TerminationType(enum.Enum):
    CONVERGENCE = "CONVERGENCE"
    NO_CONVERGENCE = "NO_CONVERGENCE"
    FAILURE = "FAILURE"
    USER_SUCCESS = "USER_SUCCESS"
    USER_FAILURE = "USER_FAILURE"


class CallbackReturnType(enum.Enum):
    SOLVER_CONTINUE = "SOLVER_CONTINUE"
    SOLVER_ABORT = "SOLVER_ABORT"
    SOLVER_TERMINATE_SUCCESSFULLY = "SOLVER_TERMINATE_SUCCESSFULLY"


class LoggingType(enum.Enum):
    SILENT = "SILENT"
    PER_MINIMIZER_ITERATION = "PER_MINIMIZER_ITERATION"


class CovarianceAlgorithmType(enum.Enum):
    DENSE_SVD = "DENSE_SVD"
    SCHUR_COMPLEMENT = "SCHUR_COMPLEMENT"


class DumpFormatType(enum.Enum):
    CONSOLE = "CONSOLE"
    TEXTFILE = "TEXTFILE"
