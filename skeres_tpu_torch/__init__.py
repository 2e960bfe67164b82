"""skeres_tpu_torch — the PyTorch/CUDA port of skeres_tpu.

The same solver surface as ``skeres_tpu`` (``Problem`` →
``solve(options, problem)`` → ``Summary``), on PyTorch tensors on one
device chosen by ``SolverOptions.device``. Residuals are written for one
block and batched with ``torch.func.vmap``; Jacobians come from
``torch.func.vjp``/``jvp``; the kernels that the JAX package wrote in Pallas
for the TPU (the dense Cholesky of the reduced camera system, its blocked
form, and the pair products of the explicit Schur complement) are CUDA
kernels written for Hopper (``csrc/cholesky.cu``, ``csrc/pair_product.cu``).

This package imports torch and never jax or skeres_tpu. It runs the
trust region (Levenberg-Marquardt on the host loop or the device loop,
dogleg on the host loop) with every linear solver of the JAX package
(DENSE_QR, DENSE_NORMAL_CHOLESKY, CGNR, DENSE_SCHUR, ITERATIVE_SCHUR and
its preconditioners), inner iterations and trust-region dumps, and the
line-search minimizer (``MinimizerType.LINE_SEARCH``; ``GradientProblem``
and ``GradientProblemSolver`` for a scalar function); ``check_gradients``
holds every residual's Jacobian against numeric differences, and
``Covariance`` estimates the solution's covariance (DENSE_SVD or
SCHUR_COMPLEMENT). Its ``Problem`` has every manifold of the JAX package,
constant blocks, bounds, numeric differentiation, block removal and
``evaluate``; pose graphs (``models/pose_graph.py``, ``io/g2o.py``), priors,
cubic interpolation and the MGH and NIST registries come with it. The Schur
solvers take the general structure of the JAX package: any number of
retained groups and of observation batches, each row with one eliminated
block and any number of retained ones (S by the column probe where the
bundle-adjustment fast paths do not apply). The command-line tools are in
``skeres_tpu_torch.cli`` (``bundle_adjuster``, ``pose_graph_2d``,
``pose_graph_3d``; ``python -m skeres_tpu_torch.cli`` lists them), and a
plain BAL file loads through the native parser (``native/``). A solve
shards its residual rows over the ranks of a ``torch.distributed`` mesh
with ``SolverOptions.mesh`` (``skeres_tpu_torch.parallel``).
"""

from skeres_tpu_torch.ops.loss import (
    ArctanLoss,
    CauchyLoss,
    ComposedLoss,
    HuberLoss,
    LossFunction,
    LossFunctionWrapper,
    ScaledLoss,
    SoftLOneLoss,
    TolerantLoss,
    TrivialLoss,
    TukeyLoss,
)

__version__ = "0.1.0"


def __getattr__(name):
    from importlib import import_module

    _core = {
        "Problem": "skeres_tpu_torch.core.problem",
        "ResidualBlockId": "skeres_tpu_torch.core.problem",
        **dict.fromkeys(
            ("Manifold", "EuclideanManifold", "SubsetManifold", "QuaternionManifold",
             "EigenQuaternionManifold", "SphereManifold", "LineManifold", "AngleManifold",
             "ProductManifold"),
            "skeres_tpu_torch.models.manifolds"),
        "EvaluationCallback": "skeres_tpu_torch.core.callbacks",
        "StateUpdatingCallback": "skeres_tpu_torch.core.callbacks",
        "LoggingCallback": "skeres_tpu_torch.core.callbacks",
        "SolverOptions": "skeres_tpu_torch.core.options",
        "Summary": "skeres_tpu_torch.core.summary",
        "solve": "skeres_tpu_torch.core.solver",
        "Covariance": "skeres_tpu_torch.core.covariance",
        "GradientProblem": "skeres_tpu_torch.core.gradient_problem",
        "GradientProblemSolver": "skeres_tpu_torch.core.gradient_problem",
    }
    if name in _core:
        return getattr(import_module(_core[name]), name)
    raise AttributeError(f"module 'skeres_tpu_torch' has no attribute {name!r}")
