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
its preconditioners), inner iterations and trust-region dumps; its
``Problem`` has every manifold of the JAX package, constant blocks,
bounds, numeric differentiation, block removal and ``evaluate``. What it
does not run yet (the line-search minimizer, the gradient checker, a
mesh) raises ``NotImplementedError``.
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
        "SolverOptions": "skeres_tpu_torch.core.options",
        "Summary": "skeres_tpu_torch.core.summary",
        "solve": "skeres_tpu_torch.core.solver",
    }
    if name in _core:
        return getattr(import_module(_core[name]), name)
    raise AttributeError(f"module 'skeres_tpu_torch' has no attribute {name!r}")
