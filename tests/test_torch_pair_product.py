"""K3 (ops/pair_product.py): its plain version against the JAX package's
Pallas pair-product kernel (interpret mode, as
tests/test_explicit_schur.py runs it) on the same numpy inputs, and the
wrapper's contract. The JAX kernel writes g-major rows; they are permuted
to the port's f-major rows before the comparison. float64, tolerance
1e-12 of max|reference| (3-term sums in two orders). The kernel itself
against the plain version needs a card: tests/test_torch_gpu.py."""

import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skeres_tpu.ops.pallas.pair_product import pair_products_lanes
from skeres_tpu_torch.ops import pair_product as k3


def _case(seed, p, kp, f, e):
    rng = np.random.default_rng(seed)
    iu, ju = np.triu_indices(kp, k=1)
    return dict(
        grid=rng.standard_normal((p, kp * f * e)),
        cinv=rng.standard_normal((p, e * e)),
        swap=rng.random((p, len(iu))) < 0.5,
        valid=rng.random((p, len(iu))) < 0.8,
        pair_kl=np.stack([iu, ju]).astype(np.int32),
    )


def _torch_args(c):
    return (
        torch.from_numpy(c["grid"]), torch.from_numpy(c["cinv"]),
        torch.from_numpy(c["swap"]), torch.from_numpy(c["valid"]),
        torch.from_numpy(c["pair_kl"]),
    )


@pytest.mark.parametrize("seed,p,kp,f,e", [(0, 23, 5, 9, 3), (1, 37, 4, 5, 3), (2, 9, 2, 9, 3)])
def test_plain_k3_matches_pallas_kernel(seed, p, kp, f, e):
    c = _case(seed, p, kp, f, e)
    want = np.asarray(pair_products_lanes(
        jnp.asarray(c["grid"]), jnp.asarray(c["cinv"]),
        jnp.asarray(c["swap"]), jnp.asarray(c["valid"]),
        kp=kp, f=f, e=e,
        pair_k=tuple(int(v) for v in c["pair_kl"][0]),
        pair_l=tuple(int(v) for v in c["pair_kl"][1]),
    ))
    want = want.reshape(-1, f, f).transpose(0, 2, 1).reshape(-1, f * f)  # g- to f-major
    got = k3.pair_products(*_torch_args(c), f, e).numpy()
    assert got.shape == (p * kp * (kp - 1) // 2, f * f)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * np.abs(want).max())
    # an invalid pair is exactly zero
    assert not got.reshape(p, -1, f * f)[~c["valid"]].any()


@pytest.mark.parametrize("chunk", [1, 7, 1000])
def test_plain_k3_chunking_leaves_values_unchanged(chunk):
    c = _case(3, 40, 5, 9, 3)
    whole = k3.pair_products_reference(*_torch_args(c), 9, 3)
    chunked = k3.pair_products(*_torch_args(c), 9, 3, chunk_points=chunk)
    torch.testing.assert_close(chunked, whole, rtol=0, atol=0)


def test_cpu_tensor_takes_plain_version_without_building():
    """A CPU tensor never launches, never builds, and leaves the launch
    counter alone, for any (f, e); the module imports without nvcc."""
    before = k3.pair_products.launches
    k3.pair_products(*_torch_args(_case(4, 6, 3, 6, 2)), 6, 2)
    assert k3.pair_products.launches == before
    if not torch.cuda.is_available():
        assert k3.build_kernels.cache_info().currsize == 0
        if shutil.which("nvcc") is None:
            with pytest.raises(RuntimeError, match="nvcc"):
                k3.build_kernels()


_BAD = {  # what the wrapper must refuse, and with which exception
    "grid": (lambda a: a["grid"][:, :-1].contiguous(), ValueError),  # not kp * f * e
    "grid_dtype": (lambda a: a["grid"].float(), TypeError),  # dtypes differ
    "cinv": (lambda a: a["cinv"][:-1], ValueError),
    "swap": (lambda a: a["swap"].to(torch.uint8), ValueError),
    "valid": (lambda a: a["valid"][:, :-1].contiguous(), ValueError),
    "pair_kl": (lambda a: a["pair_kl"].long(), ValueError),
    "grid_strided": (lambda a: a["grid"].T.contiguous().T, ValueError),
}


@pytest.mark.parametrize("case", sorted(_BAD))
def test_wrapper_rejects_what_the_kernel_does_not_take(case):
    names = ("grid", "cinv", "swap", "valid", "pair_kl")
    args = dict(zip(names, _torch_args(_case(5, 8, 4, 9, 3))))
    make, exc = _BAD[case]
    args[case.split("_")[0] if case != "pair_kl" else case] = make(args)
    with pytest.raises(exc):
        k3.pair_products(*(args[n] for n in names), 9, 3)
