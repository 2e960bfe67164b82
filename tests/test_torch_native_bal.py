"""The port's BAL loading: a plain ``.txt`` through the native parser
(``skeres_tpu_torch/native``, built with g++ at first use), ``.bz2`` and
``.gz`` through the Python parser, against each other and against the JAX
package's ``load_bal``, on a file written from ``synthetic_bal``; a
malformed file raises."""

import numpy as np
import pytest

from skeres_tpu.io import bal as jbal
from skeres_tpu_torch.io import bal as tbal
from skeres_tpu_torch.native import bal_native

FIELDS = ("cameras", "points", "camera_index", "point_index", "observations")


@pytest.fixture(scope="module")
def scene():
    return tbal.synthetic_bal(7, 90, 3)


def _equal(a, b, rtol):
    for name in FIELDS:
        x, y = getattr(a, name), getattr(b, name)
        assert x.shape == y.shape and x.dtype == y.dtype, name
        if x.dtype.kind == "i":
            np.testing.assert_array_equal(x, y, err_msg=name)
        else:
            np.testing.assert_allclose(x, y, rtol=rtol, atol=0, err_msg=name)


def test_native_python_compressed_and_jax_agree(scene, tmp_path):
    """The native parse equals the Python parse of the same file and the
    scene written, bit for bit (both round each number correctly), and the
    ``.bz2`` and ``.gz`` loads; the port's ``load_bal`` equals the JAX
    package's on the compressed files and within rtol 1e-15 on the plain
    one (the JAX package's native parser accumulates digits in double)."""
    txt = tbal.write_bal(tmp_path / "s.txt", scene)
    native = tbal.load_bal(txt)
    python = tbal.parse_bal_text(txt)
    _equal(native, python, rtol=0)
    _equal(native, scene, rtol=0)
    for suffix in (".bz2", ".gz"):
        packed = tbal.write_bal(tmp_path / f"s.txt{suffix}", scene)
        _equal(tbal.load_bal(packed), python, rtol=0)
        _equal(tbal.load_bal(packed), jbal.load_bal(packed), rtol=0)
    _equal(native, jbal.load_bal(txt), rtol=1e-15)
    assert native.cameras.flags.c_contiguous and native.observations.shape == (270, 2)


@pytest.mark.parametrize("body", ["truncated", "not a number"])
def test_malformed_file_raises(scene, tmp_path, body):
    """A file that ends early, or a token that is not a number, makes the
    native parse fail with an IOError (the JAX package would parse the file
    again in Python)."""
    good = (tmp_path / "g.txt")
    tbal.write_bal(good, scene)
    lines = good.read_text().splitlines()
    if body == "truncated":
        text = "\n".join(lines[: len(lines) // 2])
    else:
        lines[5] = "0 3 1.0 x"
        text = "\n".join(lines)
    bad = tmp_path / "bad.txt"
    bad.write_text(text + "\n")
    with pytest.raises(IOError, match="bal_load"):
        bal_native.load(str(bad))
    with pytest.raises(IOError):
        tbal.load_bal(str(bad))


def test_missing_file_raises(tmp_path):
    with pytest.raises(IOError, match="bal_sizes"):
        tbal.load_bal(str(tmp_path / "none.txt"))
