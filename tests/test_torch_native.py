"""The port's native text parser (data/native) against np.loadtxt and the
JAX package's parser, on the JAX test_native.py cases.

Each case writes one file and parses it three ways: the port's
``load_dense_text_native``, np.loadtxt and the JAX package's
``load_dense_text_native``; all three must agree bitwise (the same strtod
grammar), shapes and squeezes included. Files the parser refuses (ragged,
non-numeric, missing) return None in both packages and count as a
fallback. The port builds its library into its build directory, never
beside the source, and ``data/io.load_dense_text``'s cold load goes
through it.
"""

import numpy as np
import pytest

from erasurehead_tpu.data import native as j_native
from erasurehead_tpu_torch.data import io as t_io
from erasurehead_tpu_torch.data import native


@pytest.fixture(scope="module")
def lib_available():
    if native.get_lib() is None:
        pytest.skip("no C++ toolchain; np.loadtxt fallback covers this")


def _three_ways(tmp_path, m, fmt="%.18g"):
    p = str(tmp_path / "m.dat")
    np.savetxt(p, np.atleast_2d(m), fmt=fmt)
    want = np.loadtxt(p, dtype=np.float64)
    native.reset_counts()
    got = native.load_dense_text_native(p)
    theirs = j_native.load_dense_text_native(p)
    assert got is not None and theirs is not None
    assert native.COUNTS == {"native": 1, "fallback": 0}
    assert got.shape == want.shape == theirs.shape and got.dtype == np.float64
    assert got.tobytes() == want.tobytes() == theirs.tobytes()
    return got


CASES = {
    "matrix": (np.random.default_rng(0).standard_normal((37, 11))
               * 10.0 ** np.random.default_rng(1).integers(-30, 30, (37, 11)), "%.18g"),
    "label_vector": (np.asarray([1.0, -1.0, -1.0, 1.0]), "%.18g"),
    "single_row": (np.asarray([[1.5, 2.5, 3.5]]), "%.18g"),
    "single_column": (np.asarray([[1.5], [2.5], [-3.5]]), "%.18g"),
    "scalar_1x1": (np.asarray([[3.25]]), "%.18g"),
    "inf_and_1e300": (np.asarray([[np.inf, -np.inf], [1e-300, 1e300]]), "%.18g"),
    "reference_format": (np.asarray([[0.123456, -7.5], [42.0, 0.001]]), "%5.3f"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_parse_is_bitwise_loadtxt_and_jax(tmp_path, lib_available, case):
    m, fmt = CASES[case]
    got = _three_ways(tmp_path, m, fmt)
    if case == "scalar_1x1":
        assert got.ndim == 0
    elif case in ("label_vector", "single_row", "single_column"):
        assert got.ndim == 1


@pytest.mark.parametrize("name,text", [
    ("ragged.dat", "1 2 3\n4 5\n"),
    ("bad.dat", "1 2\nfoo 4\n"),
    ("missing.dat", None),
])
def test_refused_files_fall_back(tmp_path, lib_available, name, text):
    p = str(tmp_path / name)
    if text is not None:
        with open(p, "w") as f:
            f.write(text)
    native.reset_counts()
    assert native.load_dense_text_native(p) is None
    assert j_native.load_dense_text_native(p) is None
    assert native.COUNTS == {"native": 0, "fallback": 1}


def test_the_library_builds_into_the_build_directory(lib_available):
    """``g++ -O2 -shared -fPIC`` into build/erasurehead_tpu_torch/native,
    named by the source's hash; nothing is written beside the source."""
    so = native.library_path()
    assert so.exists() and so.parent == native._BUILD_DIR
    assert so.parent.parts[-3:] == ("build", "erasurehead_tpu_torch", "native")
    assert sorted(f.name for f in native._SRC.parent.iterdir()
                  if f.name != "__pycache__") == ["__init__.py", "loadtxt.cpp"]


def test_cold_load_goes_native_then_the_sidecar(tmp_path, lib_available):
    """``load_dense_text``: the cold load counts one native parse and writes
    the .npy sidecar; the warm load maps it and parses nothing; all agree
    with the matrix written."""
    m = np.random.default_rng(1).standard_normal((23, 7))
    p = str(tmp_path / "x.dat")
    t_io.save_dense_text(p, m)
    native.reset_counts()
    cold = t_io.load_dense_text(p)
    assert native.COUNTS == {"native": 1, "fallback": 0}
    warm = t_io.load_dense_text(p)
    assert native.COUNTS == {"native": 1, "fallback": 0}
    assert cold.tobytes() == m.tobytes() == np.asarray(warm).tobytes()


def test_cold_load_of_a_refused_file_uses_loadtxt(tmp_path, lib_available):
    """A file the parser refuses still loads, through np.loadtxt (which
    then raises its own error where the file really is bad)."""
    p = str(tmp_path / "comment.dat")
    with open(p, "w") as f:
        f.write("# a header np.loadtxt skips\n1 2\n3 4\n")
    native.reset_counts()
    got = t_io.load_dense_text(p)
    assert native.COUNTS == {"native": 0, "fallback": 1}
    assert got.tobytes() == np.loadtxt(p).tobytes()
    bad = str(tmp_path / "bad.dat")
    with open(bad, "w") as f:
        f.write("1 2\nfoo 4\n")
    with pytest.raises(ValueError):
        t_io.load_dense_text(bad)
