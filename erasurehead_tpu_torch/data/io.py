"""On-disk dataset formats: the reference's text/.npz layout plus a .npy cache.

The port's copy of erasurehead_tpu/data/io.py. The reference stores each
partition as a dense whitespace text matrix ``<i>.dat`` (src/util.py:13-15,
26-36) or a sparse CSR ``<i>.npz`` (src/util.py:17-24), with ``label.dat``,
``test_data[.dat|.npz]`` and ``label_test.dat`` alongside
(src/generate_data.py:29-46). This module reads and writes that layout, so
data prepared for the reference (or by the JAX package) loads unchanged,
and caches a ``.npy`` mirror beside each text file: parsing a large text
matrix takes minutes, np.load milliseconds.

A CSR layout loads as a scipy sparse matrix, which
``data/sharding.partition_stack`` stacks as PaddedRows or FieldOnehot.
"""

from __future__ import annotations

import os

import numpy as np
import scipy.sparse as sps

from erasurehead_tpu_torch.data.synthetic import Dataset


def save_dense_text(path: str, m: np.ndarray, fmt: str = "%.18g") -> None:
    """Whitespace text matrix, reference format (src/util.py:26-30), at full
    precision by default (the reference's label writer used "%5.3f",
    src/util.py:32-36)."""
    np.savetxt(path, np.atleast_2d(m), fmt=fmt)


def load_dense_text(path: str) -> np.ndarray:
    """Dense text matrix with a .npy cache sidecar.

    A cold load parses the text with the native from_chars parser
    (data/native) where g++ is available, np.loadtxt (float64) otherwise or
    where the native parse fails (both give bitwise the same array), and
    writes ``<path>.npy``; a warm load (the cache is not older than the
    text) memory-maps the cache read-only."""
    cache = path + ".npy"
    if os.path.exists(cache) and os.path.getmtime(cache) >= os.path.getmtime(path):
        return np.load(cache, mmap_mode="r")
    from erasurehead_tpu_torch.data import native

    m = native.load_dense_text_native(path)
    if m is None:
        m = np.loadtxt(path, dtype=np.float64)
    try:
        np.save(cache, m)
    except OSError:
        pass  # read-only data dir: parse the text again next time
    return m


def save_csr(path_no_ext: str, m) -> None:
    """Reference .npz CSR layout (src/util.py:17-19)."""
    m = m.tocsr()
    np.savez(
        path_no_ext,
        data=m.data,
        indices=m.indices,
        indptr=m.indptr,
        shape=m.shape,
    )


def load_csr(path_no_ext: str):
    """Reference .npz CSR loader (src/util.py:21-24)."""
    with np.load(path_no_ext + ".npz") as z:
        return sps.csr_matrix(
            (z["data"], z["indices"], z["indptr"]), shape=z["shape"]
        )


def write_reference_layout(
    dataset: Dataset, out_dir: str, n_partitions: int
) -> None:
    """Write a dataset in the reference's per-partition directory layout
    (src/generate_data.py:29-46): ``<i>.dat``/``<i>.npz`` (1-based),
    label.dat, test_data[.dat|.npz], label_test.dat."""
    os.makedirs(out_dir, exist_ok=True)
    n = dataset.n_samples
    rows = n // n_partitions
    sparse = sps.issparse(dataset.X_train)
    for i in range(n_partitions):
        block = dataset.X_train[i * rows : (i + 1) * rows]
        if sparse:
            save_csr(os.path.join(out_dir, str(i + 1)), block)
        else:
            save_dense_text(os.path.join(out_dir, f"{i + 1}.dat"), block)
    save_dense_text(
        os.path.join(out_dir, "label.dat"), dataset.y_train[: rows * n_partitions]
    )
    if sparse:
        save_csr(os.path.join(out_dir, "test_data"), dataset.X_test)
    else:
        save_dense_text(os.path.join(out_dir, "test_data.dat"), dataset.X_test)
    save_dense_text(os.path.join(out_dir, "label_test.dat"), dataset.y_test)


def has_reference_layout(path: str | None) -> bool:
    """True iff ``path`` holds at least partition 1 of a reference layout
    (the partition file, not just the directory: artifact writes create
    ``<dir>/results/``)."""
    return path is not None and (
        os.path.exists(os.path.join(path, "1.dat"))
        or os.path.exists(os.path.join(path, "1.npz"))
    )


def layout_is_sparse(path: str) -> bool:
    """Whether a reference-layout directory stores CSR (.npz) partitions."""
    return os.path.exists(os.path.join(path, "1.npz"))


def read_reference_layout(in_dir: str, n_partitions: int) -> Dataset:
    """Load a reference-layout directory back into a Dataset, dense or CSR
    as its partition-1 file says."""
    sparse = layout_is_sparse(in_dir)
    parts = []
    for i in range(n_partitions):
        if sparse:
            parts.append(load_csr(os.path.join(in_dir, str(i + 1))))
        else:
            parts.append(load_dense_text(os.path.join(in_dir, f"{i + 1}.dat")))
    X_train = sps.vstack(parts).tocsr() if sparse else np.vstack(parts)
    y_train = load_dense_text(os.path.join(in_dir, "label.dat")).reshape(-1)
    if sparse:
        X_test = load_csr(os.path.join(in_dir, "test_data"))
    else:
        X_test = load_dense_text(os.path.join(in_dir, "test_data.dat"))
    y_test = load_dense_text(os.path.join(in_dir, "label_test.dat")).reshape(-1)
    return Dataset(
        X_train=X_train,
        y_train=y_train[: X_train.shape[0]],
        X_test=X_test,
        y_test=y_test,
        name=os.path.basename(os.path.normpath(in_dir)),
    )
