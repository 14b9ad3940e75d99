"""Real-dataset preprocessing: amazon, dna, covtype, kc_house_data.

The port's copy of erasurehead_tpu/data/real.py (host numpy and sklearn;
the same inputs give the same bytes).

Re-implements the four dataset branches of the reference's
src/arrange_real_data.py as one shared pipeline (each reference branch
repeats the same skeleton: featurize -> bias column -> 80/20 split with
random_state=0 -> one-hot encode (fit on train+test) -> sparse CSR
partitions):

  amazon  (arrange_real_data.py:34-91):  Kaggle amazon-employee-access
      train.csv; per-column label encoding, degree-2 hashed interaction
      terms excluding column pairs (5,7) and (2,3)
      (util.py:49-55), re-encoding, bias column.
  dna     (arrange_real_data.py:93-143): first 500k rows of features.csv;
      col 0 is the label; bias column scaled 1/sqrt(n).
  covtype (arrange_real_data.py:145-205): sklearn fetch_covtype, classes
      {1,2} kept and mapped to {-1,+1}, per-column label encoding, bias.
  kc_house_data (arrange_real_data.py:207-253): kc_house_data.csv,
      'bedrooms' onward as features, bias, price/1e6 as regression target.

Determinism matches the reference: np.random.seed(0)
(arrange_real_data.py:27) and train_test_split(random_state=0).

Zero-egress note: all loaders work from local files; ``covtype`` also
accepts sklearn's cached fetch_covtype when the cache exists. Missing
sources raise with download instructions rather than fetching.
"""

from __future__ import annotations

import itertools
import math
import os
from typing import Callable, Optional

import numpy as np

from erasurehead_tpu_torch.data.synthetic import Dataset

#: column pairs excluded from amazon interaction features (util.py:53:
#: ROLE_CODEs pair and the two ROLE_ROLLUPs pair)
AMAZON_EXCLUDED_PAIRS = ((5, 7), (2, 3))


def _label_encode_columns(X: np.ndarray) -> np.ndarray:
    """Map each column's values onto 0..n_unique-1 (order-preserving), the
    effect of the reference's per-column LabelEncoder loop
    (arrange_real_data.py:41-44)."""
    out = np.empty_like(X, dtype=np.int64)
    for col in range(X.shape[1]):
        _, inverse = np.unique(X[:, col], return_inverse=True)
        out[:, col] = inverse
    return out


def hashed_interactions(
    X: np.ndarray, degree: int = 2, excluded_pairs=AMAZON_EXCLUDED_PAIRS
) -> np.ndarray:
    """Degree-d interaction features by hashing value tuples (util.py:49-55).

    Column subsets containing an excluded pair are skipped. Values are
    hashed with Python's deterministic int-tuple hash; the subsequent
    label-encoding pass collapses them to dense ids, so only injectivity
    matters.
    """
    excluded = [set(p) for p in excluded_pairs]
    cols = []
    for subset in itertools.combinations(range(X.shape[1]), degree):
        if any(e <= set(subset) for e in excluded):
            continue
        cols.append([hash(tuple(row)) for row in X[:, subset]])
    return np.array(cols).T


def _one_hot_split(
    X: np.ndarray, y: np.ndarray, test_size: float = 0.2
) -> Dataset:
    """Shared tail of every branch: 80/20 split (random_state=0), one-hot
    encoder fit on train+test jointly, sparse CSR output
    (arrange_real_data.py:59-64 etc.)."""
    from sklearn.model_selection import train_test_split
    from sklearn.preprocessing import OneHotEncoder

    X_train, X_test, y_train, y_test = train_test_split(
        X, y, test_size=test_size, random_state=0
    )
    encoder = OneHotEncoder(categories="auto")
    encoder.fit(np.vstack((X_train, X_test)))
    return Dataset(
        X_train=encoder.transform(X_train).tocsr(),
        y_train=np.asarray(y_train, dtype=np.float64),
        X_test=encoder.transform(X_test).tocsr(),
        y_test=np.asarray(y_test, dtype=np.float64),
    )


def prepare_amazon(input_dir: str) -> Dataset:
    """Kaggle amazon-employee-access; needs <input_dir>/train.csv."""
    import pandas as pd

    path = os.path.join(input_dir, "train.csv")
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"{path} missing — download train.csv from "
            "kaggle.com/c/amazon-employee-access-challenge"
        )
    df = pd.read_csv(path)
    X = df.loc[:, "RESOURCE":].values
    y = 2 * df["ACTION"].values - 1
    X = _label_encode_columns(X)
    X = np.hstack([X, hashed_interactions(X, degree=2)])
    X = _label_encode_columns(X)
    X = np.hstack([X, np.ones((X.shape[0], 1))])
    ds = _one_hot_split(X, y)
    ds.name = "amazon"
    return ds


def prepare_dna(input_dir: str, max_rows: int = 500_000) -> Dataset:
    """TU Berlin large-scale DNA; needs <input_dir>/features.csv."""
    path = os.path.join(input_dir, "features.csv")
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"{path} missing — fetch the dna dataset "
            "(ftp://largescale.ml.tu-berlin.de/largescale/dna/)"
        )
    with open(path) as fin:
        data = np.genfromtxt(itertools.islice(fin, 0, max_rows), delimiter=",")
    X, y = data[:, 1:], data[:, 0]
    n = X.shape[0]
    X = np.hstack([X, np.ones((n, 1)) / math.sqrt(n)])
    ds = _one_hot_split(X, y)
    ds.name = "dna"
    return ds


#: the genuine UCI covtype.data row layout fetch_covtype itself parses:
#: 10 quantitative columns, 4 wilderness-area indicators, 40 soil-type
#: indicators, then Cover_Type in 1..7 (55 comma-separated ints/row)
COVTYPE_N_FEATURES = 54


def prepare_covtype(input_dir: Optional[str] = None) -> Dataset:
    """UCI covertype (arrange_real_data.py:145-205 branch).

    Accepts either the raw UCI ``covtype.data``/``covtype.data.gz`` in
    ``input_dir`` (the 54-feature + Cover_Type layout — the same file
    sklearn's fetch_covtype downloads and parses), or an already-fetched
    sklearn cache (``input_dir`` as its data_home). The raw path makes the
    genuine schema drivable without network access."""
    raw = None
    for name in ("covtype.data", "covtype.data.gz"):
        p = os.path.join(input_dir or ".", name)
        if input_dir is not None and os.path.exists(p):
            raw = p
            break
    if raw is not None:
        import pandas as pd

        # pandas' C parser: the real UCI file is 581k rows (~75 MB) where
        # np.loadtxt's Python line loop would take minutes
        table = pd.read_csv(raw, header=None).to_numpy(dtype=np.float64)
        if table.ndim != 2 or table.shape[1] != COVTYPE_N_FEATURES + 1:
            raise ValueError(
                f"{raw}: expected {COVTYPE_N_FEATURES + 1} columns "
                f"(UCI covtype.data layout), got {table.shape}"
            )
        data, target = table[:, :COVTYPE_N_FEATURES], table[:, -1]
    else:
        try:
            from sklearn.datasets import fetch_covtype

            bunch = fetch_covtype(
                data_home=input_dir or None, download_if_missing=False
            )
        except OSError as e:
            raise FileNotFoundError(
                "covtype source missing — place the UCI covtype.data[.gz] "
                "in input_dir, or run sklearn.datasets.fetch_covtype() "
                "once with network access, or pass its data_home"
            ) from e
        data, target = bunch.data, bunch.target
    keep = target <= 2
    X = data[keep]
    y = np.where(target[keep] == 1, -1.0, 1.0)
    X = _label_encode_columns(X)
    X = np.hstack([X, np.ones((X.shape[0], 1))])
    ds = _one_hot_split(X, y)
    ds.name = "covtype"
    return ds


def prepare_kc_house(input_dir: str) -> Dataset:
    """KC house sales regression; needs <input_dir>/kc_house_data.csv."""
    import pandas as pd

    path = os.path.join(input_dir, "kc_house_data.csv")
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"{path} missing — download kc_house_data.csv "
            "(kaggle.com/harlfoxem/housesalesprediction)"
        )
    df = pd.read_csv(path)
    X = df.loc[:, "bedrooms":].values
    y = df["price"].values / 1e6  # arrange_real_data.py:225-226
    X = np.hstack([X, np.ones((X.shape[0], 1))])
    ds = _one_hot_split(X, y)
    ds.name = "kc_house_data"
    return ds


def prepare_breast_cancer(input_dir: Optional[str] = None) -> Dataset:
    """UCI Wisconsin breast-cancer — genuinely real (non-synthetic) data
    bundled inside scikit-learn, so it works without network access.

    Not one of the reference's four datasets (its CSVs/caches need network
    access); this routes REAL value distributions — 569 rows x 30
    continuous clinical features with heterogeneous scales and hundreds of
    distinct values per column — through the exact covtype pipeline
    (arrange_real_data.py:145-205 flow: per-column label encoding of
    continuous features, bias column, joint one-hot, CSR), proving the
    preparers on non-synthetic data.
    """
    from sklearn.datasets import load_breast_cancer

    bunch = load_breast_cancer()
    X = bunch.data
    y = 2.0 * bunch.target - 1.0  # {0,1} -> ±1 like covtype's class binarize
    X = _label_encode_columns(X)
    X = np.hstack([X, np.ones((X.shape[0], 1))])
    ds = _one_hot_split(X, y)
    ds.name = "breast_cancer"
    return ds


def prepare_diabetes(input_dir: Optional[str] = None) -> Dataset:
    """UCI diabetes regression — the genuinely real bundled counterpart of
    kc_house_data for the LINEAR model family (442 rows x 10 standardized
    clinical features; progression score target). Same pipeline shape as
    prepare_kc_house (arrange_real_data.py:207-253): bias column, 80/20
    split, one-hot of the label-encoded continuous columns, target scaled
    to O(1) like the reference's price/1e6."""
    from sklearn.datasets import load_diabetes

    bunch = load_diabetes()
    X = bunch.data
    y = bunch.target / 100.0  # O(1) target, ≙ price/1e6 scaling
    # like prepare_kc_house, raw values one-hot directly (the encoder's
    # categories='auto' handles continuous columns; no label-encode pass)
    X = np.hstack([X, np.ones((X.shape[0], 1))])
    ds = _one_hot_split(X, y)
    ds.name = "diabetes"
    return ds


PREPARERS: dict[str, Callable[..., Dataset]] = {
    "amazon": prepare_amazon,
    "amazon-dataset": prepare_amazon,  # the reference's directory name
    "dna": prepare_dna,
    "dna-dataset": prepare_dna,
    "dna-dataset/dna": prepare_dna,  # the reference's nested directory name
    "covtype": prepare_covtype,
    "kc_house_data": prepare_kc_house,
    # real (non-synthetic) data available without network access
    "breast_cancer": prepare_breast_cancer,
    "diabetes": prepare_diabetes,
}


def prepare(dataset: str, input_dir: str) -> Dataset:
    if dataset not in PREPARERS:
        raise ValueError(f"unknown dataset {dataset!r}; known: {sorted(PREPARERS)}")
    np.random.seed(0)  # reference determinism hook (arrange_real_data.py:27)
    return PREPARERS[dataset](input_dir)
