"""The port's feature stacks (ops/features.py), the one-hot generator, the
sparse and int8 stacking (data/sharding.py) and the real-data preparers
against the JAX package.

Host arrays (padded rows, field sizes, pairing plans, quantized payloads and
scales, generated data, stacked leaves, prepared datasets) must match byte
for byte. Products are float32 on both sides, summed in other orders: they
match within rtol 1e-5 / atol 1e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sps
import torch

from erasurehead_tpu.data import real as j_real
from erasurehead_tpu.data import sharding as j_sharding
from erasurehead_tpu.data import synthetic as j_syn
from erasurehead_tpu.ops import codes as j_codes
from erasurehead_tpu.ops import features as jf
from erasurehead_tpu_torch.data import real as t_real
from erasurehead_tpu_torch.data import sharding as t_sharding
from erasurehead_tpu_torch.data import synthetic as t_syn
from erasurehead_tpu_torch.ops import codes as t_codes
from erasurehead_tpu_torch.ops import features as tf
from erasurehead_tpu_torch.utils.device import pin_float32_precision

pin_float32_precision()
TOL = dict(rtol=1e-5, atol=1e-6)


def _same_bytes(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


def _random_csr(n, F, density, seed, ragged=True):
    rng = np.random.default_rng(seed)
    dense = (rng.random((n, F)) < density) * rng.standard_normal((n, F))
    if not ragged:
        dense[:, 0] += 1.0  # no empty row
    return sps.csr_matrix(dense.astype(np.float32))


@pytest.fixture(scope="module")
def onehot():
    """A 600 x 60 one-hot task with 6 fields, from both generators."""
    return t_syn.generate_onehot(600, 60, 6, n_fields=6, seed=0), j_syn.generate_onehot(
        600, 60, 6, n_fields=6, seed=0)


# ---------------------------------------------------------------------------
# host structures, byte for byte


@pytest.mark.parametrize("n,F,density,nnz", [(40, 17, 0.2, None), (33, 50, 0.1, 16), (8, 5, 0.9, None)])
def test_padded_rows_from_scipy_and_to_dense(n, F, density, nnz):
    csr = _random_csr(n, F, density, seed=n)
    got, want = tf.PaddedRows.from_scipy(csr, nnz), jf.PaddedRows.from_scipy(csr, nnz)
    _same_bytes(got.indices, want.indices)
    _same_bytes(got.values, want.values)
    assert got.n_cols == want.n_cols and got.shape == tuple(want.shape)
    _same_bytes(got.to_dense().numpy(), np.asarray(want.to_dense()))
    width = int(np.diff(csr.indptr).max()) + 2
    _same_bytes(tf.PaddedRows.from_dense(csr.toarray(), width).values,
                jf.PaddedRows.from_dense(csr.toarray(), width).values)


def test_padded_rows_refuses_a_row_wider_than_its_width():
    csr = _random_csr(10, 12, 0.9, seed=1)
    with pytest.raises(ValueError) as want:
        jf.PaddedRows.from_scipy(csr, 2)
    with pytest.raises(ValueError, match="exceeds width") as got:
        tf.PaddedRows.from_scipy(csr, 2)
    assert str(got.value) == str(want.value)


def _infer_cases():
    ds = t_syn.generate_onehot(120, 40, 4, n_fields=5, seed=3)
    X = ds.X_train
    bad_val = X.copy()
    bad_val.data[3] = 2.0
    ragged = sps.vstack([X[:5], sps.csr_matrix(np.eye(40, dtype=np.float32)[:1])]).tocsr()
    overlap = sps.csr_matrix(np.array([[1, 1, 0, 0], [0, 1, 1, 0]], np.float32))
    gaps = sps.csr_matrix(np.array([[0, 1, 0, 0, 1, 0], [0, 0, 1, 0, 0, 1]], np.float32))
    return {
        "onehot": X, "non_unit": bad_val, "ragged": ragged, "overlap": overlap,
        "gaps": gaps, "empty": sps.csr_matrix((0, 4), dtype=np.float32),
        "all_zero": sps.csr_matrix((3, 4), dtype=np.float32),
    }


@pytest.mark.parametrize("case", sorted(_infer_cases()))
def test_infer_field_sizes_matches_jax(case):
    csr = _infer_cases()[case]
    got, want = tf.infer_field_sizes(csr), jf.infer_field_sizes(csr)
    assert got == want
    assert (got is None) == (case not in ("onehot", "gaps"))


def test_field_onehot_from_scipy_and_refusals(onehot):
    tds, jds = onehot
    got, want = tf.FieldOnehot.from_scipy(tds.X_train), jf.FieldOnehot.from_scipy(jds.X_train)
    _same_bytes(got.local, want.local)
    assert got.field_sizes == want.field_sizes and got.n_cols == want.n_cols
    assert list(got.offsets) == list(want.offsets)
    _same_bytes(got.to_dense().numpy(), np.asarray(want.to_dense()))
    for bad in (_infer_cases()["non_unit"], _infer_cases()["overlap"]):
        with pytest.raises(ValueError) as w:
            jf.FieldOnehot.from_scipy(bad)
        with pytest.raises(ValueError) as g:
            tf.FieldOnehot.from_scipy(bad)
        assert str(g.value) == str(w.value)


SIZES = [(10, 10, 10, 10, 10), (1292, 1292, 1293), (5498,) * 4, (3, 700, 700, 2, 1),
         (1,), (2048, 1024, 1024, 2049)]


@pytest.mark.parametrize("sizes", SIZES)
@pytest.mark.parametrize("cap", [None, 4, 1 << 21, 1 << 22])
def test_greedy_pairing_matches_jax(sizes, cap):
    if cap is None:
        assert tf._greedy_pairing(sizes) == jf._greedy_pairing(sizes)
    else:
        assert tf._greedy_pairing(sizes, cap=cap) == jf._greedy_pairing(sizes, cap=cap)


@pytest.mark.parametrize("sizes", SIZES)
@pytest.mark.parametrize("lanes", [None, 1, 8, 128, 1024])
@pytest.mark.parametrize("itemsize", [2, 4])
def test_fields_margin_plan_matches_jax(sizes, lanes, itemsize):
    assert tf.fields_margin_plan(sizes, lanes, itemsize) == jf.fields_margin_plan(sizes, lanes, itemsize)


@pytest.mark.parametrize("bad", [0, 3, 2048, -4, 6])
def test_validators_match_jax_messages(bad):
    for t_fn, j_fn in ((tf.validate_lanes, jf.validate_lanes),
                       (tf.validate_margin_cols, jf.validate_margin_cols)):
        try:
            want = j_fn(bad)
        except ValueError as e:
            with pytest.raises(ValueError) as got:
                t_fn(bad)
            assert str(got.value) == str(e)
        else:
            assert t_fn(bad) == want
    assert tf.validate_lanes(None) is None and tf.validate_margin_cols(None) is None


@pytest.mark.parametrize("shape", [(4, 30, 7), (2, 3, 50, 9), (1, 5)])
def test_quantize_matches_jax_with_zero_columns(shape):
    rng = np.random.default_rng(len(shape))
    X = (rng.standard_normal(shape) * 3).astype(np.float32)
    X[..., 1] = 0.0  # an all-zero column in every block: scale 1.0
    got, want = tf.QuantizedStack.quantize(X), jf.QuantizedStack.quantize(X)
    _same_bytes(got.q, want.q)
    _same_bytes(got.scale, want.scale)
    deq = tf.to_device(got, "cpu", torch.float32).dequantize()
    np.testing.assert_allclose(deq.numpy(), np.asarray(jf.QuantizedStack(
        jnp.asarray(want.q), jnp.asarray(want.scale)).dequantize()), **TOL)
    assert (deq[..., 1] == 0).all()
    with pytest.raises(ValueError) as w:
        jf.QuantizedStack.quantize(X.astype(np.int32))
    with pytest.raises(ValueError) as g:
        tf.QuantizedStack.quantize(X.astype(np.int32))
    assert str(g.value) == str(w.value)


@pytest.mark.parametrize("n,F,P,K,seed", [(600, 60, 6, 6, 0), (240, 1000, 8, 12, 5), (90, 12, 3, 12, 1)])
def test_generate_onehot_bytes_match_jax(n, F, P, K, seed):
    got, want = t_syn.generate_onehot(n, F, P, n_fields=K, seed=seed), j_syn.generate_onehot(
        n, F, P, n_fields=K, seed=seed)
    for a, b in ((got.X_train, want.X_train), (got.X_test, want.X_test)):
        for part in ("data", "indices", "indptr"):
            _same_bytes(getattr(a, part), getattr(b, part))
        assert a.shape == b.shape
    _same_bytes(got.y_train, want.y_train)
    _same_bytes(got.y_test, want.y_test)
    assert got.name == want.name


def test_generate_onehot_refusals_match_jax():
    for args in ((601, 60, 6), (60, 4, 6)):
        with pytest.raises(ValueError) as w:
            j_syn.generate_onehot(*args, n_fields=5)
        with pytest.raises(ValueError) as g:
            t_syn.generate_onehot(*args, n_fields=5)
        assert str(g.value) == str(w.value)


def _j_dataset(ds):
    return j_syn.Dataset(ds.X_train, ds.y_train, ds.X_test, ds.y_test)


def _leaves(X):
    return [np.asarray(leaf) for leaf in jax.tree_util.tree_leaves(X)] if not isinstance(
        X, (tf.PaddedRows, tf.FieldOnehot, tf.QuantizedStack)) else [
        np.asarray(leaf) for leaf in torch.utils._pytree.tree_leaves(X)]


@pytest.mark.parametrize("fmt", ["padded", "fields", "auto"])
@pytest.mark.parametrize("data", ["onehot", "ragged"])
def test_partition_and_worker_stacks_match_jax(fmt, data, onehot):
    tds = onehot[0] if data == "onehot" else t_syn.Dataset(
        _random_csr(63, 20, 0.3, seed=2), np.ones(63, np.float32), None, None)
    jds = _j_dataset(tds)
    tl, jl = t_codes.cyclic_mds_layout(6, 2), j_codes.cyclic_mds_layout(6, 2)
    if fmt == "fields" and data == "ragged":
        with pytest.raises(ValueError) as w:
            j_sharding.partition_stack(jds, 6, sparse_format=fmt)
        with pytest.raises(ValueError) as g:
            t_sharding.partition_stack(tds, 6, sparse_format=fmt)
        assert str(g.value) == str(w.value)
        return
    tXp, typ = t_sharding.partition_stack(tds, 6, sparse_format=fmt)
    jXp, jyp = j_sharding.partition_stack(jds, 6, sparse_format=fmt)
    assert type(tXp).__name__ == type(jXp).__name__
    want_kind = "FieldOnehot" if (data == "onehot" and fmt != "padded") else "PaddedRows"
    assert type(tXp).__name__ == want_kind
    for got, want in zip(_leaves(tXp), _leaves(jXp)):
        _same_bytes(got, want)
    _same_bytes(typ, jyp)
    tXw, tyw = t_sharding.worker_stack(tl, tXp, typ)
    jXw, jyw = j_sharding.worker_stack(jl, jXp, jyp)
    for got, want in zip(_leaves(tXw), _leaves(jXw)):
        _same_bytes(got, want)
    _same_bytes(tyw, jyw)
    if want_kind == "FieldOnehot":
        assert tXw.field_sizes == jXw.field_sizes


def test_dense_fields_refusal_and_quantized_worker_gather_match_jax():
    ds = t_syn.generate_gmm(60, 7, 6, seed=0)
    with pytest.raises(ValueError) as w:
        j_sharding.partition_stack(_j_dataset(ds), 6, sparse_format="fields")
    with pytest.raises(ValueError) as g:
        t_sharding.partition_stack(ds, 6, sparse_format="fields")
    assert str(g.value) == str(w.value)
    Xp, yp = t_sharding.partition_stack(ds, 6)
    tq, jq = tf.QuantizedStack.quantize(Xp), jf.QuantizedStack.quantize(Xp)
    layout = t_codes.cyclic_mds_layout(6, 1)
    tw, _ = t_sharding.worker_stack(layout, tq, yp)
    jw, _ = j_sharding.worker_stack(j_codes.cyclic_mds_layout(6, 1), jq, yp)
    _same_bytes(tw.q, jw.q)
    _same_bytes(tw.scale, jw.scale)


@pytest.mark.parametrize("name", ["breast_cancer", "diabetes"])
def test_offline_preparers_match_jax(name):
    np.random.seed(0)
    want = j_real.PREPARERS[name]()
    np.random.seed(0)
    got = t_real.PREPARERS[name]()
    for a, b in ((got.X_train, want.X_train), (got.X_test, want.X_test)):
        for part in ("data", "indices", "indptr"):
            _same_bytes(getattr(a, part), getattr(b, part))
    _same_bytes(got.y_train, want.y_train)
    _same_bytes(got.y_test, want.y_test)
    assert got.name == want.name


@pytest.mark.parametrize("name", ["covtype", "amazon", "dna", "kc_house_data", "nope"])
def test_preparers_without_raw_files_raise_as_jax(tmp_path, name):
    try:
        j_real.prepare(name, str(tmp_path))
    except (FileNotFoundError, ValueError) as e:
        with pytest.raises(type(e)) as got:
            t_real.prepare(name, str(tmp_path))
        assert str(got.value) == str(e)
    else:  # pragma: no cover - the raw files are never on disk here
        pytest.fail(f"{name} prepared without its raw files")


def test_prepare_cli_writes_the_jax_layout_and_refuses_store(tmp_path):
    from erasurehead_tpu.data import prepare as j_prepare
    from erasurehead_tpu_torch.data import prepare as t_prepare

    args = ["real", "--dataset", "breast_cancer", "--source", ".", "--workers", "5"]
    assert t_prepare.main(args + ["--out", str(tmp_path / "t")]) == 0
    assert j_prepare.main(args + ["--out", str(tmp_path / "j")]) == 0
    tdir, jdir = tmp_path / "t" / "breast_cancer" / "5", tmp_path / "j" / "breast_cancer" / "5"
    assert sorted(p.name for p in tdir.iterdir()) == sorted(p.name for p in jdir.iterdir())
    for p in jdir.iterdir():
        assert (tdir / p.name).read_bytes() == p.read_bytes(), p.name
    with pytest.raises(NotImplementedError, match="--store"):
        t_prepare.main(args + ["--out", str(tmp_path / "s"), "--store", str(tmp_path / "st")])


# ---------------------------------------------------------------------------
# products, allclose


def _fields_case(onehot, lead=None):
    tds, _ = onehot
    X = tf.FieldOnehot.from_scipy(tds.X_train)
    if lead is not None:
        X = dataclasses.replace(X, local=X.local.reshape(lead + (-1, X.local.shape[-1])))
    return X


def _set_jax_modes(margin, scatter, lanes):
    jf.set_fields_margin(margin)
    jf.set_fields_scatter(scatter)
    jf.set_sparse_lanes(lanes)


@pytest.fixture
def jax_modes():
    yield _set_jax_modes
    _set_jax_modes("tables", "pairs", None)


FIELD_MODES = [("tables", "pairs", None), ("tables", "pairs", 8), ("tables", "onehot", None),
               ("onehot", "pairs", None), ("onehot", "onehot", None), ("tables", "onehot", 8)]


@pytest.mark.parametrize("margin,scatter,lanes", FIELD_MODES)
@pytest.mark.parametrize("H", [None, 5])
def test_fields_products_match_jax(onehot, jax_modes, margin, scatter, lanes, H):
    jax_modes(margin, scatter, lanes)
    Xh = _fields_case(onehot)
    jX = jf.FieldOnehot(jnp.asarray(Xh.local), Xh.field_sizes, Xh.n_cols)
    X = tf.to_device(Xh, "cpu", torch.float32).with_lowering(margin, scatter, lanes)
    rng = np.random.default_rng(7)
    v = rng.standard_normal((60,) if H is None else (60, H)).astype(np.float32)
    r = rng.standard_normal((600,) if H is None else (600, H)).astype(np.float32)
    np.testing.assert_allclose(tf.matvec(X, torch.from_numpy(v)).numpy(),
                               np.asarray(jf.matvec(jX, jnp.asarray(v))), **TOL)
    np.testing.assert_allclose(tf.rmatvec(X, torch.from_numpy(r)).numpy(),
                               np.asarray(jf.rmatvec(jX, jnp.asarray(r))), **TOL)


@pytest.mark.parametrize("margin,scatter", [("tables", "pairs"), ("onehot", "onehot")])
def test_fields_per_slot_products_match_jax_vmap(onehot, jax_modes, margin, scatter):
    """Leading (slot) dims: one product a slot, as JAX's per-slot vmap."""
    jax_modes(margin, scatter, None)
    Xh = _fields_case(onehot, lead=(3, 2))  # [3, 2, 100, K]
    X = tf.to_device(Xh, "cpu", torch.float32).with_lowering(margin, scatter)
    rng = np.random.default_rng(8)
    v = rng.standard_normal(60).astype(np.float32)
    r = rng.standard_normal((3, 2, 100)).astype(np.float32)
    loc = jnp.asarray(Xh.local)

    def j_slot(fn, arg, l, a):
        return fn(jf.FieldOnehot(l, Xh.field_sizes, Xh.n_cols), a)

    want_m = jax.vmap(jax.vmap(lambda l: j_slot(jf.matvec, None, l, jnp.asarray(v))))(loc)
    want_r = jax.vmap(jax.vmap(lambda l, a: j_slot(jf.rmatvec, None, l, a)))(loc, jnp.asarray(r))
    np.testing.assert_allclose(tf.matvec(X, torch.from_numpy(v)).numpy(), np.asarray(want_m), **TOL)
    np.testing.assert_allclose(tf.rmatvec(X, torch.from_numpy(r)).numpy(), np.asarray(want_r), **TOL)


@pytest.mark.parametrize("lanes", [None, 8])
@pytest.mark.parametrize("H", [None, 4])
@pytest.mark.parametrize("lead", [(), (4,), (2, 3)])
def test_padded_products_match_jax(jax_modes, lanes, H, lead):
    jax_modes("tables", "pairs", lanes)
    M = int(np.prod(lead))
    csr = _random_csr(20 * M, 30, 0.2, seed=M)
    nnz = int(np.diff(csr.indptr).max()) + 1  # one padding entry a row at least
    Ph = tf.PaddedRows.from_scipy(csr, nnz)
    jP = jf.PaddedRows(jnp.asarray(Ph.indices), jnp.asarray(Ph.values), Ph.n_cols)
    P = tf.to_device(tf.PaddedRows(Ph.indices.reshape(lead + (20, nnz)),
                                   Ph.values.reshape(lead + (20, nnz)), 30), "cpu", torch.float32)
    rng = np.random.default_rng(9)
    v = rng.standard_normal((30,) if H is None else (30, H)).astype(np.float32)
    r = rng.standard_normal((20 * M,) if H is None else (20 * M, H)).astype(np.float32)
    want_m = np.asarray(jf.matvec(jP, jnp.asarray(v))).reshape(lead + (20,) + v.shape[1:])
    np.testing.assert_allclose(tf.matvec(P, torch.from_numpy(v)).numpy(), want_m, **TOL)
    # per-slot scatter: one X_m^T r_m a slot
    rs = r.reshape((M, 20) + r.shape[1:])
    want_r = np.stack([np.asarray(jf.rmatvec(
        jf.PaddedRows(jP.indices[m * 20:(m + 1) * 20], jP.values[m * 20:(m + 1) * 20], 30),
        jnp.asarray(rs[m]))) for m in range(M)])
    got_r = tf.rmatvec(P, torch.from_numpy(r.reshape(lead + (20,) + r.shape[1:]))).numpy()
    np.testing.assert_allclose(got_r.reshape(want_r.shape), want_r, **TOL)


def test_flatten_rows_matches_jax(onehot):
    Xh = _fields_case(onehot, lead=(3, 2))
    flat = tf.flatten_rows(tf.to_device(Xh, "cpu", torch.float32))
    jflat = jf.flatten_rows(jf.FieldOnehot(jnp.asarray(Xh.local), Xh.field_sizes, Xh.n_cols))
    _same_bytes(flat.local.numpy(), jflat.local)
    assert tf.n_rows(flat) == jf.n_rows(jflat)
    P = tf.PaddedRows(np.zeros((2, 3, 4, 5), np.int32), np.ones((2, 3, 4, 5), np.float32), 9)
    assert tf.flatten_rows(tf.to_device(P, "cpu", torch.float32)).indices.shape == (24, 5)
    dense = torch.zeros(2, 3, 4, 5)
    assert tf.flatten_rows(dense).shape == (24, 5)


def test_scatter_is_deterministic_and_matches_index_add():
    """The segment sum equals an index_add over the same entries, and a
    rerun gives the same bits (the card's rerun check is the cuda test in
    tests/test_torch_sparse_train.py)."""
    g = torch.Generator().manual_seed(0)
    keys = torch.randint(0, 50, (4000,), generator=g)
    contrib = torch.randn(4000, 3, generator=g)
    seg = tf._Segments.of(keys, 64)
    got = seg.sum(contrib)
    want = torch.zeros(64, 3).index_add_(0, keys, contrib)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert torch.equal(got, seg.sum(contrib))
    assert (got[50:] == 0).all()
    batched = torch.func.vmap(seg.sum)(torch.stack([contrib, 2 * contrib]))
    assert torch.equal(batched[0], got)
    torch.testing.assert_close(batched[1], 2 * got)
