"""The port's on-disk loader, dataset resolution and legacy CLI form against
the JAX package.

The reader must return the same bytes as the JAX reader on layouts the JAX
writer produced (dense text and CSR); the CLI must resolve the same dataset
directory and generate the same data, with the partial schemes' (p - s) * W
partitions; the reference's 13-positional form must give the JAX config and
the JAX artifact names.
"""

import dataclasses
import os
import shutil

import numpy as np
import pytest
import scipy.sparse as sps

from erasurehead_tpu import cli as j_cli
from erasurehead_tpu.data import io as j_io
from erasurehead_tpu.data.synthetic import Dataset as JDataset
from erasurehead_tpu.data.synthetic import generate_gmm as j_generate_gmm
from erasurehead_tpu_torch import cli as t_cli
from erasurehead_tpu_torch.data import io as t_io
from erasurehead_tpu_torch.utils.config import RunConfig

ARTIFACTS = ("training_loss", "testing_loss", "auc", "timeset", "worker_timeset")


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype, a.shape, b.shape)
    assert a.tobytes() == b.tobytes()


def _same_dataset(got, want):
    for field in ("X_train", "X_test"):
        a, b = getattr(got, field), getattr(want, field)
        if sps.issparse(b):
            assert sps.issparse(a)
            for part in ("data", "indices", "indptr"):
                _same(getattr(a, part), getattr(b, part))
            assert a.shape == b.shape
        else:
            _same(a, b)
    _same(got.y_train, want.y_train)
    _same(got.y_test, want.y_test)
    assert got.name == want.name


# ---------------------------------------------------------------------------
# the reference-layout reader
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sparse", [False, True], ids=["dense_text", "csr"])
def test_reader_returns_the_jax_bytes(tmp_path, sparse):
    """Cold loads of two copies of one JAX-written layout, then the port's
    warm (cached, memory-mapped) load of the JAX side's copy."""
    ds = j_generate_gmm(120, 9, 4, seed=3)
    if sparse:
        X = ds.X_train.copy()
        X[np.abs(X) < 1.0] = 0.0
        Xt = ds.X_test.copy()
        Xt[np.abs(Xt) < 1.0] = 0.0
        ds = JDataset(sps.csr_matrix(X), ds.y_train, sps.csr_matrix(Xt), ds.y_test)
    jdir, tdir = tmp_path / "jax" / "4", tmp_path / "torch" / "4"
    j_io.write_reference_layout(ds, str(jdir), 4)
    shutil.copytree(jdir, tdir)
    assert t_io.has_reference_layout(str(tdir))
    assert t_io.layout_is_sparse(str(tdir)) == sparse
    want = j_io.read_reference_layout(str(jdir), 4)
    _same_dataset(t_io.read_reference_layout(str(tdir), 4), want)
    _same_dataset(t_io.read_reference_layout(str(jdir), 4), want)


def test_port_writer_round_trips_through_the_jax_reader(tmp_path):
    ds = t_cli.generate_gmm(96, 7, 4, seed=1)
    t_io.write_reference_layout(ds, str(tmp_path / "a"), 4)
    j_io.write_reference_layout(ds, str(tmp_path / "b"), 4)
    for name in ("1.dat", "4.dat", "label.dat", "test_data.dat", "label_test.dat"):
        assert (tmp_path / "a" / name).read_bytes() == (tmp_path / "b" / name).read_bytes()
    got = j_io.read_reference_layout(str(tmp_path / "a"), 4)
    _same(got.X_train, ds.X_train.astype(np.float64))


def test_dense_text_cache_is_bitwise_and_refreshed(tmp_path):
    path = str(tmp_path / "m.dat")
    m = np.random.default_rng(0).standard_normal((5, 3))
    t_io.save_dense_text(path, m)
    cold = t_io.load_dense_text(path)
    assert os.path.exists(path + ".npy")
    warm = t_io.load_dense_text(path)
    assert isinstance(warm, np.memmap)
    _same(np.asarray(warm), cold)
    _same(cold, np.loadtxt(path))


# ---------------------------------------------------------------------------
# dataset resolution and the partition-count repair
# ---------------------------------------------------------------------------

PARTIAL = dict(
    scheme="partialrepcoded", n_workers=4, n_stragglers=1,
    partitions_per_worker=4, n_rows=96, n_cols=8,
)


@pytest.mark.parametrize(
    "kw",
    [
        PARTIAL,
        {**PARTIAL, "scheme": "partialcyccoded", "partitions_per_worker": 3},
        dict(scheme="approx", n_workers=4, n_stragglers=1, n_rows=96, n_cols=8),
        dict(scheme="naive", n_workers=4, n_rows=96, n_cols=8, model="linear"),
    ],
)
def test_generated_dataset_is_the_jax_one(kw):
    """No layout on disk: the same synthetic bytes, drawn over (p - s) * W
    partitions for the partial schemes."""
    from erasurehead_tpu.utils.config import RunConfig as JRunConfig

    tcfg, jcfg = RunConfig(**kw), JRunConfig(**kw)
    got, want = t_cli.load_dataset(tcfg), j_cli.load_dataset(jcfg)
    _same_dataset(got, want)
    if tcfg.partitions_per_worker:
        assert t_cli.n_partitions(tcfg) == (
            tcfg.partitions_per_worker - tcfg.n_stragglers
        ) * tcfg.n_workers


@pytest.mark.parametrize(
    "kw",
    [
        PARTIAL,
        dict(scheme="approx", n_workers=4, n_stragglers=1, n_rows=96, n_cols=8),
        dict(dataset="covtype", is_real_data=True),
    ],
)
def test_dataset_dir_is_the_jax_one(tmp_path, kw):
    from erasurehead_tpu.utils.config import RunConfig as JRunConfig

    kw = {**kw, "input_dir": str(tmp_path)}
    assert t_cli.dataset_dir(RunConfig(**kw)) == j_cli.dataset_dir(JRunConfig(**kw))


def test_partial_layout_on_disk_loads_like_jax(tmp_path):
    """A JAX-written layout under partial/<(p - s) * W> loads to the JAX
    bytes."""
    from erasurehead_tpu.utils.config import RunConfig as JRunConfig

    kw = {**PARTIAL, "input_dir": str(tmp_path)}
    path = j_cli.dataset_dir(JRunConfig(**kw))
    assert path.endswith(os.path.join("partial", "12"))
    j_io.write_reference_layout(j_generate_gmm(96, 8, 12, seed=4), path, 12)
    _same_dataset(t_cli.load_dataset(RunConfig(**kw)), j_cli.load_dataset(JRunConfig(**kw)))


@pytest.mark.parametrize("with_input_dir", [True, False])
@pytest.mark.parametrize("dataset", ["covtype", "kc_house_data"])
def test_real_dataset_without_a_layout_raises(tmp_path, dataset, with_input_dir):
    """A real dataset's name never trains on generated data: without its
    layout on disk the loader raises, whether or not an input dir is given
    (the JAX CLI generates data when none is)."""
    input_dir = str(tmp_path) if with_input_dir else None
    cfg = RunConfig(dataset=dataset, is_real_data=with_input_dir, input_dir=input_dir)
    with pytest.raises(FileNotFoundError, match=dataset):
        t_cli.load_dataset(cfg)


def test_cli_refuses_a_real_dataset_name_without_input_dir(tmp_path):
    with pytest.raises(FileNotFoundError, match="covtype"):
        t_cli.main([
            "--dataset", "covtype", "--rounds", "2", "--device", "cpu", "--quiet",
            "--output-dir", str(tmp_path),
        ])
    assert not os.listdir(tmp_path)


# ---------------------------------------------------------------------------
# the legacy 13-positional form
# ---------------------------------------------------------------------------


def _legacy(n_procs, is_real, dataset, is_coded, s, partitions, coded_ver,
            num_collect, add_delay="1", rule="AGD", rows=96, cols=8, input_dir="data"):
    return [str(v) for v in (
        n_procs, rows, cols, input_dir, is_real, dataset, is_coded, s,
        partitions, coded_ver, num_collect, add_delay, rule,
    )]


LEGACY_GRID = [
    _legacy(5, 0, "artificial", 0, 1, 0, 0, 0),  # naive
    _legacy(5, 0, "artificial", 1, 1, 0, 0, 0),  # cyccoded
    _legacy(5, 0, "artificial", 1, 1, 0, 1, 0, "0", "GD"),  # repcoded
    _legacy(5, 0, "artificial", 1, 1, 0, 2, 0),  # avoidstragg
    _legacy(5, 0, "artificial", 1, 1, 0, 3, 2),  # approx, collect 2
    _legacy(5, 0, "artificial", 1, 1, 4, 0, 0),  # partialcyccoded
    _legacy(5, 0, "artificial", 1, 1, 4, 1, 0),  # partialrepcoded
    _legacy(9, 1, "kc_house_data", 1, 1, 0, 3, 4),  # linear model, real data
    _legacy(9, 1, "covtype", 0, 0, 0, 0, 0, "0", "ADAM"),
]


@pytest.mark.parametrize("argv", LEGACY_GRID, ids=lambda a: "-".join(a[4:11]))
def test_legacy_config_is_the_jax_config(argv):
    got, want = t_cli._legacy_to_config(argv), j_cli._legacy_to_config(argv)
    for field in dataclasses.fields(got):
        a, b = getattr(got, field.name), getattr(want, field.name)
        assert getattr(a, "value", a) == getattr(b, "value", b), field.name
    assert t_cli._is_legacy(argv)
    assert t_cli._is_legacy(argv + ["--device", "cpu"])
    assert not t_cli._is_legacy(["--scheme", "approx"] + argv[:11])


@pytest.mark.parametrize("partitions,coded_ver", [(0, 4), (3, 2)])
def test_legacy_refuses_a_bad_coded_ver_with_the_jax_message(partitions, coded_ver):
    argv = _legacy(5, 0, "artificial", 1, 1, partitions, coded_ver, 0)
    with pytest.raises(SystemExit) as want:
        j_cli._legacy_to_config(argv)
    with pytest.raises(SystemExit) as got:
        t_cli._legacy_to_config(argv)
    assert str(got.value) == str(want.value)


def test_legacy_real_data_needs_its_layout(tmp_path):
    argv = _legacy(5, 1, "covtype", 0, 1, 0, 0, 0, input_dir=tmp_path)
    with pytest.raises(FileNotFoundError):
        t_cli.main(argv + ["--device", "cpu", "--quiet"])


def test_legacy_run_writes_the_jax_artifact_names(tmp_path):
    """The same 13 arguments (each CLI under its own input dir): the same
    result directory and artifact names, the same simulated clocks."""
    jargv = _legacy(5, 0, "artificial", 1, 1, 4, 1, 0, rows=48, input_dir=tmp_path / "j")
    targv = _legacy(5, 0, "artificial", 1, 1, 4, 1, 0, rows=48, input_dir=tmp_path / "t")
    assert j_cli.main(jargv) == 0
    assert t_cli.main(targv + ["--device", "cpu", "--quiet"]) == 0
    sub = os.path.join("artificial-data", "48x8", "partial", "12", "results")
    jres, tres = tmp_path / "j" / sub, tmp_path / "t" / sub
    names = sorted(os.listdir(tres))
    assert names == sorted(os.listdir(jres))
    assert "partialreplication_1_4_timeset.dat" in names
    for name in names:
        if name.endswith("timeset.dat"):
            assert (tres / name).read_bytes() == (jres / name).read_bytes()


def test_legacy_and_named_flags_agree_on_a_reference_layout(tmp_path):
    """The 13-positional form and the named-flag form of one run on one
    reference layout: bitwise-equal artifacts (the CPU twin of the card's
    ``legacy`` phase)."""
    t_io.write_reference_layout(
        t_cli.generate_gmm(256, 10, 4, seed=0),
        str(tmp_path / "artificial-data" / "256x10" / "4"), 4,
    )
    argv = _legacy(5, 0, "artificial", 1, 1, 0, 3, 2, rows=256, cols=10, input_dir=tmp_path)
    common = ["--rounds", "4", "--device", "cpu", "--quiet"]
    assert t_cli.main(argv + common + ["--output-dir", str(tmp_path / "legacy")]) == 0
    assert t_cli.main([
        "--scheme", "approx", "--workers", "4", "--stragglers", "1",
        "--num-collect", "2", "--rows", "256", "--cols", "10",
        "--input-dir", str(tmp_path), "--add-delay", "--update-rule", "AGD",
        "--output-dir", str(tmp_path / "flags"),
    ] + common) == 0
    for art in ARTIFACTS:
        a = (tmp_path / "legacy" / f"approx_acc_1_{art}.dat").read_bytes()
        assert a == (tmp_path / "flags" / f"approx_acc_1_{art}.dat").read_bytes(), art
    # the on-disk data, not a generated stand-in, was trained on
    assert (tmp_path / "artificial-data" / "256x10" / "4" / "1.dat.npy").exists()
