"""Dataset preparation CLI: the reference's generate_data.py /
arrange_real_data.py / data_prepare.sh rolled into one entry point (the
port's copy of erasurehead_tpu/data/prepare.py).

Synthetic (reference: ``make generate_random_data`` -> generate_data.py)::

    python -m erasurehead_tpu_torch.data.prepare synthetic --rows 4096 \\
        --cols 100 --workers 30 --out ./straggdata

Real (reference: data_prepare.sh -> arrange_real_data.py)::

    python -m erasurehead_tpu_torch.data.prepare real --dataset breast_cancer \\
        --source . --workers 30 --out ./straggdata

Both write the reference's on-disk layout (per-partition files + labels +
test split) under the reference's directory naming
(generate_data.py:59-62, arrange_real_data.py:71-77), so prepared data is
interchangeable between the reference, the JAX package and the port.
``--partial`` mirrors the partial schemes' partition count
(n_procs-1)*(n_partitions-n_stragglers). Nothing is fetched: a real
dataset's raw files must be on disk (breast_cancer and diabetes ship with
scikit-learn).

``--store DIR`` also writes an out-of-core shard store (data/store.py),
the input of ``stack_residency="streamed"`` runs
(``store.open_store(DIR).dataset()``); ``--store-dtype int8`` quantizes the
partitions at write time (about 4x fewer disk and transfer bytes; the run
must use ``stack_dtype="int8"``).
"""

from __future__ import annotations

import argparse
import os
import sys

from erasurehead_tpu_torch.data import io as data_io
from erasurehead_tpu_torch.data import real as real_data
from erasurehead_tpu_torch.data import store as store_lib
from erasurehead_tpu_torch.data.synthetic import generate_gmm


def _n_partitions(ns) -> int:
    if ns.partial:
        return ns.workers * (ns.partitions_per_worker - ns.stragglers)
    return ns.workers


def _leaf(ns) -> str:
    return f"partial/{_n_partitions(ns)}" if ns.partial else str(ns.workers)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="erasurehead_tpu_torch.data.prepare")
    sub = p.add_subparsers(dest="cmd", required=True)

    ps = sub.add_parser("synthetic", help="generate the GMM logistic task")
    ps.add_argument("--rows", type=int, default=4096)
    ps.add_argument("--cols", type=int, default=100)
    ps.add_argument("--seed", type=int, default=0)

    pr = sub.add_parser("real", help="preprocess a real dataset")
    pr.add_argument("--dataset", required=True, choices=sorted(real_data.PREPARERS))
    pr.add_argument("--source", required=True, help="dir with the raw files")

    for q in (ps, pr):
        q.add_argument("--workers", type=int, default=30)
        q.add_argument("--out", default="./straggdata")
        q.add_argument("--partial", action="store_true")
        q.add_argument("--stragglers", type=int, default=0)
        q.add_argument("--partitions-per-worker", type=int, default=0)
        q.add_argument("--store", default=None, metavar="DIR",
                       help="ALSO write an out-of-core shard store (data/store.py) "
                            "here — the stack_residency=streamed input")
        q.add_argument("--store-dtype", default="float32", choices=("float32", "int8"),
                       help="on-disk shard dtype: int8 quantizes partitions at "
                            "write time (~4x smaller disk + PCIe; requires the run to "
                            "use stack_dtype=int8)")

    ns = p.parse_args(argv)
    if ns.partial and ns.partitions_per_worker < ns.stragglers + 2:
        p.error(
            "--partial needs --partitions-per-worker >= --stragglers + 2 "
            f"(got {ns.partitions_per_worker} vs s={ns.stragglers})"
        )
    parts = _n_partitions(ns)

    if ns.cmd == "synthetic":
        ds = generate_gmm(ns.rows, ns.cols, parts, seed=ns.seed)
        out = os.path.join(ns.out, f"artificial-data/{ns.rows}x{ns.cols}", _leaf(ns))
    else:
        ds = real_data.prepare(ns.dataset, ns.source)
        out = os.path.join(ns.out, ns.dataset, _leaf(ns))

    data_io.write_reference_layout(ds, out, parts)
    rows = ds.n_samples // parts
    print(
        f"wrote {parts} partitions x {rows} rows "
        f"({ds.n_samples} train, {ds.X_test.shape[0]} test, "
        f"{ds.n_features} features) -> {out}"
    )
    if ns.store:
        st = store_lib.write_store(ds, ns.store, parts, stack_dtype=ns.store_dtype)
        print(
            f"wrote shard store ({ns.store_dtype}, "
            f"{len(st.meta['shard_parts'])} shards, digest {st.digest}) "
            f"-> {ns.store}"
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
