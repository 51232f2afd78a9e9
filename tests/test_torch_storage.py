"""Storage of the torch port against the JAX package at SF0.01.

Every column of every TPC-H table must be bit-equal in value and in its
narrowed storage type, with equal dictionaries, zone maps, domains,
sortedness and primary-key luts, both for the port's own loader and for the
catalog carried over from the reference by `from_reference_catalog`.
"""

import numpy as np
import pytest
import torch

from duckdb_cubit_tpu.tpch import load as ref_load
from duckdb_cubit_tpu_torch.storage import table as port_table
from duckdb_cubit_tpu_torch.tpch import load as port_load

TABLES = ["region", "nation", "supplier", "customer", "part", "partsupp",
          "orders", "lineitem"]


@pytest.fixture(scope="module")
def ref_catalog():
    return ref_load.load_catalog(0.01)


@pytest.fixture(scope="module")
def catalogs(ref_catalog):
    return {"generated": port_load.load_catalog(0.01, device="cpu"),
            "carried": port_load.from_reference_catalog(ref_catalog,
                                                        device="cpu")}


def _dt(d):
    """A DataType of either package as comparable plain values."""
    return d.id.value, d.scale


def _same(a, b):
    if a is None or b is None:
        return a is None and b is None
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


@pytest.mark.parametrize("source", ["generated", "carried"])
@pytest.mark.parametrize("name", TABLES)
def test_table_bit_equal(ref_catalog, catalogs, source, name):
    rt = ref_catalog.table(name)
    pt = catalogs[source].table(name)
    assert (pt.num_rows, pt.capacity) == (rt.num_rows, rt.capacity)
    assert pt.unique_keys == rt.unique_keys
    assert pt.device == torch.device("cpu")
    assert list(pt.columns) == list(rt.columns)
    for cname, rc in rt.columns.items():
        pc = pt.columns[cname]
        assert _dt(pc.dtype) == _dt(rc.dtype), cname
        assert pc.data.device == torch.device("cpu")
        assert _same(pc.data.numpy(), rc.data), cname
        assert _same(pc.host, rc.host), cname
        assert _same(pc.dictionary, rc.dictionary), cname
        assert _same(pc.domain, rc.domain), cname
        assert (pc.zone_map is None) == (rc.zone_map is None), cname
        if rc.zone_map is not None:
            assert _same(pc.zone_map.mins, rc.zone_map.mins), cname
            assert _same(pc.zone_map.maxs, rc.zone_map.maxs), cname
        assert pc.is_sorted == rc.is_sorted, cname
        assert _same(None if pc.nulls is None else pc.nulls.numpy(),
                     rc.nulls), cname
    assert set(pt.pk_indexes) == set(rt.pk_indexes)
    for cname, rpk in rt.pk_indexes.items():
        ppk = pt.pk_indexes[cname]
        assert ppk.max_key == rpk.max_key
        # the port's table starts at the smallest key, the JAX package's
        # at key 0
        assert ppk.base == int(np.flatnonzero(np.asarray(rpk.lut) >= 0)[0])
        assert (np.asarray(rpk.lut)[:ppk.base] == -1).all()
        assert _same(ppk.lut.numpy(), np.asarray(rpk.lut)[ppk.base:])


@pytest.mark.parametrize("source", ["generated", "carried"])
def test_catalog_schema_registry(ref_catalog, catalogs, source):
    cat = catalogs[source]
    assert cat.foreign_keys == ref_catalog.foreign_keys
    assert set(cat.tables) == set(ref_catalog.tables)
    assert cat.placement == "default"


def test_load_catalog_caches_per_device():
    a = port_load.load_catalog(0.01, device="cpu")
    assert port_load.load_catalog(0.01, device="cpu") is a


@pytest.mark.parametrize("values,expect", [
    (np.array([1, 100, -5], np.int64), np.int8),
    (np.array([1, 127], np.int64), np.int16),       # strict bounds headroom
    (np.array([0, 40000], np.int64), np.int32),
    (np.array([0, 2**40], np.int64), np.int64),
])
def test_narrow_int_codec_matches_reference(values, expect):
    from duckdb_cubit_tpu import types as ref_types
    from duckdb_cubit_tpu.storage import table as ref_table
    from duckdb_cubit_tpu_torch import types as port_types

    ours = port_table._narrow_int(values, port_types.INT64, len(values))
    ref = ref_table._narrow_int(values, ref_types.INT64, len(values))
    assert ours.dtype == ref.dtype == expect
    assert np.array_equal(ours, ref)


def test_from_numpy_matches_reference_ingest():
    from duckdb_cubit_tpu.storage import table as ref_table

    rng = np.random.default_rng(5)
    n = 9000
    data = {"k": np.arange(n, dtype=np.int64),
            "v": rng.integers(-50, 50, n).astype(np.int64),
            "f": rng.random(n),
            "s": rng.choice(np.array([b"x", b"yy", b"zzz"]), n),
            "c": rng.integers(65, 70, n).astype(np.uint8)}
    ref = ref_table.from_numpy("t", data)
    ours = port_table.from_numpy("t", data, device="cpu")
    assert ours.capacity == ref.capacity
    for name in data:
        assert _same(ours.columns[name].data.numpy(), ref.columns[name].data)
        assert _dt(ours.columns[name].dtype) == _dt(ref.columns[name].dtype)
        assert ours.columns[name].is_sorted == ref.columns[name].is_sorted
    assert torch.equal(ours.row_mask(),
                       torch.as_tensor(np.array(ref.row_mask())))


def test_snapshot_restore_keeps_tables():
    cat = port_table.Catalog()
    cat.register(port_table.from_numpy(
        "t", {"a": np.arange(10, dtype=np.int64)}, device="cpu"))
    snap = cat.snapshot()
    cat.drop("t")
    assert "t" not in cat.tables
    cat.restore(snap)
    assert cat.table("t").num_rows == 10
