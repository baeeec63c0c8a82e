"""The port's parameter-server tables (``paddle_tpu_torch.distributed.ps.
tables``) against the JAX package's, on the same seeded numpy inputs:

- both run on the native core of ``csrc/ps_table.cc`` (the port's build in
  ``build/paddle_tpu_torch/ps_table-*.so``, the reference's its own): rows
  bit-equal for the same seed, SGD and Adagrad updates bit-equal, the
  export order equal; a test fails when the port's tables are not native;
- the reference's numpy fallback, kept in the port: equal to the
  reference's fallback and unlike the native rows (so a silent fallback
  would show);
- the text dumps (``part-%03d``, modes 0 and 3) byte for byte, each
  package loading the other's;
- ``CtrAccessor`` decay and shrink, ``SsdSparseTable`` spill, compaction
  and restart (files byte for byte), the ``Entry`` configs.
"""
import json
import os

import numpy as np
import pytest

from paddle_tpu.distributed.ps import tables as RT
from paddle_tpu_torch.distributed.ps import tables as PT
from paddle_tpu_torch.runtime import native


def _ids(rs, n, hi=500):
    return rs.randint(0, hi, n).astype(np.int64)


def _sorted_state(table):
    ids, rows, acc = table.export_state()
    order = np.argsort(ids)
    return ids[order], rows[order], acc[order]


def test_port_tables_are_native():
    assert PT.native_tables(), native.PS_TABLE.error
    assert native.PS_TABLE.native and native.PS_TABLE.error is None
    assert native.PS_TABLE.path().name.startswith("ps_table-")
    assert RT._lib() is not None  # the reference's own build
    t = PT.SparseTable(4)
    assert t._h  # the table lives in the native core


@pytest.mark.parametrize("optimizer", ["sgd", "adagrad"])
@pytest.mark.parametrize("seed,dim", [(0, 4), (7, 9)])
def test_sparse_rows_and_updates_bit_equal(optimizer, seed, dim):
    rs = np.random.RandomState(seed)
    tabs = [P.SparseTable(dim, optimizer, lr=0.05, seed=seed,
                          init_range=0.05) for P in (RT, PT)]
    ids = _ids(rs, 64)  # duplicates included
    a, b = (t.pull(ids) for t in tabs)
    np.testing.assert_array_equal(a, b)
    for _ in range(3):
        step = _ids(rs, 48)
        g = rs.randn(step.size, dim).astype(np.float32)
        for t in tabs:
            t.push_grad(step, g)
    np.testing.assert_array_equal(*(t.pull(ids) for t in tabs))
    assert tabs[0].size() == tabs[1].size()
    for x, y in zip(*(t.export_state() for t in tabs)):
        np.testing.assert_array_equal(x, y)  # the export order too
    erase = ids[:5]
    assert tabs[0].erase(erase) == tabs[1].erase(erase)
    for x, y in zip(*(t.export() for t in tabs)):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("optimizer", ["sgd", "adagrad"])
def test_dense_updates_bit_equal(optimizer):
    rs = np.random.RandomState(3)
    tabs = [P.DenseTable(33, optimizer, lr=0.1) for P in (RT, PT)]
    init = rs.randn(33).astype(np.float32)
    for t in tabs:
        t.assign(init)
    for _ in range(4):
        g1, g2 = rs.randn(2, 33).astype(np.float32)
        norms = []
        for t in tabs:
            t.push_grad(g1)
            t.push_grad(g2)  # accumulates until the apply
            norms.append(t.apply())
        assert norms[0] == norms[1]
    np.testing.assert_array_equal(tabs[0].read(), tabs[1].read())
    np.testing.assert_array_equal(tabs[0].read_acc(), tabs[1].read_acc())


def test_numpy_fallback_is_the_references(monkeypatch):
    monkeypatch.setattr(RT, "_lib", lambda: None)
    monkeypatch.setattr(PT, "_lib", lambda: None)
    rs = np.random.RandomState(5)
    tabs = [P.SparseTable(4, "adagrad", lr=0.1, seed=11) for P in (RT, PT)]
    assert all(t._h is None for t in tabs)
    ids = _ids(rs, 20, 30)
    first = [t.pull(ids) for t in tabs]
    np.testing.assert_array_equal(*first)
    g = rs.randn(ids.size, 4).astype(np.float32)
    for t in tabs:
        t.push_grad(ids, g)
    np.testing.assert_array_equal(*(t.pull(ids) for t in tabs))
    dense = [P.DenseTable(6, "adagrad", lr=0.5) for P in (RT, PT)]
    for t in dense:
        assert t._h is None
        t.assign(np.arange(6, dtype=np.float32))
        t.push_grad(np.ones(6, np.float32))
    assert dense[0].apply() == dense[1].apply()
    np.testing.assert_array_equal(dense[0].read(), dense[1].read())
    monkeypatch.undo()
    # the native core draws each id's row otherwise: a silent fallback
    # would change every row
    nat = PT.SparseTable(4, "adagrad", lr=0.1, seed=11)
    assert nat._h
    assert not np.array_equal(nat.pull(ids), first[1])


def _read_tree(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for name in files:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


@pytest.mark.parametrize("mode", [0, 3])
def test_text_dumps_byte_equal_and_cross_load(tmp_path, mode):
    rs = np.random.RandomState(mode)
    sparse = [P.SparseTable(4, "adagrad", lr=0.1, seed=7) for P in (RT, PT)]
    dense = [P.DenseTable(10, "adagrad", lr=0.1) for P in (RT, PT)]
    ids = _ids(rs, 40, 100)
    g = rs.rand(ids.size, 4).astype(np.float32)
    dg = rs.randn(10).astype(np.float32)
    for s, d in zip(sparse, dense):
        s.pull(ids)
        s.push_grad(ids, g)
        d.assign(np.arange(10, dtype=np.float32))
        d.push_grad(dg)
        d.apply()
    dirs = [tmp_path / "ref", tmp_path / "port"]
    for root, s, d in zip(dirs, sparse, dense):
        assert s.save_text(root, table_id=1, mode=mode).endswith(
            "part-000-00000")
        assert d.save_text(root, table_id=2, mode=mode).endswith("part-000")
    ref, port = (_read_tree(d) for d in dirs)
    assert sorted(ref) == sorted(port) == ["1/part-000-00000",
                                           "2/part-000"]
    assert ref == port
    # each package loads the other's dump
    for P, root, other in ((PT, dirs[0], sparse[0]), (RT, dirs[1],
                                                       sparse[1])):
        s = P.SparseTable(4, "adagrad", lr=0.1, seed=99)
        s.pull(np.array([777]))  # a stale row the restore clears
        assert s.load_text(root, table_id=1) == np.unique(ids).size
        want, got = _sorted_state(other), _sorted_state(s)
        np.testing.assert_array_equal(want[0], got[0])
        np.testing.assert_array_equal(want[1], got[1])
        if mode == 0:
            np.testing.assert_array_equal(want[2], got[2])
        else:
            assert not got[2].any()  # weights only: accumulators reset
        d = P.DenseTable(10, "adagrad", lr=0.1)
        assert d.load_text(root, table_id=2) == 10
        np.testing.assert_array_equal(d.read(), dense[0].read())
    for P in (RT, PT):
        with pytest.raises(ValueError, match="not supported"):
            P.SparseTable(4).save_text(tmp_path / "x", mode=1)
        with pytest.raises(ValueError, match="table size"):
            P.DenseTable(4).load_text(dirs[0], table_id=2)


def test_ctr_accessor_decay_and_shrink_equal():
    out = []
    for P in (RT, PT):
        t = P.SparseTable(dim=4, seed=0)
        acc = P.CtrAccessor(t, show_coeff=1.0, click_coeff=10.0,
                            decay_rate=0.5)
        ids = np.arange(40, dtype=np.int64)
        t.pull(ids)
        r = np.random.RandomState(8)
        acc.update(ids, shows=r.randint(0, 6, 40), clicks=r.randint(0, 2, 40))
        acc.decay()
        scores = [acc.score(i) for i in ids]
        removed = acc.shrink(2.0)
        left, rows = t.export()
        order = np.argsort(left)
        out.append((scores, removed, left[order], rows[order]))
    assert out[0][0] == out[1][0] and out[0][1] == out[1][1] > 0
    np.testing.assert_array_equal(out[0][2], out[1][2])
    np.testing.assert_array_equal(out[0][3], out[1][3])


@pytest.mark.parametrize("optimizer", ["sgd", "adagrad"])
def test_ssd_table_spill_compaction_restart_equal(tmp_path, optimizer):
    files = []
    for name, P in (("ref", RT), ("port", PT)):
        root = tmp_path / name
        path = str(root / "emb.bin")
        t = P.SsdSparseTable(dim=4, path=path, cache_rows=8,
                             optimizer=optimizer, lr=0.5, seed=3)
        first = t.pull(np.arange(32))  # 24 rows spilled through the cache
        assert t.hot_rows() <= 8 and t.size() == 32
        t.push_grad(np.array([0, 31, 0]), np.ones((3, 4), np.float32))
        spilled_size = os.path.getsize(path)
        t.save()  # compaction in place
        t.save(str(root / "ckpt.bin"))  # a checkpoint copy
        t.push_grad(np.array([5]), np.ones((1, 4), np.float32))
        after = t.pull(np.arange(32))
        t.close()
        t2 = P.SsdSparseTable(dim=4, path=path, cache_rows=4,
                              optimizer=optimizer, lr=0.5, seed=999)
        restarted = t2.pull(np.arange(32))
        acc = P.CtrAccessor(t2)
        acc.update(np.array([3, 7]), shows=[10, 10])
        removed = acc.shrink(1.0)
        t2.close()
        files.append((first, spilled_size, after, restarted, removed,
                      _read_tree(root)))
    ref, port = files
    for a, b in zip(ref[:4], port[:4]):
        np.testing.assert_array_equal(a, b)
    assert ref[4] == port[4] == 30
    assert ref[5] == port[5]  # the .bin files and their .idx, byte for byte
    idx = json.loads(ref[5]["emb.bin.idx"])
    assert len(idx) == 32
    for P in (RT, PT):
        with pytest.raises(ValueError):
            P.SsdSparseTable(dim=4, path=str(tmp_path / "z.bin"),
                             cache_rows=0)


def test_entry_configs_equal():
    for make in (lambda P: P.CountFilterEntry(3),
                 lambda P: P.ProbabilityEntry(0.25),
                 lambda P: P.ShowClickEntry("show", "click")):
        assert make(RT).attr() == make(PT).attr()
    for P in (RT, PT):
        with pytest.raises(ValueError):
            P.CountFilterEntry(-1)
        with pytest.raises(ValueError):
            P.ProbabilityEntry(1.5)
        with pytest.raises(NotImplementedError):
            P.Entry().attr()
