"""The port's datasets (``paddle_tpu_torch.distributed.fleet.dataset``),
data generators (``fleet.data_generator``) and blocking queue
(``runtime.BlockingQueue``) against the JAX package's, on the same seeded
slot files:

- ``InMemoryDataset``: the records (their structure and key order, which
  ``global_shuffle``'s owner hash reads), the batches (sparse slots padded
  with id 0 to the batch's widest row) before and after ``local_shuffle``;
  ``global_shuffle`` of two workers through a PS server gives each worker
  the reference's records;
- ``QueueDataset`` over the native queue: one reader streams the
  reference's batches in order, two stream every record, a reader's error
  reaches the consumer;
- ``MultiSlotDataGenerator`` / ``MultiSlotStringDataGenerator``: the text
  they write, from memory and from stdin, is the reference's;
- ``BlockingQueue`` runs on ``csrc/queue.cc`` (a test fails otherwise):
  order, blocking across threads, a full queue's timeout, close.
"""
import io
import queue as pyqueue
import sys
import threading

import numpy as np
import pytest

from paddle_tpu.distributed.fleet import data_generator as RG
from paddle_tpu.distributed.fleet import dataset as RD
from paddle_tpu.distributed.ps import service as RS
from paddle_tpu.runtime import blocking_queue as RQ
from paddle_tpu_torch.distributed.fleet import data_generator as PG
from paddle_tpu_torch.distributed.fleet import dataset as PD
from paddle_tpu_torch.distributed.ps import service as PS
from paddle_tpu_torch.runtime import native
from paddle_tpu_torch.runtime.blocking_queue import BlockingQueue

JOIN_S = 30.0
SPARSE, DENSE = ["click", "show"], ["f"]


@pytest.fixture
def slot_files(tmp_path):
    rs = np.random.RandomState(0)
    paths = []
    for fi in range(3):
        p = tmp_path / f"part-{fi}.txt"
        lines = []
        for i in range(20):
            ids = " ".join(f"click:{rs.randint(1, 100)}"
                           for _ in range(rs.randint(1, 4)))
            dense = ",".join(f"{v:.3f}" for v in rs.rand(2))
            lines.append(f"{i % 2} {ids} show:{rs.randint(1, 50)} f:{dense}")
        p.write_text("\n".join(lines) + "\n\n")
        paths.append(str(p))
    return paths


def _dataset(D, files, batch=8, kind="InMemoryDataset", threads=1):
    ds = getattr(D, kind)()
    ds.set_filelist(files)
    ds.set_batch_size(batch)
    ds.set_thread(threads)
    ds.set_use_var(SPARSE, dense_slots=DENSE)
    return ds


def _same_batches(a, b):
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert list(x) == list(y)
        for k in x:
            assert x[k].dtype == y[k].dtype
            np.testing.assert_array_equal(x[k], y[k])


def test_in_memory_records_and_batches_equal(slot_files):
    ref, port = (_dataset(D, slot_files) for D in (RD, PD))
    assert ref.load_into_memory() == port.load_into_memory() == 60
    assert repr(ref._records) == repr(port._records)
    _same_batches(list(ref), list(port))
    for ds in (ref, port):
        ds.local_shuffle()
    assert repr(ref._records) == repr(port._records)
    batches = list(port)
    _same_batches(list(ref), batches)
    b = batches[0]
    widest = max(len(r[1]["click"]) for r in port._records[:8])
    assert b["click"].shape == (8, widest) and b["f"].shape == (8, 2)
    assert b["label"].dtype == np.float32 and b["click"].dtype == np.int64
    port.release_memory()
    assert port.get_memory_data_size() == 0
    line = "1 click:5 click:7 show:3 f:0.5,0.25 junk"
    assert repr(RD.parse_slot_line(line, SPARSE, DENSE)) == \
        repr(PD.parse_slot_line(line, SPARSE, DENSE))


class _Role:
    def __init__(self, idx):
        self._i = idx

    def worker_num(self):
        return 2

    def worker_index(self):
        return self._i


def _global_shuffle(D, S, files):
    server = S.PsServer(port=0, n_workers=2, host="127.0.0.1").start()
    eps = [f"127.0.0.1:{server.port}"]
    datasets = []
    for w in range(2):
        ds = _dataset(D, [files[w]])
        ds.load_into_memory()
        ds._ps_client = S.PsClient(eps)
        ds._role = _Role(w)
        datasets.append(ds)
    threads = [threading.Thread(target=d.global_shuffle) for d in datasets]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=JOIN_S)
    assert not any(t.is_alive() for t in threads)
    out = [sorted(repr(r) for r in d._records) for d in datasets]
    for d in datasets:
        d._ps_client.close()
    server.stop()
    return out


def test_global_shuffle_gives_each_worker_the_references_records(slot_files):
    want = _global_shuffle(RD, RS, slot_files)
    got = _global_shuffle(PD, PS, slot_files)
    assert got == want
    assert sum(map(len, got)) == 40 and not set(got[0]) & set(got[1])


def test_queue_dataset_streams_every_record(slot_files):
    assert native.QUEUE.build() is not None, native.QUEUE.error
    one = [_dataset(D, slot_files, 7, "QueueDataset") for D in (RD, PD)]
    _same_batches(*(list(ds) for ds in one))  # one reader: in order
    two = _dataset(PD, slot_files, 7, "QueueDataset", threads=2)
    for _ in range(2):  # a second pass starts fresh readers
        batches = list(two)
        assert sum(b["label"].shape[0] for b in batches) == 60
        assert all(b["click"].shape[0] <= 7 for b in batches)
    mem = _dataset(PD, slot_files, 60)
    mem.load_into_memory()
    (whole,) = list(mem)
    assert sorted(np.concatenate([b["label"] for b in batches]).tolist()) \
        == sorted(whole["label"].tolist())


def test_queue_dataset_reader_error_propagates(tmp_path):
    p = tmp_path / "ok.txt"
    p.write_text("1 click:5\n")
    for D in (RD, PD):
        ds = D.QueueDataset()
        ds.set_filelist([str(p), str(tmp_path / "missing.txt")])
        ds.set_batch_size(2)
        ds.set_thread(2)
        ds.set_use_var(["click"])
        with pytest.raises(FileNotFoundError):
            list(ds)


def _generator(G, string):
    base = G.MultiSlotStringDataGenerator if string \
        else G.MultiSlotDataGenerator

    class Criteo(base):
        def generate_sample(self, line):
            def it():
                rs = np.random.RandomState(len(line or "") + 3)
                for _ in range(5):
                    ids = [int(v) for v in rs.randint(0, 1000, 3)]
                    dense = [float(v) for v in np.round(rs.rand(2), 3)]
                    if string:
                        ids, dense = [str(v) for v in ids], \
                            [str(v) for v in dense]
                    yield [("label", [int(rs.rand() < 0.5)]),
                           ("C1", ids), ("I1", dense)]
                yield None  # skipped
            return it

    return Criteo()


@pytest.mark.parametrize("string", [False, True], ids=["multislot",
                                                        "string"])
def test_data_generators_write_the_references_text(monkeypatch, capsys,
                                                   string):
    outs = []
    for G in (RG, PG):
        g = _generator(G, string)
        g.set_batch(2)
        g.run_from_memory()
        monkeypatch.setattr(sys, "stdin", io.StringIO("a b\nc\n"))
        g.run_from_stdin()
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1]
    lines = outs[1].splitlines()
    assert len(lines) == 15 and lines[0].split()[0] == "1"
    with pytest.raises(NotImplementedError):
        PG.DataGenerator().generate_sample("x")


def test_blocking_queue_is_native_and_blocks():
    q = BlockingQueue(capacity=2)
    assert q.native, native.QUEUE.error
    ref = RQ.BlockingQueue(capacity=2)
    for item in ({"x": 1}, [1, 2, 3]):
        q.put(item)
        ref.put(item)
    assert q.qsize() == ref.qsize() == 2
    assert q.put("late", timeout=0.05) is False  # full
    assert [q.get(), q.get()] == [ref.get(), ref.get()] == [{"x": 1},
                                                           [1, 2, 3]]
    got = []
    consumer = threading.Thread(target=lambda: got.extend(
        q.get() for _ in range(20)))
    consumer.start()
    for i in range(20):
        q.put(i)
    consumer.join(timeout=JOIN_S)
    assert not consumer.is_alive() and got == list(range(20))
    q.close()
    with pytest.raises(pyqueue.Empty):
        q.get(timeout=0.05)
