"""``paddle_tpu_torch.io.DataLoader`` and ``io.bucketing`` against the JAX
package's.

- The single, threaded and multiprocess paths give the reference's
  batches (equal arrays) in the reference's order for the same numpy
  seed, shuffled or not, with a dict sample and a user ``collate_fn``;
  the port's land as port ``Tensor``\\ s on the loader's device.
- A worker's exception reaches the consumer on both worker paths;
  ``worker_init_fn`` runs once a worker, and ``get_worker_info`` is the
  worker's inside it and None outside; a dataset holding CUDA tensors
  raises before any fork; every shared-memory segment is unlinked.
- ``IterableDataset`` with and without ``drop_last``; ``len``.
- ``bucket_boundaries``, ``pad_to_bucket``, ``pad_sequence_batch`` and
  ``LengthBucketSampler`` (shuffled under one numpy seed) equal.

Every multiprocess loader has a ``timeout``, so a hung worker fails its
test instead of hanging the suite.
"""
import os

import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu_torch as T
from paddle_tpu_torch import _device
from paddle_tpu_torch.io import dataloader as tdl

TIMEOUT = 60


@pytest.fixture(autouse=True)
def _cpu():
    prev = _device._CURRENT
    T.set_device("cpu")
    yield
    _device._CURRENT = prev


def _datasets(P):
    class Pairs(P.io.Dataset):
        def __len__(self):
            return 23

        def __getitem__(self, i):
            x = np.arange(6, dtype=np.float32).reshape(2, 3) + i
            return x, np.int64(i)

    class Dicts(P.io.Dataset):
        def __len__(self):
            return 9

        def __getitem__(self, i):
            return {"ids": np.full((4,), i, np.int64), "w": float(i) / 2}

    return Pairs(), Dicts()


def _host(obj):
    if isinstance(obj, (list, tuple)):
        return [_host(v) for v in obj]
    if isinstance(obj, dict):
        return {k: _host(v) for k, v in obj.items()}
    if hasattr(obj, "numpy"):
        return np.asarray(obj.numpy())
    return np.asarray(obj)


def _epoch(P, which, seed, **kw):
    data = _datasets(P)[which]
    np.random.seed(seed)
    return [_host(b) for b in P.io.DataLoader(data, **kw)]


def _equal(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    else:
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


PATHS = {"single": dict(num_workers=0),
         "threads": dict(num_workers=3, use_shared_memory=False),
         "processes": dict(num_workers=2, timeout=TIMEOUT)}


@pytest.mark.parametrize("path", sorted(PATHS))
@pytest.mark.parametrize("shuffle,drop_last", [(False, False), (True, True),
                                               (True, False)])
def test_paths_give_the_references_batches(path, shuffle, drop_last):
    kw = dict(batch_size=5, shuffle=shuffle, drop_last=drop_last,
              **PATHS[path])
    for which in (0, 1):
        want = _epoch(J, which, 7, **kw)
        got = _epoch(T, which, 7, **kw)
        _equal(got, want)
    assert len(T.io.DataLoader(_datasets(T)[0], batch_size=5,
                               drop_last=drop_last)) == (4 if drop_last
                                                         else 5)


@pytest.mark.parametrize("path", ["threads", "processes"])
def test_user_collate_and_tensor_landing(path):
    def collate(batch):
        return np.stack([b[0] for b in batch]).sum(axis=0)

    want = _epoch(J, 0, 3, batch_size=4, collate_fn=collate, **PATHS[path])
    got = _epoch(T, 0, 3, batch_size=4, collate_fn=collate, **PATHS[path])
    _equal(got, want)
    x, y = next(iter(T.io.DataLoader(_datasets(T)[0], batch_size=4,
                                     **PATHS[path])))
    assert isinstance(x, T.Tensor) and x.device.type == "cpu"
    assert x.dtype == torch.float32 and y.dtype == torch.int64


class _Failing:
    def __len__(self):
        return 8

    def __getitem__(self, i):
        if i == 5:
            raise ValueError("bad sample 5")
        return np.zeros(2, np.float32)


@pytest.mark.parametrize("path", ["threads", "processes"])
def test_worker_exception_reaches_the_consumer(path):
    loader = T.io.DataLoader(_Failing(), batch_size=2, **PATHS[path])
    with pytest.raises((RuntimeError, ValueError), match="bad sample 5"):
        list(loader)


class _WhoAmI:
    def __len__(self):
        return 12

    def __getitem__(self, i):
        info = tdl.get_worker_info()
        return np.array([info.id, info.num_workers, os.getpid()], np.int64)


def test_worker_init_fn_and_worker_info(tmp_path):
    assert T.io.get_worker_info() is None
    init_file = str(tmp_path / "init")

    def init(wid):
        with open(f"{init_file}_{wid}", "w") as f:
            f.write(str(wid))

    rows = np.concatenate([b.numpy() for b in T.io.DataLoader(
        _WhoAmI(), batch_size=3, num_workers=2, timeout=TIMEOUT,
        worker_init_fn=init)])
    assert set(rows[:, 0]) <= {0, 1} and set(rows[:, 1]) == {2}
    assert os.getpid() not in set(rows[:, 2])
    # each worker that made a batch ran its init first (a worker still
    # starting when the epoch ends is terminated, init or not)
    for wid in set(rows[:, 0].tolist()):
        with open(f"{init_file}_{wid}") as f:
            assert f.read() == str(wid)
    threads = np.concatenate([b.numpy() for b in T.io.DataLoader(
        _WhoAmI(), batch_size=3, num_workers=2, use_shared_memory=False)])
    assert set(threads[:, 2]) == {os.getpid()}
    assert repr(tdl.WorkerInfo(1, 2, 1, None)) == repr(
        J.io.WorkerInfo(1, 2, 1, None))


class _FakeCuda(torch.Tensor):
    @property
    def is_cuda(self):
        return True


def test_cuda_tensor_dataset_raises_before_forking():
    data = T.io.TensorDataset([torch.zeros(4, 2).as_subclass(_FakeCuda)])
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        next(iter(T.io.DataLoader(data, batch_size=2, num_workers=2,
                                  timeout=TIMEOUT)))


def test_shared_memory_segments_are_unlinked(tmp_path, monkeypatch):
    """Every segment a worker made is gone after the loop, read or
    drained; the forked workers inherit the recording wrapper, which
    notes each segment's name in a file."""
    made = tmp_path / "segments"
    create = tdl._shm_untracked

    def recording(*args, **kwargs):
        seg = create(*args, **kwargs)
        with open(made, "a") as f:
            f.write(seg.name + "\n")
        return seg

    monkeypatch.setattr(tdl, "_shm_untracked", recording)
    it = iter(T.io.DataLoader(_datasets(T)[0], batch_size=2, num_workers=2,
                              timeout=TIMEOUT))
    next(it)
    it.close()  # stop early: pending segments are drained and unlinked
    list(T.io.DataLoader(_datasets(T)[0], batch_size=4, num_workers=2,
                         timeout=TIMEOUT))
    names = made.read_text().split()
    assert len(names) >= 7  # the second loop's six batches and more
    left = [n for n in names
            if os.path.exists(os.path.join("/dev/shm", n.lstrip("/")))]
    assert left == []


def _stream(P):
    class Stream(P.io.IterableDataset):
        def __iter__(self):
            for i in range(11):
                yield np.full((3,), i, np.float32), np.int64(i % 3)

    return Stream()


@pytest.mark.parametrize("drop_last", [False, True])
def test_iterable_dataset(drop_last):
    outs = {P: [_host(b) for b in P.io.DataLoader(
        _stream(P), batch_size=4, drop_last=drop_last)] for P in (J, T)}
    _equal(outs[T], outs[J])
    assert len(outs[T]) == (2 if drop_last else 3)
    with pytest.raises(TypeError):
        len(T.io.DataLoader(_stream(T), batch_size=4))


def test_bucketing_functions():
    for scheme, kw in (("pow2", {}), ("linear", dict(min_len=8, step=24))):
        assert T.io.bucket_boundaries(100, scheme, **kw) == \
            J.io.bucket_boundaries(100, scheme, **kw)
    with pytest.raises(ValueError):
        T.io.bucket_boundaries(10, "log")
    ladder = T.io.bucket_boundaries(64)
    rng = np.random.RandomState(0)
    seqs = [rng.randint(1, 9, (n, 2)) for n in (3, 17, 16, 40)]
    for s in seqs:
        _equal(list(T.io.pad_to_bucket(s, ladder, pad_value=-1)[:1]),
               list(J.io.pad_to_bucket(s, ladder, pad_value=-1)[:1]))
        assert T.io.pad_to_bucket(s, ladder)[1] == len(s)
    with pytest.raises(ValueError):
        T.io.pad_to_bucket(np.zeros(70), ladder)
    for bounds in (None, ladder):
        _equal(list(T.io.pad_sequence_batch(seqs, bounds)),
               list(J.io.pad_sequence_batch(seqs, bounds)))

    lengths = rng.randint(1, 60, 50)
    samplers = {}
    for P in (J, T):
        np.random.seed(4)
        s = P.io.LengthBucketSampler(list(lengths),
                                     lambda d, i: d[i], ladder,
                                     batch_size=4, shuffle=True,
                                     drop_last=False)
        samplers[P] = (s, [list(map(int, b)) for b in s])
    (js, jb), (ts, tb) = samplers[J], samplers[T]
    assert tb == jb and len(ts) == len(js)
    assert [ts.bucket_of(b) for b in tb] == [js.bucket_of(b) for b in jb]
