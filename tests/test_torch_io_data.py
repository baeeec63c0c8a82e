"""The port's data half against the JAX package's, on the CPU: ``io``'s
datasets and samplers, ``dataset.common`` and the eleven reader modules,
``text.datasets``, ``vision.datasets`` (the synthetic fallbacks and the
real-file branches), the ``reader`` decorators and ``batch``.

Everything here is host Python and numpy, so items, index lists and
samples must be equal (values, dtypes and shapes) for the same seeds:
``random.seed`` for ``random_split`` and the ``shuffle`` decorator,
``np.random.seed`` for the samplers. ``xmap_readers`` (unordered) and
``multiprocess_reader`` run two workers over 20 samples and are compared
without regard to order. One difference is pinned: where an image file
cannot be read, the reference's ``_load_image`` returns a 3 x 32 x 32 zero
image and the port raises."""
import gzip
import random
import struct

import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu_torch as T
from paddle_tpu_torch import _device
from paddle_tpu_torch.analysis.layercheck import to_numpy


@pytest.fixture(autouse=True)
def _cpu():
    prev = _device._CURRENT
    T.set_device("cpu")
    yield
    _device._CURRENT = prev


def _same(got, want):
    """Equal nested samples: tuples/lists item by item, arrays by value,
    dtype and shape, scalars by value and type."""
    if isinstance(want, (list, tuple)):
        assert isinstance(got, type(want)) and len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
    elif isinstance(want, (np.ndarray, np.generic)):
        g = np.asarray(got)
        assert g.dtype == want.dtype and g.shape == np.shape(want)
        np.testing.assert_array_equal(g, want)
    elif hasattr(want, "numpy"):
        np.testing.assert_array_equal(to_numpy(got), to_numpy(want))
    else:
        assert type(got) is type(want) and got == want


# ---------------------------------------------------------------- io
def _tensor_sets():
    a = np.arange(12, dtype=np.float32).reshape(6, 2)
    b = np.arange(6, dtype=np.int64)
    return ((T.io.TensorDataset([a, b]), J.io.TensorDataset([a, b])),
            a, b)


def test_tensor_compose_concat_subset_and_chain():
    (tp, tj), a, b = _tensor_sets()
    assert len(tp) == len(tj) == 6
    for i in range(6):
        _same(tp[i], tj[i])
    tt = T.io.TensorDataset([T.to_tensor(a), T.to_tensor(b)])
    assert torch.equal(tt[2][0], torch.tensor([4.0, 5.0]))
    with pytest.raises(ValueError):
        T.io.TensorDataset([a, b[:3]])
    cp = T.io.ComposeDataset([tp, T.io.Subset(list(range(10)), [4, 1, 7, 0,
                                                               2, 9])])
    cj = J.io.ComposeDataset([tj, J.io.Subset(list(range(10)), [4, 1, 7, 0,
                                                               2, 9])])
    assert len(cp) == len(cj) == 6
    for i in range(6):
        _same(cp[i], cj[i])
    kp = T.io.ConcatDataset([tp, list("abc"), tp])
    kj = J.io.ConcatDataset([tj, list("abc"), tj])
    assert len(kp) == len(kj) == 15
    for i in list(range(15)) + [-1, -9]:
        _same(kp[i], kj[i])
    # iterated, not list(): list() asks for a length, which raises
    chain_p = [v for v in T.io.ChainDataset([[1, 2], range(3), "xy"])]
    assert chain_p == [v for v in J.io.ChainDataset([[1, 2], range(3),
                                                     "xy"])]
    for P in (T, J):
        it = P.io.IterableDataset()
        with pytest.raises(RuntimeError):
            it[0]
        with pytest.raises(RuntimeError):
            len(it)
        with pytest.raises(NotImplementedError):
            iter(it)
        with pytest.raises(NotImplementedError):
            P.io.Dataset()[0]


@pytest.mark.parametrize("lengths", [[3, 7, 10], [0.25, 0.5, 0.25],
                                     [0.3, 0.3]])
def test_random_split_is_the_references_split(lengths):
    data = list(range(20))
    random.seed(11)
    got = T.io.random_split(data, lengths)
    random.seed(11)
    want = J.io.random_split(data, lengths)
    assert [s.indices for s in got] == [s.indices for s in want]
    assert [len(s) for s in got] == [len(s) for s in want]
    assert [got[0][i] for i in range(len(got[0]))] == want[0].indices
    assert T.io.RandomSplit is T.io.random_split
    for P in (T, J):
        with pytest.raises(ValueError):
            P.io.random_split(data, [3, 4])


def _draw(P, make, seed=5):
    np.random.seed(seed)
    return [list(make(P)) for _ in range(2)]


@pytest.mark.parametrize("name,make", [
    ("sequence", lambda P: P.io.SequenceSampler(range(7))),
    ("random", lambda P: P.io.RandomSampler(range(9))),
    ("random_n", lambda P: P.io.RandomSampler(range(9), num_samples=4)),
    ("random_replacement", lambda P: P.io.RandomSampler(
        range(9), replacement=True, num_samples=12)),
    ("weighted", lambda P: P.io.WeightedRandomSampler(
        [0.1, 2.0, 0.5, 0.0, 1.0], 8)),
    ("weighted_without", lambda P: P.io.WeightedRandomSampler(
        [0.1, 2.0, 0.5, 0.3, 1.0], 3, replacement=False)),
    ("batch", lambda P: P.io.BatchSampler(range(10), batch_size=3)),
    ("batch_shuffle_drop", lambda P: P.io.BatchSampler(
        range(10), shuffle=True, batch_size=3, drop_last=True)),
    ("batch_of_sampler", lambda P: P.io.BatchSampler(
        sampler=P.io.RandomSampler(range(11)), batch_size=4)),
])
def test_samplers_draw_the_references_indices(name, make):
    got, want = _draw(T, make), _draw(J, make)
    assert got == want
    assert len(make(T)) == len(make(J))


@pytest.mark.parametrize("shuffle,drop_last", [(False, False), (True, False),
                                               (True, True)])
def test_distributed_batch_sampler(shuffle, drop_last):
    data = range(23)
    for rank in range(3):
        sp = T.io.DistributedBatchSampler(data, 4, 3, rank, shuffle,
                                          drop_last)
        sj = J.io.DistributedBatchSampler(data, 4, 3, rank, shuffle,
                                          drop_last)
        assert list(sp) == list(sj) and len(sp) == len(sj)
        sp.set_epoch(3)
        sj.set_epoch(3)
        assert list(sp) == list(sj)
    alone = T.io.DistributedBatchSampler(data, 5)
    assert (alone.nranks, alone.local_rank) == (1, 0)
    assert list(alone) == list(T.io.BatchSampler(data, batch_size=5))
    with pytest.raises(ValueError):
        T.io.BatchSampler(data, T.io.SequenceSampler(data))


def test_io_exports_the_data_half_only():
    """The data half, and since item 12d the loader and bucketing: the
    reference's ``io`` names, nothing else."""
    assert set(T.io.__all__) == {
        "ChainDataset", "ComposeDataset", "ConcatDataset", "Dataset",
        "IterableDataset", "RandomSplit", "Subset", "TensorDataset",
        "random_split", "BatchSampler", "DistributedBatchSampler",
        "RandomSampler", "Sampler", "SequenceSampler",
        "WeightedRandomSampler", "DataLoader", "WorkerInfo",
        "default_collate_fn", "get_worker_info", "LengthBucketSampler",
        "bucket_boundaries", "pad_sequence_batch", "pad_to_bucket"}
    assert set(T.io.__all__) <= set(dir(J.io))


# ------------------------------------------------------ dataset.common
def test_common_download_cache_split_and_shards(tmp_path, monkeypatch):
    for P in (T, J):
        monkeypatch.setattr(P.dataset.common, "DATA_HOME", str(tmp_path))
    url = "https://example.invalid/data/corpus.txt"
    outs = []
    for P in (T, J):
        with pytest.raises(RuntimeError, match="cannot download"):
            P.dataset.common.download(url, "mod", None)
        assert not P.dataset.common.cached(url, "mod")
    T.dataset.common.must_mkdirs(str(tmp_path / "mod"))
    (tmp_path / "mod" / "corpus.txt").write_bytes(b"abc" * 100)
    md5 = J.dataset.common.md5file(str(tmp_path / "mod" / "corpus.txt"))
    for P in (T, J):
        assert P.dataset.common.md5file(
            str(tmp_path / "mod" / "corpus.txt")) == md5
        outs.append(P.dataset.common.download(url, "mod", md5))
        assert P.dataset.common.cached(url, "mod", md5)
        with pytest.raises(RuntimeError, match="md5"):
            P.dataset.common.download(url, "mod", "0" * 32)
    assert outs[0] == outs[1]
    reader = (lambda: iter(range(25)))
    shards = {}
    for tag, P in (("t", T), ("j", J)):
        monkeypatch.chdir(tmp_path)
        P.dataset.common.split(reader, 6, suffix=f"{tag}%05d.pickle")
        shards[tag] = [list(P.dataset.common.cluster_files_reader(
            str(tmp_path / f"{tag}*.pickle"), 2, k)()) for k in range(2)]
    assert shards["t"] == shards["j"]
    assert sorted(shards["t"][0] + shards["t"][1]) == list(range(25))


# ------------------------------------------------------------- readers
READERS = {  # name -> (creator of a package, samples compared)
    "mnist_train": (lambda P: P.dataset.mnist.train(), 300),
    "mnist_test": (lambda P: P.dataset.mnist.test(), 300),
    "cifar_train10": (lambda P: P.dataset.cifar.train10(), 200),
    "cifar_test10_cycle": (lambda P: P.dataset.cifar.test10(cycle=True),
                           1100),
    "cifar_train100": (lambda P: P.dataset.cifar.train100(), 50),
    "cifar_test100": (lambda P: P.dataset.cifar.test100(), 50),
    "uci_housing_train": (lambda P: P.dataset.uci_housing.train(), 404),
    "uci_housing_test": (lambda P: P.dataset.uci_housing.test(), 102),
    "imdb_train": (lambda P: P.dataset.imdb.train(P.dataset.imdb.word_dict()),
                   100),
    "imdb_test": (lambda P: P.dataset.imdb.test({}), 100),
    "imikolov_ngram": (lambda P: P.dataset.imikolov.train({}, 5), 100),
    "imikolov_seq": (lambda P: P.dataset.imikolov.test(
        {}, 4, P.dataset.imikolov.DataType.SEQ), 100),
    "movielens_train": (lambda P: P.dataset.movielens.train(), 100),
    "movielens_test": (lambda P: P.dataset.movielens.test(), 100),
    "conll05_test": (lambda P: P.dataset.conll05.test(), 40),
    "flowers_train": (lambda P: P.dataset.flowers.train(), 20),
    "flowers_test_cycle": (lambda P: P.dataset.flowers.test(cycle=True), 20),
    "flowers_valid": (lambda P: P.dataset.flowers.valid(), 20),
    "voc2012_train": (lambda P: P.dataset.voc2012.train(), 20),
    "voc2012_test": (lambda P: P.dataset.voc2012.test(), 20),
    "voc2012_val": (lambda P: P.dataset.voc2012.val(), 20),
    "wmt14_train": (lambda P: P.dataset.wmt14.train(3000), 100),
    "wmt14_test": (lambda P: P.dataset.wmt14.test(500), 100),
    "wmt16_train": (lambda P: P.dataset.wmt16.train(1000, 800), 100),
    "wmt16_test": (lambda P: P.dataset.wmt16.test(1000, 800, "de"), 100),
    "wmt16_validation": (lambda P: P.dataset.wmt16.validation(900, 700), 100),
}


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_samples_equal_the_references(name):
    make, n = READERS[name]
    got = list(T.reader.firstn(make(T), n)())
    want = list(J.reader.firstn(make(J), n)())
    assert len(got) == len(want) == n
    for g, w in zip(got, want):
        _same(g, w)


def test_reader_helpers_equal_the_references():
    for mod, fn, args in (("conll05", "get_dict", ()),
                          ("imdb", "word_dict", ()),
                          ("imikolov", "build_dict", ()),
                          ("movielens", "max_user_id", ()),
                          ("movielens", "max_movie_id", ()),
                          ("movielens", "max_job_id", ()),
                          ("movielens", "age_table", ()),
                          ("wmt16", "get_dict", ("en", 30)),
                          ("wmt16", "get_dict", ("de", 20, True))):
        got = getattr(getattr(T.dataset, mod), fn)(*args)
        assert got == getattr(getattr(J.dataset, mod), fn)(*args)
    assert T.dataset.uci_housing.feature_names == \
        J.dataset.uci_housing.feature_names
    x, y = next(T.dataset.mnist.train()())
    assert x.shape == (784,) and x.dtype == np.float32
    assert -1.0 <= x.min() and x.max() <= 1.0 and isinstance(y, int)


# ------------------------------------------------------- text datasets
TEXT = {
    "SyntheticLMDataset": dict(vocab_size=1000, seq_len=32, size=64, seed=3),
    "Imdb": dict(size=64), "Imdb_test": dict(mode="test", size=32),
    "Conll05st": dict(size=32, seq_len=12),
    "Conll05st_test": dict(mode="test", size=16),
    "Imikolov": dict(window_size=4, size=64),
    "Imikolov_test": dict(mode="test", size=16),
    "Movielens": dict(size=64), "Movielens_test": dict(mode="test", size=16),
    "UCIHousing": {}, "UCIHousing_test": dict(mode="test"),
    "WMT14": dict(dict_size=500, size=64), "WMT14_test": dict(mode="test",
                                                                size=16),
    "WMT16": dict(src_dict_size=300, trg_dict_size=200, size=64),
    "WMT16_test": dict(mode="test", lang="de", size=16),
}


@pytest.mark.parametrize("name", sorted(TEXT))
def test_text_dataset_items_equal_the_references(name):
    cls = name.split("_")[0]
    got = getattr(T.text.datasets, cls)(**TEXT[name])
    want = getattr(J.text.datasets, cls)(**TEXT[name])
    assert len(got) == len(want)
    for i in range(len(want)):
        _same(got[i], want[i])
    assert getattr(T.text, cls, None) is getattr(T.text.datasets, cls) or \
        cls == "SyntheticLMDataset"
    if cls == "Conll05st":
        assert got.get_dict() == want.get_dict()


# ----------------------------------------------------- vision datasets
VISION = {
    "MNIST": dict(synthetic_size=40),
    "MNIST_test": dict(mode="test", synthetic_size=40),
    "FashionMNIST": dict(synthetic_size=20),
    "Cifar10": dict(synthetic_size=40),
    "Cifar10_test": dict(mode="test", synthetic_size=30),
    "Cifar100": dict(synthetic_size=40), "Flowers": dict(synthetic_size=16),
    "VOC2012": dict(synthetic_size=12),
    "VOC2012_test": dict(mode="test", synthetic_size=12),
}


@pytest.mark.parametrize("name", sorted(VISION))
def test_vision_dataset_items_equal_the_references(name):
    cls = name.split("_")[0]
    kw = VISION[name]
    for transform in (None, "normalize"):
        extra = {} if transform is None else dict(
            transform=lambda m: lambda img: m.Normalize(
                [127.5] * img.shape[0], [127.5] * img.shape[0])(img))
        got = getattr(T.vision.datasets, cls)(
            **kw, **({k: v(T.vision.transforms) for k, v in extra.items()}))
        want = getattr(J.vision.datasets, cls)(
            **kw, **({k: v(J.vision.transforms) for k, v in extra.items()}))
        assert len(got) == len(want)
        for i in range(len(want)):
            _same(got[i], want[i])


def test_default_synthetic_sizes_and_mnist_idx_files(tmp_path):
    for cls, n in (("MNIST", 6000), ("Cifar10", 5000)):
        got, want = (getattr(P.vision.datasets, cls)() for P in (T, J))
        assert len(got) == len(want) == n
        for i in (0, 1, n - 1):
            _same(got[i], want[i])
    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 256, (5, 4, 6), dtype=np.uint8)
    labels = rng.integers(0, 10, 5).astype(np.uint8)
    ip, lp = tmp_path / "img.gz", tmp_path / "lab.gz"
    with gzip.open(ip, "wb") as f:
        f.write(struct.pack(">IIII", 2051, 5, 4, 6) + imgs.tobytes())
    with gzip.open(lp, "wb") as f:
        f.write(struct.pack(">II", 2049, 5) + labels.tobytes())
    got = T.vision.datasets.MNIST(str(ip), str(lp))
    want = J.vision.datasets.MNIST(str(ip), str(lp))
    assert len(got) == 5
    for i in range(5):
        _same(got[i], want[i])
    np.testing.assert_array_equal(got[2][0][0], imgs[2])


def _image_folder(root):
    from PIL import Image

    rng = np.random.default_rng(1)
    for c in ("cat", "dog"):
        (root / c).mkdir(parents=True)
        for k in range(2):
            Image.fromarray(rng.integers(0, 256, (5, 7, 3), np.uint8)).save(
                root / c / f"{k}.png")


@pytest.mark.parametrize("cls", ["DatasetFolder", "ImageFolder"])
def test_image_folders_read_real_files(tmp_path, cls):
    _image_folder(tmp_path / "data")
    got = getattr(T.vision.datasets, cls)(str(tmp_path / "data"))
    want = getattr(J.vision.datasets, cls)(str(tmp_path / "data"))
    assert got.class_to_idx == want.class_to_idx == {"cat": 0, "dog": 1}
    assert len(got) == len(want) == 4
    for i in range(4):
        _same(got[i], want[i])
    assert got[0][0].shape == (3, 5, 7)
    assert len(T.vision.datasets.DatasetFolder(str(tmp_path / "none"))) == 0


def test_unreadable_image_raises_where_the_reference_returns_zeros(
        tmp_path):
    """Pinned difference: ``_load_image`` of the reference swallows every
    error into a zero image (``paddle_tpu/vision/datasets.py:129-135``);
    the port's raises."""
    (tmp_path / "data" / "cat").mkdir(parents=True)
    (tmp_path / "data" / "cat" / "bad.png").write_bytes(b"not an image")
    want = J.vision.datasets.ImageFolder(str(tmp_path / "data"))[0][0]
    np.testing.assert_array_equal(want, np.zeros((3, 32, 32), np.float32))
    from PIL import UnidentifiedImageError

    with pytest.raises(UnidentifiedImageError):
        T.vision.datasets.ImageFolder(str(tmp_path / "data"))[0]


# ---------------------------------------------------- reader decorators
def _r(seq):
    return lambda: iter(list(seq))


def test_cache_map_chain_compose_firstn_and_batch():
    for P in (T, J):
        calls = []

        def once():
            calls.append(1)
            return iter(range(5))
        c = P.reader.cache(once)
        assert list(c()) == list(c()) == list(range(5)) and len(calls) == 1
    pairs = [(M.reader, M) for M in (T, J)]
    out = []
    for R, M in pairs:
        out.append([
            list(R.map_readers(lambda a, b: a * 10 + b, _r(range(4)),
                               _r(range(5, 9)))()),
            list(R.chain(_r("ab"), _r([1, 2]), _r([]))()),
            list(R.compose(_r([1, 2]), _r([(3, 4), (5, 6)]))()),
            list(R.compose(_r([1, 2, 3]), _r("xy"),
                           check_alignment=False)()),
            list(R.firstn(_r(range(10)), 3)()),
            list(R.buffered(_r(range(30)), 4)()),
            list(M.batch(_r(range(7)), 3)()),
            list(M.batch(_r(range(7)), 3, drop_last=True)()),
        ])
        with pytest.raises(R.ComposeNotAligned):
            list(R.compose(_r([1, 2, 3]), _r("xy"))())
    assert out[0] == out[1]
    assert callable(T.batch) and T.batch.__module__ == "paddle_tpu_torch.batch"


def test_shuffle_is_the_references_with_the_same_seed():
    outs = []
    for P in (T, J):
        random.seed(4)
        outs.append([list(P.reader.shuffle(_r(range(23)), 5)())
                     for _ in range(2)])
    assert outs[0] == outs[1]
    assert sorted(outs[0][0]) == list(range(23))


@pytest.mark.parametrize("order", [False, True])
def test_xmap_readers_two_workers(order):
    def square(v):
        return v * v
    outs = [list(P.reader.xmap_readers(square, _r(range(20)), 2, 4, order)())
            for P in (T, J)]
    want = [v * v for v in range(20)]
    if order:
        assert outs[0] == outs[1] == want
    else:
        assert sorted(outs[0]) == sorted(outs[1]) == want


@pytest.mark.parametrize("use_pipe", [True, False])
def test_multiprocess_reader_two_processes(use_pipe):
    readers = [_r(range(10)), _r(range(100, 110))]
    outs = [sorted(P.reader.multiprocess_reader(readers, use_pipe, 8)())
            for P in (T, J)]
    assert outs[0] == outs[1] == list(range(10)) + list(range(100, 110))
    with pytest.raises(ValueError):
        T.reader.multiprocess_reader([])


def test_the_reader_path_feeds_a_batch():
    """``paddle.batch(reader.shuffle(dataset.mnist.train(), 600), 64)``, the
    path a reader-fed training loop takes, gives the reference's batches
    for the same seed."""
    outs = []
    for P in (T, J):
        random.seed(0)
        feed = P.batch(P.reader.shuffle(
            P.reader.firstn(P.dataset.mnist.train(), 600), 600), 64)
        outs.append(list(feed()))
    assert len(outs[0]) == 10 and len(outs[0][-1]) == 600 - 9 * 64
    for g, w in zip(*outs):
        _same(g, w)
