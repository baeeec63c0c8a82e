"""``paddle_tpu_torch.metric`` and ``paddle_tpu_torch.hapi`` against the
JAX package's.

- ``Accuracy`` (top-1 and top-(1, 3), ties included: the host
  ``argsort(-pred)`` ranks them as the reference's), ``Precision``,
  ``Recall``, ``Auc`` and ``accuracy()`` equal the reference's.
- ``Model.fit`` of LeNet on 128 synthetic MNIST images, 2 epochs at batch
  32, shuffled under one numpy seed, Adam: each step's loss within 1e-5
  of the reference's jitted step, the accuracies and the eval logs too;
  then ``evaluate``, ``predict``, ``save`` / ``load``, ``summary`` and
  ``flops`` equal.
- The callbacks' effects (``ModelCheckpoint``'s files, ``EarlyStopping``,
  ``LRScheduler``, ``VisualDL``'s JSONL, ``ReduceLROnPlateau``,
  ``ProgBarLogger``) and the reference's quirks: frozen parameters take no
  update, ``_split_batch``'s rule, the scheduler stepped once an epoch
  (and once a batch more by ``LRScheduler``), ``on_epoch_end`` after the
  evaluation, ``train_batch``'s ``[loss] + metrics``, and
  ``predict_batch`` switching to eval and back.
"""
import json
import os

import numpy as np
import pytest

import paddle_tpu as J
import paddle_tpu_torch as T
from paddle_tpu_torch import _device

LOSS_TOL = 1e-5


@pytest.fixture(autouse=True)
def _cpu():
    prev = _device._CURRENT
    T.set_device("cpu")
    yield
    _device._CURRENT = prev


def _np(x):
    return np.asarray(x.numpy()) if hasattr(x, "numpy") else np.asarray(x)


# ------------------------------------------------------------------ metrics
def test_accuracy_with_ties():
    pred = np.array([[0.2, 0.5, 0.5, 0.1], [0.3, 0.3, 0.3, 0.1],
                     [0.9, 0.0, 0.0, 0.0], [0.1, 0.1, 0.4, 0.4]],
                    np.float32)
    label = np.array([[2], [1], [0], [3]], np.int64)
    for topk in ((1,), (1, 3)):
        res = {}
        for P in (J, T):
            m = P.metric.Accuracy(topk=topk)
            c = m.compute(P.to_tensor(pred), P.to_tensor(label))
            res[P] = (_np(c), m.update(c), m.accumulate(), m.name())
            m.reset()
            assert m.accumulate() == (0.0 if len(topk) == 1 else [0.0, 0.0])
        np.testing.assert_array_equal(res[T][0], res[J][0])
        assert res[T][1:] == res[J][1:]
    for k in (1, 2):
        got = float(T.metric.accuracy(T.to_tensor(pred), T.to_tensor(label),
                                      k=k))
        want = float(J.metric.accuracy(J.to_tensor(pred), J.to_tensor(label),
                                       k=k))
        assert got == want


def test_precision_recall_auc():
    rng = np.random.RandomState(0)
    preds = rng.rand(64).astype(np.float32)
    labels = (rng.rand(64) > 0.4).astype(np.int64)
    two = np.stack([1 - preds, preds], 1)
    for cls, args in ((("Precision",), (preds, labels)),
                      (("Recall",), (preds, labels)),
                      (("Auc",), (two, labels))):
        out = {}
        for P in (J, T):
            m = getattr(P.metric, cls[0])()
            m.update(P.to_tensor(args[0]), P.to_tensor(args[1]))
            m.update(args[0][:10], args[1][:10])
            out[P] = (m.accumulate(), m.name())
        assert out[T][0] == pytest.approx(out[J][0], abs=1e-12)
        assert out[T][1] == out[J][1]


# ------------------------------------------------------------------ hapi
def _mnist(P, n=128):
    rng = np.random.RandomState(7)
    x = rng.rand(n, 1, 28, 28).astype(np.float32)
    y = rng.randint(0, 10, (n, 1)).astype(np.int64)

    class Mnist(P.io.Dataset):
        def __len__(self):
            return n

        def __getitem__(self, i):
            return x[i], y[i]

    return Mnist()


class _Losses:
    def __init__(self, P):
        base = P.callbacks.Callback

        class Rec(base):
            def __init__(self):
                super().__init__()
                self.losses, self.order = [], []

            def on_train_batch_end(self, step, logs=None):
                self.losses.append(logs["loss"])

            def on_epoch_end(self, epoch, logs=None):
                self.order.append(("epoch_end", sorted(logs)))

        self.cb = Rec()


def _lenet_model(P, ref_state=None):
    P.seed(2)
    net = P.vision.models.LeNet()
    if ref_state is not None:
        net.set_state_dict(ref_state)
    model = P.Model(net)
    opt = P.optimizer.Adam(learning_rate=1e-3, parameters=net.parameters())
    model.prepare(opt, P.nn.CrossEntropyLoss(), P.metric.Accuracy())
    return model


@pytest.fixture(scope="module")
def fitted():
    """Both packages' LeNet fitted on the same data, weights and order."""
    prev = _device._CURRENT
    T.set_device("cpu")
    out = {}
    ref_state = None
    for P in (J, T):
        model = _lenet_model(P, ref_state)
        if P is J:
            ref_state = {k: _np(v) for k, v in
                         model.network.state_dict().items()}
        rec = _Losses(P).cb
        np.random.seed(11)
        model.fit(_mnist(P), _mnist(P, 64), batch_size=32, epochs=2,
                  verbose=0, callbacks=[rec])
        out[P] = (model, rec)
    yield out
    _device._CURRENT = prev


def test_fit_losses_follow_the_reference(fitted):
    (jm, jrec), (tm, trec) = fitted[J], fitted[T]
    assert len(trec.losses) == len(jrec.losses) == 8
    np.testing.assert_allclose(trec.losses, jrec.losses, rtol=0,
                               atol=LOSS_TOL)
    assert trec.order == jrec.order
    assert any(k.startswith("eval_") for k in trec.order[0][1])


def test_evaluate_predict_save_load(fitted, tmp_path):
    (jm, _), (tm, _) = fitted[J], fitted[T]
    ev = {P: m.evaluate(_mnist(P, 64), batch_size=16, verbose=0)
          for P, m in ((J, jm), (T, tm))}
    assert sorted(ev[T]) == sorted(ev[J])
    assert ev[T]["loss"] == pytest.approx(ev[J]["loss"], abs=LOSS_TOL)
    assert ev[T]["acc"] == ev[J]["acc"]
    preds = {P: m.predict(_mnist(P, 20), batch_size=8, stack_outputs=True)
             for P, m in ((J, jm), (T, tm))}
    np.testing.assert_allclose(preds[T][0], preds[J][0], atol=1e-4)
    assert len(tm.predict(_mnist(T, 20), batch_size=8)) == 3
    path = str(tmp_path / "lenet")
    tm.save(path)
    assert os.path.exists(path + ".pdparams") and \
        os.path.exists(path + ".pdopt")
    fresh = _lenet_model(T)
    fresh.load(path)
    for (k, a), (_, b) in zip(sorted(fresh.network.state_dict().items()),
                              sorted(tm.network.state_dict().items())):
        np.testing.assert_array_equal(_np(a), _np(b), err_msg=k)
    assert fresh._optimizer._step_count == tm._optimizer._step_count


def test_summary_and_flops():
    got, want = {}, {}
    for P, out in ((J, want), (T, got)):
        P.seed(0)
        net = P.vision.models.LeNet()
        out["summary"] = P.summary(net)
        out["model_summary"] = P.Model(net).summary()
        out["flops"] = P.flops(net, [2, 1, 28, 28])
        seq = P.nn.Sequential(P.nn.Conv2D(3, 4, 3), P.nn.BatchNorm2D(4),
                              P.nn.ReLU(), P.nn.AvgPool2D(2),
                              P.nn.Flatten(), P.nn.Linear(36, 5))
        out["seq"] = P.flops(seq, [2, 3, 8, 8], print_detail=True)
        custom = {P.nn.ReLU: lambda layer, x, y: 1000}
        out["custom"] = P.flops(seq, [2, 3, 8, 8], custom_ops=custom)
    assert got == want
    with pytest.raises(NotImplementedError, match="12f"):
        T.flops(object(), [1, 2])


def test_callbacks_effects(tmp_path):
    model = _lenet_model(T)
    sched = T.optimizer.lr.StepDecay(0.1, step_size=1, gamma=0.5)
    model._optimizer = T.optimizer.SGD(learning_rate=sched,
                                       parameters=model.network.parameters())
    seen = []

    class Order(T.callbacks.Callback):
        def on_train_batch_end(self, step, logs=None):
            seen.append(("batch", step, sched.get_lr()))

        def on_epoch_end(self, epoch, logs=None):
            seen.append(("epoch_end", epoch, "eval_loss" in logs))

    np.random.seed(0)
    model.fit(_mnist(T, 64), _mnist(T, 32), batch_size=32, epochs=2,
              verbose=1, save_dir=str(tmp_path / "ckpt"),
              callbacks=[T.callbacks.LRScheduler(), Order(),
                         T.callbacks.VisualDL(str(tmp_path / "vdl"))])
    # LRScheduler steps per batch (2 a epoch) and fit once an epoch
    lrs = [lr for kind, _, lr in seen if kind == "batch"]
    assert lrs == [0.05, 0.025, 0.00625, 0.003125]
    assert [s for s in seen if s[0] == "epoch_end"] == [
        ("epoch_end", 0, True), ("epoch_end", 1, True)]
    files = sorted(os.listdir(tmp_path / "ckpt"))
    assert {"0.pdparams", "1.pdparams", "final.pdparams"} <= set(files)
    lines = (tmp_path / "vdl" / "metrics.jsonl").read_text().splitlines()
    assert [json.loads(x)["epoch"] for x in lines] == [0, 1]
    assert "eval_acc" in json.loads(lines[0])

    es = T.callbacks.EarlyStopping(monitor="loss", patience=1)
    es.set_model(model)
    for epoch, loss in enumerate([1.0, 0.9, 0.95]):
        es.on_epoch_end(epoch, {"loss": loss})
    assert model.stop_training
    model.stop_training = False

    plain = T.Model(model.network)
    plain.prepare(T.optimizer.SGD(learning_rate=0.4,
                                  parameters=model.network.parameters()))
    rl = T.callbacks.ReduceLROnPlateau(monitor="loss", factor=0.5,
                                       patience=1, verbose=0)
    rl.set_model(plain)
    for loss in (1.0, 1.0, 1.0):
        rl.on_epoch_end(0, {"loss": loss})
    assert plain._optimizer.get_lr() == pytest.approx(0.1)  # two waits


def test_quirks(capsys):
    model = _lenet_model(T)
    net = model.network
    frozen = net.fc[0].weight
    frozen.stop_gradient = True
    before = _np(frozen).copy()
    x = _mnist(T, 32)
    batch = [np.stack([x[i][0] for i in range(8)]),
             np.stack([x[i][1] for i in range(8)])]
    res = model.train_batch([batch[0]], [batch[1]])
    assert isinstance(res[0], float) and len(res) == 2  # loss + acc
    np.testing.assert_array_equal(_np(frozen), before)
    # _split_batch: inputs first, the rest labels
    assert [len(p) for p in model._split_batch([1, 2, 3])] == [2, 1]
    assert [len(p) for p in model._split_batch([1])] == [1, 0]
    typed = T.Model(net, inputs=["a"], labels=["b", "c"])
    assert [len(p) for p in typed._split_batch([1, 2, 3])] == [1, 2]
    labelled = T.Model(net, labels=["b"])
    assert [len(p) for p in labelled._split_batch([1, 2, 3])] == [2, 1]
    jm = J.Model(J.nn.Linear(2, 2), labels=["b"])
    assert [len(p) for p in jm._split_batch([np.zeros(1)] * 3)] == [2, 1]
    # predict_batch: eval inside, train after
    modes = []
    net.register_forward_post_hook(lambda l, i, o: modes.append(l.training))
    out = model.predict_batch([batch[0]])
    assert modes == [False] and net.training and out.shape == (8, 10)
    # the scheduler: once an epoch by fit
    sched = T.optimizer.lr.StepDecay(0.1, step_size=1, gamma=0.5)
    model._optimizer = T.optimizer.SGD(learning_rate=sched,
                                       parameters=net.parameters())
    model.fit(_mnist(T, 64), batch_size=32, epochs=2, verbose=0)
    assert sched.last_epoch == 2
