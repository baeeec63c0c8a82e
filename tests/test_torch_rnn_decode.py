"""``nn.rnn`` and ``nn.decode`` of the port against the JAX package's, on
the CPU. Each side builds its layers after ``seed(0)``; the weights must
agree (``Uniform`` draws, rtol 1e-5 / atol 2e-5) and the reference's are
loaded into the port's. Outputs, final states and the gradients of
``sum(output * cotangent)`` with respect to the inputs, the initial
states and every parameter agree within rtol 1e-4 / atol 1e-5 (products
summed in another order, then a time loop).

- ``SimpleRNN``, ``GRU`` and ``LSTM``: one and two layers, forward and
  bidirectional, batch- and time-major, with and without initial states.
- The cells: ``SimpleRNNCell`` (tanh, relu), ``GRUCell``, ``LSTMCell``.
- The ``RNN`` / ``BiRNN`` wrappers under ``sequence_length``: outputs
  zero past each length and states kept from the last real step, forward
  and reverse, both layouts (values only: the reference masks outside its
  tape, so nothing it returns there takes a gradient; the port's does).
- Pinned: ``_RNNBase.forward`` reads neither ``sequence_length`` nor
  ``dropout`` (both packages return the same outputs with and without
  them).
- ``gather_tree`` on a hand-traced case; beam search (``LSTMCell``,
  ``Embedding``, ``Linear`` carried from the reference) through
  ``dynamic_decode`` with the same tokens, lengths and scores; ties
  broken toward the lower index, as ``lax.top_k``; a greedy
  ``Decoder`` with ``impute_finished`` and time-major outputs.
"""
import numpy as np
import pytest

import paddle_tpu as J
import paddle_tpu_torch as T
from paddle_tpu_torch import _device
from paddle_tpu_torch.analysis.layercheck import to_numpy

TOL = dict(rtol=1e-4, atol=1e-5)
INIT_TOL = dict(rtol=1e-5, atol=2e-5)


@pytest.fixture(autouse=True)
def _cpu():
    prev = _device._CURRENT
    T.set_device("cpu")
    yield
    _device._CURRENT = prev


def _flat(out):
    if isinstance(out, (tuple, list)):
        return [v for o in out for v in _flat(o)]
    return [out]


def _built(build):
    """``build(P)`` in both packages after ``seed(0)``, the reference's
    weights checked against the port's draws and loaded into it."""
    J.seed(0)
    jl = build(J)
    T.seed(0)
    tl = build(T)
    want = {k: to_numpy(v) for k, v in jl.state_dict().items()}
    got = {k: to_numpy(v) for k, v in tl.state_dict().items()}
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **INIT_TOL)
    missing, unexpected = tl.set_state_dict(want)
    assert missing == [] and unexpected == []
    return jl, tl


def _drive(P, layer, call, arrays, grad=True):
    ts = [P.to_tensor(a, stop_gradient=not (grad and a.dtype == np.float32))
          for a in arrays]
    outs = _flat(call(layer, ts))
    if grad:
        rng = np.random.default_rng(9)
        loss = None
        for o in outs:
            c = P.to_tensor(rng.standard_normal(tuple(o.shape)).astype(
                np.float32))
            term = P.sum(o * c)
            loss = term if loss is None else loss + term
        loss.backward()
    return ([to_numpy(o) for o in outs],
            {i: to_numpy(t.grad) for i, t in enumerate(ts)
             if not t.stop_gradient},
            {n: to_numpy(p.grad) for n, p in layer.named_parameters()
             if p.grad is not None} if grad else {})


def _compare(build, call, arrays, grad=True):
    jl, tl = _built(build)
    want = _drive(J, jl, call, arrays, grad)
    got = _drive(T, tl, call, arrays, grad)
    assert len(got[0]) == len(want[0])
    for i, (g, w) in enumerate(zip(got[0], want[0])):
        assert g.shape == w.shape, (i, g.shape, w.shape)
        np.testing.assert_allclose(g, w, err_msg=f"output {i}", **TOL)
    for part in (1, 2):
        assert sorted(got[part]) == sorted(want[part])
        for k in want[part]:
            np.testing.assert_allclose(got[part][k], want[part][k],
                                       err_msg=str(k), **TOL)
    return got


def _f(*shape):
    return np.random.default_rng(sum(shape)).standard_normal(shape).astype(
        np.float32)


# (num_layers, direction, time_major, initial states)
CONFIGS = [(1, "forward", False, False), (2, "bidirect", True, True),
           (2, "forward", False, True), (1, "bidirectional", False, False)]


@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: "-".join(map(str, c)))
@pytest.mark.parametrize("mode", ["SimpleRNN", "GRU", "LSTM"])
def test_rnn_layers_match_the_reference(mode, cfg):
    layers, direction, time_major, init = cfg
    dirs = 1 if direction == "forward" else 2
    b, t, i, h = 2, 4, 3, 5
    x = _f(t, b, i) if time_major else _f(b, t, i)
    arrays = [x]
    if init:
        arrays.append(_f(layers * dirs, b, h))
        if mode == "LSTM":
            arrays.append(_f(layers * dirs, b, h) * 0.5)

    def build(P):
        return getattr(P.nn, mode)(i, h, num_layers=layers,
                                   direction=direction, time_major=time_major)

    def call(layer, ts):
        if not init:
            return layer(ts[0])
        states = (ts[1], ts[2]) if mode == "LSTM" else ts[1]
        return layer(ts[0], states)

    got = _compare(build, call, arrays)
    out = got[0][0]
    assert out.shape == ((t, b, h * dirs) if time_major else (b, t, h * dirs))


@pytest.mark.parametrize("cell,with_states", [
    ("SimpleRNNCell-tanh", True), ("SimpleRNNCell-relu", False),
    ("GRUCell", True), ("GRUCell", False), ("LSTMCell", True),
    ("LSTMCell", False)])
def test_cells_match_the_reference(cell, with_states):
    name, _, act = cell.partition("-")

    def build(P):
        kw = {"activation": act} if act else {}
        return getattr(P.nn, name)(3, 4, **kw)

    arrays = [_f(2, 3)]
    if with_states:
        arrays += [_f(2, 4)] + ([_f(2, 4)] if name == "LSTMCell" else [])

    def call(layer, ts):
        if not with_states:
            return layer(ts[0])
        return layer(ts[0], (ts[1], ts[2]) if name == "LSTMCell" else ts[1])

    _compare(build, call, arrays)


@pytest.mark.parametrize("wrapper,reverse,time_major", [
    ("RNN", False, False), ("RNN", True, True), ("BiRNN", None, False),
    ("BiRNN", None, True)])
def test_wrapper_masks_outputs_and_states_past_each_length(wrapper, reverse,
                                                           time_major):
    b, t = 3, 5
    lengths = np.array([5, 2, 3], np.int64)
    x = _f(t, b, 3) if time_major else _f(b, t, 3)

    def build(P):
        if wrapper == "RNN":
            return P.nn.RNN(P.nn.SimpleRNNCell(3, 4), is_reverse=reverse,
                            time_major=time_major)
        return P.nn.BiRNN(P.nn.SimpleRNNCell(3, 4), P.nn.SimpleRNNCell(3, 4),
                          time_major=time_major)

    def call(layer, ts):
        return layer(ts[0], sequence_length=ts[1])

    got = _compare(build, call, [x, lengths], grad=False)
    y = got[0][0]
    for row, n in enumerate(lengths):
        past = y[n:, row] if time_major else y[row, n:]
        assert (past == 0).all()
        assert (y[:n, row] if time_major else y[row, :n]).any(-1).all()
    # the port's masked outputs take a gradient (the reference's do not)
    T.seed(0)
    layer = build(T)
    xt = T.to_tensor(x, stop_gradient=False)
    out = _flat(call(layer, [xt, T.to_tensor(lengths)]))[0]
    T.sum(out).backward()
    assert xt.grad is not None and float(T.abs(xt.grad).sum()) > 0


@pytest.mark.parametrize("mode", ["GRU", "LSTM"])
def test_rnn_base_ignores_sequence_length_and_dropout(mode):
    """Pinned: ``_RNNBase.forward`` never reads ``sequence_length``, and
    ``dropout`` is stored but never applied, in both packages."""
    x = _f(2, 4, 3)
    outs = {}
    for P in (J, T):
        P.seed(0)
        plain = getattr(P.nn, mode)(3, 4, num_layers=2)
        P.seed(0)
        dropped = getattr(P.nn, mode)(3, 4, num_layers=2, dropout=0.9)
        a = _flat(plain(P.to_tensor(x)))
        b = _flat(plain(P.to_tensor(x),
                        sequence_length=P.to_tensor(np.array([1, 2]))))
        c = _flat(dropped.train()(P.to_tensor(x)))
        for u, v, w in zip(a, b, c):
            np.testing.assert_array_equal(to_numpy(u), to_numpy(v))
            np.testing.assert_array_equal(to_numpy(u), to_numpy(w))
        outs[P] = [to_numpy(v) for v in a]
    for g, w in zip(outs[T], outs[J]):
        np.testing.assert_allclose(g, w, **TOL)


def test_gather_tree_traces_each_final_beam_back():
    ids = np.array([[[2, 3]], [[5, 6]], [[7, 8]]], np.int64)  # [T, 1, 2]
    parents = np.array([[[0, 0]], [[1, 0]], [[1, 1]]], np.int64)
    # final beam 0: t2 token 7 from beam 1; t1 token 6 from beam 0;
    # t0 token 2. Final beam 1: 8 <- beam 1 (6 <- beam 0 (2)).
    want = np.array([[[2, 2]], [[6, 6]], [[7, 8]]])
    for P in (J, T):
        got = P.nn.functional.gather_tree(P.to_tensor(ids),
                                          P.to_tensor(parents))
        np.testing.assert_array_equal(to_numpy(got), want)


def _beam(P, beam, weights=None, max_step=12):
    P.seed(0)
    vocab, hidden = 17, 16
    emb = P.nn.Embedding(vocab, hidden)
    cell = P.nn.LSTMCell(hidden, hidden)
    proj = P.nn.Linear(hidden, vocab)
    if weights is not None:
        for m, sd in zip((emb, cell, proj), weights):
            assert m.set_state_dict(sd) == ([], [])
    dec = P.nn.BeamSearchDecoder(cell, start_token=1, end_token=2,
                                 beam_size=beam, embedding_fn=emb,
                                 output_fn=proj)
    h0 = P.to_tensor(np.random.RandomState(0).randn(3, hidden).astype(
        np.float32))
    c0 = P.to_tensor(np.zeros((3, hidden), np.float32))
    out, states, lengths = P.nn.dynamic_decode(
        dec, inits=(h0, c0), max_step_num=max_step, return_length=True)
    weights = [{k: to_numpy(v) for k, v in m.state_dict().items()}
               for m in (emb, cell, proj)]
    return (to_numpy(out), to_numpy(lengths),
            to_numpy(states["log_probs"]), weights)


@pytest.mark.parametrize("beam", [1, 4])
def test_beam_search_tokens_equal_the_references(beam):
    ids_j, len_j, lp_j, weights = _beam(J, beam)
    ids_t, len_t, lp_t, _ = _beam(T, beam, weights)
    assert ids_t.shape == ids_j.shape == (3, 12, beam)
    np.testing.assert_array_equal(ids_t, ids_j)
    np.testing.assert_array_equal(len_t, len_j)
    np.testing.assert_allclose(lp_t, lp_j, rtol=1e-5, atol=1e-5)


class _TieCell:
    """Every step the same logits with exact ties between tokens, so beam
    selection rests on the tie rule alone."""

    def __init__(self, P, logits):
        self.P, self.logits = P, logits

    def __call__(self, inputs, states):
        n = inputs.shape[0]
        return self.P.to_tensor(np.tile(self.logits, (n, 1))), states


def test_beam_ties_go_to_the_lower_index():
    logits = np.log(np.array([0.1, 0.3, 0.3, 0.3], np.float32))
    got = {}
    for P in (J, T):
        dec = P.nn.BeamSearchDecoder(_TieCell(P, logits), start_token=0,
                                     end_token=0, beam_size=3)
        out, _, lengths = P.nn.dynamic_decode(
            dec, inits=P.to_tensor(np.zeros((2, 1), np.float32)),
            max_step_num=3, return_length=True)
        got[P] = (to_numpy(out), to_numpy(lengths))
    np.testing.assert_array_equal(got[T][0], got[J][0])
    np.testing.assert_array_equal(got[T][1], got[J][1])
    assert got[T][0][0, 0].tolist() == [1, 1, 1]


def _greedy(P):
    """A greedy ``Decoder`` over a ``GRUCell`` in the package ``P``."""
    class Greedy(P.nn.Decoder):
        def __init__(self):
            self.emb = P.nn.Embedding(11, 6)
            self.cell = P.nn.GRUCell(6, 6)
            self.proj = P.nn.Linear(6, 11)

        def initialize(self, h0):
            n = h0.shape[0]
            return (self.emb(P.to_tensor(np.ones((n,), np.int64))), h0,
                    P.to_tensor(np.zeros((n,), bool)))

        def step(self, time, inputs, states, **kwargs):
            out, h = self.cell(inputs, states)
            logits = self.proj(out)
            token = P.argmax(logits, axis=-1)
            return ({"logits": logits, "token": token}, h,
                    self.emb(token), token == 3)

    return Greedy()


def test_dynamic_decode_greedy_impute_finished_time_major():
    results = {}
    weights = None
    for P in (J, T):
        P.seed(0)
        dec = _greedy(P)
        if weights is None:
            weights = [{k: to_numpy(v) for k, v in m.state_dict().items()}
                       for m in (dec.emb, dec.cell, dec.proj)]
        else:
            for m, sd in zip((dec.emb, dec.cell, dec.proj), weights):
                m.set_state_dict(sd)
        h0 = P.to_tensor(np.random.RandomState(1).randn(4, 6).astype(
            np.float32))
        out, state, lengths = P.nn.dynamic_decode(
            dec, inits=h0, max_step_num=7, output_time_major=True,
            impute_finished=True, return_length=True)
        results[P] = (to_numpy(out["logits"]), to_numpy(out["token"]),
                      to_numpy(state), to_numpy(lengths))
    got, want = results[T], results[J]
    assert got[0].shape == want[0].shape == (7, 4, 11)
    np.testing.assert_allclose(got[0], want[0], **TOL)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[2], want[2], **TOL)
    np.testing.assert_array_equal(got[3], want[3])


def test_impute_finished_refuses_beam_search_in_both():
    for P in (J, T):
        dec = P.nn.BeamSearchDecoder(_TieCell(P, np.zeros(4, np.float32)),
                                     0, 1, 2)
        with pytest.raises(ValueError):
            P.nn.dynamic_decode(dec, inits=P.to_tensor(np.zeros((1, 1),
                                                                np.float32)),
                                impute_finished=True)
