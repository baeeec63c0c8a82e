"""``examples/train_gpt.py`` — Paddle's 2.x dygraph workflow on the GPT —
against the port.

1. The example's loop (``seed``, ``to_tensor`` of a fixed numpy batch,
   ``model(ids, labels=)``, ``backward``, ``AdamW(learning_rate=
   CosineAnnealingDecay(3e-3, 20), parameters=model.parameters(),
   weight_decay=0.01)``, ``step`` / ``sched.step`` / ``clear_grad``,
   ``float(loss.numpy())``) runs 20 steps in the JAX package and in the
   port, the port's model carrying the JAX model's initial parameters
   (``paddle_tpu_torch.load`` of its ``.pdparams``, then
   ``text.convert.state_dict_from_jax``): the losses agree step for step
   within 1e-5, the tolerance ``tests/test_torch_train.py`` holds a
   float32 step to. The reference's 20 steps run as one ``jax.jit`` of its
   step (``functional_call``'s loss and gradients, then the optimizer's
   ``functional_update`` at the scheduler's rate, passed in as an
   argument), not op by op.
2. The example file itself, unedited, runs against the port on the CPU
   (``set_device("cpu")``, the ``paddle_tpu`` modules it imports aliased
   to the port's): its own assertion (the loss falls) and its checkpoint
   round trip pass, and its printed losses equal those of part 1.
"""
import io
import os
import runpy
import sys
from contextlib import redirect_stdout

import jax
import numpy as np
import pytest

import paddle_tpu as J
import paddle_tpu_torch as T
from paddle_tpu.text.gpt import GPTConfig as JGPTConfig
from paddle_tpu.core.tensor import Tensor as JTensor
from paddle_tpu.text.gpt import GPTForCausalLM as JGPT
from paddle_tpu_torch import _device
from paddle_tpu_torch.text.convert import state_dict_from_jax
from paddle_tpu_torch.text.gpt import GPTConfig, GPTForCausalLM

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLE = os.path.join(ROOT, "examples", "train_gpt.py")
CFG = dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=4,
           max_seq_len=64, dropout=0.0)
STEPS, LOSS_TOL = 20, 1e-5


@pytest.fixture(autouse=True)
def _cpu():
    prev = _device._CURRENT
    T.set_device("cpu")
    yield
    _device._CURRENT = prev


def _loop(P, model, steps=STEPS):
    """The example's loop body, verbatim but for the package."""
    sched = P.optimizer.lr.CosineAnnealingDecay(3e-3, T_max=20)
    opt = P.optimizer.AdamW(learning_rate=sched,
                            parameters=model.parameters(),
                            weight_decay=0.01)
    rng = np.random.RandomState(0)
    data = rng.randint(0, 512, (8, 65)).astype("int64")
    losses = []
    for _ in range(steps):
        ids = P.to_tensor(data[:, :-1])
        labels = P.to_tensor(data[:, 1:])
        loss = model(ids, labels=labels)
        loss.backward()
        opt.step()
        sched.step()
        opt.clear_grad()
        losses.append(float(loss.numpy()))
    return losses


def _jax_losses(tmp_path):
    """The example's loop in the reference, each step one ``jax.jit``."""
    J.seed(0)
    jm = JGPT(JGPTConfig(**CFG))
    path = str(tmp_path / "init.pdparams")
    J.save(jm.state_dict(), path)
    sched = J.optimizer.lr.CosineAnnealingDecay(3e-3, T_max=20)
    opt = J.optimizer.AdamW(learning_rate=sched,
                            parameters=jm.parameters(), weight_decay=0.01)
    params, buffers = jm.functional_state()
    p = {k: v._value for k, v in params.items()}
    b = {k: v._value for k, v in buffers.items() if v is not None}

    def loss_fn(p, ids, labels):
        out, _ = jm.functional_call(p, b, JTensor(ids), labels=JTensor(labels))
        return out._value

    @jax.jit
    def step(p, state, ids, labels, lr):
        loss, grads = jax.value_and_grad(loss_fn)(p, ids, labels)
        p, state = opt.functional_update(p, grads, state, lr)
        return loss, p, state

    state = opt.functional_init(p)
    rng = np.random.RandomState(0)
    data = rng.randint(0, 512, (8, 65)).astype("int64")
    losses = []
    for _ in range(STEPS):
        loss, p, state = step(p, state, data[:, :-1], data[:, 1:],
                              np.float32(sched()))
        sched.step()
        losses.append(float(loss))
    return losses, path


def test_losses_equal_the_reference_step_for_step(tmp_path):
    want, init = _jax_losses(tmp_path)
    T.seed(0)
    tm = GPTForCausalLM(GPTConfig(**CFG))
    assert tm.set_state_dict(state_dict_from_jax(T.load(init),
                                                 tm.cfg)) == ([], [])
    got = _loop(T, tm)
    np.testing.assert_allclose(got, want, atol=LOSS_TOL, rtol=0)
    assert got[-1] < got[0]


def test_the_example_file_runs_against_the_port(monkeypatch):
    import paddle_tpu_torch.text
    import paddle_tpu_torch.text.gpt

    for name, mod in (("paddle_tpu", T),
                      ("paddle_tpu.text", paddle_tpu_torch.text),
                      ("paddle_tpu.text.gpt", paddle_tpu_torch.text.gpt)):
        monkeypatch.setitem(sys.modules, name, mod)
    monkeypatch.delitem(sys.modules, "_common", raising=False)
    monkeypatch.syspath_prepend(os.path.dirname(EXAMPLE))
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    out = io.StringIO()
    with redirect_stdout(out):
        runpy.run_path(EXAMPLE, run_name="__main__")
    text = out.getvalue()
    assert "checkpoint round-trip ok" in text
    sys.modules.pop("_common", None)
    # the printed losses (every fifth step) are the port's own loop's
    T.seed(0)
    printed = [float(line.split()[3]) for line in text.splitlines()
               if line.startswith("step")]
    T.seed(0)
    model = GPTForCausalLM(GPTConfig(**CFG))
    losses = _loop(T, model)
    np.testing.assert_allclose(printed, losses[::5], atol=1e-4, rtol=0)
