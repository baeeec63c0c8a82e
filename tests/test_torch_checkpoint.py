"""Distributed checkpoints of the port (``distributed.checkpoint``)
against the JAX package's, the reference on its ``framework.io.save``
branch (``state.pdparams``), the one it takes where orbax is absent (the
card's machine has none; its orbax branch has no counterpart in the
port), forced here by ``_HAS_ORBAX = False``.

- a checkpoint of either package loads into the other: a layer model's
  state written by one package's ``save_state_dict`` is read by the
  other's ``load_state_dict``, entry for entry equal (exact), and the
  model it is set into gives the writer's output (rtol 1e-6);
- ``AutoCheckpoint``: the snapshots kept (interval 2, ``max_to_keep``
  2, seven steps), ``latest()`` and each kept snapshot's contents equal
  the reference's;
- model parallelism over two spawned gloo ranks (mp2, the tiny GPT of
  ``tests/test_torch_fleet_ranks.py``): ``save_state_dict`` of the cut
  model writes the WHOLE state once (rank 0; exact against the uncut
  model's), and ``load_state_dict(path, model)`` sets each rank's shard
  (``meta_parallel.shard_state_dict`` of the file, exact);
  ``AutoCheckpoint`` over the ranks keeps one snapshot, and both ranks
  name it.
"""
import os

import numpy as np
import pytest

import paddle_tpu as J
import paddle_tpu.distributed.checkpoint as jck
import paddle_tpu_torch as T
import paddle_tpu_torch.distributed.checkpoint as pck
from paddle_tpu_torch import _device


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setattr(jck, "_HAS_ORBAX", False)
    prev = _device._CURRENT
    T.set_device("cpu")
    yield
    _device._CURRENT = prev


def _models():
    J.seed(3)
    ref = J.nn.Sequential(J.nn.Linear(6, 5), J.nn.Tanh(), J.nn.Linear(5, 2))
    T.seed(4)
    port = T.nn.Sequential(T.nn.Linear(6, 5), T.nn.Tanh(), T.nn.Linear(5, 2))
    return ref, port


def _x():
    return np.random.default_rng(1).standard_normal((3, 6)).astype(np.float32)


def test_port_checkpoint_loads_into_the_reference(tmp_path):
    ref, port = _models()
    pck.save_state_dict(port.state_dict(), str(tmp_path))
    got = jck.load_state_dict(str(tmp_path))
    want = {k: v.detach().numpy() for k, v in port.state_dict().items()}
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(np.asarray(got[k]), v)
    ref.set_state_dict(got)
    np.testing.assert_allclose(ref(J.to_tensor(_x())).numpy(),
                               port(T.to_tensor(_x())).detach().numpy(),
                               rtol=1e-6)


def test_reference_checkpoint_loads_into_the_port(tmp_path):
    ref, port = _models()
    jck.save_state_dict(ref.state_dict(), str(tmp_path))
    got = pck.load_state_dict(str(tmp_path))
    want = {k: v.numpy() for k, v in ref.state_dict().items()}
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(np.asarray(got[k]), v)
    pck.load_state_dict(str(tmp_path), port)  # set into the model
    np.testing.assert_allclose(port(T.to_tensor(_x())).detach().numpy(),
                               ref(J.to_tensor(_x())).numpy(), rtol=1e-6)


def _auto(mod, directory):
    ac = mod.AutoCheckpoint(directory, save_interval_steps=2, max_to_keep=2)
    latest = []
    for i in range(7):
        assert ac.step(lambda: {"w": np.full((2,), i, np.float32)}) == i + 1
        latest.append(None if ac.latest() is None
                      else os.path.basename(ac.latest()))
    kept = sorted(os.listdir(directory))
    return latest, kept, [np.asarray(mod.load_state_dict(
        os.path.join(directory, d))["w"]).tolist() for d in kept]


def test_auto_checkpoint_keeps_what_the_reference_keeps(tmp_path):
    want = _auto(jck, str(tmp_path / "ref"))
    got = _auto(pck, str(tmp_path / "port"))
    assert got == want
    assert got[1] == ["step_4", "step_6"] and got[0][-1] == "step_6"


def test_model_parallel_checkpoint_writes_whole_and_loads_shards(tmp_path):
    import jax

    if len(jax.devices()) < 2:
        pytest.skip("needs the conftest 8-device CPU mesh")
    from paddle_tpu.text.gpt import GPTConfig as JGPTConfig
    from paddle_tpu.text.gpt import GPTForCausalLM as JGPT
    from paddle_tpu_torch.distributed import fleet, spawn
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        model_specs, shard_state_dict)
    from paddle_tpu_torch.framework.io import load
    from test_torch_fleet_ranks import GPT, gpt_from
    from test_torch_sp_ranks import SPAWN_TIMEOUT_S, checkpoint_rank

    params = {}
    for prefix, s in (("p:", 11), ("q:", 12)):
        J.seed(s)
        m = JGPT(JGPTConfig(**GPT))
        params.update({prefix + k: np.asarray(v._value) for k, v in
                       m.functional_state()[0].items()})
    path = str(tmp_path / "in.npz")
    np.savez(path, **params)
    out = str(tmp_path / "ck")
    ranks = spawn(checkpoint_rank, 2,
                  args=(f"file://{tmp_path / 'rdv'}", path, out),
                  timeout_s=SPAWN_TIMEOUT_S)
    full_model = gpt_from({k[2:]: v for k, v in params.items()
                           if k.startswith("p:")})
    full = {k: v.detach() for k, v in full_model.state_dict().items()}
    written = load(os.path.join(out, "whole", "state.pdparams"))
    assert sorted(written) == sorted(full)
    for k, v in full.items():
        np.testing.assert_array_equal(np.asarray(written[k]), v.numpy())
    fleet.apply_megatron_specs(full_model)
    specs = model_specs(full_model)
    assert specs  # the GPT's projections are split
    for r, res in enumerate(ranks):
        want = shard_state_dict(full, specs, r, 2)
        assert sorted(res["state"]) == sorted(want)
        for k, v in want.items():
            np.testing.assert_array_equal(res["state"][k], v.numpy(),
                                          err_msg=f"rank {r} {k}")
        assert res["latest"] == os.path.join(out, "auto", "step_2")
    assert os.listdir(os.path.join(out, "auto")) == ["step_2"]
