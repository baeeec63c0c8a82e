"""``paddle_tpu_torch.save`` / ``load`` (``framework/io.py``) against the
JAX package's: files cross both ways, with equal arrays and dtypes.

- a state dict (float32, float64, int64, bool and a bfloat16 tensor,
  which both packages widen to float32) under pickle protocols 2, 3
  and 4: the port's file read by ``paddle_tpu.load``, the reference's by
  ``paddle_tpu_torch.load``, and the raw pickles equal key for key;
- a nested object (a dict holding a list, a tensor and a number);
- a big parameter sliced for protocols 2-3 (``UnpackBigParamInfor@@``),
  written by hand in the reference's layout, merged on load by both;
- the binary LoDTensor stream (``use_binary_format=True``), float32,
  int64 and bfloat16, both ways and byte for byte;
- a ``.pdparams`` of the JAX GPT through ``paddle_tpu_torch.load``, then
  ``text.convert.state_dict_from_jax``, then ``set_state_dict``: the
  port's logits equal the JAX model's within float32 ``atol 2e-5``
  (summation order), and ``set_state_dict`` reports missing and
  unexpected keys as the reference does.
"""
import pickle

import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu_torch as T
from paddle_tpu.text.gpt import GPTConfig as JGPTConfig
from paddle_tpu.text.gpt import GPTForCausalLM as JGPT
from paddle_tpu_torch import _device
from paddle_tpu_torch.core.dtype import convert_dtype
from paddle_tpu_torch.framework import io as tio
from paddle_tpu_torch.text import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.text.convert import state_dict_from_jax


@pytest.fixture(autouse=True)
def _cpu():
    prev = _device._CURRENT
    T.set_device("cpu")
    yield
    _device._CURRENT = prev


def _arrays():
    rng = np.random.RandomState(0)
    return {"w": rng.standard_normal((4, 3)).astype(np.float32),
            "d": rng.standard_normal(5),
            "i": rng.randint(0, 9, (2, 2)).astype(np.int64),
            "m": rng.rand(3) > 0.5,
            "h": rng.standard_normal(6).astype(np.float32)}


def _port_state():
    sd = {k: T.to_tensor(v) for k, v in _arrays().items()}
    sd["h"] = sd["h"].astype("bfloat16")
    return sd


def _jax_state():
    sd = {k: J.to_tensor(v) for k, v in _arrays().items()}
    sd["h"] = sd["h"].astype("bfloat16")
    return sd


def _same(got: dict, want: dict, side: str):
    assert set(got) == set(want)
    for k in want:
        g, w = got[k], want[k]
        gd = convert_dtype(g.dtype) if side == "port" else g.dtype
        wd = w.dtype if not isinstance(w, np.ndarray) else w.dtype.name
        assert gd == (wd if isinstance(wd, str) else convert_dtype(wd)), k
        np.testing.assert_array_equal(np.asarray(g.numpy()),
                                      np.asarray(w.numpy()
                                                 if hasattr(w, "numpy")
                                                 else w), err_msg=k)


@pytest.mark.parametrize("protocol", [2, 3, 4])
def test_state_dict_crosses_both_ways(tmp_path, protocol):
    port_file, jax_file = tmp_path / "port.pdparams", tmp_path / "jax.pdparams"
    T.save(_port_state(), str(port_file), protocol=protocol)
    J.save(_jax_state(), str(jax_file), protocol=protocol)
    with open(port_file, "rb") as f1, open(jax_file, "rb") as f2:
        raw_t, raw_j = pickle.load(f1), pickle.load(f2)
    assert set(raw_t) == set(raw_j)
    for k in raw_j:
        if isinstance(raw_j[k], np.ndarray):
            assert raw_t[k].dtype == raw_j[k].dtype
            np.testing.assert_array_equal(raw_t[k], raw_j[k])
        else:
            assert raw_t[k] == raw_j[k]
    # the port reads the reference's file, the reference the port's
    from_jax = T.load(str(jax_file))
    from_port = J.load(str(port_file))
    assert all(isinstance(v, T.Tensor) for v in from_jax.values())
    _same(from_jax, J.load(str(jax_file)), "port")
    _same(from_port, from_jax, "jax")
    np_back = T.load(str(port_file), return_numpy=True)
    assert np_back["h"].dtype == np.float32  # bf16 widened on save
    for P in (T, J):
        with pytest.raises(ValueError):
            P.save(_port_state() if P is T else _jax_state(),
                   str(tmp_path / "x"), protocol=5)


def test_nested_object_crosses_both_ways(tmp_path):
    arr = np.arange(6, dtype=np.float32).reshape(2, 3)
    T.save({"a": [T.to_tensor(arr), 3], "b": {"c": T.to_tensor(arr[0])},
            "n": "text"}, str(tmp_path / "p.pd"))
    J.save({"a": [J.to_tensor(arr), 3], "b": {"c": J.to_tensor(arr[0])},
            "n": "text"}, str(tmp_path / "j.pd"))
    for path in ("p.pd", "j.pd"):
        t, j = T.load(str(tmp_path / path)), J.load(str(tmp_path / path))
        np.testing.assert_array_equal(t["a"][0].numpy(), j["a"][0].numpy())
        np.testing.assert_array_equal(t["b"]["c"].numpy(),
                                      j["b"]["c"].numpy())
        assert t["a"][1] == j["a"][1] == 3 and t["n"] == j["n"] == "text"
        assert isinstance(t["a"][0], T.Tensor)


def test_sliced_big_parameter_merges_on_load(tmp_path):
    """The reference's protocol-2/3 layout for a parameter past the
    slicing threshold, written by hand at a small size."""
    full = np.arange(10, dtype=np.float32).reshape(2, 5)
    flat = full.reshape(-1)
    saved = {"big@@.0": flat[:4], "big@@.1": flat[4:8], "big@@.2": flat[8:],
             "small": np.ones(2, np.float32),
             "StructuredToParameterName@@": {"big": "big", "small": "small"},
             "UnpackBigParamInfor@@": {"big": {
                 "OriginShape": (2, 5),
                 "slices": ["big@@.0", "big@@.1", "big@@.2"]}}}
    path = tmp_path / "sliced.pdparams"
    with open(path, "wb") as f:
        pickle.dump(saved, f, protocol=2)
    t, j = T.load(str(path)), J.load(str(path))
    assert set(t) == set(j) == {"big", "small"}
    np.testing.assert_array_equal(t["big"].numpy(), full)
    np.testing.assert_array_equal(j["big"].numpy(), full)
    # below the threshold nothing is sliced, in either package
    arrs = {"w": np.ones((3, 3), np.float32)}
    from paddle_tpu.framework import io as jio
    assert tio._unpack_big_params(dict(arrs), 2).keys() == \
        jio._unpack_big_params(dict(arrs), 2).keys() == {"w"}


@pytest.mark.parametrize("dtype", ["float32", "int64", "bfloat16"])
def test_binary_lod_tensor_crosses_both_ways(tmp_path, dtype):
    arr = np.random.RandomState(1).standard_normal((3, 4)) * 5
    t = T.to_tensor(arr.astype(np.float32)).astype(dtype)
    j = J.to_tensor(arr.astype(np.float32)).astype(dtype)
    T.save(t, str(tmp_path / "t.bin"), use_binary_format=True)
    J.save(j, str(tmp_path / "j.bin"), use_binary_format=True)
    assert (tmp_path / "t.bin").read_bytes() == \
        (tmp_path / "j.bin").read_bytes()
    for name in ("t.bin", "j.bin"):
        got = T.load(str(tmp_path / name))
        want = J.load(str(tmp_path / name))
        assert isinstance(got, T.Tensor)
        assert convert_dtype(got.dtype) == want.dtype == dtype
        np.testing.assert_array_equal(
            got.float().numpy() if dtype == "bfloat16" else got.numpy(),
            np.asarray(want.numpy(), np.float32)
            if dtype == "bfloat16" else want.numpy())
    with pytest.raises(TypeError):
        T.save({"a": t}, str(tmp_path / "x.bin"), use_binary_format=True)


SMALL = dict(vocab_size=97, hidden_size=32, num_layers=2, num_heads=4,
             max_seq_len=16)


def test_jax_gpt_checkpoint_loads_into_the_port(tmp_path):
    J.seed(5)
    jm = JGPT(JGPTConfig(**SMALL))
    jm.eval()
    path = str(tmp_path / "gpt.pdparams")
    J.save(jm.state_dict(), path)
    cfg = GPTConfig(**SMALL)
    tm = GPTForCausalLM(cfg, device="cpu")
    loaded = T.load(path)
    missing, unexpected = tm.set_state_dict(state_dict_from_jax(loaded,
                                                                cfg))
    assert missing == [] and unexpected == []
    ids = np.random.RandomState(2).randint(0, 97, (2, 16)).astype(np.int64)
    want = jm(J.to_tensor(ids)).numpy()
    got = tm(T.to_tensor(ids))
    assert isinstance(got, T.Tensor)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=2e-5,
                               rtol=0)
    # the reference's missing / unexpected rule
    sd = dict(tm.state_dict())
    sd.pop("gpt.ln_f.bias")
    sd["extra"] = torch.zeros(1)
    missing, unexpected = tm.set_state_dict(sd)
    jsd = dict(jm.state_dict())
    jsd.pop("gpt.ln_f.bias")
    jsd["extra"] = J.zeros([1])
    assert (missing, unexpected) == tuple(jm.set_state_dict(jsd)) == \
        (["gpt.ln_f.bias"], ["extra"])
    with pytest.raises(ValueError):
        tm.set_state_dict({"gpt.ln_f.bias": np.zeros(3, np.float32)})


def test_port_checkpoint_round_trip_is_exact(tmp_path):
    cfg = GPTConfig(**SMALL)
    src = GPTForCausalLM(cfg, device="cpu",
                         generator=torch.Generator().manual_seed(0))
    T.save(src.state_dict(), str(tmp_path / "m.pdparams"))
    dst = GPTForCausalLM(cfg, device="cpu",
                         generator=torch.Generator().manual_seed(1))
    assert dst.load_dict(T.load(str(tmp_path / "m.pdparams"))) == ([], [])
    ids = T.to_tensor(np.arange(16).reshape(1, 16) % 97)
    assert torch.equal(src(ids), dst(ids))
