"""The port's public surface against the reference's, namespace by
namespace: the root (``paddle``), ``core``, each tensor-function module
and ``einsum``, ``linalg``, ``serving``, ``obs``, ``text``, ``nn``,
``nn.functional`` (its ``__all__`` and the functions its module defines
beyond it), ``nn.initializer``, ``nn.utils``, ``optimizer``, ``vision``
and ``vision.models``; and ``io``, ``reader``, ``dataset``,
``vision.ops``, ``vision.transforms``, ``vision.datasets``, ``amp``,
``autograd``, ``jit``, ``metric``, ``hapi``, ``profiler``,
``distributed`` and ``distributed.fleet`` by every
public name the reference module defines (its functions, classes and
submodules, whatever its ``__all__`` lists); ``callbacks`` (a re-export
that defines nothing of its own) by its ``__all__``.

Every public name of a reference namespace must exist in the port's
counterpart or stand in that namespace's ``NO_COUNTERPART`` dict with
its reason (a Queue 1 item not ported yet, or a TPU-only piece with
nothing to port); an entry whose name the port does have is stale and
fails. The behavioural divergences the port keeps on purpose are pinned
by ``test_pinned_divergence``. The Part-C modules of the dygraph core
each have their counterpart under the same path. The imports below fail
on a port whose package roots export less than the reference's.
"""
import functools
import importlib
import inspect
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu_torch as T
from paddle_tpu_torch import _device
from paddle_tpu_torch.serving import (SLOConfig, TenantSLO,  # noqa: F401
                                      encode_page, init_pools)
from paddle_tpu_torch.obs import FleetScope, load_banked_kernel_speedups  # noqa: F401
from paddle_tpu_torch.text import generate, sample_logits  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_12F = "ROADMAP item 12f (static graph, inference, fluid and the rest)"
_TPU = "TPU-only: the port runs on no TPU"
_MESH = ("a JAX device mesh; a rank of the port is a process, its groups "
         "collective.new_group's")

NO_COUNTERPART = {
    "root": {
        "TPUPlace": _TPU, "is_compiled_with_tpu": _TPU,
        "NPUPlace": "an NPU alias of the TPU place; the port has no NPU",
        "static": _12F, "enable_static": _12F, "inference": _12F,
        "LoDTensor": _12F, "RaggedTensor": _12F, "create_lod_tensor": _12F,
        "sparse": _12F, "fft": _12F, "signal": _12F,
        "distribution": _12F, "quantization": _12F, "onnx": _12F,
        "device": _12F, "compat": _12F,
        "sysconfig": _12F, "hub": _12F, "cost_model": _12F,
        "get_flags": _12F + " (the flags registry)",
        "set_flags": _12F + " (the flags registry)",
    },
    "core": {
        "TPUPlace": _TPU,
        "to_jax_dtype": "JAX dtypes; the port's is core.to_torch_dtype",
        "dispatch": "the jax.vjp op recorder; torch's autograd records "
                    "every op the port runs",
        "primitive": "the jax.vjp op recorder (torch's autograd)",
        "primitive_call": "the jax.vjp op recorder (torch's autograd)",
        "ragged": _12F, "selected_rows": _12F,
    },
    "hapi": {"static_flops": _12F + " (it reads a static Program)"},
    "distributed": {
        "global_mesh": _MESH, "set_global_mesh": _MESH,
    },
}
#: the reference's hybrid-step helpers that place arrays on a device mesh
#: (``paddle_tpu/distributed/fleet/hybrid_train.py``): nothing to port
MESH_ONLY = {"maybe_shard": _MESH, "mesh_scope": _MESH, "_zero_spec": _MESH,
             "active_mesh": _MESH, "build_hybrid_step": _MESH}

_OPS = ("creation", "math", "manipulation", "logic", "search", "random",
        "linalg")


_NO_ALL = ("root", "core", "text", "nn", "optimizer", "vision",
           "vision_models")  # without __all__
#: checked by the names their reference module defines
_DEFINED = {"io": "io", "reader": "reader", "dataset": "dataset",
            "vision_ops": "vision.ops", "vision_transforms": "vision.transforms",
            "vision_datasets": "vision.datasets", "amp": "amp",
            "autograd": "autograd", "jit": "jit", "metric": "metric",
            "hapi": "hapi", "profiler": "profiler",
            "distributed": "distributed",
            "distributed_fleet": "distributed.fleet"}


@functools.lru_cache(maxsize=1)
def _fresh_names() -> dict:
    """The public names of the reference namespaces without an ``__all__``
    as a fresh interpreter sees them: in this process other tests import
    submodules (``paddle_tpu.fluid`` ...), which then show in ``dir``."""
    code = ("import json, paddle_tpu, paddle_tpu.core, paddle_tpu.text\n"
            "pub = lambda m: sorted(n for n in dir(m) if n[0] != '_')\n"
            "names = {'root': pub(paddle_tpu), "
            "'core': pub(paddle_tpu.core), 'text': pub(paddle_tpu.text), "
            "'nn': pub(paddle_tpu.nn), "
            "'optimizer': pub(paddle_tpu.optimizer)}\n"
            "import paddle_tpu.vision\n"
            "names['vision'] = pub(paddle_tpu.vision)\n"
            "names['vision_models'] = pub(paddle_tpu.vision.models)\n"
            "import importlib, inspect\n"
            "def defined(m):\n"
            "    own = lambda v: (inspect.ismodule(v) and v.__name__.startswith("
            "m.__name__ + '.')) or ((inspect.isfunction(v) or "
            "inspect.isclass(v)) and v.__module__.startswith(m.__name__))\n"
            "    return sorted(n for n, v in vars(m).items() "
            "if n[0] != '_' and own(v))\n"
            f"for space, path in {_DEFINED!r}.items():\n"
            "    names[space] = defined(importlib.import_module("
            "'paddle_tpu.' + path))\n"
            "print(json.dumps(names))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=ROOT,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    return json.loads(out.stdout.strip().splitlines()[-1])


def _public(space, mod) -> set:
    if space in _NO_ALL or space in _DEFINED:
        names = _fresh_names()[space]
    else:
        names = mod.__all__
    if space == "functional":  # and the functions it defines beyond it
        names = set(names) | {
            n for n, v in vars(mod).items() if n[0] != "_"
            and inspect.isfunction(v) and v.__module__ == mod.__name__}
    return set(names) - {"annotations"}


def _namespaces():
    out = {"root": (J, T), "core": (J.core, T.core),
           "linalg": (J.linalg, T.linalg),
           "serving": (importlib.import_module("paddle_tpu.serving"),
                       importlib.import_module("paddle_tpu_torch.serving")),
           "obs": (importlib.import_module("paddle_tpu.obs"),
                   importlib.import_module("paddle_tpu_torch.obs")),
           "text": (importlib.import_module("paddle_tpu.text"),
                    importlib.import_module("paddle_tpu_torch.text")),
           "nn": (J.nn, T.nn), "functional": (J.nn.functional,
                                              T.nn.functional),
           "initializer": (J.nn.initializer, T.nn.initializer),
           "nn_utils": (J.nn.utils, T.nn.utils),
           "optimizer": (J.optimizer, T.optimizer),
           "vision": (importlib.import_module("paddle_tpu.vision"),
                      importlib.import_module("paddle_tpu_torch.vision")),
           "vision_models": (
               importlib.import_module("paddle_tpu.vision.models"),
               importlib.import_module("paddle_tpu_torch.vision.models")),
           "callbacks": (J.callbacks, T.callbacks)}
    for name in _OPS:
        out[name] = (importlib.import_module(f"paddle_tpu.tensor_ops.{name}"),
                     importlib.import_module(
                         f"paddle_tpu_torch.tensor_ops.{name}"))
    for space, path in _DEFINED.items():
        out[space] = (importlib.import_module(f"paddle_tpu.{path}"),
                      importlib.import_module(f"paddle_tpu_torch.{path}"))
    return out


@pytest.mark.parametrize("space", ["root", "core", "linalg", "serving", "obs",
                                   "text", *_OPS, "nn", "functional",
                                   "initializer", "nn_utils", "optimizer",
                                   "vision", "vision_models", "callbacks",
                                   *_DEFINED])
def test_namespace_covers_the_reference(space):
    ref, port = _namespaces()[space]
    listed = NO_COUNTERPART.get(space, {})
    want = _public(space, ref)
    # the root re-exports the tensor functions: every module's names
    if space == "root":
        for name in _OPS:
            want |= set(importlib.import_module(
                f"paddle_tpu.tensor_ops.{name}").__all__)
    lacking = {n for n in want if not hasattr(port, n)}
    assert lacking - set(listed) == set(), \
        f"{space}: names with neither a counterpart nor a reason"
    stale = {n for n in listed if hasattr(port, n)}
    assert stale == set(), f"{space}: listed but present"
    assert set(listed) <= want, f"{space}: listed names the reference lacks"
    if space not in _NO_ALL and space not in _DEFINED:  # its own __all__
        assert want - set(listed) <= set(port.__all__)


def test_mesh_only_helpers_have_no_counterpart():
    ref = importlib.import_module("paddle_tpu.distributed.fleet.hybrid_train")
    port = importlib.import_module(
        "paddle_tpu_torch.distributed.fleet.hybrid_train")
    for name in MESH_ONLY:
        assert hasattr(ref, name) and not hasattr(port, name), name


def test_einsum_and_every_op_at_the_root():
    from paddle_tpu_torch.tensor_ops.einsum import einsum

    assert T.einsum is einsum and callable(J.einsum)
    for name in _OPS:
        mod = importlib.import_module(f"paddle_tpu_torch.tensor_ops.{name}")
        for fn in mod.__all__:
            assert getattr(T, fn) is getattr(mod, fn), fn


#: the modules of the dygraph core, each under the reference's path
CORE_MODULES = ("core/dtype.py", "core/place.py", "core/tensor.py",
                "core/tape.py", "core/errors.py", "core/memory.py",
                "core/rng.py", "tensor_ops/creation.py", "tensor_ops/math.py",
                "tensor_ops/manipulation.py", "tensor_ops/logic.py",
                "tensor_ops/search.py", "tensor_ops/random.py",
                "tensor_ops/linalg.py", "tensor_ops/einsum.py",
                "tensor_ops/methods.py", "framework/io.py",
                "framework/__init__.py")


@pytest.mark.parametrize("path", CORE_MODULES)
def test_core_module_has_its_counterpart(path):
    assert os.path.isfile(os.path.join(ROOT, "paddle_tpu", path))
    port = os.path.join(ROOT, "paddle_tpu_torch", path)
    assert os.path.isfile(port)
    src = open(port).read()
    assert "import jax" not in src and "paddle_tpu." not in src.replace(
        "paddle_tpu_torch", "")


@pytest.fixture
def _cpu():
    prev = _device._CURRENT
    T.set_device("cpu")
    yield
    _device._CURRENT = prev


DIVERGENCES = {
    "shape": "Tensor.shape stays torch.Size (torch's own code does tuple "
             "arithmetic on it); the reference returns a list. "
             "paddle.shape(x) gives the reference's int32 tensor",
    "is_compiled_with_cuda": "True: the port's kernels are CUDA; the "
                             "reference (a TPU build) says False",
    "dtype": "dtypes are torch's (x.dtype == paddle.float32 holds in "
             "both); the reference's Tensor.dtype is a string",
    "random_module": "paddle_tpu_torch.random is the threefry module (key, "
                     "fold_in, split ...); the reference's paddle.random "
                     "is its tensor_ops.random, whose functions are at "
                     "both roots",
    "bfloat16_numpy": "numpy() of a bfloat16 tensor is float32 (numpy has "
                      "no bfloat16); the reference returns ml_dtypes "
                      "bfloat16",
    "torch_methods": "a Tensor method torch.Tensor already has keeps "
                     "torch's signature (x.size() is a method, "
                     "x.transpose(d0, d1)); the root functions take the "
                     "reference's",
    "crop": "the reference's crop raises TypeError (it calls its module's "
            "own slice function); the port's crops",
    "poisson": "draws are not the reference's (XLA's rejection sampler); "
               "every other random function is",
}


@pytest.mark.parametrize("name", sorted(DIVERGENCES))
def test_pinned_divergence(name, _cpu):
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    t, j = T.to_tensor(x), J.to_tensor(x)
    if name == "shape":
        assert isinstance(t.shape, torch.Size) and isinstance(j.shape, list)
        assert list(t.shape) == j.shape
        np.testing.assert_array_equal(T.shape(t).numpy(),
                                      J.shape(j).numpy())
    elif name == "is_compiled_with_cuda":
        assert T.is_compiled_with_cuda() and not J.is_compiled_with_cuda()
    elif name == "dtype":
        assert t.dtype == T.float32 and j.dtype == J.float32 == "float32"
    elif name == "random_module":
        assert isinstance(T.random, types.ModuleType)
        assert hasattr(T.random, "threefry2x32")
        assert hasattr(J.random, "rand") and callable(T.rand)
    elif name == "bfloat16_numpy":
        assert t.astype("bfloat16").numpy().dtype == np.float32
        assert j.astype("bfloat16").numpy().dtype.name == "bfloat16"
    elif name == "torch_methods":
        assert t.size() == torch.Size([2, 3]) and j.size == 6
        assert tuple(t.transpose(0, 1).shape) == (3, 2)
        np.testing.assert_array_equal(T.transpose(t, [1, 0]).numpy(),
                                      J.transpose(j, [1, 0]).numpy())
    elif name == "crop":
        with pytest.raises(TypeError):
            J.crop(j, [1, 1])
        assert T.crop(t, [1, 1]).tolist() == [[0.0]]
    elif name == "poisson":
        lam = np.full((50,), 4.0, np.float32)
        T.seed(1)
        J.seed(1)
        a, b = T.poisson(T.to_tensor(lam)), J.poisson(J.to_tensor(lam))
        assert a.shape == torch.Size(b.shape)
        assert not np.array_equal(a.numpy(), b.numpy())


def test_banked_gauges_are_the_ports():
    assert load_banked_kernel_speedups()  # the port's own bank is present
