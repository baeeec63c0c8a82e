"""Import hygiene of the port: ``paddle_tpu_torch`` and ``chip_smoke.py``
import neither jax nor the JAX package ``paddle_tpu`` (the port's own
``paddle_tpu_torch`` is allowed), and the port calls no library kernel in
place of its own: nothing on ``torch.nn.functional`` but the plain layers,
no ``torch.nn`` module that stands in for a kernel of the port
(``torch.nn.LayerNorm``), no cuDNN switch (but the local
``torch.backends.cudnn.flags(..., allow_tf32=False)`` that keeps a
float32 convolution in full float32, which reads only the current
``enabled``, ``benchmark`` and ``deterministic``), no ``torch.compile``,
no fused library optimizer. The port's own names that mirror the reference
(``scaled_dot_product_attention``, ``flash_attention``, ``layer_norm``,
``LayerNorm``) are not library calls."""
import ast
import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "paddle_tpu_torch").rglob("*.py"))
SCANNED = PORT_FILES + [ROOT / "chip_smoke.py"]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", None) == "__import__" and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield node.args[0].value


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "paddle_tpu")


@pytest.mark.parametrize("path", SCANNED, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_and_no_reference_imports(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scan_sees_the_port():
    names = {p.name for p in PORT_FILES}
    assert {"engine.py", "gpt.py", "ragged_paged_attention.py",
            "flash_attention.py", "fused_optimizer.py", "functional.py",
            "optimizers.py", "train.py", "fused_layernorm.py",
            "layers_norm.py", "metrics.py", "slo.py", "monitor.py",
            "histogram.py", "trace.py", "timeline.py", "attribution.py",
            "tenant.py", "journey.py", "alerts.py", "export.py",
            "recorder.py", "__main__.py", "rng.py", "dropout.py",
            "global_norm.py", "clip_grad.py", "lr.py", "recompute.py",
            "layers_common.py", "tp.py", "wire.py", "channel.py",
            "fleet.py", "fleet_sim.py", "chaos.py", "fleetscope.py",
            "env.py", "collective.py", "spawn.py", "tracecheck.py",
            "hlocheck.py", "meshcheck.py", "kernelcheck.py", "lint.py",
            "check_all.py", "layers_conv.py", "layers_pooling.py",
            "layers_extra.py", "rnn.py", "decode.py", "resnet.py",
            "lenet.py", "ernie.py", "transformer_mt.py",
            "viterbi_decode.py", "tokenizer_ops.py", "string_tensor.py",
            "alexnet.py", "vgg.py", "squeezenet.py", "mobilenetv1.py",
            "mobilenet.py", "mobilenetv3.py", "shufflenetv2.py",
            "googlenet.py", "inceptionv3.py", "densenet.py"} <= names
    assert (ROOT / "chip_smoke.py").is_file()
    assert _forbidden("jax.numpy") and _forbidden("paddle_tpu.kernels")
    assert not _forbidden("paddle_tpu_torch.kernels")


#: the plain layers the port may take from torch.nn.functional
ALLOWED_TORCH_FUNCTIONAL = {"linear", "gelu", "embedding"}
#: torch.nn modules whose work is a hand-written kernel of the port
BANNED_TORCH_NN = {"LayerNorm"}
_FUSED_OPTIMIZER = re.compile(r"^_?(fused|foreach)_(adam|sgd)", re.I)
_CUDNN = "torch.backends.cudnn"
#: what the local no-TF32 flag may name inside its own call
_CUDNN_LOCAL = {f"{_CUDNN}.{n}" for n in ("flags", "enabled", "benchmark",
                                          "deterministic")}


def _dotted(node) -> str:
    """``a.b.c`` for a chain of attributes on a name, else ""."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _local_no_tf32(tree) -> set:
    """ids of the attribute nodes (and their ``torch.backends.cudnn``
    prefixes) inside each ``torch.backends.cudnn.flags(...)`` call that
    passes ``allow_tf32=False`` and every other setting as it stands
    (``enabled=torch.backends.cudnn.enabled`` ...)."""
    exempt = set()
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call)
                and _dotted(node.func) == f"{_CUDNN}.flags"):
            continue
        if not any(k.arg == "allow_tf32" and isinstance(k.value, ast.Constant)
                   and k.value.value is False for k in node.keywords):
            continue
        # every other setting passed on as it stands
        if node.args or not all(
                k.arg == "allow_tf32" or _dotted(k.value) == f"{_CUDNN}.{k.arg}"
                for k in node.keywords):
            continue
        names = [n for n in ast.walk(node) if isinstance(n, ast.Attribute)
                 and _dotted(n).startswith(_CUDNN)]
        if not all(_dotted(n) in _CUDNN_LOCAL or _dotted(n) in (
                _CUDNN, "torch.backends") for n in names):
            continue
        exempt |= {id(n) for n in names}
        exempt |= {id(n.value) for n in names}
        exempt |= {id(n.value.value) for n in names
                   if isinstance(n.value, ast.Attribute)}
    return exempt


def library_calls(source: str) -> list[str]:
    """Library kernels a source reaches: attributes of
    ``torch.nn.functional`` (under any alias) other than the plain layers,
    names imported from it other than those, the ``torch.nn`` modules of
    ``BANNED_TORCH_NN`` (under any alias of ``torch.nn``), anything on
    ``torch.backends.cudnn`` but the local no-TF32 flag
    (:func:`_local_no_tf32`), ``torch.compile``, the fused optimizer entry
    points (``torch._fused_adam*`` and kin) and a ``fused=True`` or
    ``foreach=True`` argument."""
    tree = ast.parse(source)
    exempt = _local_no_tf32(tree)
    aliases = {"torch.nn.functional"}
    nn_aliases = {"torch.nn"}
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module == "torch.nn":
            aliases |= {a.asname or a.name for a in node.names
                        if a.name == "functional"}
            found += [f"from torch.nn import {a.name}" for a in node.names
                      if a.name in BANNED_TORCH_NN]
        elif isinstance(node, ast.ImportFrom) and node.module == "torch":
            nn_aliases |= {a.asname or a.name for a in node.names
                           if a.name == "nn"}
        elif isinstance(node, ast.ImportFrom) and \
                node.module == "torch.nn.functional":
            found += [f"from torch.nn.functional import {a.name}"
                      for a in node.names
                      if a.name not in ALLOWED_TORCH_FUNCTIONAL]
        elif isinstance(node, ast.Import):
            aliases |= {a.asname for a in node.names
                        if a.name == "torch.nn.functional" and a.asname}
            nn_aliases |= {a.asname for a in node.names
                           if a.name == "torch.nn" and a.asname}
    for node in ast.walk(tree):
        if isinstance(node, ast.Attribute):
            base, name = _dotted(node.value), node.attr
            if base in aliases and name not in ALLOWED_TORCH_FUNCTIONAL:
                found.append(f"{base}.{name}")
            if base in nn_aliases and name in BANNED_TORCH_NN:
                found.append(f"{base}.{name}")
            full = _dotted(node)
            if (full.startswith(_CUDNN) and id(node) not in exempt) or full in (
                    "torch.compile", "torch._dynamo") or (
                    base == "torch" and _FUSED_OPTIMIZER.match(name)):
                found.append(full)
        elif isinstance(node, ast.keyword) and node.arg in (
                "fused", "foreach") and isinstance(node.value, ast.Constant) \
                and node.value.value is True:
            found.append(f"{node.arg}=True")
    return found


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_calls_no_library_kernel(path):
    found = library_calls(path.read_text())
    assert not found, f"{path.relative_to(ROOT)}: {found}"


@pytest.mark.parametrize("snippet", [
    "import torch.nn.functional as F\nF.scaled_dot_product_attention(q, k, v)",
    "from torch.nn import functional as G\nG.scaled_dot_product_attention(q)",
    "import torch\ntorch.nn.functional.scaled_dot_product_attention(q, k, v)",
    "from torch.nn.functional import scaled_dot_product_attention",
    "import torch\ntorch.backends.cudnn.allow_tf32 = True",
    "import torch\nf = torch.compile(f)",
    "import torch\ntorch._fused_adamw_(ps, gs, ms, vs)",
    "import torch\nopt = torch.optim.AdamW(ps, fused=True)",
    "from torch.nn import functional as F\ny = F.layer_norm(x, (8,), w, b)",
    "from torch import nn\nln = nn.LayerNorm(64)",
    "import torch\nln = torch.nn.LayerNorm(64)",
    "import torch.nn as tnn\nln = tnn.LayerNorm(64)",
    "from torch.nn import LayerNorm",
    "import torch\nwith torch.backends.cudnn.flags(allow_tf32=True):\n"
    "    pass",
    "import torch\nwith torch.backends.cudnn.flags(\n"
    "        benchmark=True, allow_tf32=False):\n    pass",
    "import torch\ntorch.backends.cudnn.benchmark = True",
    "import torch\nwith torch.backends.cudnn.flags(\n"
    "        enabled=torch.backends.cudnn.allow_tf32, allow_tf32=False):\n"
    "    pass",
], ids=["alias", "from-alias", "dotted", "from-import", "cudnn", "compile",
        "fused-adamw", "fused-optim", "layer-norm", "nn-LayerNorm",
        "torch-nn-LayerNorm", "nn-alias-LayerNorm", "from-nn-LayerNorm",
        "cudnn-flags-tf32", "cudnn-flags-benchmark", "cudnn-benchmark",
        "cudnn-flags-reads-tf32"])
def test_library_call_scan_catches(snippet):
    assert library_calls(snippet)


def test_library_call_scan_allows_the_ports_own_names():
    assert not library_calls(
        "from torch.nn import functional as F\n"
        "from ..nn.functional import scaled_dot_product_attention\n"
        "from .flash_attention import flash_attention\n"
        "from ..nn import LayerNorm\n"
        "x = F.linear(F.gelu(x), w)\n"
        "ln = LayerNorm(64)\n"
        "y = nnf.layer_norm(x, (64,), w, b)\n"
        "y = nnf.scaled_dot_product_attention(q, k, v)\n"
        "z = fa.flash_attention(q, k, v)\n")


def test_library_call_scan_allows_the_local_no_tf32_flag():
    assert not library_calls(
        "import torch\n"
        "with torch.backends.cudnn.flags(\n"
        "        enabled=torch.backends.cudnn.enabled,\n"
        "        benchmark=torch.backends.cudnn.benchmark,\n"
        "        deterministic=torch.backends.cudnn.deterministic,\n"
        "        allow_tf32=False):\n"
        "    y = torch.convolution(x, w, None, [1], [0], [1], False, [0], 1)\n")


def test_importing_the_port_loads_no_jax():
    code = ("import sys, paddle_tpu_torch.serving, paddle_tpu_torch.text, "
            "paddle_tpu_torch.kernels, paddle_tpu_torch.nn, "
            "paddle_tpu_torch.optimizer, paddle_tpu_torch.train, "
            "paddle_tpu_torch.obs, paddle_tpu_torch.obs.__main__, "
            "paddle_tpu_torch.utils.monitor, paddle_tpu_torch.core.rng, "
            "paddle_tpu_torch.distributed.fleet.recompute, "
            "paddle_tpu_torch.utils.clip_grad, paddle_tpu_torch.optimizer.lr, "
            "paddle_tpu_torch.analysis, paddle_tpu_torch.analysis.check_all, "
            "paddle_tpu_torch.vision, paddle_tpu_torch.nn.decode, "
            "paddle_tpu_torch.text.transformer_mt, "
            "paddle_tpu_torch.core.string_tensor; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'paddle_tpu')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)
