"""Import hygiene of the port: ``paddle_tpu_torch`` and ``chip_smoke.py``
import neither jax nor the JAX package ``paddle_tpu`` (the port's own
``paddle_tpu_torch`` is allowed), and the port calls no library kernel in
place of its own: nothing on ``torch.nn.functional`` but the plain layers,
no ``torch.nn`` module that stands in for a kernel of the port
(``torch.nn.LayerNorm``), no cuDNN switch, no ``torch.compile``, no fused
library optimizer. The port's own names that mirror the reference
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
            "check_all.py"} <= names
    assert (ROOT / "chip_smoke.py").is_file()
    assert _forbidden("jax.numpy") and _forbidden("paddle_tpu.kernels")
    assert not _forbidden("paddle_tpu_torch.kernels")


#: the plain layers the port may take from torch.nn.functional
ALLOWED_TORCH_FUNCTIONAL = {"linear", "gelu", "embedding"}
#: torch.nn modules whose work is a hand-written kernel of the port
BANNED_TORCH_NN = {"LayerNorm"}
_FUSED_OPTIMIZER = re.compile(r"^_?(fused|foreach)_(adam|sgd)", re.I)


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


def library_calls(source: str) -> list[str]:
    """Library kernels a source reaches: attributes of
    ``torch.nn.functional`` (under any alias) other than the plain layers,
    names imported from it other than those, the ``torch.nn`` modules of
    ``BANNED_TORCH_NN`` (under any alias of ``torch.nn``), anything on
    ``torch.backends.cudnn``, ``torch.compile``, the fused optimizer entry
    points (``torch._fused_adam*`` and kin) and a ``fused=True`` or
    ``foreach=True`` argument."""
    tree = ast.parse(source)
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
            if full.startswith("torch.backends.cudnn") or full in (
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
], ids=["alias", "from-alias", "dotted", "from-import", "cudnn", "compile",
        "fused-adamw", "fused-optim", "layer-norm", "nn-LayerNorm",
        "torch-nn-LayerNorm", "nn-alias-LayerNorm", "from-nn-LayerNorm"])
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


def test_importing_the_port_loads_no_jax():
    code = ("import sys, paddle_tpu_torch.serving, paddle_tpu_torch.text, "
            "paddle_tpu_torch.kernels, paddle_tpu_torch.nn, "
            "paddle_tpu_torch.optimizer, paddle_tpu_torch.train, "
            "paddle_tpu_torch.obs, paddle_tpu_torch.obs.__main__, "
            "paddle_tpu_torch.utils.monitor, paddle_tpu_torch.core.rng, "
            "paddle_tpu_torch.distributed.fleet.recompute, "
            "paddle_tpu_torch.utils.clip_grad, paddle_tpu_torch.optimizer.lr, "
            "paddle_tpu_torch.analysis, paddle_tpu_torch.analysis.check_all; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'paddle_tpu')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)
