"""Import hygiene of the port: ``paddle_tpu_torch`` and ``chip_smoke.py``
import neither jax nor the JAX package ``paddle_tpu`` (the port's own
``paddle_tpu_torch`` is allowed), and the port calls no library attention
kernel, cuDNN switch or ``torch.compile`` in place of its own kernels."""
import ast
import pathlib
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
    assert {"engine.py", "gpt.py", "ragged_paged_attention.py"} <= names
    assert (ROOT / "chip_smoke.py").is_file()
    assert _forbidden("jax.numpy") and _forbidden("paddle_tpu.kernels")
    assert not _forbidden("paddle_tpu_torch.kernels")


def test_port_calls_no_library_kernel():
    banned = {"scaled_dot_product_attention", "cudnn", "compile",
              "flash_attention"}
    for path in PORT_FILES:
        tree = ast.parse(path.read_text(), filename=str(path))
        used = {n.attr for n in ast.walk(tree) if isinstance(n, ast.Attribute)}
        assert not used & banned, f"{path.relative_to(ROOT)}: {used & banned}"


def test_importing_the_port_loads_no_jax():
    code = ("import sys, paddle_tpu_torch.serving, paddle_tpu_torch.text, "
            "paddle_tpu_torch.kernels; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'paddle_tpu')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)
