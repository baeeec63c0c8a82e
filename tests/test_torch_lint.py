"""``paddle_tpu_torch.analysis.lint``: each rule fires on one inline
source and stays quiet on its clean (or pragma-suppressed) twin, the
rule table is the reference's less PT002 (which has no counterpart), and
the port itself lints clean."""
import pathlib
import textwrap

import pytest

from paddle_tpu.analysis import lint as jlint
from paddle_tpu_torch.analysis import lint

ROOT = pathlib.Path(__file__).resolve().parents[1]
SERVING = "paddle_tpu_torch/serving/x.py"

#: rule -> (path the scope sees, failing source, clean source)
CASES = {
    "PT001": ("paddle_tpu_torch/x.py", """
        from dataclasses import dataclass
        import torch
        @dataclass
        class Slot:
            pages: torch.Tensor
        """, """
        from dataclasses import dataclass
        import torch
        @dataclass(eq=False)
        class Slot:
            pages: torch.Tensor
        """),
    "PT003": ("paddle_tpu_torch/x.py", """
        PREFIX = "serving_"
        _SEEDED = ("tokens_total",)
        def on_tokens(monitor):
            monitor.stat_add(PREFIX + "tokenz_total", 1)
        """, """
        PREFIX = "serving_"
        _SEEDED = ("tokens_total",)
        def on_tokens(monitor):
            monitor.stat_add(PREFIX + "tokens_total", 1)
        """),
    "PT004": (SERVING, """
        import time
        def deadline():
            return time.time() + 1.0
        """, """
        def deadline(engine):
            return engine.now() + 1.0
        """),
    "PT005": (SERVING, """
        def _decode(self, toks):
            return toks.tolist()
        """, """
        def _decode(self, toks):
            return toks.tolist()  # lint: disable=PT005
        """),
    "PT006": (SERVING, """
        from ..analysis.tracecheck import CompileGuard
        def scatter(pools, idx, data):
            pools.index_copy_(2, idx, data)
        g = CompileGuard(scatter, "swap_scatter", budget=1)
        """, """
        from ..analysis.tracecheck import CompileGuard
        def scatter(pools, idx, data):
            pools.index_copy_(2, idx, data)
        g = CompileGuard(scatter, "swap_scatter", budget=1,
                         donate_argnums=(0,))
        """),
    "PT007": ("paddle_tpu_torch/x.py", """
        def add(x, seen=[]):
            seen.append(x)
        """, """
        def add(x, seen=None):
            seen = [] if seen is None else seen
        """),
    "PT008": ("paddle_tpu_torch/x.py", """
        PREFIX = "serving_"
        _SEEDED = ("queue_depth",)
        def on_state(monitor, n):
            monitor.stat_set(PREFIX + "queue_depht", n)
        """, """
        PREFIX = "serving_"
        _SEEDED = ("queue_depth",)
        def on_state(monitor, n):
            monitor.stat_set(PREFIX + "queue_depth", n)
        """),
    "PT009": (SERVING, """
        import torch
        class Engine:
            def __init__(self):
                self.step = torch.compile(self._decode_impl)
            def _decode_impl(self, pools):
                return pools
        """, """
        from ..analysis.tracecheck import CompileGuard
        class Engine:
            def __init__(self):
                self.step = CompileGuard(self._decode_impl, "decode",
                                         donate_argnums=(0,))
            def _decode_impl(self, pools):
                return pools
        """),
    "PT010": (SERVING, """
        from ..text.gpt import tp_axis
        def forward(model, ids, axis):
            with tp_axis(axis):
                return model(ids)
        """, """
        from ..text.gpt import tp_axis
        def forward(model, ids, tp, b):
            budget = tp.step_budget(batch=b, seq=1)
            with tp_axis(tp.axis):
                return model(ids), budget
        """),
    "PT011": ("paddle_tpu_torch/kernels/x.py", """
        from . import _build
        def entry():
            return _build.load("x")
        """, """
        from . import _build
        KERNELCHECK_CERTS = ("x",)
        def entry():
            return _build.load("x")
        """),
    "PT012": ("paddle_tpu_torch/x.py", """
        PREFIX = "serving_"
        _SEEDED = ()
        _FAMILIES = {"alerts_total": "rule"}
        def on(monitor, r):
            monitor.stat_add(PREFIX + f"alertz_total{{rule={r}}}", 1)
        """, """
        PREFIX = "serving_"
        _SEEDED = ()
        _FAMILIES = {"alerts_total": "rule"}
        def on(monitor, r):
            monitor.stat_add(PREFIX + f"alerts_total{{rule={r}}}", 1)
        """),
    "PT013": ("paddle_tpu_torch/serving/fleet_x.py", """
        def submit(eng, p):
            return eng.add_request(p, 4)
        """, """
        def submit(router, p):
            return router.submit(p, 4)
        """),
    "PT014": (SERVING, """
        import pickle
        def frame(x):
            return pickle.dumps(x)
        """, """
        from . import wire
        def frame(page):
            return wire.encode_page(page)
        """),
    "PT015": (SERVING, """
        import torch.distributed as dist
        def reduce(t):
            dist.all_reduce(t)
        """, """
        from ..distributed import collective
        def reduce(t):
            collective.all_reduce(t)
        """),
    "PT016": (SERVING, """
        import random
        def jitter():
            return random.random()
        """, """
        import random
        def jitter(seed):
            return random.Random(seed).random()
        """),
    "PT017": (SERVING, """
        def fetch(transport, frame):
            return transport.exchange(frame)
        """, """
        def fetch(transport, frame, rid, step):
            return transport.exchange(frame, rid=rid, step=step)
        """),
}


@pytest.mark.parametrize("rule", sorted(CASES))
def test_rule_fires_and_its_twin_is_clean(rule):
    path, bad, good = CASES[rule]
    found = lint.lint_source(textwrap.dedent(bad), path)
    assert found and {f.rule for f in found} == {rule}, \
        [str(f) for f in found]
    assert lint.lint_source(textwrap.dedent(good), path) == []


def test_rule_table_is_the_references_less_pt002():
    assert set(lint.RULES) == set(jlint.RULES) - {"PT002"}
    assert "PT002" in lint.__doc__  # the stated reason it has no twin
    assert lint.ALLOWLIST == {}


def test_serving_rules_do_not_fire_outside_serving():
    _, bad, _ = CASES["PT004"]
    assert lint.lint_source(textwrap.dedent(bad),
                            "paddle_tpu_torch/obs/x.py") == []


def test_pragma_takes_a_list():
    src = "def _step(t, s=[]):  # lint: disable=PT007, PT005\n" \
          "    return t.item()  # lint: disable=PT005\n"
    assert lint.lint_source(src, SERVING) == []


def test_the_port_lints_clean():
    assert lint.lint_paths([ROOT / "paddle_tpu_torch"]) == []


def test_cli_exit_codes(tmp_path, capsys):
    bad = tmp_path / "serving" / "x.py"
    bad.parent.mkdir()
    bad.write_text(textwrap.dedent(CASES["PT004"][1]))
    assert lint.main([str(bad)]) == 1
    assert "PT004" in capsys.readouterr().out
    assert lint.main([str(bad), "--rule", "PT007"]) == 0
    assert lint.main(["--rule", "PT999"]) == 2
    assert lint.main([]) == 0


def test_analysis_gate_exits_clean():
    """``python -m paddle_tpu_torch.analysis all``: the lint sweep, the
    step audits (TP=2 in spawned gloo ranks), the kernel certificates and
    the placements, one exit code — 0 on the port as it stands."""
    import subprocess
    import sys

    proc = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.analysis", "all"],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    verdicts = proc.stdout.split("==== gate")[1].split()
    for engine in ("lint", "hlocheck", "kernelcheck", "meshcheck"):
        assert verdicts[verdicts.index(engine) + 1] == "clean", engine
