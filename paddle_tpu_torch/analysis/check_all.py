"""One-shot analysis gate — the port of
``paddle_tpu/analysis/check_all.py``: every engine, one exit code.

``python -m paddle_tpu_torch.analysis all`` runs, in process and back to
back, the lint sweep over ``paddle_tpu_torch/``, the hlocheck step
registry (its TP=2 steps in one spawn of gloo ranks), the kernelcheck
registry (plans, budgets, race proofs, the roofline bank) and the
meshcheck registry (placements and their bank), and folds their exit
codes (0 clean / 1 findings / 2 usage). meshcheck places the step
audits hlocheck made in the same run, rather than spawning them again. Every engine runs even when an
earlier one fails, and the summary names each verdict. ``--skip ENGINE``
and the narrowing flags keep a run cheap.
"""
from __future__ import annotations

__all__ = ["ENGINES", "main"]

ENGINES = ("lint", "hlocheck", "kernelcheck", "meshcheck")


def _engine_main(name: str):
    if name == "lint":
        from .lint import main
    elif name == "hlocheck":
        from .hlocheck import main
    elif name == "kernelcheck":
        from .kernelcheck import main
    else:
        from .meshcheck import main
    return main


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.analysis all",
        description="Every analysis engine back to back, one exit code "
                    "(0 clean, 1 findings, 2 usage).")
    parser.add_argument("--skip", action="append", default=[],
                        choices=list(ENGINES), metavar="ENGINE")
    parser.add_argument("--hlo-step", action="append", default=None,
                        metavar="NAME")
    parser.add_argument("--kernel", action="append", default=None,
                        metavar="NAME")
    parser.add_argument("--mesh-step", action="append", default=None,
                        metavar="NAME")
    args = parser.parse_args(argv)
    engine_argv = {
        "lint": [],
        "hlocheck": [a for n in (args.hlo_step or []) for a in ("--step", n)],
        "kernelcheck": [a for n in (args.kernel or [])
                        for a in ("--kernel", n)],
        "meshcheck": [a for n in (args.mesh_step or [])
                      for a in ("--step", n)],
    }
    results: dict[str, int] = {}
    audits: dict = {}  # hlocheck's step audits, reused by meshcheck
    for name in ENGINES:
        if name in args.skip:
            continue
        print(f"==== {name} ".ljust(60, "="), flush=True)
        try:
            if name in ("hlocheck", "meshcheck"):
                rc = _engine_main(name)(engine_argv[name], audits=audits)
            else:
                rc = _engine_main(name)(engine_argv[name])
        except SystemExit as e:  # argparse errors inside an engine
            rc = int(e.code or 0)
        except Exception as e:  # noqa: BLE001 — one broken engine must
            # not mask the others' reports; it still fails the gate
            print(f"FAIL {name}: {type(e).__name__}: {e}")
            rc = 1
        results[name] = rc
    print("==== gate ".ljust(60, "="))
    for name, rc in results.items():
        verdict = ("clean" if rc == 0 else
                   "FINDINGS" if rc == 1 else f"USAGE ERROR (rc={rc})")
        print(f"{name:<12} {verdict}")
    if not results:
        print("nothing ran (everything skipped)")
        return 2
    if any(rc == 2 for rc in results.values()):
        return 2
    return 1 if any(results.values()) else 0
