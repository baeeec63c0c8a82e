"""``python -m paddle_tpu_torch.analysis {lint,hlo,meshcheck,kernelcheck,
all} [options]``: one entry point, five engines, one exit-code contract
(0 clean, 1 findings or violations, 2 bad usage). With no engine named
the arguments go to the linter."""
import sys

argv = list(sys.argv[1:])
engine = argv[0] if argv[:1] and argv[0] in (
    "lint", "hlo", "meshcheck", "kernelcheck", "all") else "lint"
if argv[:1] == [engine]:
    argv = argv[1:]
if engine == "hlo":
    from .hlocheck import main
elif engine == "meshcheck":
    from .meshcheck import main
elif engine == "kernelcheck":
    from .kernelcheck import main
elif engine == "all":
    from .check_all import main
else:
    from .lint import main

sys.exit(main(argv))
