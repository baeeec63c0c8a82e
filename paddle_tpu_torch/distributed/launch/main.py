"""Entry point: ``python -m paddle_tpu_torch.distributed.launch`` — the
port of ``paddle_tpu/distributed/launch/main.py`` (reference:
python/paddle/distributed/launch/main.py + __main__.py)."""
from __future__ import annotations

import sys

from .context import Context
from .controller import CollectiveController, PSController


def launch(argv=None) -> int:
    ctx = Context(argv)
    cls = PSController if ctx.args.run_mode == "ps" else CollectiveController
    controller = cls(ctx)
    try:
        return controller.run()
    except KeyboardInterrupt:
        controller.stop()
        return 130
    finally:
        controller.stop()


if __name__ == "__main__":
    sys.exit(launch())
