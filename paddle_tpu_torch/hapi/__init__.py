"""``paddle.hapi`` — the port of ``paddle_tpu/hapi``: ``Model`` and
``summary`` (``model.py``), the callbacks, the hub and ``flops``
(``dynamic_flops.py``). ``static_flops`` reads a static ``Program``:
ROADMAP Queue 1 item 12f."""
from .model import Model, summary  # noqa: F401
from . import callbacks  # noqa: F401
from . import dynamic_flops  # noqa: F401
from . import hub  # noqa: F401
