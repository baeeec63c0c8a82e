"""``paddle.vision`` of the port: ``models`` (every model family of the
reference) and ``LeNet``. ``datasets``, ``transforms``, ``ops`` and the
image backend are ROADMAP Queue 1 item 12c-2."""
from . import models
from .models import LeNet

__all__ = ["models", "LeNet"]
