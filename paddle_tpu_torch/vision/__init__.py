"""``paddle.vision`` of the port: ``models`` (LeNet and the ResNets) and
``LeNet``. ``datasets``, ``transforms``, ``ops`` and the image backend
are ROADMAP Queue 1 item 12c."""
from . import models
from .models import LeNet

__all__ = ["models", "LeNet"]
