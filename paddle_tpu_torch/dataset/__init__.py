"""The legacy reader-protocol datasets (reference: ``paddle_tpu/dataset/``;
Paddle's ``python/paddle/dataset/``).

Each submodule's ``train()`` / ``test()`` returns a *reader creator*, a
zero-argument callable yielding samples, which ``paddle.batch`` and the
``paddle.reader`` decorators consume. Each is a thin adapter over the
port's map-style ``vision.datasets`` / ``text.datasets``, with the
reference's normalisation, so both protocols read one data source.
"""
from . import common  # noqa: F401
from . import mnist  # noqa: F401
from . import cifar  # noqa: F401
from . import uci_housing  # noqa: F401
from . import imdb  # noqa: F401
from . import imikolov  # noqa: F401
from . import movielens  # noqa: F401
from . import conll05  # noqa: F401
from . import flowers  # noqa: F401
from . import voc2012  # noqa: F401
from . import wmt14  # noqa: F401
from . import wmt16  # noqa: F401

__all__ = []
