"""The functional tensor library — the port of ``paddle_tpu/tensor_ops``
(``python/paddle/tensor/`` in Paddle): creation, math, manipulation,
logic, search, random and linalg functions under the reference's names
and signatures (``axis=``, ``keepdim=``, ``name=``), each a plain
function of torch tensors that returns the port's ``Tensor``. Operands
that are not tensors (Python numbers, lists, ndarrays) are made tensors
on ``set_device``'s place; tensors stay where they are. Gradients are
torch's autograd, through every differentiable function."""
from .creation import *  # noqa: F401,F403
from .math import *  # noqa: F401,F403
from .manipulation import *  # noqa: F401,F403
from .logic import *  # noqa: F401,F403
from .search import *  # noqa: F401,F403
from .random import *  # noqa: F401,F403
from .linalg import *  # noqa: F401,F403
from .einsum import einsum  # noqa: F401
from . import (creation as _creation, linalg as _linalg,  # noqa: E402
               logic as _logic, manipulation as _manipulation,
               math as _math, random as _random, search as _search)

#: the functions only: ``from tensor_ops import *`` must not bind the
#: submodule names (the root's ``random`` is the threefry module)
__all__ = sorted({n for m in (_creation, _math, _manipulation, _logic,
                              _search, _random, _linalg)
                  for n in m.__all__} | {"einsum"})
