"""paddle_tpu_torch.core — the port of ``paddle_tpu/core``: dtypes
(:mod:`.dtype`), places (:mod:`.place`), the eager ``Tensor``
(:mod:`.tensor`, a ``torch.Tensor`` subclass), grad mode (:mod:`.tape`),
the error taxonomy (:mod:`.errors`), allocator statistics
(:mod:`.memory`), the random-key schedule (:mod:`.rng`) and the host
string tensors (:mod:`.string_tensor`)."""
from . import errors, memory, rng, string_tensor
from .dtype import convert_dtype, get_default_dtype, set_default_dtype, \
    to_torch_dtype
from .place import (CPUPlace, CUDAPinnedPlace, CUDAPlace, Place,
                    device_count, get_device, set_device)
from .rng import (Generator, default_generator, get_rng_tracker,
                  next_rng_key, seed, trace_rng_scope)
from .tape import enable_grad, is_grad_enabled, no_grad
from .tensor import Tensor, to_tensor

__all__ = ["rng", "errors", "memory", "string_tensor", "convert_dtype",
           "get_default_dtype",
           "set_default_dtype", "to_torch_dtype", "Place", "CPUPlace",
           "CUDAPlace", "CUDAPinnedPlace", "device_count", "get_device",
           "set_device", "Generator", "default_generator",
           "get_rng_tracker", "next_rng_key", "seed", "trace_rng_scope",
           "enable_grad", "is_grad_enabled", "no_grad", "Tensor",
           "to_tensor"]
