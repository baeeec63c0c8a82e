"""``paddle.vision`` of the port (reference: ``paddle_tpu/vision/__init__.py``):
``models`` (every model family of the reference) and ``LeNet``; the
datasets, the host transforms, the detection operators (``ops``, on the
device of their inputs) and the image backend."""
from . import datasets
from . import models
from . import ops
from . import transforms
from .models import LeNet

__all__ = ["datasets", "models", "ops", "transforms", "LeNet",
           "set_image_backend", "get_image_backend", "image_load"]

_image_backend = "pil"


def set_image_backend(backend):
    """Select the image-decoding backend: ``pil``, ``cv2`` or ``tensor``."""
    global _image_backend
    if backend not in ("pil", "cv2", "tensor"):
        raise ValueError(f"unsupported backend {backend}")
    _image_backend = backend


def get_image_backend():
    return _image_backend


def image_load(path, backend=None):
    """The image at ``path`` through PIL (reference: ``paddle_tpu/vision/
    __init__.py:25-39``): a PIL image, or with the ``tensor`` backend its
    array as a tensor on ``set_device``'s place. PIL must be present, as
    in the reference; ``cv2`` is not shipped."""
    backend = backend or _image_backend
    if backend == "cv2":
        raise NotImplementedError("cv2 is not available; use the pil backend")
    from PIL import Image

    img = Image.open(path)
    if backend == "tensor":
        import numpy as np

        from ..core.tensor import to_tensor

        return to_tensor(np.asarray(img))
    return img
