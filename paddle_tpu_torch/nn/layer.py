"""The smallest piece of ``paddle_tpu/nn/layer.py``'s ``Layer`` the
dygraph workflow needs: :class:`LayerMixin`, which gives a
``torch.nn.Module`` Paddle's ``set_state_dict`` (alias ``load_dict``).
The port's GPT modules take it; the rest of ``Layer`` is ROADMAP Queue 1
item 12b."""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["LayerMixin"]


class LayerMixin:
    """Mixed into a ``torch.nn.Module`` before it."""

    def set_state_dict(self, state_dict, use_structured_name=True):
        """Copy each entry of ``state_dict`` (tensors or arrays, keyed by
        structured name, as ``state_dict()`` and ``paddle.load`` give
        them) into the module's parameter or buffer of that name, in
        place and cast to its dtype; the shapes must match. Returns
        ``(missing, unexpected)``: the module's names the dict lacks and
        the dict's names the module lacks, as the reference does.
        ``use_structured_name`` is the reference's argument; the keys are
        structured names either way."""
        own = self.state_dict(keep_vars=True)
        missing, unexpected = [], []
        with torch.no_grad():
            for k, v in state_dict.items():
                if k not in own:
                    unexpected.append(k)
                    continue
                dst = own[k]
                src = v if isinstance(v, torch.Tensor) \
                    else torch.as_tensor(np.asarray(v))
                if tuple(src.shape) != tuple(dst.shape):
                    raise ValueError(
                        f"set_state_dict {k}: shape {tuple(src.shape)} vs "
                        f"the module's {tuple(dst.shape)}")
                torch.Tensor.copy_(dst, src.detach().to(dst.dtype))
        missing = [k for k in own if k not in state_dict]
        return missing, unexpected

    load_dict = set_state_dict
