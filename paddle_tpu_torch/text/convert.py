"""The weights bridge: the JAX package's GPT parameters into the port, and
back.

``paddle_tpu``'s ``GPTForCausalLM.functional_state()`` names every
parameter as the port does (``gpt.wte.weight``,
``gpt.blocks.{i}.attn.qkv_proj.weight``, ``gpt.ln_f.bias`` ...), so the
bridge keeps the names and changes one thing: a Linear weight is
``[in, out]`` there and ``[out, in]`` in ``torch.nn.Linear``, so it is
transposed. The qkv projection keeps its column order
``(3, heads, head_dim)``; embeddings keep ``[rows, hidden]``.
``state_dict_to_jax`` is the inverse, so that updated parameters and
gradients can be compared under the reference's names and layout.
"""
from __future__ import annotations

import numpy as np
import torch

from .gpt import GPTConfig

__all__ = ["state_dict_from_jax", "state_dict_to_jax", "expected_shapes"]

_LINEARS = ("attn.qkv_proj", "attn.out_proj", "mlp.fc1", "mlp.fc2")


def expected_shapes(cfg: GPTConfig) -> dict[str, tuple]:
    """Every parameter of the reference GPT with its shape there
    (Linear weights ``[in, out]``)."""
    h, f, v = cfg.hidden_size, cfg.ffn_hidden, cfg.vocab_size
    shapes = {"gpt.wte.weight": (v, h), "gpt.wpe.weight": (cfg.max_seq_len, h),
              "gpt.ln_f.weight": (h,), "gpt.ln_f.bias": (h,)}
    for i in range(cfg.num_layers):
        p = f"gpt.blocks.{i}."
        shapes.update({
            p + "ln1.weight": (h,), p + "ln1.bias": (h,),
            p + "attn.qkv_proj.weight": (h, 3 * h),
            p + "attn.qkv_proj.bias": (3 * h,),
            p + "attn.out_proj.weight": (h, h), p + "attn.out_proj.bias": (h,),
            p + "ln2.weight": (h,), p + "ln2.bias": (h,),
            p + "mlp.fc1.weight": (h, f), p + "mlp.fc1.bias": (f,),
            p + "mlp.fc2.weight": (f, h), p + "mlp.fc2.bias": (h,)})
    if not cfg.tie_word_embeddings:
        shapes["lm_head.weight"] = (h, v)
    return shapes


def _is_linear_weight(name: str) -> bool:
    return name == "lm_head.weight" or (
        name.endswith(".weight") and name[:-len(".weight")].endswith(_LINEARS))


def state_dict_from_jax(params: dict, cfg: GPTConfig) -> dict:
    """``{name: np.ndarray}`` from the reference ``functional_state()``
    (values as numpy arrays) -> a ``state_dict`` for the port's
    ``GPTForCausalLM(cfg)``. Raises KeyError naming missing or unexpected
    parameters and ValueError naming a shape that does not match ``cfg``."""
    want = expected_shapes(cfg)
    missing = sorted(set(want) - set(params))
    extra = sorted(set(params) - set(want))
    if missing or extra:
        raise KeyError(f"parameters do not match the config: missing "
                       f"{missing}, unexpected {extra}")
    out = {}
    for name, shape in want.items():
        arr = np.asarray(params[name])
        if arr.shape != shape:
            raise ValueError(f"{name}: shape {arr.shape}, config wants "
                             f"{shape}")
        t = torch.from_numpy(np.array(arr, copy=True))
        out[name] = t.t().contiguous() if _is_linear_weight(name) else t
    return out


def state_dict_to_jax(sd: dict, cfg: GPTConfig) -> dict:
    """The inverse of :func:`state_dict_from_jax`: a port ``state_dict``
    (or any ``{name: tensor}`` over the same names, such as gradients) ->
    ``{name: float32 np.ndarray}`` under the reference's names and shapes
    (Linear weights back to ``[in, out]``). Raises KeyError naming missing
    or unexpected names and ValueError naming a shape that does not match
    ``cfg``."""
    want = expected_shapes(cfg)
    missing = sorted(set(want) - set(sd))
    extra = sorted(set(sd) - set(want))
    if missing or extra:
        raise KeyError(f"tensors do not match the config: missing "
                       f"{missing}, unexpected {extra}")
    out = {}
    for name, shape in want.items():
        t = sd[name].detach().float().cpu()
        if _is_linear_weight(name):
            t = t.t()
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)} in the "
                             f"reference layout, config wants {shape}")
        out[name] = t.contiguous().numpy()
    return out
