"""paddle_tpu_torch — the PyTorch/CUDA port of ``paddle_tpu``.

The JAX package ``paddle_tpu`` is the reference; this package mirrors its
layout (``kernels/``, ``text/``, ``serving/``) so each module's
counterpart is found under the same name. It imports torch, numpy and the
standard library only — never jax and never ``paddle_tpu``.

The first slice is greedy serving of a GPT through the paged-KV engine:

    from paddle_tpu_torch.text import GPTForCausalLM, gpt_config
    from paddle_tpu_torch.serving import ServingEngine, ServingConfig

    model = GPTForCausalLM(gpt_config("gpt3-1.3b"))        # on the card
    engine = ServingEngine(model, ServingConfig(max_batch=8))
    rid = engine.add_request(prompt_ids, max_new_tokens=64)
    outputs = engine.run()

Entry points run on CUDA unless the caller passes ``device="cpu"``; with
no CUDA device they raise.
"""
from ._device import resolve_device

__all__ = ["resolve_device"]
