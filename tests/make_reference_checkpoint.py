"""Write a checkpoint with the JAX package, for ``chip_smoke.py`` phase 17
(d): the port loads a ``state.pdparams`` that the reference wrote and
computes the loss the reference computed for the next batch.

Run on a machine with JAX (the card's machine has none), from the root of
the checkout::

    JAX_PLATFORMS=cpu python tests/make_reference_checkpoint.py chip_scratch/reference_ckpt

It writes, under the directory given: ``state.pdparams`` (the reference's
``distributed.checkpoint.save_state_dict``, its ``framework.io.save``
branch, which it takes without orbax), ``batch.npz`` (the ids and labels
of the next step) and ``reference.json`` (the model's configuration and
the reference's float32 loss on that batch, on the CPU). The model is a
GPT of ``CONFIG`` (head_dim 64, which the flash kernels take), small
enough (about 42 MB) to travel with a copy of the repository to the
card. Not a test: pytest collects no file
of this name.
"""
import json
import os
import sys

import numpy as np

LAYERS, BATCH, SEQ, SEED = 2, 2, 256, 17
CONFIG = dict(vocab_size=8192, hidden_size=512, num_layers=LAYERS,
              num_heads=8, max_seq_len=SEQ, dropout=0.0)


def main(out: str) -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    import paddle_tpu as J
    import paddle_tpu.distributed.checkpoint as jck
    from paddle_tpu.text.gpt import GPTConfig, GPTForCausalLM

    jck._HAS_ORBAX = False   # the branch the reference takes without orbax
    J.seed(SEED)
    model = GPTForCausalLM(GPTConfig(**CONFIG))
    os.makedirs(out, exist_ok=True)
    jck.save_state_dict(model.state_dict(), out)
    rng = np.random.default_rng(SEED)
    ids = rng.integers(0, CONFIG["vocab_size"], (BATCH, SEQ + 1))
    x, y = ids[:, :-1].astype(np.int64), ids[:, 1:].astype(np.int64)
    np.savez(os.path.join(out, "batch.npz"), ids=x, labels=y)
    loss = float(model(J.to_tensor(x), labels=J.to_tensor(y)).numpy())
    with open(os.path.join(out, "reference.json"), "w") as f:
        json.dump({"config": CONFIG, "loss": loss,
                   "writer": "paddle_tpu.distributed.checkpoint"}, f)
    print(json.dumps({"out": out, "loss": loss}))


if __name__ == "__main__":
    main(sys.argv[1])
