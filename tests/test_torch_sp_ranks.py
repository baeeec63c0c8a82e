"""The ranks' half of ``tests/test_torch_sequence_parallel.py`` and of
``tests/test_torch_checkpoint.py``'s model-parallel case: what each
spawned gloo rank runs. No JAX here (a
rank started with ``spawn`` imports this module); inputs arrive as an
``.npz`` file and each rank returns numpy arrays.

A rank computes, on its sequence shard of q, k, v ``[2, 4, 32, 8]``
(float32; the group is the four ranks):

- ring attention, causal and full: the output, and the gradients of
  ``sum(out * g)``;
- Ulysses attention, causal and full: the same;
- ``split_sequence`` of a replicated tensor, ``gather_sequence`` of the
  shard and the gradient of ``sum(gather * w)`` through it;
- ``scaled_dot_product_attention`` inside ``sequence_parallel_scope``
  (the ring; Ulysses where the scope names it) and its raise on an
  explicit mask;
- ``build_context_parallel_step`` at dp2 x sp2: the tiny GPT of
  ``tests/test_context_parallel_gpt.py`` (vocab 128, hidden 32, 2
  layers, 4 heads, untied head), SGD at lr 0.1, three steps on a batch
  of 4 x 64, then two steps on a batch whose last 24 labels of each row
  are -100 (the last sequence shard ignored whole, the one before half):
  the losses and the final weights.
"""
import numpy as np
import torch

from paddle_tpu_torch import distributed as ptd

RANK_TIMEOUT_S = 120.0
SPAWN_TIMEOUT_S = 300.0
WORLD = 4
B, H, S, D = 2, 4, 32, 8
GPT = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=4,
           max_seq_len=64, dropout=0.0, tie_word_embeddings=False)
CP_BATCH, CP_SEQ, CP_LR = 4, 64, 0.1
CP_STEPS, CP_PAD_STEPS, CP_PAD = 3, 2, 24


def _t(a, grad=False):
    return torch.from_numpy(np.array(a, copy=True)).requires_grad_(grad)


def _shard(a, r, n=WORLD, dim=2):
    return np.split(a, n, axis=dim)[r]


def attention_cases(rank, data):
    from paddle_tpu_torch.distributed import sequence_parallel as sp

    out = {}
    q, k, v, g = (_shard(data[n], rank) for n in "qkvg")
    for name, fn in (("ring", sp.ring_attention),
                     ("ulysses", sp.ulysses_attention)):
        for causal in (True, False):
            tq, tk, tv = _t(q, True), _t(k, True), _t(v, True)
            o = fn(tq, tk, tv, None, causal=causal)
            (o * _t(g)).sum().backward()
            out[f"{name}_{causal}"] = [o.detach().numpy(), tq.grad.numpy(),
                                       tk.grad.numpy(), tv.grad.numpy()]
    # split / gather: [B, S, hidden] sequence on dim 1
    x = _t(data["x"], True)
    part = sp.split_sequence(x, None, 1)
    full = sp.gather_sequence(_t(_shard(data["x"], rank, dim=1)), None, 1)
    shard = _t(_shard(data["x"], rank, dim=1), True)
    (sp.gather_sequence(shard, None, 1) * _t(data["w"])).sum().backward()
    out["split"] = part.detach().numpy()
    out["gather"] = full.detach().numpy()
    out["gather_grad"] = shard.grad.numpy()
    # the framework's attention inside the scope
    from paddle_tpu_torch.nn import functional as F

    with sp.sequence_parallel_scope(None, "ulysses"):
        out["sdpa_ulysses"] = F.scaled_dot_product_attention(
            _t(q), _t(k), _t(v), is_causal=True).numpy()
    with sp.sequence_parallel_scope(None):
        out["sdpa"] = F.scaled_dot_product_attention(
            _t(q), _t(k), _t(v), is_causal=True).numpy()
        try:
            F.scaled_dot_product_attention(
                _t(q), _t(k), _t(v), attn_mask=torch.ones(S // WORLD,
                                                          S // WORLD,
                                                          dtype=torch.bool))
            out["mask_raises"] = False
        except NotImplementedError:
            out["mask_raises"] = True
    return out


def gpt_from(params):
    from paddle_tpu_torch.text import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.text.convert import state_dict_from_jax

    cfg = GPTConfig(**GPT)
    model = GPTForCausalLM(cfg, device="cpu")
    missing, unexpected = model.set_state_dict(state_dict_from_jax(
        {k: np.array(v, copy=True) for k, v in params.items()}, cfg))
    assert missing == [] and unexpected == []
    model.train()
    return model


def loss_fn(logits, labels):
    from paddle_tpu_torch.nn import functional as F

    return F.cross_entropy(logits.reshape([-1, GPT["vocab_size"]]),
                           labels.reshape([-1]))


def context_parallel(data, labels_key, steps):
    from paddle_tpu_torch.distributed.sequence_parallel import \
        build_context_parallel_step
    from paddle_tpu_torch.distributed.topology import CommunicateTopology
    from paddle_tpu_torch.optimizer import SGD

    params = {k[2:]: v for k, v in data.items() if k.startswith("p:")}
    model = gpt_from(params)
    opt = SGD(learning_rate=CP_LR, parameters=list(model.named_parameters()))
    mesh = CommunicateTopology(("dp", "sp"), [2, 2])
    init_fn, step_fn, shard_batch = build_context_parallel_step(
        model, opt, loss_fn, mesh)
    state = init_fn()
    xs = shard_batch([data["ids"]])
    ys = shard_batch([data[labels_key]])
    losses = []
    for i in range(steps):
        loss, state = step_fn(state, (0, 7 + i), CP_LR, xs, ys)
        losses.append(float(loss))
    return {"losses": losses,
            "state": {k: v.detach().numpy().copy()
                      for k, v in model.state_dict().items()}}


def sp_rank(rank, world, init, path):
    torch.set_num_threads(1)
    ptd.init_parallel_env("gloo", init, world, rank,
                          timeout_s=RANK_TIMEOUT_S)
    try:
        data = dict(np.load(path))
        out = attention_cases(rank, data)
        out["cp"] = context_parallel(data, "labels", CP_STEPS)
        out["cp_pad"] = context_parallel(data, "labels_pad", CP_PAD_STEPS)
        return out
    finally:
        ptd.destroy_process_group()


# ------------------------------------------------------------ checkpoints
def checkpoint_rank(rank, world, init, path, out_dir):
    """mp2 over two ranks: the tiny GPT of ``test_torch_fleet_ranks``
    (2 heads) cut by ``distributed_model``, saved whole through
    ``save_state_dict(dm, ...)`` (rank 0 writes), then loaded into a
    model of other weights cut the same way; and ``AutoCheckpoint`` at
    interval 1 over both ranks. Returns the loaded rank's state and what
    ``latest()`` gives."""
    import os

    from paddle_tpu_torch.distributed import checkpoint as ck
    from paddle_tpu_torch.distributed import fleet
    from test_torch_fleet_ranks import gpt_from as fleet_gpt
    from test_torch_fleet_ranks import strategy_for

    torch.set_num_threads(1)
    ptd.init_parallel_env("gloo", init, world, rank,
                          timeout_s=RANK_TIMEOUT_S)
    try:
        data = dict(np.load(path))
        models = []
        for prefix in ("p:", "q:"):
            f = fleet.fleet.reset()
            s = strategy_for("dp2_mp2")
            s.hybrid_configs = dict(s.hybrid_configs, dp_degree=1)
            f.init(is_collective=True, strategy=s)
            model = fleet_gpt({k[2:]: v for k, v in data.items()
                               if k.startswith(prefix)})
            fleet.apply_megatron_specs(model)
            models.append(f.distributed_model(model))
        ck.save_state_dict(models[0], os.path.join(out_dir, "whole"))
        ck.load_state_dict(os.path.join(out_dir, "whole"), models[1])
        auto = ck.AutoCheckpoint(os.path.join(out_dir, "auto"), 1, 1)
        for _ in range(2):
            auto.step(lambda: models[1])
        return {"state": {k: v.detach().numpy().copy()
                          for k, v in models[1].state_dict().items()},
                "latest": auto.latest()}
    finally:
        ptd.destroy_process_group()
