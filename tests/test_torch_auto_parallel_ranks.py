"""The ranks' half of the auto-parallel tests: what each of four spawned
gloo ranks runs for ``tests/test_torch_auto_parallel.py``, which holds
what they return against the JAX package.

This module imports no JAX (a rank started with the ``spawn`` method
imports the module that defines its function). Inputs cross to the ranks
as an ``.npz`` file; each rank returns numpy arrays and plain values.

- ``shard_tensor`` / ``local_shard`` / ``reshard`` round trips of an
  ``[8, 16]`` array on a 2 x 2 mesh (all-gather, slice, all-to-all), on
  a permuted mesh, and across two meshes of two ranks (send / recv), with
  ``Resharder.log``'s kinds;
- the Engine on the reference test's tiny GPT (vocab 64, hidden 16, 2
  layers, 2 heads, seq 8) over a dp2 x mp2 ``ProcessMesh``: partly
  annotated and completed, and with ``apply_megatron_specs``, SGD at lr
  0.1, three batches;
- ``fit`` / ``evaluate`` / ``predict`` / ``save`` / ``load`` of the
  reference test's MLP (16 -> 64 -> 4, Adam 5e-3) on the planner's mesh;
- ``examples/auto_parallel_plan.py``'s workflow at four ranks: the plan
  of its wide FFN on ``cpu_test_cluster(4)``, the placement, and six Adam
  steps on the planned mesh of its column -> row block, also with the
  block's output gathered and the row layer splitting its own input.
"""
import os

import numpy as np
import torch

from paddle_tpu_torch import distributed as ptd

RANK_TIMEOUT_S = 120.0
SPAWN_TIMEOUT_S = 300.0
WORLD = 4
GPT = dict(vocab_size=64, hidden_size=16, num_layers=2, num_heads=2,
           max_seq_len=8, dropout=0.0)
GPT_BATCH, GPT_STEPS, GPT_LR = 4, 3, 0.1
MLP_EPOCHS, MLP_LOG_FREQ, MLP_LR = 8, 4, 5e-3
#: examples/auto_parallel_plan.py: the model's seven numbers, the block's
#: widths, six steps of Adam at 1e-3 on one batch of 8
PLAN_DESC = dict(n_params=4_300_000, layers=1, hidden=512, heads=0, seq=1,
                 batch=8)
FFN = dict(d=512, ffn=4096, classes=16)
PLAN_STEPS, PLAN_LR = 6, 1e-3


def partial_annotations(model, mesh):
    """The reference test's: the qkv and fc1 weights split on their
    output features, the word embedding on the vocabulary."""
    from paddle_tpu_torch.distributed.auto_parallel import shard_tensor

    for name, p in model.named_parameters():
        if name.endswith(("qkv_proj.weight", "fc1.weight")):
            shard_tensor(p, mesh, [None, "mp"])
        if name.endswith("wte.weight"):
            shard_tensor(p, mesh, ["mp", None])


def lm_loss(logits, labels):
    from paddle_tpu_torch.nn import functional as F

    return F.cross_entropy(logits.reshape(-1, GPT["vocab_size"]),
                           labels.reshape(-1).long())


def reshard_cases(rank):
    from paddle_tpu_torch.distributed.auto_parallel import (
        ProcessMesh, Resharder, TensorDistAttr, local_shard, reshard,
        shard_tensor)

    whole = np.arange(8 * 16, dtype=np.float32).reshape(8, 16)
    out = {}
    pm = ProcessMesh([[0, 1], [2, 3]], dim_names=["x", "y"])
    t = shard_tensor(whole, pm, ["x", "y"])
    out["local"] = local_shard(t).numpy().copy()
    r = Resharder()
    moved = r.apply(t, TensorDistAttr(pm, [None, "x"]))
    out["moved"] = moved.numpy().copy()
    back = r.apply(moved, TensorDistAttr(pm, [None, None]))
    out["gathered"] = back.numpy().copy()
    rows = r.apply(back, TensorDistAttr(pm, ["y", None]))
    out["rows"] = rows.numpy().copy()
    r.apply(rows, TensorDistAttr(pm, ["y", None]))
    rows_x = shard_tensor(whole, pm, ["x", None])
    out["a2a"] = r.apply(rows_x, TensorDistAttr(pm, [None, "x"])).numpy(
        ).copy()
    out["log"] = [k for k, _ in r.log]
    # a permuted mesh: the groups and the gather follow the ids array
    perm = ProcessMesh([[0, 2], [1, 3]], dim_names=["x", "y"])
    pt = shard_tensor(whole, perm, ["x", "y"])
    out["perm_local"] = local_shard(pt).numpy().copy()
    out["perm_gathered"] = reshard(pt, perm, [None, None]).numpy().copy()
    out["perm_groups"] = {d: list(perm.group(d).ranks) for d in ("x", "y")}
    # across two meshes: ranks 0, 1 hold rows, ranks 2, 3 receive columns
    a = ProcessMesh([0, 1], dim_names=["x"])
    b = ProcessMesh([2, 3], dim_names=["x"])
    xa = shard_tensor(whole, a, ["x", None])
    r2 = Resharder()
    got = r2.apply(xa, TensorDistAttr(b, [None, "x"]))
    out["across"] = None if got is None else got.numpy().copy()
    out["across_log"] = [k for k, _ in r2.log]
    return out


def gpt_from(params):
    from paddle_tpu_torch.text import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.text.convert import state_dict_from_jax

    cfg = GPTConfig(**GPT)
    model = GPTForCausalLM(cfg, device="cpu")
    missing, unexpected = model.set_state_dict(
        state_dict_from_jax(params, cfg))
    assert missing == [] and unexpected == []
    model.train()
    return model


def gpt_engine(params, ids, annotate):
    """One Engine run: the losses of ``GPT_STEPS`` batches, the layout's
    counts and the completed specs."""
    from paddle_tpu_torch.distributed.auto_parallel import (Engine,
                                                            ProcessMesh)
    from paddle_tpu_torch.distributed.fleet import apply_megatron_specs
    from paddle_tpu_torch.optimizer import SGD

    pm = ProcessMesh(np.arange(4).reshape(2, 2), dim_names=["dp", "mp"])
    model = gpt_from(params)
    if annotate == "partial":
        partial_annotations(model, pm)
    else:
        apply_megatron_specs(model)
    opt = SGD(GPT_LR, parameters=model.parameters())
    eng = Engine(model=model, loss=lm_loss, optimizer=opt, process_mesh=pm)
    eng.prepare(inputs_spec=[torch.zeros(GPT_BATCH, GPT["max_seq_len"],
                                         dtype=torch.long)])
    batches = [(ids, ids)] * GPT_STEPS
    losses = eng.fit(batches, epochs=1, log_freq=1)["loss"]
    counts = {}
    for kind in eng.layout.values():
        counts[kind] = counts.get(kind, 0) + 1
    return {"losses": losses, "layout": dict(eng.layout), "counts": counts,
            "specs": {n: p._sharding_spec for n, p in model.named_parameters()
                      if getattr(p, "_sharding_spec", None) is not None}}


def mlp(params):
    from paddle_tpu_torch import nn

    model = nn.Sequential(nn.Linear(16, 64), nn.ReLU(), nn.Linear(64, 4))
    missing, unexpected = model.set_state_dict(params)
    assert missing == [] and unexpected == []
    return model


def mlp_engine(params, xs, ys, out_dir):
    """The reference test's ``fit`` / ``evaluate`` / ``predict`` /
    ``save`` / ``load``, at MLP_EPOCHS epochs."""
    from paddle_tpu_torch import metric, nn
    from paddle_tpu_torch.distributed.auto_parallel import Engine
    from paddle_tpu_torch.optimizer import Adam

    model = mlp(params)
    opt = Adam(learning_rate=MLP_LR, parameters=model.parameters())
    engine = Engine(model=model, loss=nn.CrossEntropyLoss(), optimizer=opt,
                    metrics=metric.Accuracy())
    batches = [(xs[i:i + 16], ys[i:i + 16]) for i in range(0, 64, 16)]
    hist = engine.fit(batches, epochs=MLP_EPOCHS, log_freq=MLP_LOG_FREQ)
    res = engine.evaluate(batches)
    preds = engine.predict([(xs[:16],)])
    path = os.path.join(out_dir, "m")
    engine.save(path)
    fresh = mlp({k: np.zeros_like(v) for k, v in params.items()})
    engine2 = Engine(model=fresh, loss=nn.CrossEntropyLoss(),
                     metrics=metric.Accuracy())
    engine2.load(path)
    res2 = engine2.evaluate(batches)
    return {"losses": hist["loss"], "eval": res, "eval_loaded": res2,
            "pred": preds[0][0], "mesh": engine.process_mesh.shape,
            "saved": os.path.isfile(path + ".pdparams")}


def ffn(params, gathered):
    """The example's column -> row block (the fleet's parallel layers);
    ``gathered``: the column layer gathers its output and the row layer
    splits its own input (the same function)."""
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.distributed.fleet import (ColumnParallelLinear,
                                                    RowParallelLinear)
    from paddle_tpu_torch.nn import functional as F

    class Block(nn.Layer):
        def __init__(self):
            super().__init__()
            self.col = ColumnParallelLinear(FFN["d"], FFN["ffn"],
                                            gather_output=gathered)
            self.row = RowParallelLinear(FFN["ffn"], FFN["classes"],
                                         input_is_parallel=not gathered)

        def forward(self, x):
            return self.row(F.relu(self.col(x)))

    model = Block()
    missing, unexpected = model.set_state_dict(params)
    assert missing == [] and unexpected == []
    return model


def plan_example(params, xs, ys):
    """The example's plan, placement and losses (both block variants)."""
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.distributed.auto_parallel import (
        Engine, ModelDesc, ProcessMesh, cpu_test_cluster, plan_parallel)
    from paddle_tpu_torch.optimizer import Adam

    cluster = cpu_test_cluster(WORLD)
    plan = plan_parallel(WORLD, ModelDesc(**PLAN_DESC), cluster)
    placed = plan.process_mesh(cluster)
    out = {"plan": plan.axis_sizes, "t_comm": plan.t_comm,
           "placement": placed.placement}
    mesh = ProcessMesh(np.arange(WORLD).reshape(plan.dp, plan.sharding,
                                                plan.mp),
                       dim_names=["dp", "sharding", "mp"])
    for gathered in (False, True):
        model = ffn(params, gathered)
        opt = Adam(PLAN_LR, parameters=model.parameters())
        eng = Engine(model=model, loss=nn.CrossEntropyLoss(), optimizer=opt,
                     process_mesh=mesh)
        out["gathered" if gathered else "losses"] = eng.fit(
            [(xs, ys)] * PLAN_STEPS, log_freq=1)["loss"]
        out["layout" + ("_gathered" if gathered else "")] = dict(eng.layout)
    return out


def ap_rank(rank, world, init, path, out_dir):
    """Everything a rank runs for ``test_torch_auto_parallel.py``."""
    import paddle_tpu_torch as paddle

    torch.set_num_threads(1)
    paddle.set_device("cpu")
    ptd.init_parallel_env("gloo", init, world, rank,
                          timeout_s=RANK_TIMEOUT_S)
    try:
        data = dict(np.load(path))
        gpt = {k[2:]: v for k, v in data.items() if k.startswith("p:")}
        mlp_params = {k[2:]: v for k, v in data.items()
                      if k.startswith("m:")}
        ffn_params = {k[2:]: v for k, v in data.items()
                      if k.startswith("f:")}
        return {"reshard": reshard_cases(rank),
                "partial": gpt_engine(gpt, data["ids"], "partial"),
                "megatron": gpt_engine(gpt, data["ids"], "megatron"),
                "mlp": mlp_engine(mlp_params, data["xs"], data["ys"],
                                  out_dir),
                "plan": plan_example(ffn_params, data["plan_xs"],
                                     data["plan_ys"])}
    finally:
        ptd.destroy_process_group()
