"""The ranks' half of the parallel-training tests: the functions each
spawned gloo rank runs, for ``tests/test_torch_collective.py``,
``test_torch_distributed_ops.py``, ``test_torch_fleet_hybrid.py`` and
``test_torch_moe.py``, which hold what they return against the JAX
package on its 8-device CPU mesh.

This module imports no JAX: a rank started with the ``spawn`` method
imports the module that defines its function, and importing the JAX
package would turn on x64 process-wide. Inputs cross to the ranks as an
``.npz`` file; each rank returns numpy arrays.

The hybrid cases train the reference tests' tiny GPT (vocab 128, hidden
32, 2 layers, 2 heads, seq 16, dropout 0) for three ``train_batch`` steps
of AdamW (epsilon 1e-4) with ``ClipGradByGlobalNorm(1.0)`` on a batch
of 8.
"""
import os

import numpy as np
import torch

from paddle_tpu_torch import distributed as ptd

#: a rank's rendezvous and collective timeout, and the parent's join limit
RANK_TIMEOUT_S = 120.0
SPAWN_TIMEOUT_S = 300.0
WORLD = 4
GPT = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=2,
           max_seq_len=16, dropout=0.0)
BATCH, SEQ, STEPS = 8, 16, 3
ADAM = dict(epsilon=1e-4)
#: name -> (hybrid_configs, strategy switches[, GPT overrides]); every
#: case has 4 ranks. mp4 runs 4 heads: a rank keeps whole heads, and 2
#: do not split over 4 ranks
HYBRID = {
    "dp2_mp2": (dict(dp_degree=2, mp_degree=2), {}),
    "mp4": (dict(mp_degree=4), {}, dict(num_heads=4)),
    "dp4": (dict(dp_degree=4), {}),
    "zero_os": (dict(sharding_degree=2, mp_degree=2),
                {"sharding": True, "sharding_configs": {"stage": 1}}),
    "zero_os_g": (dict(sharding_degree=2, mp_degree=2),
                  {"sharding": True, "sharding_configs": {"stage": 2}}),
    "zero_p_g_os": (dict(sharding_degree=2, mp_degree=2),
                    {"sharding": True, "sharding_configs": {"stage": 3}}),
    "dp2_mp2_recompute": (dict(dp_degree=2, mp_degree=2),
                          {"recompute": True}),
    "dp2_mp2_amp": (dict(dp_degree=2, mp_degree=2),
                    {"amp": True, "amp_configs": {"level": "O1"}}),
    "dp2_mp2_dropout": (dict(dp_degree=2, mp_degree=2), {},
                        dict(dropout=0.1)),
}


def spawn_ranks(fn, tmp_path, *args, world=WORLD):
    """``fn(rank, world, init_method, *args)`` on ``world`` spawned ranks
    over a ``file://`` rendezvous under ``tmp_path``."""
    init = f"file://{os.path.join(tmp_path, f'rdv-{fn.__name__}')}"
    return ptd.spawn(fn, world, args=(init, *args),
                     timeout_s=SPAWN_TIMEOUT_S)


def _join(rank, world, init):
    torch.set_num_threads(1)
    ptd.init_parallel_env("gloo", init, world, rank,
                          timeout_s=RANK_TIMEOUT_S)


def strategy_for(name):
    from paddle_tpu_torch.distributed import fleet

    hybrid, switches = HYBRID[name][:2]
    s = fleet.DistributedStrategy()
    s.hybrid_configs = dict(dict(dp_degree=1, mp_degree=1, pp_degree=1,
                                 sharding_degree=1), **hybrid)
    for k, v in switches.items():
        setattr(s, k, v)
    return s


def gpt_config(name=None) -> dict:
    """The GPT fields of hybrid case ``name``."""
    extra = HYBRID[name][2] if name and len(HYBRID[name]) > 2 else {}
    return dict(GPT, **extra)


def gpt_from(params, name=None):
    """The port's GPT (float32, CPU, training mode) with the reference's
    weights (numpy, its layout)."""
    from paddle_tpu_torch.text import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.text.convert import state_dict_from_jax

    cfg = GPTConfig(**gpt_config(name))
    model = GPTForCausalLM(cfg, device="cpu")
    missing, unexpected = model.set_state_dict(
        state_dict_from_jax(params, cfg))
    assert missing == [] and unexpected == []
    model.train()
    return model


def train_hybrid(name, params, ids, labels):
    """One hybrid case through the public entry points: ``fleet.init`` ->
    ``apply_megatron_specs`` -> ``distributed_model`` ->
    ``distributed_optimizer(AdamW + ClipGradByGlobalNorm(1.0))`` -> three
    ``train_batch``. Returns the losses and this rank's state dict."""
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.utils.clip_grad import ClipGradByGlobalNorm

    f = fleet.fleet.reset()
    f.init(is_collective=True, strategy=strategy_for(name))
    model = gpt_from(params, name)
    fleet.apply_megatron_specs(model)
    opt = AdamW(parameters=list(model.named_parameters()),
                grad_clip=ClipGradByGlobalNorm(1.0), **ADAM)
    dm = f.distributed_model(model)
    dopt = f.distributed_optimizer(opt)
    losses = [float(dm.train_batch([ids, labels], dopt))
              for _ in range(STEPS)]
    state = {k: v.detach().float().numpy().copy()
             for k, v in dm.state_dict().items()}
    out = {"losses": losses, "state": state,
           "coord": f.get_hybrid_communicate_group()._coord}
    if dm._zero is not None:
        out["state_bytes"] = dm._zero.state_bytes()
        out["zero_chunk"] = dm._zero.master.numpy().copy()
    return out


def params_for(data):
    """The reference's weights (``p:`` entries of the inputs file; the
    4-head GPT of mp4 has the 2-head one's shapes)."""
    return {k[2:]: v for k, v in data.items() if k.startswith("p:")}


def hybrid_norm(params, ids, labels):
    """The hybrid clip's total at dp2 x mp2: this rank's sum of squares
    over its shard of the data-averaged gradients, reduced by
    ``HybridNorm`` between the two launches of the global norm."""
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet.hybrid_train import (HybridNorm,
                                                                 batch_slice)
    from paddle_tpu_torch.distributed.parallel import average_gradients
    from paddle_tpu_torch.kernels.global_norm import global_norm_scale

    f = fleet.fleet.reset()
    f.init(is_collective=True, strategy=strategy_for("dp2_mp2"))
    model = gpt_from(params)
    fleet.apply_megatron_specs(model)
    f.distributed_model(model)
    hcg = f.get_hybrid_communicate_group()
    r, n = hcg.get_batch_rank()
    loss = model(batch_slice(ids, r, n), labels=batch_slice(labels, r, n))
    loss.backward()
    params = list(model.parameters())
    average_gradients(params, hcg.get_batch_group())
    total, _ = global_norm_scale([p.grad for p in params], 1.0,
                                 HybridNorm(hcg)(params))
    return float(total)


def hybrid_rank(rank, world, init, path, names):
    _join(rank, world, init)
    try:
        data = dict(np.load(path))
        ids = torch.from_numpy(data["ids"])
        labels = torch.from_numpy(data["labels"])
        out = {n: train_hybrid(n, params_for(data), ids, labels)
               for n in names}
        out["norm"] = hybrid_norm(params_for(data), ids, labels)
        return out
    finally:
        ptd.destroy_process_group()


# ------------------------------------------------------------ pipeline
#: pp2 x dp2, the batch of 8 in ``ACCUMULATE`` micro-batches
PIPE_HYBRID = dict(dp_degree=2, pp_degree=2)
ACCUMULATE = 2


def pipe_state_from(params, model):
    """The reference's pipeline state dict (numpy, its layout) in the
    port's layout: a ``torch.nn.Linear`` weight transposed."""
    mods = dict(model.named_modules())
    out = {}
    for k, v in params.items():
        owner = mods.get(k.rsplit(".", 1)[0])
        t = torch.from_numpy(np.array(v, copy=True))
        if t.dim() == 2 and isinstance(owner, torch.nn.Linear):
            t = t.t().contiguous()
        out[k] = t
    return out


def gpt_pipeline(params, stages=2):
    from paddle_tpu_torch.text import GPTConfig
    from paddle_tpu_torch.text.gpt import build_gpt_pipeline

    pipe = build_gpt_pipeline(GPTConfig(**GPT), stages, device="cpu")
    missing, unexpected = pipe.set_state_dict(pipe_state_from(params, pipe))
    assert missing == [] and unexpected == []
    pipe.train()
    return pipe


def train_pipeline(recompute, params, ids, labels):
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.optimizer import AdamW

    s = fleet.DistributedStrategy()
    s.hybrid_configs = dict(dp_degree=2, mp_degree=1, pp_degree=2,
                            sharding_degree=1)
    s.pipeline = True
    s.pipeline_configs = {"accumulate_steps": ACCUMULATE,
                          "micro_batch_size": BATCH // ACCUMULATE,
                          "recompute": recompute}
    f = fleet.fleet.reset()
    f.init(is_collective=True, strategy=s)
    pipe = gpt_pipeline(params)
    dm = f.distributed_model(pipe)
    opt = AdamW(parameters=list(pipe.named_parameters()), **ADAM)
    dopt = f.distributed_optimizer(opt)
    losses = [float(dm.train_batch((ids, labels), dopt))
              for _ in range(STEPS)]
    state = {k: v.detach().numpy().copy()
             for k, v in pipe.state_dict().items()}
    return {"losses": losses, "state": state,
            "eval": float(dm.eval_batch((ids, labels))),
            "coord": f.get_hybrid_communicate_group()._coord}


def pipeline_rank(rank, world, init, path):
    _join(rank, world, init)
    try:
        data = dict(np.load(path))
        params = {k[2:]: v for k, v in data.items() if k.startswith("q:")}
        ids = torch.from_numpy(data["ids"])
        labels = torch.from_numpy(data["labels"])
        return {rc: train_pipeline(rc, params, ids, labels)
                for rc in (True, False)}
    finally:
        ptd.destroy_process_group()


# ------------------------------------------------------- collectives
def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def collective_rank(rank, world, init, path, port):
    """Every collective of ``distributed.collective`` on this rank's row
    of the inputs; each result as numpy. The rank joins through
    ``init_parallel_env()``'s no-argument form: the launcher's
    environment, a TCP rendezvous on ``port``."""
    from paddle_tpu_torch.distributed import collective as C

    torch.set_num_threads(1)
    os.environ.update(PADDLE_TRAINER_ID=str(rank),
                      PADDLE_TRAINERS_NUM=str(world),
                      PADDLE_MASTER=f"127.0.0.1:{port}",
                      PADDLE_DISTRIBUTED_BACKEND="gloo")
    penv = ptd.init_parallel_env()
    try:
        d = dict(np.load(path))
        x = _t(d["x"][rank])           # positive: PROD's reference takes logs
        out = {"env": (penv.rank, penv.world_size, penv.nranks,
                       penv.local_rank)}
        for name in ("SUM", "MAX", "MIN", "PROD", "AVG"):
            out[f"all_reduce_{name}"] = C.all_reduce(
                x.clone(), op=getattr(C.ReduceOp, name)).numpy()
            out[f"reduce_{name}"] = C.reduce(
                x.clone(), dst=1, op=getattr(C.ReduceOp, name)).numpy()
        sub = C.new_group([1, 2])
        if rank in (1, 2):
            out["sub_all_reduce"] = C.all_reduce(x.clone(), group=sub).numpy()
            out["sub_rank"] = sub.rank
        got = []
        C.all_gather(got, x)
        out["all_gather"] = np.stack([g.numpy() for g in got])
        y = torch.empty_like(x)
        out["reduce_scatter"] = C.reduce_scatter(
            y, _t(d["rs"][rank])).numpy()
        out["broadcast"] = C.broadcast(x.clone(), src=2).numpy()
        lst = [_t(v) for v in d["scatter"]] if rank == 0 else None
        out["scatter"] = C.scatter(torch.empty_like(x), lst, src=0).numpy()
        out["alltoall"] = C.alltoall(_t(d["a2a"][rank])).numpy()
        outs = C.alltoall([_t(v) for v in d["a2a"][rank]], [])
        out["alltoall_list"] = np.stack([o.numpy() for o in outs])
        # point to point around the ring, both orders of posting
        nxt, prv = (rank + 1) % world, (rank - 1) % world
        buf = torch.empty_like(x)
        task = C.irecv(buf, src=prv)
        C.isend(x, dst=nxt).wait()
        task.wait()
        out["irecv_then_isend"] = buf.numpy()
        buf2 = torch.empty_like(x)
        send = C.isend(x * 2, dst=nxt)
        C.irecv(buf2, src=prv).wait()
        send.wait()
        out["isend_then_irecv"] = buf2.numpy()
        buf3 = torch.empty_like(x)
        if rank % 2 == 0:
            C.send(x, dst=nxt)
            C.recv(buf3, src=prv)
        else:
            C.recv(buf3, src=prv)
            C.send(x, dst=nxt)
        out["send_recv"] = buf3.numpy()
        C.barrier()
        C.barrier(sub)
        C.wait(x)
        C.destroy_process_group(sub)
        out["world"] = (C.get_world_size(), C.get_rank())
        return out
    finally:
        ptd.destroy_process_group()


#: the ``c_*`` functions held with their gradients: name -> call
OPS = {
    "c_allreduce_sum": lambda O, x, g: O.c_allreduce_sum(x, g),
    "c_allgather": lambda O, x, g: O.c_allgather(x, g),
    "c_reducescatter": lambda O, x, g: O.c_reducescatter(x, g),
    "c_broadcast": lambda O, x, g: O.c_broadcast(x, g, 1),
    "c_identity": lambda O, x, g: O.c_identity(x, g),
    "mp_allreduce": lambda O, x, g: O.mp_allreduce(x, g),
    "c_concat": lambda O, x, g: O.c_concat(x, g, -1),
    "c_split": lambda O, x, g: O.c_split(x, g, -1),
    "c_alltoall": lambda O, x, g: O.c_alltoall(x, g),
    "send_next": lambda O, x, g: O.send_next(x, g),
    "send_prev": lambda O, x, g: O.send_prev(x, g),
    "send_v2": lambda O, x, g: O.send_v2(x, g, dst=2, src=0),
    "recv_v2": lambda O, x, g: O.recv_v2(x, g, src=1, dst=3),
    "p2p_exchange": lambda O, x, g: O.p2p_exchange(
        x, g, [(0, 3), (3, 1), (1, 0), (2, 2)]),
    "global_scatter": lambda O, x, g: O.global_scatter(x, g),
    "global_gather": lambda O, x, g: O.global_gather(x, g),
}
#: forward only (the reference's pmax / pmin have no gradient)
OPS_FORWARD = ("c_allreduce_max", "c_allreduce_min", "c_allreduce_prod",
               "c_allreduce_avg")


def ops_rank(rank, world, init, path):
    """Each ``c_*`` function's output and gradient (the backward of ``<ct,
    y>``) on this rank; the vocab-parallel loss and embedding with the
    gradients of their logits and table shards; DataParallel's step and
    the meta-optimizers' cross-rank averages."""
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.distributed import ops as O

    _join(rank, world, init)
    try:
        d = dict(np.load(path))
        g = C.new_group(range(world))
        out = {}
        for name, fn in OPS.items():
            x = _t(d[f"x:{name}"][rank]).requires_grad_(True)
            y = fn(O, x, g)
            (y * _t(d[f"ct:{name}"][rank])).sum().backward()
            out[name] = (y.detach().numpy(), x.grad.numpy())
        for name in OPS_FORWARD:
            out[name] = getattr(O, name)(_t(d["x:fwd"][rank]), g).numpy()
        logits = _t(d["logits"][rank]).requires_grad_(True)
        loss = O.c_softmax_with_cross_entropy(logits, _t(d["labels"]), g)
        loss.sum().backward()
        out["ce"] = (loss.detach().numpy(), logits.grad.numpy())
        table = _t(d["table"][rank]).requires_grad_(True)
        emb = O.c_embedding(_t(d["ids"]), table, g)
        (emb * _t(d["emb_ct"])).sum().backward()
        out["embedding"] = (emb.detach().numpy(), table.grad.numpy())
        out["dataparallel"] = dataparallel_step(rank, world, d)
        out["meta"] = meta_averages(rank, d)
        return out
    finally:
        ptd.destroy_process_group()


def mlp(d):
    """The port's two-layer MLP with the reference's weights."""
    import paddle_tpu_torch as T

    T.set_device("cpu")
    net = T.nn.Sequential(T.nn.Linear(8, 16), T.nn.ReLU(),
                          T.nn.Linear(16, 4))
    net.set_state_dict({k[4:]: v for k, v in d.items()
                        if k.startswith("mlp:")})
    return net


def dataparallel_step(rank, world, d):
    """Two SGD steps of ``DataParallel(mlp)`` on this rank's quarter of
    the batch (the reference: one controller, the whole batch)."""
    import paddle_tpu_torch as T
    from paddle_tpu_torch.distributed import DataParallel

    net = mlp(d)
    dp = DataParallel(net, comm_buffer_size=0.0001)   # several buckets
    opt = T.optimizer.SGD(0.1, parameters=net.parameters())
    x, y = d["dp_x"], d["dp_y"]
    k = x.shape[0] // world
    losses = []
    for _ in range(2):
        out = dp(_t(x[rank * k:(rank + 1) * k]))
        loss = T.nn.functional.cross_entropy(out, _t(y[rank * k:(rank + 1)
                                                       * k]))
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    return losses, {k: v.detach().numpy() for k, v in net.state_dict().items()}


def meta_averages(rank, d):
    """LocalSGD's parameter average and DGC's averaged sparse gradient
    over the ranks, each rank starting from its own row."""
    import paddle_tpu_torch as T
    from paddle_tpu_torch.distributed.fleet import (DGCMomentumOptimizer,
                                                    LocalSGDOptimizer)

    w = torch.nn.Parameter(_t(d["meta_w"][rank]))
    local = LocalSGDOptimizer(T.optimizer.SGD(0.5, parameters=[w]),
                              k_steps=1)
    w.grad = _t(d["meta_g"][rank])
    local.step()
    v = torch.nn.Parameter(_t(d["meta_w"][0]))
    dgc = DGCMomentumOptimizer(T.optimizer.SGD(0.5, parameters=[v]),
                               sparsity=0.5)
    v.grad = _t(d["meta_g"][rank])
    dgc.step()
    return w.detach().numpy(), v.detach().numpy()


# --------------------------------------------------------------- MoE
MOE = dict(d_model=16, d_hidden=32, num_experts=8, gate="gshard",
           capacity_factor=0.5)


def moe_rank(rank, world, init, path):
    """The MoE layer with its experts split over the ranks, on this rank's
    tokens: output, the gradients of the input, the gate and this rank's
    experts, and the kept (token, k) slots."""
    import paddle_tpu_torch as T
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.incubate import MoELayer

    _join(rank, world, init)
    try:
        T.set_device("cpu")
        d = dict(np.load(path))
        moe = MoELayer(**MOE)
        missing, unexpected = moe.set_state_dict(
            {k[4:]: v for k, v in d.items() if k.startswith("moe:")})
        assert missing == [] and unexpected == []
        moe.shard(C.new_group(range(world)))
        x = _t(d["tokens"][rank]).requires_grad_(True)
        y = moe(x)
        (y * _t(d["ct"][rank])).sum().backward()
        return {"y": y.detach().numpy(), "dx": x.grad.numpy(),
                "keep": moe.last_keep.numpy(),
                "grads": {n: p.grad.numpy()
                          for n, p in moe.named_parameters()}}
    finally:
        ptd.destroy_process_group()


def hybrid_and_pipeline_rank(rank, world, init, path, names, pipe_init,
                             pipe_path):
    """:func:`hybrid_rank`, then :func:`pipeline_rank` over the rendezvous
    ``pipe_init``, in one spawned process (one spawn for the module)."""
    return (hybrid_rank(rank, world, init, path, names),
            pipeline_rank(rank, world, pipe_init, pipe_path))
