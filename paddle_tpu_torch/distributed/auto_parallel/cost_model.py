"""The cost model — the port of
``paddle_tpu/distributed/auto_parallel/cost_model.py``: alpha-beta
collective times (``CommCostModel``), a roofline op time
(``CompCostModel``) and the per-step volumes of a partition of a
transformer (``ModelDesc``, ``partition_comm_volumes``,
``estimate_partition``).

Every default is the reference's, so the same inputs give the same
plans. Those defaults describe a TPU v5p chip (its bf16 peak, HBM and
ICI link), not the card: ``cluster.Cluster("h100", ...)`` gives the
H100's data-sheet constants.

``CompCostModel.analyze`` reads the reference's numbers from XLA's cost
analysis of a compiled ``fn``. The port runs ``fn`` once under a
``TorchDispatchMode`` instead: FLOPs as ``torch.utils.flop_counter``
counts them, bytes as the sum over the ATen ops it ran of their input
and output tensors' bytes (no fusion is assumed, so the bytes are an
upper bound of what a compiler's fused program would move).
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass
class ClusterSpec:
    """One slice of chips. The defaults are the reference's: a TPU v5p
    chip's, not the card's."""

    chips: int = 8
    peak_flops: float = 459e12  # bf16 FLOPs/s per chip
    hbm_bytes: float = 95e9
    hbm_bandwidth: float = 2.7e12  # bytes/s
    ici_bandwidth: float = 90e9  # bytes/s per link direction
    dcn_bandwidth: float = 6.25e9  # bytes/s per host
    ici_latency: float = 1e-6
    dcn_latency: float = 10e-6


class CommCostModel:
    """Ring-based collective timing: t = alpha * steps + moved_bytes / bw."""

    def __init__(self, cluster: ClusterSpec | None = None, over_dcn: bool = False):
        self.cluster = cluster or ClusterSpec()
        self.bw = self.cluster.dcn_bandwidth if over_dcn else self.cluster.ici_bandwidth
        self.alpha = self.cluster.dcn_latency if over_dcn else self.cluster.ici_latency

    def all_reduce(self, nbytes: float, n: int) -> float:
        if n <= 1:
            return 0.0
        return 2 * (n - 1) * self.alpha + 2 * (n - 1) / n * nbytes / self.bw

    def all_gather(self, nbytes: float, n: int) -> float:
        # nbytes = full (gathered) size
        if n <= 1:
            return 0.0
        return (n - 1) * self.alpha + (n - 1) / n * nbytes / self.bw

    reduce_scatter = all_gather

    def all_to_all(self, nbytes: float, n: int) -> float:
        if n <= 1:
            return 0.0
        return (n - 1) * self.alpha + (n - 1) / n * nbytes / self.bw / n

    def p2p(self, nbytes: float) -> float:
        return self.alpha + nbytes / self.bw


class CompCostModel:
    def __init__(self, cluster: ClusterSpec | None = None, mfu: float = 0.4):
        self.cluster = cluster or ClusterSpec()
        self.mfu = mfu

    def matmul_time(self, flops: float) -> float:
        return flops / (self.cluster.peak_flops * self.mfu)

    def hbm_time(self, nbytes: float) -> float:
        return nbytes / self.cluster.hbm_bandwidth

    def op_time(self, flops: float, nbytes: float) -> float:
        """Roofline: an op takes the larger of its compute time and its
        memory time."""
        return max(self.matmul_time(flops), self.hbm_time(nbytes))

    def analyze(self, fn, *example_args) -> dict:
        """``{flops, bytes_accessed, time}`` of one run of ``fn`` on
        ``example_args`` (arrays become tensors), counted op by op
        (module docstring); ``time`` is :meth:`op_time` of the two."""
        import numpy as np
        import torch
        from torch.utils.flop_counter import FlopCounterMode

        args = [a if isinstance(a, torch.Tensor) or not isinstance(
            a, np.ndarray) else torch.as_tensor(a) for a in example_args]
        moved = _byte_counter()
        with FlopCounterMode(display=False) as flops, moved, \
                torch.no_grad():
            fn(*args)
        total = float(flops.get_total_flops())
        return {"flops": total, "bytes_accessed": float(moved.bytes),
                "time": self.op_time(total, float(moved.bytes))}


def _byte_counter():
    """A dispatch mode summing each ATen op's input and output bytes."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    class ByteCounter(TorchDispatchMode):
        bytes = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in tree_leaves((args, kwargs, out)):
                if isinstance(t, torch.Tensor):
                    self.bytes += t.numel() * t.element_size()
            return out

    return ByteCounter()


# ------------------------------------------------- partition-level modeling
@dataclass
class ModelDesc:
    """The transformer-shaped facts the partition cost model needs.

    Reference analog: auto_parallel/cost_model.py builds per-op cost from
    the serialized program; here the per-step volumes of a transformer
    train step are closed-form in these seven numbers (survey §7 /
    scaling-book recipe), which also covers MLP stacks (heads/seq free)."""

    n_params: int
    layers: int
    hidden: int
    heads: int
    seq: int
    batch: int
    dtype_bytes: int = 4
    opt_slots: int = 2  # adam m+v

    @property
    def tokens(self) -> float:
        return float(self.batch) * self.seq

    @property
    def param_bytes(self) -> float:
        return float(self.n_params) * self.dtype_bytes

    @property
    def step_flops(self) -> float:
        # 6N per token (fwd+bwd matmuls) + causal-attention score/AV term
        return (6.0 * self.n_params * self.tokens
                + 12.0 * self.layers * self.hidden * self.tokens * self.seq)

    @property
    def act_layer_bytes(self) -> float:
        """One [batch, seq, hidden] activation."""
        return self.tokens * self.hidden * self.dtype_bytes


def partition_comm_volumes(model: ModelDesc, dp: int, sp: int, sh: int,
                           mp: int) -> dict:
    """Per-step bytes each axis's collectives move, per chip, for one
    candidate partition.

    Conventions (the reference's hybrid step; the port's HybridParallelModel
    moves the same tensors):
    - dp/sp replicate params: ONE grad all-reduce (or reduce-scatter under
      ZeRO) of the per-chip grad shard param_bytes/(mp*sh) over dp*sp.
    - sharding (ZeRO>=1): all-gather params + reduce-scatter grads of
      param_bytes/mp over sh each step.
    - mp (megatron tp): 2 fwd + 2 bwd all-reduces per layer of the local
      [b/dp/sp, s, h] activation.
    - sp (Ulysses): 4 all-to-alls per layer each direction (q,k,v fwd +
      attn-out, mirrored in bwd) of the local activation — a2a moves
      (n-1)/n^2 of the tensor per link, captured in CommCostModel.
    """
    grad_shard = model.param_bytes / (mp * sh)
    # batch splits over BOTH dp and sharding (HybridParallelModel), so
    # local activations shrink with sh as well
    act_local = model.act_layer_bytes / (dp * sp * sh)
    return {
        "dp": {"collective": "all_reduce", "group": dp * sp,
               "bytes": grad_shard if dp * sp > 1 else 0.0, "count": 1},
        "sharding": {"collective": "all_gather+reduce_scatter", "group": sh,
                     "bytes": 2.0 * model.param_bytes / mp if sh > 1 else 0.0,
                     "count": 1},
        "mp": {"collective": "all_reduce", "group": mp,
               "bytes": act_local if mp > 1 else 0.0,
               "count": 4 * model.layers},
        "sp": {"collective": "all_to_all", "group": sp,
               "bytes": act_local if sp > 1 else 0.0,
               "count": 8 * model.layers},
    }


def estimate_partition(model: ModelDesc, dp: int, sp: int, sh: int, mp: int,
                       cluster: ClusterSpec | None = None,
                       placement: dict | None = None) -> dict:
    """Score one (dp, sp, sharding, mp) candidate: roofline compute over the
    per-chip FLOP share + alpha-beta time of every collective the layout
    implies + per-chip memory. placement (axis->'ici'/'dcn', from the
    mapper) routes each axis's collective over the right link class."""
    cluster = cluster or ClusterSpec()
    comp = CompCostModel(cluster)
    vols = partition_comm_volumes(model, dp, sp, sh, mp)

    t_comp = comp.matmul_time(model.step_flops / (dp * sp * sh * mp))
    t_comm = {}
    for axis, v in vols.items():
        if not v["bytes"]:
            t_comm[axis] = 0.0
            continue
        comm = CommCostModel(
            cluster, over_dcn=(placement or {}).get(axis) == "dcn")
        fn = {"all_reduce": comm.all_reduce, "all_to_all": comm.all_to_all,
              "all_gather+reduce_scatter":
                  lambda b, n: comm.all_gather(b / 2, n)
                  + comm.reduce_scatter(b / 2, n)}[v["collective"]]
        t_comm[axis] = v["count"] * fn(v["bytes"], v["group"])

    # memory: params+grads replicated over mp (and sh for ZeRO-3-ish slot
    # sharding), opt slots over mp*sh; activations over every batch/seq axis
    # (x8: the ~per-layer stash of h, qkv, attn, mlp intermediates)
    per_chip = (model.param_bytes * 2 / (mp * sh)
                + model.param_bytes * model.opt_slots / (mp * sh)
                + 8.0 * model.layers * model.act_layer_bytes
                / (dp * sp * sh * mp))
    return {"dp": dp, "sp": sp, "sharding": sh, "mp": mp,
            "time": t_comp + sum(t_comm.values()),
            "t_comp": t_comp, "t_comm": t_comm,
            "comm_volumes": vols, "per_chip_bytes": per_chip}
