"""Mixture of Experts — the port of
``paddle_tpu/incubate/distributed/models/moe.py`` (``MoELayer``,
``GShardGate``, ``SwitchGate``, ``NaiveGate``).

The routing is the reference's dense, static-shape GShard computation on
this rank's tokens: top-k of the gate's softmax, each (token, k) placed
at its position among the tokens routed to its expert (token-major), kept
while the position is under the capacity ``max(1, int(capacity_factor *
tokens * top_k / num_experts))``, the kept gates renormalised; a
``[experts, capacity, d]`` dispatch buffer, each expert a GELU (tanh) FFN
``gelu(x @ w1 + b1) @ w2 + b2``, and the combine.

With ``moe_group`` (or after ``shard(group)``) the experts are split over
the group's ranks, rank r holding experts ``[r * E / n, (r + 1) * E /
n)``: the dispatch buffer goes to the experts' ranks by ``global_scatter``
(an all-to-all), each rank runs its experts over every rank's slots, and
``global_gather`` (the all-to-all back) returns the outputs, so each
rank's output is the dense layer's on its own tokens. The gradients
follow the all-to-alls back: an expert's weights gather every rank's
tokens.
"""
from __future__ import annotations

import torch

from .... import nn
from ....distributed import ops

__all__ = ["MoELayer", "GShardGate", "SwitchGate", "NaiveGate"]


class GShardGate(nn.Layer):
    def __init__(self, d_model, num_experts, topk=2):
        super().__init__()
        self.gate = nn.Linear(d_model, num_experts, bias_attr=False)
        self.topk = topk
        self.num_experts = num_experts

    def forward(self, x):
        return self.gate(x)


class SwitchGate(GShardGate):
    def __init__(self, d_model, num_experts):
        super().__init__(d_model, num_experts, topk=1)


class NaiveGate(GShardGate):
    pass


def route(tokens, gate_w, num_experts: int, top_k: int,
          capacity_factor: float):
    """The reference's routing of ``tokens [n, d]``: ``(dispatch [E, cap,
    n], combine [n, E, cap], keep [n, k], capacity)``."""
    n = tokens.shape[0]
    cap = max(1, int(capacity_factor * n * top_k / num_experts))
    probs = torch.softmax(tokens @ gate_w, dim=-1)
    gate_vals, gate_idx = torch.topk(probs, top_k, dim=-1)
    onehot = (gate_idx.unsqueeze(-1) == torch.arange(
        num_experts, device=tokens.device)).long()  # [n, k, E]
    flat = onehot.reshape(n * top_k, num_experts)
    pos = torch.cumsum(flat, dim=0) - 1
    pos = (pos * flat).sum(-1).reshape(n, top_k)
    keep = pos < cap
    gv = gate_vals * keep
    gv = gv / torch.clamp(gv.sum(-1, keepdim=True), min=1e-9)
    pos_c = pos.clamp(0, cap - 1)
    n_idx = torch.arange(n, device=tokens.device)
    disp = torch.zeros(num_experts, cap, n, dtype=tokens.dtype,
                       device=tokens.device)
    comb = torch.zeros(n, num_experts, cap, dtype=tokens.dtype,
                       device=tokens.device)
    for k in range(top_k):
        disp = disp.index_put((gate_idx[:, k], pos_c[:, k], n_idx),
                              keep[:, k].to(tokens.dtype), accumulate=True)
        comb = comb.index_put((n_idx, gate_idx[:, k], pos_c[:, k]),
                              gv[:, k].to(tokens.dtype), accumulate=True)
    return disp, comb, keep, cap


class MoELayer(nn.Layer):
    """Static-shape MoE; ``gate``: "gshard" (top-2), "switch" (top-1) or
    "naive" (top-2)."""

    def __init__(self, d_model, d_hidden, num_experts, gate="gshard",
                 capacity_factor=1.25, top_k=None, moe_group=None,
                 mp_group=None, recompute_interval=0, **kwargs):
        super().__init__()
        if isinstance(gate, str):
            top_k = top_k or (1 if gate == "switch" else 2)
        self.top_k = top_k or 2
        self.num_experts = num_experts
        self.capacity_factor = capacity_factor
        self.gate = nn.Linear(d_model, num_experts, bias_attr=False)
        init = nn.initializer.XavierNormal()
        self.w1 = self.create_parameter((num_experts, d_model, d_hidden),
                                        default_initializer=init)
        self.b1 = self.create_parameter((num_experts, 1, d_hidden),
                                        is_bias=True)
        self.w2 = self.create_parameter((num_experts, d_hidden, d_model),
                                        default_initializer=init)
        self.b2 = self.create_parameter((num_experts, 1, d_model),
                                        is_bias=True)
        for p in (self.w1, self.b1, self.w2, self.b2):
            p._sharding_spec = ("mp",)
            p._mp_dim, p._mp_groups = 0, 1
        self._group = None
        #: the last forward's kept (token, k) slots, ``[tokens, k]`` bool
        self.last_keep = None
        if moe_group is not None:
            self.shard(moe_group)

    def shard(self, group):
        """Keep this rank's experts of ``group`` (a ``collective.Group``)."""
        n, r = group.nranks, group.rank
        if self.num_experts % n:
            raise ValueError(f"{self.num_experts} experts do not split "
                             f"over {n} ranks")
        k = self.num_experts // n
        with torch.no_grad():
            for p in (self.w1, self.b1, self.w2, self.b2):
                p.data = p.data[r * k:(r + 1) * k].contiguous()
                p._mp_split = True
        self._group = group
        return self

    def _experts(self, x):
        """The local experts over ``x [E_local, slots, d]``."""
        h = torch.nn.functional.gelu(torch.matmul(x, self.w1) + self.b1,
                                     approximate="tanh")
        return torch.matmul(h, self.w2) + self.b2

    def forward(self, x):
        shape = x.shape
        tokens = x.reshape(-1, shape[-1])
        disp, comb, keep, cap = route(tokens, self.gate.weight,
                                      self.num_experts, self.top_k,
                                      self.capacity_factor)
        self.last_keep = keep
        expert_in = torch.einsum("ecn,nd->ecd", disp, tokens)
        if self._group is None:
            expert_out = self._experts(expert_in)
        else:
            n = self._group.nranks
            e_l, d = self.num_experts // n, tokens.shape[-1]
            sent = ops.global_scatter(expert_in.reshape(n, e_l, cap, d),
                                      self._group)
            local = sent.permute(1, 0, 2, 3).reshape(e_l, n * cap, d)
            out = self._experts(local).reshape(e_l, n, cap, d)
            back = ops.global_gather(out.permute(1, 0, 2, 3).contiguous(),
                                     self._group)
            expert_out = back.reshape(self.num_experts, cap, d)
        out = torch.einsum("nec,ecd->nd", comb, expert_out)
        return out.reshape(shape)
