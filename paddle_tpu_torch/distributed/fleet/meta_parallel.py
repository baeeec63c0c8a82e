"""Meta-parallel layers — the port of
``paddle_tpu/distributed/fleet/meta_parallel.py``: tensor (Megatron)
parallelism and the pipeline's layer descriptions.

The reference tags each parallel weight with a ``PartitionSpec`` and lets
GSPMD split it and insert the collectives. The port splits for real:
every rank builds the full layer (the reference's draws, from the same
seed), and ``shard_model`` (which ``fleet.distributed_model`` calls) cuts
each tagged parameter to this rank's rows or columns in place and puts
the collectives of ``distributed.ops`` around the layer:

- a column-parallel Linear (``ColumnParallelLinear``; a name rule's
  ``(None, "mp")``: the output features split): ``c_identity`` on its
  input, and with ``gather_output`` ``c_concat`` on its output;
- a row-parallel Linear (``RowParallelLinear``; ``("mp", None)``: the input
  features split): ``c_split`` on an input that is not parallel yet, the
  product's ``mp_allreduce``, then the bias, once;
- a vocab-parallel embedding (``VocabParallelEmbedding``; a table's
  ``("mp", None)``): ``c_embedding``;
- a fused qkv projection (``qkv_proj``) splits by heads, each rank keeping
  its heads' q, k and v columns, so that its attention needs no
  collective;
- ``ParallelCrossEntropy`` and the GPT's LM head under labels:
  ``c_softmax_with_cross_entropy`` on vocab-split logits, which are never
  gathered.

Specs are kept in the reference's layout (``[in, out]`` Linear weights,
``p._sharding_spec``); ``p._mp_dim`` is the dimension split in the port's
tensor (``torch.nn.Linear`` holds ``[out, in]``), ``p._mp_groups`` the
number of equal column groups split alike (3 for a fused qkv).

``LayerDesc``, ``SharedLayerDesc``, ``SegmentLayers`` and ``PipelineLayer``
are the reference's: the layer builds every stage, as the reference does
(so that ``seed`` draws its weights), and ``PipelineParallel`` keeps only
this rank's stage.
"""
from __future__ import annotations

import re
import types

import torch

from ... import nn
from ...amp import amp_state, maybe_cast_inputs
from ...core.rng import get_rng_tracker as _core_tracker
from ...nn import functional as F
from ...nn.layer import Layer
from .. import ops

__all__ = ["get_rng_state_tracker", "model_parallel_random_seed",
           "VocabParallelEmbedding", "ColumnParallelLinear",
           "RowParallelLinear", "ParallelCrossEntropy", "apply_megatron_specs",
           "shard_model", "shard_state_dict", "rank_state_dict",
           "model_specs", "LayerDesc", "SharedLayerDesc",
           "SegmentLayers", "PipelineLayer"]


def get_rng_state_tracker():
    """The tracker of named random streams, with the reference's
    ``global_seed`` (2021) and ``local_seed`` (1024) streams."""
    tr = _core_tracker()
    if "global_seed" not in tr.states():
        tr.add("global_seed", 2021)
    if "local_seed" not in tr.states():
        tr.add("local_seed", 1024)
    return tr


def model_parallel_random_seed(seed=2021):
    tr = _core_tracker()
    tr._states.clear()
    tr.add("global_seed", seed)
    tr.add("local_seed", seed + 1024)


def _tag(p, spec, dim, groups=1):
    p._sharding_spec = spec
    p._mp_dim = dim
    p._mp_groups = groups


class VocabParallelEmbedding(Layer):
    """A table split over the model-parallel group by rows."""

    def __init__(self, num_embeddings, embedding_dim, weight_attr=None,
                 mp_group=None, name=None):
        super().__init__()
        self._num_embeddings = num_embeddings
        self.weight = self.create_parameter(
            (num_embeddings, embedding_dim), attr=weight_attr,
            default_initializer=nn.initializer.XavierNormal())
        _tag(self.weight, ("mp", None), 0)
        self._mp_group = None

    def forward(self, x):
        if self._mp_group is None:
            return F.embedding(x, self.weight)
        return ops.c_embedding(x, self.weight, self._mp_group)


class ColumnParallelLinear(Layer):
    """``weight [in, out]`` split on ``out``; ``gather_output`` gathers the
    output features."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, gather_output=True, fuse_matmul_bias=False,
                 mp_group=None, name=None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.gather_output = gather_output
        self.weight = self.create_parameter(
            (in_features, out_features), attr=weight_attr,
            default_initializer=nn.initializer.XavierNormal())
        _tag(self.weight, (None, "mp"), 1)
        self.bias = None
        if has_bias:
            self.bias = self.create_parameter(
                (out_features,), is_bias=True,
                default_initializer=nn.initializer.Constant(0.0))
            _tag(self.bias, ("mp",), 0)
        self._mp_group = None

    def forward(self, x):
        g = self._mp_group
        if g is None:
            return F.linear(x, self.weight, self.bias)
        out = F.linear(ops.c_identity(x, g), self.weight, self.bias)
        return ops.c_concat(out, g, -1) if self.gather_output else out


class RowParallelLinear(Layer):
    """``weight [in, out]`` split on ``in``; the partial products are summed
    over the group and the bias added once."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=False,
                 fuse_matmul_bias=False, mp_group=None, name=None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.input_is_parallel = input_is_parallel
        self.weight = self.create_parameter(
            (in_features, out_features), attr=weight_attr,
            default_initializer=nn.initializer.XavierNormal())
        _tag(self.weight, ("mp", None), 0)
        self.bias = None
        if has_bias:
            self.bias = self.create_parameter(
                (out_features,), is_bias=True,
                default_initializer=nn.initializer.Constant(0.0))
        self._mp_group = None

    def forward(self, x):
        g = self._mp_group
        if g is None:
            return F.linear(x, self.weight, self.bias)
        if not self.input_is_parallel:
            x = ops.c_split(x, g, -1)
        out = ops.mp_allreduce(F.linear(x, self.weight), g)
        return out if self.bias is None else out + self.bias


class ParallelCrossEntropy(Layer):
    """The softmax cross-entropy of logits split over the model-parallel
    group on their last dimension (per token, float32; ``ignore_index``
    labels give 0). Without a group, the plain cross-entropy."""

    def __init__(self, mp_group=None, name=None, ignore_index=-100):
        super().__init__()
        self._ignore_index = ignore_index
        self._mp_group = mp_group

    def forward(self, input, label):
        lab = label.long()
        if lab.dim() == input.dim():
            lab = lab.squeeze(-1)
        ignore = lab == self._ignore_index
        safe = torch.where(ignore, torch.zeros_like(lab), lab)
        if self._mp_group is None:
            lf = input.float()
            loss = torch.logsumexp(lf, -1) - torch.gather(
                lf, -1, safe.unsqueeze(-1)).squeeze(-1)
        else:
            loss = ops.c_softmax_with_cross_entropy(input, safe,
                                                    self._mp_group)
        return torch.where(ignore, torch.zeros_like(loss), loss)


# ------------------------------------------------------------ name rules
#: the reference's rules (``meta_parallel.py:192-221``): name pattern ->
#: spec in the reference's layout
MEGATRON_RULES = [
    (r"qkv_proj\.weight$", (None, "mp")), (r"qkv_proj\.bias$", ("mp",)),
    (r"\b[qkv]_proj\.weight$", (None, "mp")),
    (r"\b[qkv]_proj\.bias$", ("mp",)),
    (r"out_proj\.weight$", ("mp", None)),
    (r"fc1\.weight$", (None, "mp")), (r"fc1\.bias$", ("mp",)),
    (r"fc2\.weight$", ("mp", None)),
    (r"linear1\.weight$", (None, "mp")), (r"linear1\.bias$", ("mp",)),
    (r"linear2\.weight$", ("mp", None)),
    (r"(wte|word_embeddings)\.weight$", ("mp", None)),
    (r"lm_head\.weight$", (None, "mp")),
]


def _torch_linear(mod) -> bool:
    """A ``torch.nn.Linear`` (``[out, in]``), not the port's
    ``nn.Linear`` (``[in, out]``)."""
    return isinstance(mod, torch.nn.Linear)


def apply_megatron_specs(model, rules=None):
    """Tag a transformer's parameters for tensor parallelism by name (the
    default rules fit the GPT: qkv and fc1 column-split, out_proj and fc2
    row-split, the embeddings vocab-split); returns how many were
    tagged. ``rules``: ``[(pattern, spec)]`` in the reference's layout."""
    rules = rules or MEGATRON_RULES
    mods = dict(model.named_modules())
    n = 0
    for name, p in model.named_parameters():
        for pat, spec in rules:
            if not re.search(pat, name):
                continue
            spec = tuple(spec)
            dim = spec.index("mp")
            owner = mods.get(name.rsplit(".", 1)[0])
            if p.dim() == 2 and _torch_linear(owner):
                dim = 1 - dim      # [out, in]
            _tag(p, spec, dim, 3 if "qkv_proj" in name else 1)
            n += 1
            break
    return n


def _slice(t, dim, groups, rank, degree):
    """Rank ``rank``'s part of ``t`` along ``dim``: the dimension cut into
    ``groups`` equal groups, each cut into ``degree`` equal parts."""
    size = t.shape[dim]
    if size % (groups * degree):
        raise ValueError(f"dimension {dim} of size {size} does not split "
                         f"into {groups} x {degree}")
    parts = [c.chunk(degree, dim=dim)[rank] for c in t.chunk(groups, dim=dim)]
    return torch.cat(parts, dim=dim).contiguous()


def shard_state_dict(state: dict, specs: dict, rank: int, degree: int):
    """A full state dict cut to model-parallel ``rank`` of ``degree``:
    ``specs`` maps a name to its ``(dim, groups)`` (the port's layout);
    names without a spec are kept whole."""
    out = {}
    for k, v in state.items():
        t = v if isinstance(v, torch.Tensor) else torch.as_tensor(v)
        if k in specs and degree > 1:
            dim, groups = specs[k]
            t = _slice(t, dim, groups, rank, degree)
        out[k] = t
    return out


def rank_state_dict(state: dict, specs: dict, topology, rank: int,
                    zero: bool = False) -> dict:
    """A full state dict (the port's layout, e.g. the reference's through
    ``text.convert``) cut to global ``rank`` of ``topology`` (a
    ``CommunicateTopology``): its model-parallel slice of each tagged
    entry (``specs``, :func:`model_specs`); under pipeline parallelism
    only its stage's ``stages.{s}.`` entries; with ``zero``, its ZeRO
    partition as well, under ``"zero_chunk"``: its chunk of the flat,
    padded vector of those entries in order (``sharding.ZeroOptimizer``'s
    layout), as float32."""
    coord = topology.get_coord(rank)
    names = topology.get_hybrid_group_names()
    mp = topology.get_dim("model") if "model" in names else 1
    out = shard_state_dict(state, specs, coord.get("model", 0), mp)
    if "pipe" in names and topology.get_dim("pipe") > 1:
        pre = f"stages.{coord['pipe']}."
        out = {k: v for k, v in out.items() if k.startswith(pre)}
    if zero and "sharding" in names:
        n = topology.get_dim("sharding")
        flat = torch.cat([v.reshape(-1).float() for v in out.values()])
        chunk = -(-flat.numel() // n)
        flat = torch.cat([flat, flat.new_zeros(chunk * n - flat.numel())])
        r = coord["sharding"]
        out = dict(out, zero_chunk=flat[r * chunk:(r + 1) * chunk].clone())
    return out


def model_specs(model) -> dict:
    """``{name: (dim, groups)}`` of the model's tagged parameters."""
    return {n: (p._mp_dim, p._mp_groups)
            for n, p in model.named_parameters()
            if getattr(p, "_mp_dim", None) is not None}


def _column(mod, group):
    orig = mod.forward

    def forward(self, x, *a, **k):
        return orig(ops.c_identity(x, group), *a, **k)

    mod.forward = types.MethodType(forward, mod)


def _row(mod, group):
    def forward(self, x):
        w = self.weight
        if _torch_linear(self):
            if amp_state() is not None:
                x, w = maybe_cast_inputs("linear", [x, w])
            part = torch.nn.functional.linear(x, w)
        else:
            part = F.linear(x, w)
        out = ops.mp_allreduce(part, group)
        return out if self.bias is None else out + self.bias

    mod.forward = types.MethodType(forward, mod)


def _vocab(mod, group):
    def forward(self, x):
        return ops.c_embedding(x, self.weight, group)

    mod.forward = types.MethodType(forward, mod)


def shard_model(model, group) -> int:
    """Cut every tagged parameter of ``model`` to this rank's part over
    the model-parallel ``group`` (a ``collective.Group``), in place (the
    parameter objects stay, so an optimizer built on them follows), mark
    it ``_mp_split``, and put the collectives around its layer (module
    docstring). Returns the number of parameters cut."""
    rank, degree = group.rank, group.nranks
    for name, mod in model.named_modules():
        qkv = getattr(mod, "qkv_proj", None)
        hd = getattr(mod, "head_dim", None)
        if qkv is not None and hd and getattr(qkv.weight, "_mp_dim",
                                              None) is not None:
            heads = qkv.weight.shape[qkv.weight._mp_dim] // (3 * hd)
            if heads % degree:
                raise ValueError(f"{name}: {heads} heads do not split over "
                                 f"{degree} model-parallel ranks")
    n = 0
    with torch.no_grad():
        for _, p in model.named_parameters():
            if getattr(p, "_mp_dim", None) is None:
                continue
            p.data = _slice(p.data, p._mp_dim, p._mp_groups, rank, degree)
            p._mp_split = True
            n += 1
    for name, mod in model.named_modules():
        if hasattr(mod, "_mp_group") and isinstance(
                mod, (VocabParallelEmbedding, ColumnParallelLinear,
                      RowParallelLinear, ParallelCrossEntropy)):
            mod._mp_group = group
            continue
        w = getattr(mod, "weight", None)
        if not isinstance(w, torch.Tensor) or not getattr(w, "_mp_split",
                                                          False):
            continue
        spec = w._sharding_spec
        if isinstance(mod, (torch.nn.Embedding, nn.Embedding)):
            _vocab(mod, group)
        elif name.endswith("lm_head"):
            continue        # the head is the model's own (vocab-split CE)
        elif spec == (None, "mp"):
            _column(mod, group)
        elif spec == ("mp", None):
            _row(mod, group)
    model._mp_group = group
    for mod in model.modules():     # the models whose head is their own
        if getattr(type(mod), "takes_mp_group", False):
            mod._mp_group = group
    return n


# ------------------------------------------------------------ pipeline
class LayerDesc:
    def __init__(self, layer_func, *inputs, **kwargs):
        self.layer_func = layer_func
        self.inputs = inputs
        self.kwargs = kwargs

    def build_layer(self):
        return self.layer_func(*self.inputs, **self.kwargs)


class SharedLayerDesc(LayerDesc):
    """A layer shared by several stages (tied embeddings): built once a
    stage that holds it, its ``shared_weight_attr`` gradient summed over
    those stages' ranks after the backward."""

    def __init__(self, key, layer_func, forward_func=None,
                 shared_weight_attr="weight", *inputs, **kwargs):
        super().__init__(layer_func, *inputs, **kwargs)
        self.layer_name = key
        self.forward_func = forward_func
        self.shared_weight_attr = shared_weight_attr


class SegmentLayers:
    def __init__(self, layers_desc, num_parts, method="uniform"):
        self.descs = layers_desc
        self.num_parts = num_parts
        self.method = method

    def do_segment(self):
        n = len(self.descs)
        if self.method == "uniform":
            return self.uniform(n, self.num_parts)
        if self.method.startswith("layer:"):
            name = self.method.split(":", 1)[1]
            weights = [1 if re.search(name, str(getattr(d, "layer_func", d)))
                       else 0 for d in self.descs]
            return self.by_weights(weights)
        raise ValueError(self.method)

    @staticmethod
    def uniform(num_items, num_parts):
        base = num_items // num_parts
        rem = num_items % num_parts
        result = [0]
        for i in range(num_parts):
            result.append(result[-1] + base + (1 if i < rem else 0))
        return result

    def by_weights(self, weights):
        total = sum(weights)
        per = total / self.num_parts
        result = [0]
        acc = 0
        for i, w in enumerate(weights):
            acc += w
            if acc >= per * len(result) and len(result) < self.num_parts:
                result.append(i + 1)
        while len(result) < self.num_parts + 1:
            result.append(len(weights))
        result[-1] = len(weights)
        return result


class PipelineLayer(Layer):
    """The model as stages: ``stages[s]`` holds the layers of segment s
    (``stage_bounds``), each built from its description in order (a
    ``SharedLayerDesc`` once, the same layer in every stage that names
    it). ``forward`` runs every stage (one process); under
    ``PipelineParallel`` each rank keeps its own."""

    def __init__(self, layers, num_stages=None, topology=None, loss_fn=None,
                 seg_method="uniform", recompute_interval=0, **kwargs):
        super().__init__()
        self.descs = list(layers)
        self.num_stages = topology.get_dim("pipe") if topology is not None \
            else (num_stages or 1)
        self.loss_fn = loss_fn
        self._recompute_interval = recompute_interval
        bounds = SegmentLayers(self.descs, self.num_stages,
                               seg_method).do_segment()
        self.stage_bounds = bounds
        self._shared = {}  # key -> the built layer
        self.stages = nn.LayerList()
        self._stage_fwd_funcs = []
        self._stage_shared = []   # per stage: the shared keys it holds
        for s in range(self.num_stages):
            built, fwds, shared = [], [], []
            for d in self.descs[bounds[s]:bounds[s + 1]]:
                if isinstance(d, SharedLayerDesc):
                    if d.layer_name not in self._shared:
                        self._shared[d.layer_name] = d.build_layer()
                    built.append(self._shared[d.layer_name])
                    fwds.append(d.forward_func)
                    shared.append(d.layer_name)
                elif isinstance(d, LayerDesc):
                    built.append(d.build_layer())
                    fwds.append(None)
                else:
                    built.append(d)
                    fwds.append(None)
            self.stages.append(nn.LayerList(built))
            self._stage_fwd_funcs.append(fwds)
            self._stage_shared.append(shared)

    def stage_forward(self, stage_idx, x):
        for layer, fwd in zip(self.stages[stage_idx],
                              self._stage_fwd_funcs[stage_idx]):
            x = fwd(layer, x) if fwd is not None else layer(x)
        return x

    def forward(self, x):
        for s in range(self.num_stages):
            x = self.stage_forward(s, x)
        return x

    def get_stage_params(self, stage_idx):
        out = []
        for layer in self.stages[stage_idx]:
            out.extend(layer.parameters())
        return out
