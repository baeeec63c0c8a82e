"""Dist-attr completion — the port of
``paddle_tpu/distributed/auto_parallel/completion.py``
(``propagate_graph``, the counterpart of ``propagate_jaxpr``;
``complete_param_specs``; ``complete``).

The reference propagates dims-mappings (a mesh-dim name or None a tensor
dim) over the model's jaxpr to a fixpoint: user annotations seed the
parameter inputs, per-primitive rules carry them forward (operands to
outputs) and backward (outputs and known operands to unknown operands),
and a parameter that ends with a mapping gets it as its
``_sharding_spec``. The port runs the same algorithm, with the
reference's merge, broadcast, reshape and dot helpers, over an ATen
graph: ``torch.func.functional_call(model, params, inputs)`` traced by
``make_fx`` on fake CPU tensors (the parameters are placeholders, the env
is keyed by fx node). Fake CPU tensors keep the trace on the plain path,
the composites the reference's CPU trace sees (``sdpa_reference``'s
products, the LayerNorm's formula), never a kernel's custom op, whatever
device the model is on, and allocate nothing. The model is traced in
eval mode (dropout adds only an elementwise mask, which carries every
mapping through). Each reference rule has its ATen counterparts:

- ``dot_general``: ``mm``, ``bmm`` and ``addmm`` (its bias through the
  elementwise rule), forward and run in reverse;
- elementwise with broadcast: ``add`` ... ``where``, ``masked_fill``, the
  comparisons, and the composites the reference lowers to elementwise
  primitives (``gelu``, ``_softmax``);
- unary: the rest of the shape-preserving ops (``tanh``, ``sqrt``,
  ``_to_copy``, ``clone`` ...);
- ``transpose``: ``t``, ``transpose``, ``permute``; ``reshape``: ``view``,
  ``_unsafe_view``, ``reshape`` (``_reshape_map``'s conservative rule);
  ``broadcast_in_dim``: ``expand``, ``unsqueeze``;
- reductions (forward only): ``sum``, ``mean``, ``amax``, ``amin``,
  ``argmax`` ... (with ``keepdim`` the reduced dims carry None);
  ``squeeze``; ``concatenate``: ``cat``;
- ``gather``: ``embedding``, ``index_select``; ``slice``: ``slice``,
  ``select``, and the pieces of ``split`` / ``unbind``;
- the default: outputs replicated, never guessed. ``relu``, ``clamp``
  (relu6, hardtanh) and ``_log_softmax`` take it too: the reference's
  counterparts lower to a nested ``jit`` that its rule table does not
  enter. The port's silu, leaky_relu and elu are composites of
  elementwise ops and propagate, where the reference's (nested ``jit``
  too) replicate.

Specs are written in the reference's layout: a ``torch.nn.Linear``
weight is ``[out, in]``, so its spec is flipped on the way in and out,
as ``meta_parallel.apply_megatron_specs`` does. The flatten in front of
a 3-D Linear's product (``view`` to ``[b * s, k]``) drops the batch
dims' mappings that the reference's 3-D ``dot_general`` keeps; a
parameter's spec does not depend on them.

``complete`` is the reference's check against the compiler: there it
reads GSPMD's choice from the compiled executable. The port has no
compiler partitioner, so its ``inputs`` / ``outputs`` come from this
propagation with ``in_shardings`` as the seeds, and ``compiled`` holds
the fx ``GraphModule``.
"""
from __future__ import annotations

import contextlib
import operator

import numpy as np
import torch

__all__ = ["complete_param_specs", "propagate_graph", "complete",
           "reference_layout"]


# A "mapping" is a tuple of (axis-name | None), one entry per tensor dim.
def _none(ndim):
    return (None,) * ndim


def _merge_dim(a, b):
    """Merge two dim annotations; conflicting names -> None (replicate)."""
    if a == b:
        return a
    if a is None:
        return b
    if b is None:
        return a
    return None


def _merge(m1, m2):
    return tuple(_merge_dim(a, b) for a, b in zip(m1, m2))


def _align_broadcast(mapping, from_shape, to_shape):
    """Right-align an operand mapping onto the (broadcast) output shape."""
    out = [None] * len(to_shape)
    off = len(to_shape) - len(from_shape)
    for i, ax in enumerate(mapping):
        if from_shape[i] == to_shape[off + i] and from_shape[i] != 1:
            out[off + i] = ax
    return tuple(out)


def _unalign_broadcast(out_mapping, from_shape, to_shape):
    """Project an output mapping back onto a broadcast operand."""
    off = len(to_shape) - len(from_shape)
    m = []
    for i in range(len(from_shape)):
        ax = out_mapping[off + i]
        m.append(ax if from_shape[i] == to_shape[off + i] and from_shape[i] != 1
                 else None)
    return tuple(m)


def _reshape_map(mapping, old_shape, new_shape):
    """Carry a dim's annotation through reshape when the dim survives intact:
    same size and same product of preceding dims (the common flatten/unflatten
    cases). Anything else replicates — conservative, never wrong."""
    out = [None] * len(new_shape)
    for i, ax in enumerate(mapping):
        if ax is None:
            continue
        pre_old = int(np.prod(old_shape[:i])) if i else 1
        for j, s in enumerate(new_shape):
            pre_new = int(np.prod(new_shape[:j])) if j else 1
            if s == old_shape[i] and pre_new == pre_old:
                out[j] = ax
                break
    return tuple(out)


def _dot_out_mapping(lhs_m, rhs_m, dnums):
    (lc, rc), (lb, rb) = dnums
    lhs_free = [i for i in range(len(lhs_m)) if i not in lc and i not in lb]
    rhs_free = [j for j in range(len(rhs_m)) if j not in rc and j not in rb]
    out = []
    for i, j in zip(lb, rb):
        out.append(_merge_dim(lhs_m[i], rhs_m[j]))
    out += [lhs_m[i] for i in lhs_free]
    out += [rhs_m[j] for j in rhs_free]
    return tuple(out)


def _dot_operand_from(known_m, out_m, dnums, lhs_known, lhs_shape, rhs_shape):
    """Infer the unknown dot operand's mapping from the known operand and/or
    the output (the dist_matmul rule run in reverse)."""
    (lc, rc), (lb, rb) = dnums
    nb = len(lb)
    lhs_free = [i for i in range(len(lhs_shape)) if i not in lc and i not in lb]
    rhs_free = [j for j in range(len(rhs_shape)) if j not in rc and j not in rb]
    if lhs_known:  # infer rhs
        m = [None] * len(rhs_shape)
        for i, j in zip(lb, rb):
            m[j] = known_m[i]
        for i, j in zip(lc, rc):  # contracting dims must match
            m[j] = known_m[i]
        if out_m is not None:
            for k, j in enumerate(rhs_free):
                m[j] = _merge_dim(m[j], out_m[nb + len(lhs_free) + k])
        return tuple(m)
    m = [None] * len(lhs_shape)
    for i, j in zip(lb, rb):
        m[i] = known_m[j]
    for i, j in zip(lc, rc):
        m[i] = known_m[j]
    if out_m is not None:
        for k, i in enumerate(lhs_free):
            m[i] = _merge_dim(m[i], out_m[nb + k])
    return tuple(m)




class _SpecEnv:
    """fx node -> mapping, with change tracking for the fixpoint loop."""

    def __init__(self):
        self.specs: dict = {}
        self.changed = False

    def get(self, v):
        if not isinstance(v, torch.fx.Node):  # a Python scalar
            return ()
        return self.specs.get(v)

    def join(self, v, mapping):
        if not isinstance(v, torch.fx.Node) or mapping is None:
            return
        nd = len(_shape(v))
        mapping = tuple(mapping)[:nd] + (None,) * (nd - len(mapping))
        old = self.specs.get(v)
        new = mapping if old is None else _merge(old, mapping)
        if new != old:
            self.specs[v] = new
            self.changed = True


def _shape(v) -> tuple:
    val = v.meta.get("val") if isinstance(v, torch.fx.Node) else v
    return tuple(val.shape) if isinstance(val, torch.Tensor) else ()


def _aten(*names):
    ops = set()
    for n in names:
        packet = getattr(torch.ops.aten, n, None)
        if packet is not None:
            ops.add(packet)
    return ops


_DOT = _aten("mm", "bmm", "addmm")
_TRANSPOSE = _aten("t", "transpose", "permute")
_RESHAPE = _aten("view", "_unsafe_view", "reshape")
_BROADCAST = _aten("expand", "unsqueeze")
_REDUCE = _aten("sum", "mean", "amax", "amin", "prod", "argmax", "argmin",
                "max", "min", "var", "std", "logsumexp", "any", "all")
_SQUEEZE = _aten("squeeze")
_CAT = _aten("cat")
_GATHER = _aten("embedding", "index_select")
_SLICE = _aten("slice", "select", "narrow")
_PIECES = _aten("split", "split_with_sizes", "chunk", "unbind")
# the reference's elementwise primitives, the comparisons, and the ops its
# JAX counterpart lowers to elementwise primitives
_ELEMENTWISE = _aten(
    "add", "sub", "mul", "div", "maximum", "minimum", "pow", "remainder",
    "fmod", "atan2", "where", "masked_fill", "clamp_min", "clamp_max",
    "rsub", "eq", "ne", "lt", "le", "gt", "ge", "logical_and",
    "logical_or", "logical_xor", "bitwise_and", "bitwise_or", "gelu",
    "silu", "_softmax", "softmax", "leaky_relu", "elu")
# the activations whose reference lowers to a nested ``jit`` (``jax.nn``'s
# relu, relu6 / hardtanh, log_softmax), a primitive its rule table does
# not enter: their outputs take the default rule there, and here
_OPAQUE = _aten("relu", "clamp", "_log_softmax", "log_softmax")
_UNARY = _aten(
    "exp", "log", "log1p", "expm1", "tanh", "sigmoid", "erf", "erfc",
    "erfinv", "sqrt", "rsqrt", "reciprocal", "neg", "abs", "sign", "floor",
    "ceil", "round", "sin", "cos", "tan", "asin", "acos", "atan", "sinh",
    "cosh", "asinh", "acosh", "atanh", "_to_copy", "clone", "detach",
    "alias", "contiguous", "lift_fresh_copy", "isfinite", "logical_not",
    "bitwise_not", "square", "exp2", "tril", "triu", "to", "type_as",
    "native_dropout", "dropout")


def _packet(node):
    return getattr(node.target, "overloadpacket", None)


def _dims_arg(node, pos, ndim):
    """A reduction's dims (all of them when absent or None)."""
    dims = node.args[pos] if len(node.args) > pos else node.kwargs.get("dim")
    if dims is None:
        return tuple(range(ndim))
    if isinstance(dims, int):
        dims = (dims,)
    return tuple(d % ndim for d in dims) if ndim else ()


def _dot_dnums(op, lhs_shape):
    if op is torch.ops.aten.bmm:
        return ((2,), (1,)), ((0,), (0,))
    return ((1,), (0,)), ((), ())


def _propagate_node(node, env: _SpecEnv):
    if node.op != "call_function":
        return
    op = _packet(node)
    args = node.args
    out = node

    if node.target is operator.getitem:
        _propagate_piece(node, env)
        return

    if op in _OPAQUE:
        env.join(out, _none(len(_shape(out))))
        return

    if op in _DOT:
        bias = None
        if op is torch.ops.aten.addmm:
            bias, lhs, rhs = args[0], args[1], args[2]
        else:
            lhs, rhs = args[0], args[1]
        dnums = _dot_dnums(op, _shape(lhs))
        lm, rm, om = env.get(lhs), env.get(rhs), env.get(out)
        if lm is not None and rm is not None:
            env.join(out, _dot_out_mapping(lm, rm, dnums))
        if bias is not None:
            bm = env.get(bias)
            if bm is not None:
                env.join(out, _align_broadcast(bm, _shape(bias), _shape(out)))
            om = env.get(out)
            if bm is None and om is not None and _shape(bias):
                env.join(bias, _unalign_broadcast(om, _shape(bias),
                                                  _shape(out)))
            if lm is None or rm is None:  # the product's own output
                om = env.get(out)
        if lm is not None and rm is None:
            env.join(rhs, _dot_operand_from(lm, om, dnums, True,
                                            _shape(lhs), _shape(rhs)))
        if rm is not None and lm is None:
            env.join(lhs, _dot_operand_from(rm, om, dnums, False,
                                            _shape(lhs), _shape(rhs)))
        return

    if op in _ELEMENTWISE:
        osh = _shape(out)
        ins = [a for a in args if isinstance(a, torch.fx.Node)]
        known = [(v, env.get(v)) for v in ins]
        for v, m in known:
            if m is not None:
                env.join(out, _align_broadcast(m, _shape(v), osh))
        om = env.get(out)
        if om is not None:
            for v, m in known:
                if m is None and _shape(v):
                    env.join(v, _unalign_broadcast(om, _shape(v), osh))
        return

    if op in _UNARY:
        m = env.get(args[0])
        if m is not None:
            env.join(out, m)
        om = env.get(out)
        if om is not None and _shape(args[0]) == _shape(out):
            env.join(args[0], om)
        return

    if op in _TRANSPOSE:
        nd = len(_shape(args[0]))
        if op is torch.ops.aten.permute:
            perm = [d % nd for d in args[1]]
        else:
            perm = list(range(nd))
            if op is torch.ops.aten.transpose:
                a, b = args[1] % nd, args[2] % nd
            else:
                a, b = 0, nd - 1
            perm[a], perm[b] = perm[b], perm[a]
        m = env.get(args[0])
        if m is not None:
            env.join(out, tuple(m[p] for p in perm))
        om = env.get(out)
        if om is not None:
            inv = [None] * len(perm)
            for i, p in enumerate(perm):
                inv[p] = om[i]
            env.join(args[0], tuple(inv))
        return

    if op in _RESHAPE:
        src, dst = _shape(args[0]), _shape(out)
        m = env.get(args[0])
        if m is not None:
            env.join(out, _reshape_map(m, src, dst))
        om = env.get(out)
        if om is not None:
            env.join(args[0], _reshape_map(om, dst, src))
        return

    if op in _BROADCAST:
        ish, osh = _shape(args[0]), _shape(out)
        if op is torch.ops.aten.unsqueeze:
            new = args[1] % len(osh)
            bdims = [d for d in range(len(osh)) if d != new]
        else:
            bdims = list(range(len(osh) - len(ish), len(osh)))
        m = env.get(args[0])
        if m is not None:
            o = [None] * len(osh)
            for i, d in enumerate(bdims):
                if ish[i] == osh[d]:
                    o[d] = m[i]
            env.join(out, tuple(o))
        om = env.get(out)
        if om is not None:
            env.join(args[0], tuple(om[d] if ish[i] == osh[d] else None
                                    for i, d in enumerate(bdims)))
        return

    if op in _REDUCE:
        m = env.get(args[0])
        if m is None:
            return
        nd = len(_shape(args[0]))
        axes = _dims_arg(node, 1, nd)
        keep = len(_shape(_first(out))) == nd
        o = tuple(None if i in axes else ax for i, ax in enumerate(m)
                  if keep or i not in axes)
        if isinstance(out.meta.get("val"), (tuple, list)):
            env.specs[("pieces", out)] = [o] * len(out.meta["val"])
        else:
            env.join(out, o)
        return

    if op in _SQUEEZE:
        m = env.get(args[0])
        ish, osh = _shape(args[0]), _shape(out)
        if m is not None:
            if len(args) > 1:
                dims = _dims_arg(node, 1, len(ish))
                dims = tuple(d for d in dims if ish[d] == 1)
            else:
                dims = tuple(i for i, s in enumerate(ish) if s == 1)
            env.join(out, tuple(ax for i, ax in enumerate(m) if i not in dims))
        return

    if op in _CAT:
        nd = len(_shape(out))
        dim = (args[1] if len(args) > 1 else node.kwargs.get("dim", 0)) % nd
        for v in args[0]:
            m = env.get(v)
            if m is not None and len(m) == nd:
                env.join(out, tuple(None if i == dim else ax
                                    for i, ax in enumerate(m)))
        return

    if op in _GATHER or op in _SLICE:
        table = args[0]
        m = env.get(table)
        osh, ish = _shape(out), _shape(table)
        if m is None or not osh:
            return
        if op in _GATHER:
            # an embedding-style take: trailing dims copy from the table
            o = [None] * len(osh)
            k, j = len(osh) - 1, len(ish) - 1
            while k >= 0 and j >= 1 and osh[k] == ish[j]:
                o[k] = m[j]
                k -= 1
                j -= 1
            env.join(out, tuple(o))
        elif len(ish) == len(osh):
            env.join(out, tuple(ax if ish[i] == osh[i] else None
                                for i, ax in enumerate(m)))
        elif op is torch.ops.aten.select:
            dim = args[1] % len(ish)
            rest = [i for i in range(len(ish)) if i != dim]
            env.join(out, tuple(m[i] if ish[i] == osh[k] else None
                                for k, i in enumerate(rest)))
        return

    if op in _PIECES:
        m = env.get(args[0])
        if m is None:
            return
        ish = _shape(args[0])
        pieces = []
        for val in out.meta.get("val", ()):
            osh = tuple(val.shape)
            if len(osh) == len(ish):
                pieces.append(tuple(ax if ish[i] == osh[i] else None
                                    for i, ax in enumerate(m)))
            else:  # unbind: the dim goes
                dim = (args[1] if len(args) > 1 else 0) % len(ish)
                pieces.append(tuple(ax for i, ax in enumerate(m)
                                    if i != dim))
        env.specs[("pieces", out)] = pieces
        return

    # default: outputs replicated (unknown rule) — never guess
    val = out.meta.get("val")
    if isinstance(val, torch.Tensor):
        env.join(out, _none(val.dim()))


def _first(node):
    val = node.meta.get("val")
    if isinstance(val, (tuple, list)):
        return val[0]
    return val


def _propagate_piece(node, env):
    src, idx = node.args
    pieces = env.specs.get(("pieces", src))
    if pieces is not None and idx < len(pieces):
        env.join(node, pieces[idx])


def propagate_graph(graph, in_mappings, n_iters=8):
    """Run forward/backward propagation over an fx graph to a fixpoint.

    in_mappings: list aligned with the graph's placeholders (mapping or
    None = unknown). Returns the _SpecEnv holding every node's mapping.
    """
    graph = getattr(graph, "graph", graph)
    env = _SpecEnv()
    places = [n for n in graph.nodes if n.op == "placeholder"]
    for v, m in zip(places, in_mappings):
        if m is not None:
            env.join(v, m)
    nodes = [n for n in graph.nodes if n.op == "call_function"]
    for _ in range(n_iters):
        env.changed = False
        for node in nodes:
            _propagate_node(node, env)
        if not env.changed:
            break
    return env


# ------------------------------------------------------------- the trace
def _fake_like(mode, t):
    with mode:
        return torch.empty(tuple(t.shape), dtype=t.dtype, device="cpu")


def trace(fn, example_args):
    """``(GraphModule, placeholders' flat inputs)``: ``fn(*example_args)``
    traced by ``make_fx`` on fake CPU tensors of the arguments' shapes
    and dtypes (tensors anywhere in nested dicts, lists and tuples)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.fx.experimental.proxy_tensor import make_fx
    from torch.utils._pytree import tree_map

    mode = FakeTensorMode(allow_non_fake_inputs=True)

    def fake(a):
        if isinstance(a, np.ndarray):
            a = torch.from_numpy(np.ascontiguousarray(a))
        return _fake_like(mode, a) if isinstance(a, torch.Tensor) else a

    args = tree_map(fake, tuple(example_args))
    with mode, torch.no_grad():
        gm = make_fx(fn)(*args)
    return gm


def _torch_linear_weights(model) -> set:
    """Names of the parameters held ``[out, in]`` (``torch.nn.Linear``
    weights), whose specs flip between the reference's layout and the
    port's."""
    out = set()
    for mname, mod in model.named_modules():
        if isinstance(mod, torch.nn.Linear):
            out.add(f"{mname}.weight" if mname else "weight")
    return out


def reference_layout(model) -> callable:
    """``flip(name, spec)``: a spec between the port's layout and the
    reference's for parameter ``name`` of ``model`` (its own inverse)."""
    flipped = _torch_linear_weights(model)

    def flip(name, spec):
        if spec is None or name not in flipped or len(spec) != 2:
            return spec
        return tuple(spec)[::-1]

    return flip


@contextlib.contextmanager
def _eval_mode(model):
    was = model.training
    model.eval()
    try:
        yield
    finally:
        model.train(was)


def complete_param_specs(model, example_inputs, input_specs=None):
    """Complete ``_sharding_spec`` annotations across a model's parameters.

    Traces ``functional_call(model, params, inputs)`` on fake CPU copies
    of the parameters, buffers and ``example_inputs`` (arrays or tensors;
    only their shapes and dtypes matter), seeds the parameter
    placeholders from existing annotations (and the inputs from
    ``input_specs``), propagates, and writes inferred specs back onto
    previously unannotated parameters. Returns ``{param_name: spec}``
    (tuples, the reference's layout) for every parameter that ends up
    sharded.
    """
    from torch.func import functional_call

    params = dict(model.named_parameters())
    buffers = dict(model.named_buffers())
    flip = reference_layout(model)

    def fwd(pv, bv, *inputs):
        with _eval_mode(model):
            out = functional_call(model, {**pv, **bv}, tuple(inputs))
        return out[0] if isinstance(out, (tuple, list)) else out

    gm = trace(fwd, (params, buffers, *example_inputs))
    names = list(params)
    in_mappings = []
    for name in names:
        spec = getattr(params[name], "_sharding_spec", None)
        in_mappings.append(None if spec is None
                           else tuple(flip(name, tuple(spec))))
    in_mappings += [None] * len(buffers)
    for i in range(len(example_inputs)):
        spec = None
        if input_specs is not None and i < len(input_specs):
            spec = input_specs[i]
        in_mappings.append(tuple(spec) if spec is not None else None)

    env = propagate_graph(gm, in_mappings)
    places = [n for n in gm.graph.nodes if n.op == "placeholder"]

    out = {}
    for name, node in zip(names, places[:len(names)]):
        m = env.specs.get(node)
        p = params[name]
        spec = getattr(p, "_sharding_spec", None)
        if m is not None and any(ax is not None for ax in m):
            if spec is None:
                p._sharding_spec = flip(name, tuple(m))
            out[name] = tuple(p._sharding_spec)
        elif spec is not None:
            out[name] = tuple(spec)
    return out


def _spec_of(s):
    if s is None:
        return None
    return tuple(getattr(s, "dims_mapping", s))


def complete(fn, *example_args, mesh=None, in_shardings=None):
    """Trace ``fn`` and propagate ``in_shardings`` (a spec a positional
    argument: tuples of mesh-dim names, ``TensorDistAttr``s or None) to
    every value: ``inputs`` / ``outputs`` hold the mappings the
    propagation gives the arguments and the results (module docstring),
    ``input_shardings`` / ``output_shardings`` the same as
    ``TensorDistAttr``s on ``mesh`` (when given), ``compiled`` the fx
    ``GraphModule``."""
    from torch.utils._pytree import tree_leaves

    gm = trace(fn, example_args)
    places = [n for n in gm.graph.nodes if n.op == "placeholder"]
    seeds = [_spec_of(s) for s in (in_shardings or [])]
    seeds += [None] * (len(places) - len(seeds))
    if mesh is not None:
        from .reshard import normalize_spec

        for node, s in zip(places, seeds):
            if s is not None:
                normalize_spec(s, len(_shape(node)), mesh.dim_names)
    env = propagate_graph(gm, seeds)
    out_node = next(n for n in gm.graph.nodes if n.op == "output")
    outs = [a for a in tree_leaves(out_node.args)
            if isinstance(a, torch.fx.Node)]
    inputs = [env.specs.get(n) for n in places]
    outputs = [env.specs.get(n) for n in outs]

    def attrs(maps):
        if mesh is None:
            return list(maps)
        from .interface import TensorDistAttr

        return [None if m is None else TensorDistAttr(mesh, m)
                for m in maps]

    return {"inputs": inputs, "outputs": outputs,
            "input_shardings": attrs(inputs),
            "output_shardings": attrs(outputs), "compiled": gm}
