"""AST linter of the port — the port of ``paddle_tpu/analysis/lint.py``:
rules distilled from bugs the reference shipped, as they read in PyTorch.

Ported as they are (framework-agnostic):

- PT001 — a ``@dataclass`` with an ndarray/Array/Tensor field and no
  ``eq=False``: the generated ``__eq__`` compares arrays elementwise
  (numpy 2 raises on a shape mismatch; ``deque.remove`` corrupted a
  waiting queue this way).
- PT003 / PT008 — a monitor counter (``stat_add``) or gauge
  (``stat_set``/``stat_max``) written without pre-seeding in the module's
  ``_SEEDED`` registry: dashboards key on presence.
- PT004 — ``time.time()`` in ``serving/``: the engine clock is pluggable.
- PT007 — a mutable default argument.
- PT012 — a labeled stat family written without a ``_FAMILIES``
  declaration, or with label keys disagreeing with it.
- PT013 — a direct ``.add_request`` in ``serving/fleet*``: admission goes
  through the router.
- PT014 — raw ``pickle``/``socket``/``struct`` in ``serving/`` outside
  ``wire.py``: replica-boundary bytes go through the versioned codec.
- PT016 — the determinism fence: ``time.monotonic``, the global or an
  unseeded RNG, ``id()``-keyed ordering in ``serving/`` outside
  ``engine.py`` and ``channel.py``.
- PT017 — a wire ``.exchange(...)`` without ``rid=``/``step=``.

Their torch counterparts, same codes:

- PT005 — ``.item()``/``.cpu()``/``.tolist()``/``.numpy()`` inside a
  ``step``/decode/verify hot path in ``serving/``: every one waits for
  the card. The step's one sanctioned read carries the pragma.
- PT006 — a ``CompileGuard`` over a function with pool arguments and no
  ``donate_argnums``: the guard then never checks the pools are written
  in place (a read-only mover says so with the pragma).
- PT009 — a serving step outside the ``CompileGuard`` registry: a
  ``torch.compile``/``torch.jit``/CUDA-graph capture in ``serving/``, or
  a ``_*_impl`` step program that no ``CompileGuard`` in its module
  wraps — invisible to the budgets, the retrace explainer and the
  audits.
- PT010 — a tensor-parallel forward (``tp_axis(axis)`` with an axis) in
  ``serving/`` in a module that registers no ``CollectiveBudget``
  (``step_budget``): its all-reduces would go uncounted.
- PT011 — ``_build.load`` (a kernel library) in a module with no
  ``KERNELCHECK_CERTS`` naming its ``analysis.kernelcheck`` entries.
- PT015 — a raw ``torch.distributed.all_reduce`` in ``serving/`` outside
  ``tp.py``: collectives go through ``distributed.collective`` (counted
  and censused) from the tensor-parallel layer.

No counterpart: PT002 (a per-layer host ``.at[].set`` loop over a stacked
pool). A functional ``.at[].set`` copies the whole pool, so a per-layer
loop of them was O(pool) a layer; a PyTorch write is in place and costs
what it writes, and the port's page movers are single index operations
over the layer-stacked pool (``serving/kv_cache.py``), so the bug the
rule encodes cannot be written here.

Suppression: a ``# lint: disable=PT005`` (comma-separated for several)
pragma on the finding's line, or an :data:`ALLOWLIST` entry mapping a
path substring to exempt codes. CLI: ``python -m
paddle_tpu_torch.analysis lint [paths] [--rule PTxxx]``; with no paths it
sweeps ``paddle_tpu_torch/``. Exit code 0 = clean, 1 = findings, 2 = bad
usage.
"""
from __future__ import annotations

import ast
import re
from dataclasses import dataclass
from pathlib import Path

__all__ = ["Finding", "RULES", "ALLOWLIST", "lint_source", "lint_paths",
           "main"]

# path substring -> rule codes exempt in matching files. Empty: every
# sanctioned exception is a pragma, visible at the offending line.
ALLOWLIST: dict[str, set[str]] = {}

_PRAGMA = re.compile(r"#\s*lint:\s*disable=([A-Z0-9_,\s]+)")
_ARRAY_ANN = re.compile(r"\bndarray\b|\bArray\b|\bTensor\b")


@dataclass(frozen=True)
class Finding:
    rule: str
    path: str
    line: int
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: {self.rule} {self.message}"


def _unparse(node) -> str:
    try:
        return ast.unparse(node)
    except Exception:  # noqa: BLE001 — diagnostics only
        return "<?>"


# ------------------------------------------------------------------- rules
def _pt001(tree, path):
    """dataclass with ndarray/Array field missing eq=False."""
    for node in ast.walk(tree):
        if not isinstance(node, ast.ClassDef):
            continue
        deco = next((d for d in node.decorator_list
                     if "dataclass" in _unparse(d)), None)
        if deco is None:
            continue
        if isinstance(deco, ast.Call) and any(
                k.arg == "eq" and isinstance(k.value, ast.Constant)
                and k.value.value is False for k in deco.keywords):
            continue
        arr = [f"{b.target.id}: {_unparse(b.annotation)}"
               for b in node.body
               if isinstance(b, ast.AnnAssign) and b.annotation is not None
               and isinstance(b.target, ast.Name)
               and _ARRAY_ANN.search(_unparse(b.annotation))]
        if arr:
            # anchored at the decorator: that line carries the fix (and
            # any pragma)
            yield (deco.lineno,
                   f"dataclass {node.name!r} has array field(s) "
                   f"({', '.join(arr)}) but no eq=False — the generated "
                   f"__eq__ compares arrays elementwise (numpy 2 raises on "
                   f"shape mismatch; deque.remove corrupted the PR 2 "
                   f"queue). Use @dataclass(eq=False).")


def _seeding_contract(tree):
    """The module's (seeded names, stat prefix) — the registry PT003 and
    PT008 check against. ``seeded`` is None when the module declares no
    ``_SEEDED`` tuple (no contract to enforce)."""
    seeded, prefix = None, ""
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            tgt = node.targets[0].id
            if tgt == "_SEEDED" and isinstance(node.value, (ast.Tuple,
                                                            ast.List)):
                seeded = {e.value for e in node.value.elts
                          if isinstance(e, ast.Constant)}
            elif tgt == "PREFIX" and isinstance(node.value, ast.Constant):
                prefix = node.value.value
    return seeded, prefix


#: stands in for each formatted field in a resolved name SKELETON — a
#: character no real stat name contains
_FMT_PLACEHOLDER = "\x00"


def _stat_name_text(node, fn_suffixes, prefix):
    """The statically visible text of a ``stat_xxx`` call's name
    argument — the ONE resolver behind PT003/PT008 (whole names) and
    PT012 (labeled-family heads AND label keys), so a newly supported
    naming idiom lands in exactly one place and the rules can never
    disagree about which call sites they see. Resolves ``PREFIX +
    "..."`` / ``PREFIX + f"..."`` concatenations and bare (f-)strings
    carrying the prefix inline. Returns ``(text, whole, skeleton)``:
    ``text`` is the leading constant, ``whole`` says it is the ENTIRE
    name (a plain constant), and ``skeleton`` is the full name with
    every formatted field replaced by a placeholder — the surface the
    multi-label family check (``base{a=,b=}``) reads its label keys
    off. None when the call isn't one of ``fn_suffixes`` or nothing is
    statically visible (runtime-computed names can't be checked
    statically)."""
    if not (isinstance(node, ast.Call) and node.args
            and _unparse(node.func).endswith(fn_suffixes)):
        return None
    arg = node.args[0]
    strip = True  # bare names carry the prefix inline; PREFIX + x doesn't
    if isinstance(arg, ast.BinOp) and isinstance(arg.op, ast.Add) \
            and _unparse(arg.left) == "PREFIX":
        arg, strip = arg.right, False
    if isinstance(arg, ast.Constant):
        text, whole, skeleton = arg.value, True, arg.value
    elif isinstance(arg, ast.JoinedStr) and arg.values \
            and isinstance(arg.values[0], ast.Constant):
        text, whole = arg.values[0].value, False
        skeleton = "".join(
            str(v.value) if isinstance(v, ast.Constant)
            else _FMT_PLACEHOLDER for v in arg.values)
    else:
        return None
    if not isinstance(text, str) or not isinstance(skeleton, str):
        return None
    if strip:
        if not (prefix and text.startswith(prefix)):
            return None
        text = text[len(prefix):]
        skeleton = skeleton[len(prefix):]
    return text, whole, skeleton


def _stat_call_name(node, fn_suffixes, prefix):
    """The statically visible WHOLE stat name of a ``stat_xxx`` call;
    None when the name has a formatted tail, or is a labeled-family
    member (contains ``{`` — PT012's domain, where the check is against
    ``_FAMILIES``, not ``_SEEDED``)."""
    resolved = _stat_name_text(node, fn_suffixes, prefix)
    if resolved is None:
        return None
    text, whole, _ = resolved
    if not whole or "{" in text:
        return None  # formatted tail / labeled family: PT012's domain
    return text


_STAT_FNS = ("stat_add", "stat_set", "stat_max")

# a COMPLETE static family shape: base{k=...,k2=...} with only the label
# VALUES possibly formatted — the precondition for reading label keys
_FULL_FAMILY = re.compile(
    r"^[A-Za-z0-9_]+\{[A-Za-z_][A-Za-z0-9_]*=[^{}]*\}$")
_LABEL_KEYS = re.compile(r"[{,]([A-Za-z_][A-Za-z0-9_]*)=")


def _labeled_stat_family(node, prefix):
    """``(base, keys)`` of a labeled stat name at a ``stat_xxx`` call
    site — ``base`` is the head before the first ``{`` of the leading
    constant text (the ``base{label=value}`` / multi-label
    ``base{a=,b=}`` family shapes, e.g. ``PREFIX +
    f"base{{a={x},b={y}}}"``), and ``keys`` the ORDERED tuple of label
    keys when the whole label structure is statically visible (only the
    VALUES formatted), else None. None for anything else — a name whose
    brace only appears after a formatted field (e.g. the family
    percentile mirrors ``f"base_{suffix}{{label=...}}"``) has no
    checkable base, the same documented blindness PT003 has to fully
    dynamic names."""
    resolved = _stat_name_text(node, _STAT_FNS, prefix)
    if resolved is None:
        return None
    text, _, skeleton = resolved
    if "{" not in text:
        return None
    base = text.split("{", 1)[0]
    keys = None
    if _FULL_FAMILY.match(skeleton):
        keys = tuple(_LABEL_KEYS.findall(skeleton))
    return base, keys


def _pt003(tree, path):
    """Counter incremented without pre-seeding in the monitor registry."""
    seeded, prefix = _seeding_contract(tree)
    if seeded is None:  # no seeding registry in this module: no contract
        return
    for node in ast.walk(tree):
        name = _stat_call_name(node, ("stat_add",), prefix)
        if name is not None and name not in seeded:
            yield (node.lineno,
                   f"counter {name!r} is incremented but never pre-seeded "
                   f"in _SEEDED — a snapshot taken before its first "
                   f"increment omits it, and dashboards key on presence. "
                   f"Add it to _SEEDED so reset() seeds the zero.")


def _pt004(tree, path):
    """time.time() in serving/ instead of the pluggable engine clock."""
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "time"
                and isinstance(node.func.value, ast.Name)
                and node.func.value.id in ("time", "_time")):
            yield (node.lineno,
                   "time.time() in serving/ bypasses the pluggable engine "
                   "clock (ServingConfig clock= + slow_step fault skew) — "
                   "deadlines and budgets become untestable without "
                   "sleeping. Use engine.now() / the injected clock.")


_HOT_NAMES = ("step", "_step")
_HOT_PARTS = ("decode", "verify")
_READS = ("item", "cpu", "tolist", "numpy")


def _pt005(tree, path):
    """A host read of a tensor inside a step/decode/verify hot path."""
    for fn in ast.walk(tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if not (fn.name in _HOT_NAMES
                or any(p in fn.name for p in _HOT_PARTS)):
            continue
        for node in ast.walk(fn):
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr in _READS and not node.args:
                yield (node.lineno,
                       f".{node.func.attr}() inside hot path {fn.name!r} "
                       f"waits for the card every step. If this is the "
                       f"step's sanctioned read, annotate it with "
                       f"`# lint: disable=PT005`; otherwise keep the value "
                       f"on the device. NOTE: int()/float()/bool() of a "
                       f"tensor read it too but are invisible statically — "
                       f"analysis.SyncTally certifies the loop at run "
                       f"time.")

def _pt006(tree, path):
    """A CompileGuard over pool arguments without donate_argnums."""
    defs = {n.name: n for n in ast.walk(tree)
            if isinstance(n, ast.FunctionDef)}
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call) or not node.args:
            continue
        fname = _unparse(node.func)
        if not fname.endswith("CompileGuard"):
            continue
        if any(k.arg == "donate_argnums" for k in node.keywords):
            continue
        target = node.args[0]
        if isinstance(target, ast.Name):
            fn = defs.get(target.id)
        elif isinstance(target, ast.Attribute):
            fn = defs.get(target.attr)
        else:
            fn = None
        if fn is None:
            continue
        pool_args = [a.arg for a in fn.args.args if "pool" in a.arg.lower()]
        if pool_args:
            yield (node.lineno,
                   f"{fname}({fn.name}) takes pool argument(s) {pool_args} "
                   f"but declares no donate_argnums — the guard never "
                   f"checks that the step writes them in place (a copy "
                   f"holds two pools live). Donate the pools, or "
                   f"pragma-suppress if the function only READS them.")

def _pt007(tree, path):
    """Mutable default argument."""
    for fn in ast.walk(tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.Lambda)):
            continue
        name = getattr(fn, "name", "<lambda>")
        for d in list(fn.args.defaults) + [x for x in fn.args.kw_defaults
                                           if x is not None]:
            mutable = isinstance(d, (ast.List, ast.Dict, ast.Set,
                                     ast.ListComp, ast.DictComp,
                                     ast.SetComp)) or (
                isinstance(d, ast.Call) and isinstance(d.func, ast.Name)
                and d.func.id in ("list", "dict", "set"))
            if mutable:
                yield (d.lineno,
                       f"mutable default {_unparse(d)!r} in {name}() is "
                       f"created ONCE and shared across every call — use "
                       f"None and construct inside, or a dataclass "
                       f"default_factory.")


def _pt008(tree, path):
    """Gauge written (stat_set/stat_max) without pre-seeding — the
    unseeded-gauge mirror of PT003."""
    seeded, prefix = _seeding_contract(tree)
    if seeded is None:
        return
    for node in ast.walk(tree):
        name = _stat_call_name(node, ("stat_set", "stat_max"), prefix)
        if name is not None and name not in seeded:
            yield (node.lineno,
                   f"gauge {name!r} is written but never pre-seeded in "
                   f"_SEEDED — it first appears in the registry when the "
                   f"condition it reports starts happening, so a "
                   f"dashboard keyed on presence is blind exactly until "
                   f"then. Add it to _SEEDED so reset() seeds the zero.")


_CAPTURE_ATTRS = ("compile", "CUDAGraph", "graph", "make_graphed_callables",
                  "script", "trace")


def _pt009(tree, path):
    """A serving step outside the CompileGuard registry: a compiled or
    captured callable (``torch.compile``, ``torch.jit.script/trace``,
    ``torch.cuda.CUDAGraph``/``graph``/``make_graphed_callables``), or a
    ``_*_impl`` step program that no ``CompileGuard(...)`` in the module
    wraps."""
    msg = ("a serving step outside the CompileGuard registry — compile "
           "budgets, the retrace explainer and the step audits (collective "
           "census, in-place pools, host reads) cannot see it. Wrap the "
           "step in analysis.CompileGuard (or pragma-suppress a "
           "sanctioned exception).")
    guarded = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and node.args \
                and _unparse(node.func).endswith("CompileGuard"):
            t = node.args[0]
            guarded.add(t.attr if isinstance(t, ast.Attribute)
                        else getattr(t, "id", None))
    for node in ast.walk(tree):
        if isinstance(node, ast.Attribute) and node.attr in _CAPTURE_ATTRS:
            base = _unparse(node.value)
            if base in ("torch", "torch.jit", "torch.cuda"):
                yield node.lineno, f"{base}.{node.attr}: " + msg
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and node.name.startswith("_") \
                and node.name.endswith("_impl") \
                and node.name not in guarded:
            yield (node.lineno,
                   f"step program {node.name!r} is wrapped by no "
                   f"CompileGuard in this module: " + msg)

def _pt010(tree, path):
    """A tensor-parallel forward in serving/ with no registered
    CollectiveBudget: ``tp_axis(axis)`` with an axis (not None) in a
    module that never calls ``step_budget`` (``serving/tp.py``'s declared
    budget, the one the debug checks' census is held to)."""
    budgets = any(isinstance(n, ast.Attribute) and n.attr == "step_budget"
                  for n in ast.walk(tree))
    if budgets:
        return
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and _unparse(node.func).endswith(
                "tp_axis") and node.args and not (
                isinstance(node.args[0], ast.Constant)
                and node.args[0].value is None):
            yield (node.lineno,
                   "a tensor-parallel forward (tp_axis with an axis) in a "
                   "module that registers no CollectiveBudget "
                   "(TPContext.step_budget): its all-reduces are never "
                   "held to a declared count — route it through the "
                   "engine's guarded steps, or declare the budget")

def _pt011(tree, path):
    """A kernel library load (``_build.load``) in a module with no
    ``KERNELCHECK_CERTS`` naming its analysis.kernelcheck entries."""
    def _declares(node):
        if isinstance(node, ast.Assign):
            return (len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                    and node.targets[0].id == "KERNELCHECK_CERTS")
        if isinstance(node, ast.AnnAssign):
            return (isinstance(node.target, ast.Name)
                    and node.target.id == "KERNELCHECK_CERTS"
                    and node.value is not None)
        return False

    if any(_declares(node) for node in tree.body):
        return
    msg = ("a kernel library loaded in a module with no kernelcheck "
           "certificate — the kernel ships with no shared-memory or "
           "register budget, race proof or roofline contract. Register it "
           "in analysis/kernelcheck.py REGISTRY and declare "
           "KERNELCHECK_CERTS = (\"<entry>\", ...) at module top level.")
    for node in ast.walk(tree):
        if isinstance(node, ast.Attribute) and node.attr == "load" \
                and isinstance(node.value, ast.Name) \
                and node.value.id == "_build":
            yield node.lineno, msg
        elif isinstance(node, ast.ImportFrom) \
                and (node.module or "").endswith("_build") \
                and any(a.name == "load" for a in node.names):
            yield node.lineno, "importing _build.load bare: " + msg

def _family_registry(tree):
    """The module's declared labeled families: ``{base: label keys}``
    from a top-level ``_FAMILIES = {...}`` dict — a string value
    normalizes to a 1-tuple, a tuple/list of strings is a multi-label
    declaration in registry-key order, anything non-constant maps to
    None (declared, keys not statically checkable). None when the
    module declares no registry."""
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and node.targets[0].id == "_FAMILIES" \
                and isinstance(node.value, ast.Dict):
            out = {}
            for k, v in zip(node.value.keys, node.value.values):
                if not isinstance(k, ast.Constant):
                    continue
                if isinstance(v, ast.Constant) and isinstance(v.value, str):
                    out[k.value] = (v.value,)
                elif isinstance(v, (ast.Tuple, ast.List)) and all(
                        isinstance(e, ast.Constant) for e in v.elts):
                    out[k.value] = tuple(e.value for e in v.elts)
                else:
                    out[k.value] = None
            return out
    return None


def _pt012(tree, path):
    """Labeled stat family written without a ``_FAMILIES`` declaration —
    the dynamically-formatted-name gap of PT003/PT008 — or written with
    label keys (or key ORDER) disagreeing with the declaration: the
    label keys are part of the registry key, so a mismatched write
    builds a member the seeding never created and dashboards keyed on
    presence go blind exactly like the undeclared case. Gated, like
    PT003/PT008, on the module declaring a ``_SEEDED`` contract."""
    seeded, prefix = _seeding_contract(tree)
    if seeded is None:  # no seeding registry in this module: no contract
        return
    families = _family_registry(tree) or {}

    def registered(base):
        # a declared family sanctions its derived mirror names too
        # (step_phase_s -> step_phase_s_count / step_phase_s_p99)
        return base in seeded or any(
            base == fam or base.startswith(fam + "_") for fam in families)

    for node in ast.walk(tree):
        resolved = _labeled_stat_family(node, prefix)
        if resolved is None:
            continue
        base, keys = resolved
        if not registered(base):
            yield (node.lineno,
                   f"labeled stat family {base!r} ({base}{{...=...}}) is "
                   f"written but declared in neither _FAMILIES nor "
                   f"_SEEDED — the formatted name is invisible to "
                   f"PT003/PT008, so its members are never pre-seeded "
                   f"and dashboards keyed on presence are blind until "
                   f"the first event. Declare the base in _FAMILIES and "
                   f"seed its label values (ServingMetrics.seed_family).")
        elif keys is not None and families.get(base) is not None \
                and keys != families[base]:
            yield (node.lineno,
                   f"labeled stat family {base!r} is written with label "
                   f"keys {keys} but _FAMILIES declares "
                   f"{families[base]} — label keys and their ORDER are "
                   f"part of the registry key, so this write builds a "
                   f"member the seeding never created (it reads as "
                   f"absent on dashboards and never resets). Write the "
                   f"labels exactly as declared.")


def _pt013(tree, path):
    """Direct ServingEngine.add_request call in a fleet module. Scope is
    the serving/fleet* files only (gated on the filename — the rule
    encodes a fleet-layer contract, not an engine one): the router's
    single sanctioned dispatch site — the line every request reaches
    only AFTER weighted admission placed it — pragma-suppresses itself;
    any other ``.add_request`` attribute access in a fleet module is an
    admission bypass."""
    if not Path(path).name.startswith("fleet"):
        return
    for node in ast.walk(tree):
        if isinstance(node, ast.Attribute) and node.attr == "add_request":
            yield (node.lineno,
                   "direct .add_request in a fleet module bypasses the "
                   "router's admission path — no prefix-affinity "
                   "placement, no per-tenant weight, no "
                   "spill-before-shed, no fleet counters or journey "
                   "hops. Route the request through "
                   "FleetRouter.submit() (the router's one sanctioned "
                   "dispatch site carries the pragma).")


_PT014_MODULES = ("pickle", "socket")
_PT014_STRUCT_FNS = ("pack", "unpack", "pack_into", "unpack_from",
                     "iter_unpack", "calcsize", "Struct")


def _pt014(tree, path):
    """Raw serialization/transport primitive in serving/ outside the
    codec module. Gated on the filename (like PT013): serving/wire.py
    IS the sanctioned user — the rule exists so the versioned framed
    codec stays the only place replica-boundary bytes are shaped."""
    if Path(path).name == "wire.py":
        return
    for node in ast.walk(tree):
        mods = []
        if isinstance(node, ast.Import):
            mods = [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            mods = [(node.module or "").split(".")[0]]
        for m in mods:
            if m in _PT014_MODULES + ("struct",):
                yield (node.lineno,
                       f"raw {m!r} import in serving/ outside wire.py — "
                       f"bytes that cross a replica boundary go through "
                       f"the versioned wire codec (serving/wire.py: "
                       f"encode_*/decode_frame, CRC-trailed, typed "
                       f"WireError taxonomy). Ad-hoc {m} framing forks "
                       f"the schema and skips corruption accounting, "
                       f"retry policy, and the wire fault points.")
        if isinstance(node, ast.Attribute) \
                and isinstance(node.value, ast.Name):
            base = node.value.id
            if base in _PT014_MODULES or (
                    base == "struct" and node.attr in _PT014_STRUCT_FNS):
                yield (node.lineno,
                       f"raw {base}.{node.attr} in serving/ outside "
                       f"wire.py — shape these bytes through the "
                       f"versioned wire codec (serving/wire.py) so the "
                       f"frame format stays single-sourced and every "
                       f"decode failure lands in the typed WireError "
                       f"taxonomy the transport counts by kind.")


def _pt015(tree, path):
    """A raw ``torch.distributed.all_reduce`` in serving/ outside tp.py:
    serving collectives go through ``distributed.collective`` (counted,
    censused by the step audit) from the tensor-parallel layer."""
    if Path(path).name == "tp.py":
        return
    dist_names = {"dist", "torch.distributed"} | {
        a.asname for node in ast.walk(tree) if isinstance(node, ast.Import)
        for a in node.names if a.name == "torch.distributed" and a.asname}
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) \
                and node.module == "torch.distributed" \
                and any(a.name == "all_reduce" for a in node.names):
            yield (node.lineno,
                   "raw `from torch.distributed import all_reduce` in "
                   "serving/ outside tp.py — route the reduction through "
                   "distributed.collective.all_reduce so the step audit's "
                   "census counts it against the declared budget")
        elif isinstance(node, ast.Attribute) and node.attr == "all_reduce" \
                and _unparse(node.value) in dist_names:
            yield (node.lineno,
                   f"raw {_unparse(node.value)}.all_reduce in serving/ "
                   f"outside tp.py — an uncounted collective: route it "
                   f"through distributed.collective.all_reduce (the "
                   f"debug checks' census holds every step to its "
                   f"CollectiveBudget)")

_PT016_SANCTIONED = ("engine.py", "channel.py")
_PT016_SEEDED_CTORS = ("RandomState", "default_rng", "Generator", "Random",
                      "PRNGKey", "key")


def _pt016(tree, path):
    """Determinism fence: nondeterminism sources in serving/ outside the
    clock- and channel-sanctioned modules. Gated on the filename (like
    PT013/PT014/PT015): serving/engine.py OWNS the pluggable clock
    (``self._clock = clock or time.monotonic`` is the one sanctioned
    wall-clock binding) and serving/channel.py owns the seeded lossy-
    channel RNG. Everything else in serving/ must be replayable from
    (config, seed, trace) alone — the discipline ``chaos_soak``'s
    >=5-seed matrix and ``SimChannel``'s deterministic loss schedule
    depend on. Flags:

    - ``time.monotonic`` (attribute use or from-import — ``time.time``
      is already PT004's arm of the same fence; together they close the
      wall clock),
    - the process-global RNGs: any ``random.*`` call, any
      ``np.random.*`` / ``numpy.random.*`` call that is not a SEEDED
      constructor (``RandomState(seed)`` / ``default_rng(seed)`` /
      ``Random(seed)`` with an explicit argument),
    - ``id()``-keyed ordering: ``key=id`` in a sort/min/max call or an
      ``id(x)`` subscript key — iteration order then depends on
      allocator addresses, which no seed replays."""
    if Path(path).name in _PT016_SANCTIONED:
        return
    for node in ast.walk(tree):
        if isinstance(node, ast.Attribute) and node.attr == "monotonic" \
                and isinstance(node.value, ast.Name) \
                and node.value.id in ("time", "_time"):
            yield (node.lineno,
                   "time.monotonic in serving/ outside engine.py — the "
                   "engine clock is pluggable (ServingConfig(clock=)); a "
                   "raw monotonic read is wall time no seed replays and "
                   "no virtual clock can skew. Take the engine's clock "
                   "(engine.now() / the injected clock callable) "
                   "instead.")
        elif isinstance(node, ast.ImportFrom) and node.module == "time":
            for a in node.names:
                if a.name in ("monotonic", "time"):
                    yield (node.lineno,
                           f"`from time import {a.name}` in serving/ "
                           f"outside engine.py — binds the wall clock "
                           f"directly; route timing through the "
                           f"pluggable engine clock so replay and the "
                           f"slow_step fault skew keep working.")
        elif isinstance(node, ast.ImportFrom) and node.module == "random":
            for a in node.names:
                if a.name not in ("Random", "SystemRandom"):
                    yield (node.lineno,
                           f"`from random import {a.name}` in serving/ "
                           f"— the process-global RNG is shared mutable "
                           f"state no (config, seed) pair replays. Use "
                           f"a seeded random.Random(seed) / "
                           f"np.random.RandomState(seed) instance owned "
                           f"by the component.")
        if isinstance(node, ast.Call):
            f = node.func
            if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name) \
                    and f.value.id == "random":
                if not (f.attr in ("Random", "SystemRandom") and node.args):
                    yield (node.lineno,
                           f"random.{f.attr}(...) in serving/ — the "
                           f"global RNG's state is shared across every "
                           f"module and call order; chaos_soak's seed "
                           f"matrix and SimChannel replay need a seeded "
                           f"per-component random.Random(seed) / "
                           f"RandomState(seed) instead.")
            elif isinstance(f, ast.Attribute) \
                    and isinstance(f.value, ast.Attribute) \
                    and f.value.attr == "random" \
                    and isinstance(f.value.value, ast.Name) \
                    and f.value.value.id in ("np", "numpy"):
                if not (f.attr in _PT016_SEEDED_CTORS and node.args):
                    yield (node.lineno,
                           f"np.random.{f.attr}(...) in serving/ — "
                           f"global numpy RNG (or an unseeded "
                           f"constructor): not replayable from (config, "
                           f"seed). Construct "
                           f"np.random.RandomState(seed) / "
                           f"default_rng(seed) with an explicit seed "
                           f"and own it on the component.")
            for kw in node.keywords:
                if kw.arg == "key" and isinstance(kw.value, ast.Name) \
                        and kw.value.id == "id":
                    yield (node.lineno,
                           "key=id ordering in serving/ — sorts by "
                           "allocator address, which differs run to run "
                           "under identical (config, seed, trace). Key "
                           "on a stable field (rid, arrival index) "
                           "instead.")
        elif isinstance(node, ast.Subscript):
            sl = node.slice
            if isinstance(sl, ast.Call) and isinstance(sl.func, ast.Name) \
                    and sl.func.id == "id":
                yield (node.lineno,
                       "id()-keyed table in serving/ — the key is an "
                       "allocator address: dict iteration order (and "
                       "anything derived from it) stops being "
                       "replayable. Key on a stable identity (rid, "
                       "sequence number) instead.")


def _pt017(tree, path):
    """Contextless wire exchange: a ``.exchange(...)`` call in serving/
    that omits the ``rid=`` or ``step=`` keyword. Those two keywords are
    what ties an exchange to a request journey and an engine step — an
    exchange without them produces a span/journey hop nothing can join
    against (rid) or order (step), which is exactly the blind spot
    fleetscope exists to close. Calls that deliberately carry no
    request (gossip) must say so with an explicit ``rid=None``; a
    ``**kwargs`` splat is assumed to forward the context."""
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "exchange"):
            continue
        kws = {kw.arg for kw in node.keywords}
        if None in kws:  # **splat forwards the caller's context
            continue
        missing = [k for k in ("rid", "step") if k not in kws]
        if missing:
            yield (node.lineno,
                   f".exchange(...) without {'/'.join(missing)}= — the "
                   f"exchange is invisible to fleetscope: no rid to "
                   f"join the span to a journey, no step to order it "
                   f"on the fleet timeline. Pass rid= (rid=None if the "
                   f"exchange genuinely carries no request, e.g. "
                   f"gossip) and step=.")


@dataclass(frozen=True)
class Rule:
    code: str
    doc: str
    check: object  # generator fn(tree, path) -> (line, message)
    scope: str | None = None  # path part required for the rule to fire


RULES: dict[str, Rule] = {r.code: r for r in (
    Rule("PT001", "dataclass with ndarray/Array/Tensor field missing "
         "eq=False", _pt001),
    Rule("PT003", "metric counter incremented without pre-seeding", _pt003),
    Rule("PT004", "time.time() in serving/ instead of the engine clock",
         _pt004, scope="serving"),
    Rule("PT005", ".item/.cpu/.tolist/.numpy inside a step/decode/verify "
         "hot path", _pt005, scope="serving"),
    Rule("PT006", "CompileGuard over pool arguments without "
         "donate_argnums", _pt006, scope="serving"),
    Rule("PT007", "mutable default argument", _pt007),
    Rule("PT008", "metric gauge written (stat_set/stat_max) without "
         "pre-seeding", _pt008),
    Rule("PT009", "serving step outside the CompileGuard registry "
         "(torch.compile / CUDA graph / unwrapped _*_impl)", _pt009,
         scope="serving"),
    Rule("PT010", "tensor-parallel forward in a serving module with no "
         "registered CollectiveBudget", _pt010, scope="serving"),
    Rule("PT011", "kernel library load in a module with no "
         "KERNELCHECK_CERTS", _pt011),
    Rule("PT012", "labeled stat family written without a _FAMILIES "
         "declaration, or with label keys disagreeing with it", _pt012),
    Rule("PT013", "direct ServingEngine.add_request in serving/fleet* "
         "bypassing the router's weighted admission path", _pt013,
         scope="serving"),
    Rule("PT014", "raw pickle/socket/struct in serving/ outside wire.py",
         _pt014, scope="serving"),
    Rule("PT015", "raw torch.distributed.all_reduce in serving/ outside "
         "tp.py", _pt015, scope="serving"),
    Rule("PT016", "determinism fence: time.monotonic / global or unseeded "
         "random / id()-keyed ordering in serving/ outside engine.py and "
         "channel.py", _pt016, scope="serving"),
    Rule("PT017", "wire .exchange(...) in serving/ without rid=/step=",
         _pt017, scope="serving"),
)}


# ------------------------------------------------------------------ driver
def _pragmas(source: str) -> dict[int, set[str]]:
    out: dict[int, set[str]] = {}
    for i, line in enumerate(source.splitlines(), start=1):
        m = _PRAGMA.search(line)
        if m:
            out[i] = {c.strip() for c in m.group(1).split(",") if c.strip()}
    return out


def lint_source(source: str, path: str, rules=None,
                allowlist=None) -> list[Finding]:
    """Lint one module's source. ``path`` scopes path-restricted rules (a
    fixture can be linted "as if" it lived under serving/)."""
    allowlist = ALLOWLIST if allowlist is None else allowlist
    parts = Path(path).parts
    try:
        tree = ast.parse(source)
    except SyntaxError as e:
        return [Finding("PT000", path, e.lineno or 0,
                        f"syntax error: {e.msg}")]
    pragmas = _pragmas(source)
    exempt = set().union(*(codes for sub, codes in allowlist.items()
                           if sub in path), set())
    findings = []
    for rule in RULES.values():
        if rules is not None and rule.code not in rules:
            continue
        if rule.scope is not None and rule.scope not in parts:
            continue
        if rule.code in exempt:
            continue
        for line, msg in rule.check(tree, path):
            if rule.code in pragmas.get(line, ()):
                continue
            findings.append(Finding(rule.code, path, line, msg))
    return sorted(findings, key=lambda f: (f.path, f.line, f.rule))


def lint_paths(paths, rules=None, path_filter: str | None = None,
               allowlist=None) -> list[Finding]:
    """Lint every ``.py`` file under the given files/directories."""
    files: list[Path] = []
    for p in paths:
        p = Path(p)
        files.extend(sorted(p.rglob("*.py")) if p.is_dir() else [p])
    findings = []
    for f in files:
        rel = f.as_posix()
        if path_filter is not None and path_filter not in rel:
            continue
        findings.extend(lint_source(f.read_text(), rel, rules=rules,
                                    allowlist=allowlist))
    return sorted(findings, key=lambda f: (f.path, f.line, f.rule))


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.analysis lint",
        description="The port's linter: invariants the reference shipped "
                    "bugs against, as they read in PyTorch.")
    parser.add_argument("paths", nargs="*",
                        help="files or directories (default: the "
                             "paddle_tpu_torch package)")
    parser.add_argument("--rule", action="append", default=None,
                        metavar="PTxxx", help="run only these rules "
                        "(repeatable / comma-separated)")
    parser.add_argument("--path", default=None, metavar="SUBSTR",
                        help="lint only files whose path contains SUBSTR")
    parser.add_argument("--list-rules", action="store_true",
                        help="print the rule table and exit")
    args = parser.parse_args(argv)

    if args.list_rules:
        for r in RULES.values():
            scope = f" [scope: {r.scope}/]" if r.scope else ""
            print(f"{r.code}  {r.doc}{scope}")
        return 0
    rules = None
    if args.rule:
        rules = {c.strip() for spec in args.rule for c in spec.split(",")}
        unknown = rules - set(RULES)
        if unknown:
            print(f"unknown rule(s): {', '.join(sorted(unknown))} "
                  f"(have: {', '.join(RULES)})")
            return 2
    paths = args.paths or [Path(__file__).resolve().parent.parent]
    findings = lint_paths(paths, rules=rules, path_filter=args.path)
    for f in findings:
        print(f)
    n = len(findings)
    print(f"{n} finding(s)" if n else "clean: 0 findings")
    return 1 if findings else 0
