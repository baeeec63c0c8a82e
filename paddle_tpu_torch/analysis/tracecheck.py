"""Call-time auditing of the port's step callables — the port of
``paddle_tpu/analysis/tracecheck.py``.

The serving contract the reference certifies — compile once, never read
the device mid-step, write every donated pool in place — holds for the
port too, but nothing compiles here: PyTorch runs a step eagerly. So each
auditor keeps the reference's contract and reads what the port runs
instead of a jaxpr:

- :class:`CompileGuard` wraps a step callable and counts a *novel
  abstract signature* as a trace: the shapes, dtypes and devices of its
  tensor arguments and the values of its Python scalars — what the port
  would have to specialise (or capture as a CUDA graph) anew. It keeps
  the reference's budget, ``group_by`` and retrace explanation (the
  argument and axis whose signature changed, ``"axis 0: 2 -> 3"``); with
  ``strict=True`` an over-budget novel signature raises
  :class:`RetraceError` before the step runs, the same storage passed
  through two donated arguments raises :class:`DonationViolation`, and
  after the call a donated tensor that was not written in place (its
  ``data_ptr()`` changed or its ``_version`` did not move) raises it too.
- :func:`donation_audit` runs a step once and reports a donated tensor it
  never writes (``"never consumed"``) — the reference reads that off the
  jaxpr.
- :class:`SyncTally` counts the host's reads of tensor values inside a
  ``with`` region: ``.item``, ``.tolist``, ``.numpy``, ``.cpu``, ``.to`` a
  CPU device, ``__bool__``/``__int__``/``__float__``/``__index__``,
  ``__array__`` (``np.asarray(t)``) and iteration. It counts them on CPU
  tensors as well, so the CPU counts equal the reference's. On the card
  it also counts the synchronising CUDA operations the patches cannot see
  (a blocking host-to-device copy, ``nonzero``, a boolean mask): it turns
  on ``torch.cuda.set_sync_debug_mode("warn")`` inside the region and
  counts each warning that is not already one of the patched reads.
  Tallies nest; each active tally counts every event.
  :func:`sync_tally_paused` suspends counting.

Nothing here imports the serving stack — serving imports us.
"""
from __future__ import annotations

import contextlib
import functools
import inspect
import threading
import warnings

import numpy as np
import torch

__all__ = ["CompileGuard", "RetraceError", "DonationViolation",
           "SyncViolation", "SyncTally", "donation_audit",
           "abstract_signature", "explain_signature_diff",
           "sync_tally_paused", "tallying", "flatten_args"]


class RetraceError(RuntimeError):
    """A guarded callable exceeded its declared budget of signatures. The
    message names the argument whose abstract signature changed and how."""


class DonationViolation(RuntimeError):
    """A donated tensor was misused: the same storage donated through two
    arguments at once, or a donated tensor not written in place."""


class SyncViolation(RuntimeError):
    """A guarded region read the device more often than it declared."""


# --------------------------------------------------------------- signatures
def _flatten(obj, name: str, out: list) -> None:
    """(leaf name, leaf) pairs of one argument: lists and tuples by
    ``[i]``, dicts by ``['key']`` in sorted key order, as the reference's
    ``keystr`` spells pytree paths."""
    if isinstance(obj, (list, tuple)):
        for i, x in enumerate(obj):
            _flatten(x, f"{name}[{i}]", out)
    elif isinstance(obj, dict):
        for k in sorted(obj):
            _flatten(obj[k], f"{name}[{k!r}]", out)
    else:
        out.append((name, obj))


def flatten_args(args, kwargs=None, param_names=()) -> list:
    """Every leaf of a call's arguments as ``(name, leaf)``: positional
    argument ``i`` under its parameter name (``arg{i}`` past the
    signature), keyword arguments in sorted order."""
    out: list = []
    for i, arg in enumerate(args):
        _flatten(arg, param_names[i] if i < len(param_names) else f"arg{i}",
                 out)
    for k in sorted(kwargs or ()):
        _flatten(kwargs[k], k, out)
    return out


def _leaf_spec(leaf):
    """The abstract signature of one leaf: a tensor's shape, dtype and
    device; a numpy array's shape and dtype; anything else by value."""
    if isinstance(leaf, torch.Tensor):
        return ("tensor", tuple(leaf.shape), str(leaf.dtype).split(".")[-1],
                str(leaf.device))
    if isinstance(leaf, np.ndarray):
        return ("tensor", tuple(leaf.shape), str(leaf.dtype), "numpy")
    return ("static", repr(leaf))


def abstract_signature(args, kwargs=None, param_names=()) -> tuple:
    """The abstract signature of a call: ``(leaf_name, spec)`` over every
    leaf of every argument — what the reference's ``static_argnums`` key
    by value, the port keys every non-tensor leaf by. Container structure
    is part of it (leaf names carry the path), so a list growing an
    element reads as an added leaf."""
    return tuple((n, _leaf_spec(x))
                 for n, x in flatten_args(args, kwargs, param_names))


def _describe_change(name: str, old, new) -> str:
    if old[0] != new[0]:
        return f"{name}: {old[0]} {old[1:]} -> {new[0]} {new[1:]}"
    if old[0] == "static":
        return f"{name}: static value {old[1]} -> {new[1]}"
    parts = []
    if old[1] != new[1]:
        axes = [f"axis {i}: {a} -> {b}"
                for i, (a, b) in enumerate(zip(old[1], new[1])) if a != b]
        if len(old[1]) != len(new[1]):
            axes.append(f"rank {len(old[1])} -> {len(new[1])}")
        parts.append(f"shape {old[1]} -> {new[1]} ({', '.join(axes)})")
    if old[2] != new[2]:
        parts.append(f"dtype {old[2]} -> {new[2]}")
    if old[3] != new[3]:
        parts.append(f"device {old[3]} -> {new[3]}")
    return f"{name}: " + ", ".join(parts)


def explain_signature_diff(prior: tuple, new: tuple) -> list[str]:
    """Human-readable differences between two abstract signatures, one
    string per changed, added or removed leaf (empty = identical)."""
    po, no_ = dict(prior), dict(new)
    out = []
    for name, spec in no_.items():
        if name not in po:
            out.append(f"{name}: new leaf {spec} (argument structure "
                       f"changed)")
        elif po[name] != spec:
            out.append(_describe_change(name, po[name], spec))
    for name in po:
        if name not in no_:
            out.append(f"{name}: leaf removed (argument structure changed)")
    return out


def _param_names(fn) -> list[str]:
    try:
        return [p.name for p in inspect.signature(fn).parameters.values()]
    except (TypeError, ValueError):
        return []


def _donated(args, donate_argnums, params) -> list:
    """``(name, tensor)`` for every tensor leaf of the donated arguments."""
    return [(n, x) for i in donate_argnums if i < len(args)
            for n, x in flatten_args((args[i],), None, params[i:i + 1])
            if isinstance(x, torch.Tensor)]


def _written(before: tuple, t: torch.Tensor) -> bool:
    """Was ``t`` written in place since ``before = (data_ptr, _version)``?"""
    return t.data_ptr() == before[0] and t._version != before[1]


# ------------------------------------------------------------ CompileGuard
class CompileGuard:
    """A step callable with an audit trail: signature counting, budgets,
    retrace explanation and donation checks.

    ``guard.traces`` counts novel signatures (what the port would
    specialise or capture anew), ``guard.signatures`` holds each in
    order, ``guard.retraces`` counts traces beyond ``budget``, and
    ``guard.calls`` every call. ``strict=False`` only counts.
    ``strict=True`` refuses an over-budget novel signature with
    :class:`RetraceError` before the step runs, checks the donated
    arguments on the way in (one storage through two of them) and on the
    way out (each written in place), raising :class:`DonationViolation`.

    ``group_by`` (a callable over the call's positional arguments
    returning a hashable group id) declares that each group traces at
    most once — the serving prefill groups by pad bucket, so a same-bucket
    retrace cannot hide in the headroom of buckets never used."""

    def __init__(self, fn, name: str | None = None, *, budget: int | None
                 = None, strict: bool = False, donate_argnums=(),
                 group_by=None):
        self.fn = fn
        self.name = name or getattr(fn, "__name__", "step")
        self.budget = budget
        self.strict = strict
        self.donate_argnums = tuple(donate_argnums)
        self.group_by = group_by
        self.traces = 0
        self.calls = 0
        self.retraces = 0  # traces beyond budget (counted even unstrict)
        self.signatures: list[tuple] = []
        self._seen: set[tuple] = set()
        self._refused: set[tuple] = set()  # strict-mode pre-raised sigs
        self._groups: set = set()  # group ids that have traced already
        self._params = _param_names(fn)

    # ------------------------------------------------------------- auditing
    def signature_of(self, args, kwargs=None) -> tuple:
        return abstract_signature(args, kwargs, self._params)

    def _check_donation(self, args) -> list:
        """One storage donated through two arguments raises; returns each
        donated tensor with its (data_ptr, _version) on the way in."""
        seen: dict[int, str] = {}
        out = []
        for where, t in _donated(args, self.donate_argnums, self._params):
            key = t.untyped_storage().data_ptr()
            prev = seen.get(key)
            if prev is not None:
                raise DonationViolation(
                    f"{self.name}: double donation — {prev} and {where} "
                    f"are the same storage, donated twice in one call")
            seen[key] = where
            out.append((where, t, (t.data_ptr(), t._version)))
        return out

    def _explain(self, sig: tuple, group=None) -> str:
        trace_no = len(self.signatures) + 1
        if group is not None:
            why = (f"group {group!r} has already traced (budget: one "
                   f"signature per group)")
        else:
            why = (f"trace #{trace_no} exceeds the budget of {self.budget} "
                   f"signature(s)")
        head = f"CompileGuard({self.name!r}): unexpected retrace — {why}."
        if not self.signatures:
            return head + " No prior trace recorded (budget 0?)."
        diffs_per = [explain_signature_diff(prev, sig)
                     for prev in self.signatures]
        best_i = min(range(len(diffs_per)), key=lambda i: len(diffs_per[i]))
        diffs = diffs_per[best_i]
        if not diffs:
            return (head + f" The call's abstract signature matches trace "
                    f"#{best_i + 1} exactly — the group key changed "
                    f"outside the audited signature.")
        unchanged = len(sig) - len([d for d in diffs if "removed" not in d])
        return (head + f" vs trace #{best_i + 1} (closest of "
                f"{len(self.signatures)}), {len(diffs)} leaf(s) changed: "
                + "; ".join(diffs)
                + f". {max(unchanged, 0)} other leaf(s) unchanged.")

    # --------------------------------------------------------------- call
    def __call__(self, *args, **kwargs):
        self.calls += 1
        group = self.group_by(*args) if self.group_by is not None else None
        sig = self.signature_of(args, kwargs)
        novel = sig not in self._seen
        donated = ()
        if self.strict:
            donated = self._check_donation(args)
            regroup = group is not None and group in self._groups
            if novel and ((self.budget is not None
                           and self.traces >= self.budget) or regroup):
                # retraces counts retrace EVENTS (novel over-budget
                # signatures), not refused calls
                if sig not in self._refused:
                    self._refused.add(sig)
                    self.retraces += 1
                raise RetraceError(self._explain(
                    sig, group if regroup else None))
        if novel:
            regroup = group is not None and group in self._groups
            self.traces += 1
            if (self.budget is not None and self.traces > self.budget) \
                    or regroup:
                self.retraces += 1
            self._groups.add(group)
            self.signatures.append(sig)
            self._seen.add(sig)
        out = self.fn(*args, **kwargs)
        for where, t, before in donated:
            if not _written(before, t):
                raise DonationViolation(
                    f"{self.name}: donated argument {where} was not written "
                    f"in place (data_ptr {before[0]:#x} -> "
                    f"{t.data_ptr():#x}, version {before[1]} -> "
                    f"{t._version}) — the step copied it or never wrote it")
        return out


# ---------------------------------------------------------- donation audit
def donation_audit(fn, donate_argnums, *args) -> list[str]:
    """Run ``fn(*args)`` once and report donated tensors the step (a)
    never writes — donating a tensor the step only reads can alias
    nothing, almost always a wrong ``donate_argnums`` — or (b) returns as
    they came in, unwritten (an identity pass-through). Human-readable
    report strings; empty when the donation is clean."""
    params = _param_names(fn)
    donated = [(n, t, (t.data_ptr(), t._version))
               for n, t in _donated(args, donate_argnums, params)]
    out = fn(*args)
    returned = {id(x) for _, x in flatten_args((out,))}
    reports = []
    for where, t, before in donated:
        if _written(before, t):
            continue
        if id(t) in returned:
            reports.append(f"donated leaf {where} is returned unchanged — "
                           f"the alias is an identity pass-through")
        else:
            reports.append(
                f"donated leaf {where} is never consumed by the step — it "
                f"is never written in place (wrong donate_argnums?)")
    return reports


# ------------------------------------------------------------- host syncs
_tally_lock = threading.Lock()
_active_tallies: list["SyncTally"] = []
_saved_attrs: list[tuple[object, str, object]] = []
_in_event = threading.local()
_saved_warnings: list = []
#: the message of torch's sync debug mode (c10/cuda/CUDAFunctions.cpp)
CUDA_SYNC_MESSAGE = "called a synchronizing CUDA operation"


def _record(kind: str) -> None:
    for t in _active_tallies:
        t.count += 1
        t.events.append(kind)


def _counted(kind: str, orig):
    @functools.wraps(orig)
    def wrapper(*args, **kwargs):
        # a read built on another (``__array__`` -> ``numpy``) counts once,
        # and the CUDA sync warning it raises inside is the same event
        if getattr(_in_event, "on", False):
            return orig(*args, **kwargs)
        _in_event.on = True
        try:
            _record(kind)
            return orig(*args, **kwargs)
        finally:
            _in_event.on = False
    return wrapper


def _to_host(orig):
    """``Tensor.to``: a read only when it copies to the CPU."""
    @functools.wraps(orig)
    def wrapper(self, *args, **kwargs):
        dest = kwargs.get("device", args[0] if args else None)
        if isinstance(dest, (str, torch.device)) \
                and torch.device(dest).type == "cpu" \
                and not getattr(_in_event, "on", False):
            _in_event.on = True
            try:
                _record("to_cpu")
                return orig(self, *args, **kwargs)
            finally:
                _in_event.on = False
        return orig(self, *args, **kwargs)
    return wrapper


def _cuda_sync_seen(message, category, filename, lineno, file=None,
                    line=None):
    if CUDA_SYNC_MESSAGE in str(message):
        if not getattr(_in_event, "on", False):
            _record("cuda_sync")
        return
    _saved_warnings[0](message, category, filename, lineno, file, line)


def _cuda_ready() -> bool:
    return torch.cuda.is_available() and torch.cuda.is_initialized()


def _install_patches() -> None:
    cls = torch.Tensor
    for attr, kind in (("item", "item"), ("tolist", "tolist"),
                       ("numpy", "numpy"), ("cpu", "cpu"),
                       ("__array__", "np.asarray"), ("__iter__", "iter"),
                       ("__bool__", "bool"), ("__int__", "int"),
                       ("__float__", "float"), ("__index__", "index")):
        orig = getattr(cls, attr)
        _saved_attrs.append((cls, attr, cls.__dict__.get(attr)))
        setattr(cls, attr, _counted(kind, orig))
    _saved_attrs.append((cls, "to", cls.__dict__.get("to")))
    cls.to = _to_host(cls.to)
    if _cuda_ready():
        _saved_warnings[:] = [warnings.showwarning, list(warnings.filters),
                              torch.cuda.get_sync_debug_mode()]
        warnings.filterwarnings("always", message=CUDA_SYNC_MESSAGE)
        warnings.showwarning = _cuda_sync_seen
        torch.cuda.set_sync_debug_mode("warn")


def _remove_patches() -> None:
    while _saved_attrs:
        obj, attr, orig = _saved_attrs.pop()
        if orig is None:
            delattr(obj, attr)  # it was inherited: drop our shadow
        else:
            setattr(obj, attr, orig)
    if _saved_warnings:
        show, filters, mode = _saved_warnings
        torch.cuda.set_sync_debug_mode(mode)
        warnings.showwarning = show
        warnings.filters[:] = filters
        # the C warnings module caches the filters until told they moved
        getattr(warnings, "_filters_mutated", lambda: None)()
        _saved_warnings.clear()


def tallying() -> bool:
    """Is a SyncTally counting?"""
    return bool(_active_tallies)


@contextlib.contextmanager
def sync_tally_paused():
    """Suspend SyncTally counting for the region: reads inside it are
    deliberately NOT counted, and on the card torch's sync debug mode is
    off inside it (so a library's own synchronisation, on any thread,
    raises no warning). For work that is not the step's own host reads —
    a collective's transport staging its payload through the host (gloo
    on one card) is the collective's, which the census counts."""
    prev = getattr(_in_event, "on", False)
    _in_event.on = True
    # the outermost pause switches the debug mode off, and back on
    mode = _saved_warnings[2] if _saved_warnings and not prev else None
    if mode is not None:
        torch.cuda.set_sync_debug_mode(mode)
    try:
        yield
    finally:
        if mode is not None:
            torch.cuda.set_sync_debug_mode("warn")
        _in_event.on = prev


class SyncTally:
    """Counts the host's reads of tensor values inside a ``with`` region
    (see the module docstring for the list). ``allowed=N`` turns the
    tally into an assertion: leaving the region with more than N reads
    raises :class:`SyncViolation`.

    Reentrant — nested tallies each count every event — but not
    thread-safe: the patches are process-global."""

    def __init__(self, allowed: int | None = None, name: str = "region"):
        self.allowed = allowed
        self.name = name
        self.count = 0
        self.events: list[str] = []

    def __enter__(self) -> "SyncTally":
        with _tally_lock:
            if not _active_tallies:
                _install_patches()
            _active_tallies.append(self)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        with _tally_lock:
            _active_tallies.remove(self)
            if not _active_tallies:
                _remove_patches()
        if exc_type is None and self.allowed is not None \
                and self.count > self.allowed:
            raise SyncViolation(
                f"{self.name}: {self.count} host sync(s) in a region that "
                f"allows {self.allowed} — events: {self.events}")
        return False
