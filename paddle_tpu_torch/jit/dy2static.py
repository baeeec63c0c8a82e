"""dy2static — the port of ``paddle_tpu/jit/dy2static.py``: the AST
conversion of Python control flow over tensors (``convert_control_flow``)
and its runtime (``run_if``, ``run_while``, ``MISSING``).

The AST pass is the reference's, as it is (plain Python): a tensor-
dependent ``if`` becomes ``run_if`` over two branch functions, a ``while``
(and a ``for i in range(...)``) ``run_while`` over its carried variables,
and a ``break`` / ``continue`` inside such a loop a flag-guarded body.

The runtime differs by design. The reference traces under ``jax.jit``,
where a tensor predicate is symbolic: both branches run and their results
merge with ``where``, and a loop becomes ``lax.while_loop``. The port runs
eagerly (on the card too), so ``run_if`` and ``run_while`` evaluate a
tensor predicate on the spot: one host read a branch or a loop test, and
only the taken branch runs. The reference's contract stays where a caller
could see it: a variable assigned in only one branch of a tensor ``if``
(and not bound before it) raises ``NameError``, and a body-local
temporary of a tensor ``while`` is unbound after the loop.
"""
from __future__ import annotations

import ast
import functools
import inspect
import textwrap

import torch

__all__ = ["convert_control_flow", "run_if", "run_while", "MISSING"]


class _Missing:
    def __repr__(self):
        return "<dy2static: variable not assigned on the taken branch>"


MISSING = _Missing()


def _is_symbolic(x):
    """A tensor predicate (its value lives on a device)."""
    return isinstance(x, torch.Tensor)


# ------------------------------------------------------------- runtime helpers
def run_if(pred, true_fn, false_fn, env, one_sided=()):
    """A transformed ``if`` lands here. One branch runs, chosen by the
    predicate (a tensor one read once). ``one_sided``: the names only one
    branch assigns; under a tensor predicate such a name that was not
    bound before the ``if`` raises, as the reference's merge does."""
    if _is_symbolic(pred):
        taken = bool(pred)
        for k in one_sided:
            if env.get(k, MISSING) is MISSING:
                raise NameError(
                    f"dy2static: variable {k!r} is assigned in only one "
                    "branch of a tensor-dependent `if`; assign it in both "
                    "branches (or before the if)")
        return true_fn(dict(env)) if taken else false_fn(dict(env))
    return true_fn(dict(env)) if pred else false_fn(dict(env))


def run_while(cond_fn, body_fn, env):
    """A transformed ``while`` lands here: the loop runs eagerly, a tensor
    predicate read once a test. From the first tensor predicate on, the
    variables unbound at that point are body-local temporaries, unbound
    after the loop again (the reference's functional loop carries only
    the variables bound when it starts)."""
    env = dict(env)
    unbound = None
    while True:
        p = cond_fn(dict(env))
        if _is_symbolic(p):
            if unbound is None:
                unbound = [k for k, v in env.items() if v is MISSING]
            p = bool(p)
        if not p:
            break
        env = body_fn(dict(env))
    for k in unbound or ():
        env[k] = MISSING
    return env


def _snapshot(frame_locals, keys):
    return {k: frame_locals.get(k, MISSING) for k in keys}


# --------------------------------------------------------------- AST transform
class _AssignedNames(ast.NodeVisitor):
    def __init__(self):
        self.names = set()

    def visit_Name(self, node):
        if isinstance(node.ctx, (ast.Store, ast.Del)):
            self.names.add(node.id)

    def visit_FunctionDef(self, node):
        self.names.add(node.name)  # the def binds its name; don't descend

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node):
        pass


def _assigned(stmts):
    v = _AssignedNames()
    for s in stmts:
        v.visit(s)
    # synthesized helper/out names from earlier (nested) transforms are
    # implementation detail, never loop-carried user state
    return {n for n in v.names if not n.startswith("__jst_")}


class _ReadNames(ast.NodeVisitor):
    def __init__(self):
        self.names = set()

    def visit_Name(self, node):
        if isinstance(node.ctx, ast.Load):
            self.names.add(node.id)


def _reads(node_or_stmts):
    v = _ReadNames()
    for s in (node_or_stmts if isinstance(node_or_stmts, list)
              else [node_or_stmts]):
        v.visit(s)
    return {n for n in v.names if not n.startswith("__jst")}


def _load_prologue(keys):
    """Guarded `k = __jst_env['k']`: a key that is absent/MISSING stays
    unbound so reads fall through to globals/builtins (e.g. `torch` in a loop
    condition)."""
    out = []
    for k in sorted(keys):
        out.append(ast.parse(
            f"if not __jst.missing(__jst_env, {k!r}):\n"
            f"    {k} = __jst_env[{k!r}]").body[0])
    return out


def _return_epilogue(keys):
    # snapshot() maps still-unassigned names to MISSING instead of NameError
    return ast.parse(f"return __jst.snapshot(locals(), {sorted(keys)!r})").body[0]


def _rebind(keys, out_name):
    """Guarded rebind: a MISSING result leaves the name unbound, preserving
    python's UnboundLocalError instead of leaking the sentinel downstream."""
    return [ast.parse(
        f"if not __jst.missing({out_name}, {k!r}):\n"
        f"    {k} = {out_name}[{k!r}]").body[0] for k in sorted(keys)]


def _has_flow_escape(stmts):
    """True if return/break/continue appears at THIS function's level —
    nested function bodies (incl. the __jst_* helpers synthesized by earlier
    transforms) have their own flow and must not mask conversion."""

    class V(ast.NodeVisitor):
        found = False

        def visit_Return(self, node):
            self.found = True

        def visit_Break(self, node):
            self.found = True

        def visit_Continue(self, node):
            self.found = True

        def visit_FunctionDef(self, node):
            pass  # don't descend

        visit_AsyncFunctionDef = visit_FunctionDef

        def visit_Lambda(self, node):
            pass

    v = V()
    for s in stmts:
        v.visit(s)
    return v.found


def _contains_break_continue(stmts):
    """Break/Continue belonging to THIS loop level: descend into If bodies
    but not into nested loops or function definitions."""
    for s in stmts:
        if isinstance(s, (ast.Break, ast.Continue)):
            return True
        if isinstance(s, ast.If):
            if _contains_break_continue(s.body) or \
                    _contains_break_continue(s.orelse):
                return True
        elif isinstance(s, (ast.With,)):
            if _contains_break_continue(s.body):
                return True
    return False


class _BreakContinueTransformer(ast.NodeTransformer):
    """Rewrite loops containing break/continue into flag-guarded form
    (reference: dygraph_to_static/break_continue_transformer.py):

        while test:                 __brk = False
            ...                     while __jst.loop_cond(test, __brk):
            if p: break       =>        __cont = False
            rest                        ...
                                        if p: __brk = True; __cont = True
                                        if __jst.not_(__cont): rest

    A python predicate keeps the flags python bools (plain loop, original
    semantics); a tensor predicate turns them into bool tensors that the
    main transformer's run_if/run_while carry functionally."""

    def __init__(self):
        self.n = 0
        self._top = None

    def visit_FunctionDef(self, node):
        if self._top is None:
            self._top = node
            self.generic_visit(node)
        return node

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node):
        return node

    def _rewrite_body(self, stmts, brk, cont, allow_break=True):
        out = []
        for i, st in enumerate(stmts):
            if isinstance(st, ast.Break) and allow_break:
                out += ast.parse(f"{brk} = True\n{cont} = True").body
                break  # anything after an unconditional break is dead
            if isinstance(st, ast.Continue):
                out.append(ast.parse(f"{cont} = True").body[0])
                break
            carries_flow = isinstance(st, (ast.If, ast.With)) and (
                _contains_break_continue(getattr(st, "body", []))
                or _contains_break_continue(getattr(st, "orelse", [])))
            if carries_flow:
                if isinstance(st, ast.If):
                    new_st = ast.If(
                        test=st.test,
                        body=self._rewrite_body(st.body, brk, cont)
                        or [ast.Pass()],
                        orelse=self._rewrite_body(st.orelse, brk, cont),
                    )
                else:  # With wrapping a break/continue (no_grad, auto_cast…)
                    new_st = ast.With(
                        items=st.items,
                        body=self._rewrite_body(st.body, brk, cont)
                        or [ast.Pass()],
                    )
                out.append(new_st)
                rest = self._rewrite_body(stmts[i + 1:], brk, cont)
                if rest:
                    guard = ast.parse(f"if __jst.not_({cont}):\n    pass"
                                      ).body[0]
                    guard.body = rest
                    out.append(guard)
                return out
            out.append(st)
        return out

    def _flagged_while(self, test_expr, body, brk, cont):
        shell = ast.parse(
            f"{brk} = False\n"
            f"while __jst.loop_cond(__TEST__, {brk}):\n"
            f"    {cont} = False").body
        loop = shell[1]
        loop.test.args[0] = test_expr
        loop.body = loop.body + self._rewrite_body(body, brk, cont)
        return shell

    def visit_While(self, node):
        self.generic_visit(node)  # inner loops first (their own flags)
        if node.orelse or not _contains_break_continue(node.body):
            return node
        self.n += 1
        brk, cont = f"__bc_brk_{self.n}", f"__bc_cont_{self.n}"
        return self._flagged_while(node.test, node.body, brk, cont)

    def visit_For(self, node):
        self.generic_visit(node)
        if node.orelse or not _contains_break_continue(node.body):
            return node
        # same range() subset as visit_For below; others stay python
        it = node.iter
        if (not isinstance(node.target, ast.Name)
                or not isinstance(it, ast.Call)
                or not isinstance(it.func, ast.Name) or it.func.id != "range"
                or it.keywords or not 1 <= len(it.args) <= 3):
            return node
        step_val = 1
        if len(it.args) == 3:
            s = it.args[2]
            if not (isinstance(s, ast.Constant) and isinstance(s.value, int)
                    and s.value != 0):
                return node
            step_val = s.value
        if len(it.args) == 1:
            start, stop = ast.Constant(value=0), it.args[0]
        else:
            start, stop = it.args[0], it.args[1]
        self.n += 1
        brk, cont = f"__bc_brk_{self.n}", f"__bc_cont_{self.n}"
        cn, sn = f"__bc_i_{self.n}", f"__bc_stop_{self.n}"
        tgt = node.target.id
        pre = ast.parse(f"{cn} = __START__\n{sn} = __STOP__").body
        pre[0].value = start
        pre[1].value = stop
        cmp_op = "<" if step_val > 0 else ">"
        test = ast.parse(f"{cn} {cmp_op} {sn}", mode="eval").body
        # counter increments BEFORE the guarded body so continue can't skip it
        body = ast.parse(f"{tgt} = {cn}\n{cn} = {cn} + ({step_val})").body \
            + list(node.body)
        return pre + self._flagged_while(test, body, brk, cont)


class _ControlFlowTransformer(ast.NodeTransformer):
    def __init__(self):
        self.counter = 0
        self._top = None

    def visit_FunctionDef(self, node):
        # transform the function being converted; don't descend into nested
        # function definitions (their control flow is theirs)
        if self._top is None:
            self._top = node
            self.generic_visit(node)
        return node

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node):
        return node

    def _fresh(self, base):
        self.counter += 1
        return f"__jst_{base}_{self.counter}"

    def visit_If(self, node):
        node = self.generic_visit(node)  # transform nested ifs first
        keys = _assigned(node.body) | _assigned(node.orelse)
        if not keys:
            return node  # pure side-effect if (prints etc.): leave it
        if _has_flow_escape(node.body + node.orelse):
            # return/break/continue in a branch: leave the python `if` as-is
            # (correct for python predicates; eagerly a tensor predicate is
            # read once, as the reference's concrete bool is)
            return node
        tname, fname, oname = (self._fresh("true"), self._fresh("false"),
                               self._fresh("out"))

        def branch(name, body):
            fn = ast.parse(f"def {name}(__jst_env):\n    pass").body[0]
            fn.body = (_load_prologue(keys) + (body or [ast.Pass()])
                       + [_return_epilogue(keys)])
            return fn

        one_sided = sorted(_assigned(node.body) ^ _assigned(node.orelse))
        call = ast.parse(
            f"{oname} = __jst.run_if(__jst_PRED__, {tname}, {fname}, "
            f"__jst.snapshot(locals(), {sorted(keys)!r}), "
            f"{one_sided!r})").body[0]
        call.value.args[0] = node.test  # splice the original predicate expr
        return ([branch(tname, node.body), branch(fname, node.orelse), call]
                + _rebind(keys, oname))

    def visit_For(self, node):
        """`for i in range(...)` desugars to the while machinery (reference
        loop_transformer.py for_loop handling). Subset: simple Name target,
        range() with 1-3 args (a step must be a literal int so its sign is
        static), no else/break/continue. Anything else stays python.

        The loop target is a body-local of the while: after a zero-iteration
        python range it stays unbound (python semantics); after a
        tensor-bound loop it is not readable (functional loops don't leak
        body temps — documented subset edge)."""
        it = node.iter
        if (node.orelse or _has_flow_escape(node.body)
                or not isinstance(node.target, ast.Name)
                or not isinstance(it, ast.Call)
                or not isinstance(it.func, ast.Name) or it.func.id != "range"
                or it.keywords or not 1 <= len(it.args) <= 3):
            return self.generic_visit(node)
        step_val = 1
        if len(it.args) == 3:
            s = it.args[2]
            if not (isinstance(s, ast.Constant) and isinstance(s.value, int)
                    and s.value != 0):
                return self.generic_visit(node)  # dynamic step sign: python
            step_val = s.value
        if len(it.args) == 1:
            start, stop = ast.Constant(value=0), it.args[0]
        else:
            start, stop = it.args[0], it.args[1]
        tgt = node.target.id
        self.counter += 1
        cn, sn = f"__d2s_c_{self.counter}", f"__d2s_stop_{self.counter}"
        cmp_op = "<" if step_val > 0 else ">"
        # range args hoisted to names: evaluated exactly once, like range()
        pre = ast.parse(f"{cn} = __START__\n{sn} = __STOP__").body
        pre[0].value = start
        pre[1].value = stop
        shell = ast.parse(
            f"while {cn} {cmp_op} {sn}:\n"
            f"    {tgt} = {cn}\n"
            f"    {cn} = {cn} + ({step_val})").body[0]
        # original (unvisited) body spliced in; visit_While transforms it once
        shell.body = shell.body[:1] + list(node.body) + shell.body[1:]
        converted = self.visit_While(shell)
        return pre + (converted if isinstance(converted, list) else [converted])

    def visit_While(self, node):
        node = self.generic_visit(node)
        if node.orelse:
            return node  # while/else: out of subset, leave untouched
        keys = _assigned(node.body) | (_reads(node.test) - {"__jst"})
        if not keys:
            return node
        if _has_flow_escape(node.body):
            return node  # python while stays; see visit_If note
        cname, bname, oname = (self._fresh("cond"), self._fresh("body"),
                               self._fresh("out"))
        cond_fn = ast.parse(f"def {cname}(__jst_env):\n    pass").body[0]
        cond_fn.body = _load_prologue(keys) + [
            ast.fix_missing_locations(ast.Return(value=node.test))]
        body_fn = ast.parse(f"def {bname}(__jst_env):\n    pass").body[0]
        body_fn.body = (_load_prologue(keys) + node.body
                        + [_return_epilogue(keys)])
        call = ast.parse(
            f"{oname} = __jst.run_while({cname}, {bname}, "
            f"__jst.snapshot(locals(), {sorted(keys)!r}))").body[0]
        return [cond_fn, body_fn, call] + _rebind(keys, oname)


class _JstNamespace:
    run_if = staticmethod(run_if)
    run_while = staticmethod(run_while)
    snapshot = staticmethod(_snapshot)
    MISSING = MISSING

    @staticmethod
    def missing(env, key):
        return key not in env or env[key] is MISSING

    @staticmethod
    def loop_cond(test, brk):
        """`test and not brk`, a tensor when either is one (break/continue
        flag loops)."""
        if _is_symbolic(test) or _is_symbolic(brk):
            t = torch.as_tensor(test).reshape(()).bool()
            b = torch.as_tensor(brk).reshape(()).bool()
            return torch.logical_and(t, torch.logical_not(b.to(t.device)))
        return bool(test) and not bool(brk)

    @staticmethod
    def not_(x):
        if _is_symbolic(x):
            return torch.logical_not(x)
        return not x


def convert_control_flow(fn):
    """AST-convert ``fn`` so tensor-dependent if/while/for and
    break/continue run through :func:`run_if` / :func:`run_while` (the
    ProgramTranslator entry point; ``jit.to_static`` applies it)."""
    try:
        src = textwrap.dedent(inspect.getsource(fn))
    except (OSError, TypeError):
        return fn  # no source (builtins, lambdas from REPL): nothing to do
    tree = ast.parse(src)
    fdef = tree.body[0]
    # drop decorators so applying @to_static(...) around this doesn't recurse
    fdef.decorator_list = []
    _BreakContinueTransformer().visit(fdef)
    ast.fix_missing_locations(tree)
    _ControlFlowTransformer().visit(fdef)
    ast.fix_missing_locations(tree)
    code = compile(tree, filename=f"<dy2static {fn.__name__}>", mode="exec")
    glb = dict(fn.__globals__)
    glb["__jst"] = _JstNamespace
    # exec can't recreate closures: splice the current cell values of the
    # original function's free variables in as globals
    if fn.__closure__:
        for name, cell in zip(fn.__code__.co_freevars, fn.__closure__):
            glb[name] = cell.cell_contents
    loc: dict = {}
    exec(code, glb, loc)  # noqa: S102 — compiling the user's own source
    out = loc[fdef.name]
    out = functools.wraps(fn)(out)
    out.__wrapped_original__ = fn
    return out
