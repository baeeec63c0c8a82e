"""``paddle_tpu_torch.analysis.tracecheck`` against
``paddle_tpu.analysis.tracecheck``: the same calls on each package's own
arrays — torch tensors through the port's CompileGuard and SyncTally, jax
arrays through the reference's — give the same counts, the same retrace
and donation verdicts and the same diff messages. The port's contract on
donation is read off ``_version`` and ``data_ptr``: a step that copies a
donated pool instead of writing it raises."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.analysis import tracecheck as jtc
from paddle_tpu_torch.analysis import hlocheck
from paddle_tpu_torch.analysis import tracecheck as ttc


def _arr(side, shape, dtype="float32"):
    if side == "jax":
        return jnp.zeros(shape, dtype)
    return torch.zeros(shape, dtype=getattr(torch, dtype))


def _mod(side):
    return jtc if side == "jax" else ttc


SIDES = ("jax", "torch")


@pytest.mark.parametrize("side", SIDES)
def test_guard_counts_signatures_not_calls(side):
    g = _mod(side).CompileGuard(lambda x: x * 2, "double", budget=2)
    for _ in range(3):
        g(_arr(side, (4,)))
    g(_arr(side, (8,)))
    assert (g.calls, g.traces, g.retraces, len(g.signatures)) == (4, 2, 0, 2)
    g(_arr(side, (3,)))  # over budget, not strict: counted, not raised
    assert (g.traces, g.retraces) == (3, 1)


def _retrace_message(side, make_args, *, static=()):
    """The port keys every Python scalar by value; the reference needs
    ``static_argnums`` for that."""
    m = _mod(side)
    kw = {"static_argnums": static} if side == "jax" and static else {}
    g = m.CompileGuard(lambda lhs, rhs: lhs, "mm", budget=1, strict=True,
                       **kw)
    g(*make_args(side, 0))
    with pytest.raises(m.RetraceError) as ei:
        g(*make_args(side, 1))
    assert g.traces == 1 and g.retraces == 1  # refused before running
    return str(ei.value)


@pytest.mark.parametrize("case", ["shape", "dtype", "static"])
def test_retrace_explanations_equal_reference(case):
    """The diff each package writes for the same change: the argument,
    the axis (``"axis 0: 2 -> 3"``), the dtype, the static value."""
    def make(side, i):
        if case == "shape":
            return (_arr(side, (4, 8 * (1 + i))),
                    _arr(side, ((2, 3)[i], 2)))
        if case == "dtype":
            return (_arr(side, (4,), ("int32", "float32")[i]),
                    _arr(side, (4,), "int32"))
        return (_arr(side, (8,)), (4, 6)[i])
    static = (1,) if case == "static" else ()
    msgs = {side: _retrace_message(side, make, static=static)
            for side in SIDES}
    for msg in msgs.values():
        assert "CompileGuard('mm')" in msg and "budget of 1" in msg
    diffs = {side: [d for d in msgs[side].split(": ", 1)[1].split("; ")]
             for side in SIDES}
    want = {"shape": ["axis 1: 8 -> 16", "axis 0: 2 -> 3"],
            "dtype": ["dtype int32 -> float32"],
            "static": ["static value 4 -> 6"]}[case]
    for w in want:
        assert all(w in m for m in msgs.values()), (w, msgs)
    assert ("rhs" in msgs["torch"]) == ("rhs" in msgs["jax"])
    assert diffs["torch"][-1].split(". ")[-1] == \
        diffs["jax"][-1].split(". ")[-1]  # "N other leaf(s) unchanged."


@pytest.mark.parametrize("side", SIDES)
def test_group_budget_and_strict_refusal(side):
    m = _mod(side)
    g = m.CompileGuard(lambda ids: ids * 2, "prefill", budget=4,
                       strict=True, group_by=lambda ids: tuple(ids.shape))
    g(_arr(side, (8,), "int32"))
    g(_arr(side, (16,), "int32"))  # a new bucket: allowed
    with pytest.raises(m.RetraceError) as ei:
        g(_arr(side, (8,), "float32"))  # same bucket, drifted dtype
    msg = str(ei.value)
    assert "group (8,)" in msg and "dtype int32 -> float32" in msg
    assert (g.traces, g.retraces) == (2, 1)
    for _ in range(2):  # a retried refused signature is one event
        with pytest.raises(m.RetraceError):
            g(_arr(side, (8,), "float32"))
    assert g.retraces == 1


@pytest.mark.parametrize("side", SIDES)
def test_double_donation_raises(side):
    m = _mod(side)
    if side == "jax":
        fn = lambda a, b: (a.at[0].set(1.0), b.at[0].set(2.0))  # noqa: E731
    else:
        def fn(a, b):
            a[0] = 1.0
            b[0] = 2.0
    g = m.CompileGuard(fn, "dd", donate_argnums=(0, 1), strict=True)
    x = _arr(side, (3,))
    with pytest.raises(m.DonationViolation) as ei:
        g(x, x)
    assert "double donation" in str(ei.value)


def test_view_of_the_same_storage_is_a_double_donation():
    pool = torch.zeros(2, 4)
    g = ttc.CompileGuard(lambda a, b: (a.add_(1), b.add_(1)), "views",
                         donate_argnums=(0, 1), strict=True)
    with pytest.raises(ttc.DonationViolation, match="same storage"):
        g(pool[0], pool[1])


def test_step_that_copies_its_pool_raises():
    """Writing a copy of a donated pool leaves the pool unwritten (two
    pools live): the strict guard, the donation audit and the step audit
    all refuse it; the in-place twin passes all three."""
    def copies(pool, i):
        pool = pool.clone()
        pool[i] = 1.0
        return pool

    def in_place(pool, i):
        pool[i] = 1.0
        return pool

    g = ttc.CompileGuard(copies, "scatter", donate_argnums=(0,),
                         strict=True)
    with pytest.raises(ttc.DonationViolation, match="not written in place"):
        g(torch.zeros(4, 2), 1)
    reports = ttc.donation_audit(copies, (0,), torch.zeros(4, 2), 1)
    assert len(reports) == 1 and "never consumed" in reports[0]
    with pytest.raises(hlocheck.AliasingViolation, match="pool"):
        hlocheck.audit(copies, (torch.zeros(4, 2), 1), name="scatter",
                       donate_argnums=(0,), budget=hlocheck.SINGLE_CHIP)
    ok = ttc.CompileGuard(in_place, "scatter", donate_argnums=(0,),
                          strict=True)
    ok(torch.zeros(4, 2), 1)
    assert ttc.donation_audit(in_place, (0,), torch.zeros(4, 2), 1) == []
    rep = hlocheck.audit(in_place, (torch.zeros(4, 2), 1),
                         donate_argnums=(0,), budget=hlocheck.SINGLE_CHIP)
    assert rep.aliased_leaves == rep.donated_leaves == 1


@pytest.mark.parametrize("side", SIDES)
def test_donation_audit_reports_unused_donated_leaf(side):
    m = _mod(side)
    if side == "jax":
        fn = lambda pool, dead: pool * 2  # noqa: E731
        ok = lambda pool: pool * 2  # noqa: E731
    else:
        def fn(pool, dead):
            return pool.mul_(2)

        def ok(pool):
            return pool.mul_(2)
    reports = m.donation_audit(fn, (0, 1), _arr(side, (3,)),
                               _arr(side, (4,)))
    assert len(reports) == 1 and "dead" in reports[0] \
        and "never consumed" in reports[0]
    assert m.donation_audit(ok, (0,), _arr(side, (3,))) == []


def _events(side):
    """The reference test's sync workload, in one package's ops."""
    m = _mod(side)
    with m.SyncTally() as t:
        if side == "jax":
            arr = jnp.arange(4)
            jnp.sum(arr)
            np.asarray(np.ones(2))
            np.asarray(arr)
            int(arr[0])
            arr[1].item()
            arr.tolist()
            total = sum(int(x) for x in jnp.arange(3))
        else:
            arr = torch.arange(4)
            torch.sum(arr)
            np.asarray(np.ones(2))
            np.asarray(arr)
            int(arr[0])
            arr[1].item()
            arr.tolist()
            total = sum(int(x) for x in torch.arange(3))
    assert total == 3
    return t


def test_sync_tally_counts_equal_reference():
    """Device compute and host-to-host copies are not reads; asarray,
    int(), .item(), .tolist() and iteration (plus each coercion inside
    the loop) are — the same events in the same order in both."""
    j, t = _events("jax"), _events("torch")
    assert t.events == j.events == ["np.asarray", "int", "item", "tolist",
                                    "iter", "int", "int", "int"]
    before = t.count
    torch.zeros(2).tolist()  # patches removed on exit
    assert t.count == before


def test_sync_tally_counts_host_copies_once():
    with ttc.SyncTally() as t:
        x = torch.arange(3)
        x.numpy()
        x.cpu()
        x.to("cpu")
        x.to(torch.float64)  # a dtype cast is no copy to the host
        np.asarray(x)        # __array__ -> numpy(): one event
    assert t.events == ["numpy", "cpu", "to_cpu", "np.asarray"]


@pytest.mark.parametrize("side", SIDES)
def test_sync_tally_nests_pauses_and_enforces_allowance(side):
    m = _mod(side)

    def read():
        np.asarray(_arr(side, (2,)))
    with m.SyncTally() as outer:
        with m.SyncTally() as inner:
            read()
        with m.sync_tally_paused():
            read()
        read()
    assert inner.count == 1 and outer.count == 2
    with pytest.raises(m.SyncViolation) as ei:
        with m.SyncTally(allowed=1, name="decode"):
            read()
            read()
    assert "decode" in str(ei.value) and "allows 1" in str(ei.value)


def test_abstract_signature_keys_tensors_and_scalars():
    sig = ttc.abstract_signature(
        (torch.zeros(2, 3, dtype=torch.int32), 4, [torch.ones(1)], None),
        param_names=("ctx", "n", "pools", "scales"))
    assert sig == (
        ("ctx", ("tensor", (2, 3), "int32", "cpu")),
        ("n", ("static", "4")),
        ("pools[0]", ("tensor", (1,), "float32", "cpu")),
        ("scales", ("static", "None")))
    other = ttc.abstract_signature(
        (torch.zeros(3, 3, dtype=torch.int32), 4, [torch.ones(1)], None),
        param_names=("ctx", "n", "pools", "scales"))
    assert ttc.explain_signature_diff(sig, other) == [
        "ctx: shape (2, 3) -> (3, 3) (axis 0: 2 -> 3)"]
