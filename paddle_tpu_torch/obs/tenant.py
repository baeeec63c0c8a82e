"""Per-tenant SLO classes and the goodput/badput ledger — the port of
``paddle_tpu/obs/tenant.py``.

A **tenant** is a traffic class sharing one engine: "interactive" and
"batch" workloads with different TTFT/TPOT promises, or distinct
customers behind one deployment. This module declares the classes
(:class:`TenantSLO` — per-tenant p99 targets) and keeps the books
(:class:`TenantLedger`): every retirement is classified into exactly ONE
of the seven terminal classes

    in_slo     finished inside both targets (or no targets declared)
    ttft_late  finished, but time-to-first-token exceeded the target
    tpot_late  finished inside TTFT, but per-token time exceeded its target
    shed       dropped from a full queue before ever being admitted
    expired    retired by its deadline sweep
    cancelled  retired by engine.cancel()
    failed     retired by an injected or real step fault

and the request's emitted tokens accrue to that class — goodput is the
``in_slo`` token stream, badput everything else, and the per-class token
totals reconcile EXACTLY with the engine's ``serving_tokens_total``
(every emitted token lands in one class at retirement, including tokens
a recompute preemption re-emitted — both sides count the re-emission).

**Observe-only**: the ledger classifies and accounts; weighted admission
by tenant is the fleet router's (``serving/fleet.py``). The
burn-rate watchdog rule ``slo_burn`` (``alerts.py``) windows the per-tenant
violation fraction the ledger exposes through
:meth:`TenantLedger.burn_totals` — host ints only.

SLO-violation semantics for the burn rate: ``ttft_late`` / ``tpot_late``
/ ``shed`` / ``expired`` / ``failed`` count as violations (the tenant
asked for work and the promise broke); ``cancelled`` does not (the
client withdrew), and ``in_slo`` obviously not.

Imports nothing from ``paddle_tpu_torch.serving`` — serving imports us.
"""
from __future__ import annotations

from dataclasses import dataclass

__all__ = ["CLASSES", "TENANT_CLASSES", "VIOLATION_CLASSES", "TenantSLO",
           "TenantLedger", "check_tenant_name", "tenant_table"]

#: the seven terminal classes — the pre-seeded label set of
#: ``serving_tenant_retired_total{tenant=,class=}``
CLASSES = ("in_slo", "ttft_late", "tpot_late", "shed", "expired",
           "cancelled", "failed")
TENANT_CLASSES = CLASSES  # the package-level export name

#: classes the slo_burn watchdog counts as SLO violations
VIOLATION_CLASSES = frozenset(
    {"ttft_late", "tpot_late", "shed", "expired", "failed"})

# tenant names become metric-registry label values (``{tenant=<name>}``
# keys) and Chrome track names — the registry-key convention reserves
# ``{ } , =`` and quotes, so names are confined to a safe identifier set
_NAME_OK = frozenset(
    "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_.-")


def check_tenant_name(name) -> str:
    """Validate a tenant name for use as a metric label value; returns
    it. Raises ValueError on anything that would corrupt the
    ``base{tenant=value}`` registry-key convention."""
    if not isinstance(name, str) or not name:
        raise ValueError(f"tenant name must be a non-empty str, got "
                         f"{name!r}")
    if len(name) > 64:
        raise ValueError(f"tenant name {name[:20]!r}... exceeds 64 chars")
    bad = set(name) - _NAME_OK
    if bad:
        raise ValueError(
            f"tenant name {name!r} contains {sorted(bad)} — allowed: "
            f"letters, digits, '_', '.', '-' (names become metric label "
            f"values and Chrome track names)")
    return name


@dataclass(frozen=True)
class TenantSLO:
    """One tenant class's latency promise: p99 targets for time-to-first-
    token and per-output-token time, in engine-clock seconds."""
    ttft_p99_s: float
    tpot_p99_s: float

    def validate(self) -> None:
        for field in ("ttft_p99_s", "tpot_p99_s"):
            v = getattr(self, field)
            if not (isinstance(v, (int, float)) and v > 0):
                raise ValueError(f"TenantSLO.{field} must be > 0, "
                                 f"got {v!r}")


class TenantLedger:
    """The per-tenant books: classification + token accrual per class.
    Pure host state (dicts of ints) — the engine feeds it once per
    retirement and the watchdog reads the monotonic totals."""

    def __init__(self, slos: dict | None = None):
        self.slos: dict[str, TenantSLO] = dict(slos or {})
        for name, slo in self.slos.items():
            check_tenant_name(name)
            slo.validate()
        # tenant -> {"retired": {class: n}, "tokens": {class: n}}
        self._books: dict[str, dict] = {}
        self.ensure("default")
        for name in self.slos:
            self.ensure(name)

    def ensure(self, tenant: str) -> None:
        """Open the (zeroed) books for a tenant."""
        if tenant not in self._books:
            self._books[tenant] = {
                "retired": {c: 0 for c in CLASSES},
                "tokens": {c: 0 for c in CLASSES},
            }

    def tenants(self) -> list[str]:
        """Every tenant with open books, declared-first order."""
        return list(self._books)

    def classify(self, tenant: str, state: str, ttft, tpot) -> str:
        """The terminal class of one retirement. Non-finished states map
        to their own class; a finished request checks the tenant's
        targets (no declared SLO — including the implicit ``default``
        tenant — finishes ``in_slo``)."""
        if state != "finished":
            if state not in CLASSES:
                raise ValueError(f"unknown terminal state {state!r}")
            return state
        slo = self.slos.get(tenant)
        if slo is None:
            return "in_slo"
        if ttft is not None and ttft > slo.ttft_p99_s:
            return "ttft_late"
        if tpot is not None and tpot > slo.tpot_p99_s:
            return "tpot_late"
        return "in_slo"

    def on_retire(self, tenant: str, state: str, ttft, tpot,
                  tokens: int) -> str:
        """Account one retirement: classify, bump the class's retirement
        count, accrue its emitted tokens. Returns the class."""
        self.ensure(tenant)
        cls = self.classify(tenant, state, ttft, tpot)
        book = self._books[tenant]
        book["retired"][cls] += 1
        book["tokens"][cls] += int(tokens)
        return cls

    # ----------------------------------------------------------- read side
    def burn_totals(self) -> dict[str, tuple[int, int]]:
        """{tenant: (violation retirements, total retirements)} — the
        monotonic host ints the slo_burn watchdog windows over."""
        out = {}
        for tenant, book in self._books.items():
            retired = book["retired"]
            total = sum(retired.values())
            violations = sum(retired[c] for c in CLASSES
                             if c in VIOLATION_CLASSES)
            out[tenant] = (violations, total)
        return out

    def token_totals(self) -> dict[str, dict[str, int]]:
        """{tenant: {class: tokens}} — the reconciliation surface: summed
        over everything, equals every emitted token of every RETIRED
        request, each counted exactly once."""
        return {t: dict(b["tokens"]) for t, b in self._books.items()}

    def rollup(self, hists: dict | None = None) -> dict:
        """The per-tenant flight-record section: class counts, token
        totals, goodput fraction, declared targets, and (when the caller
        passes the serving histogram families) observed p99s."""
        out = {}
        for tenant, book in self._books.items():
            tokens = book["tokens"]
            good = tokens["in_slo"]
            bad = sum(v for c, v in tokens.items() if c != "in_slo")
            entry = {
                "retired": dict(book["retired"]),
                "tokens": dict(tokens),
                "goodput_tokens": good,
                "badput_tokens": bad,
                "goodput_fraction": good / (good + bad)
                if good + bad else None,
            }
            slo = self.slos.get(tenant)
            if slo is not None:
                entry["slo"] = {"ttft_p99_s": slo.ttft_p99_s,
                                "tpot_p99_s": slo.tpot_p99_s}
            for key, fam in (hists or {}).items():
                child = fam.children().get(tenant)
                if child is not None:
                    entry[f"{key}_p99"] = child.percentile(0.99)
            out[tenant] = entry
        return out


def tenant_table(tenants: dict, header: bool = True) -> str:
    """Fixed-width per-tenant table from a rollup (live or out of a
    flight record): goodput %, observed TTFT/TPOT p99, and the badput
    breakdown by class — the CLI's ``--tenant-table`` view."""
    def pct(v):
        return f"{100.0 * v:>7.1f}%" if isinstance(v, (int, float)) \
            else f"{'-':>8}"

    def sec(v):
        return f"{v:>10.4f}" if isinstance(v, (int, float)) \
            else f"{'-':>10}"

    rows = []
    if header:
        rows.append(f"{'tenant':>12} {'goodput':>8} {'tokens':>8} "
                    f"{'ttft_p99':>10} {'tpot_p99':>10}  badput breakdown")
    for name in sorted(tenants):
        e = tenants[name]
        tokens = e.get("tokens", {})
        bad = ", ".join(f"{c}={tokens[c]}" for c in CLASSES
                        if c != "in_slo" and tokens.get(c))
        retired = e.get("retired", {})
        bad_retired = ", ".join(
            f"{c}:{retired[c]}" for c in CLASSES
            if c != "in_slo" and retired.get(c))
        breakdown = bad or bad_retired or "-"
        total = sum(tokens.values()) if tokens else 0
        rows.append(f"{name:>12} {pct(e.get('goodput_fraction'))} "
                    f"{total:>8} {sec(e.get('ttft_s_p99'))} "
                    f"{sec(e.get('tpot_s_p99'))}  {breakdown}")
    return "\n".join(rows)
