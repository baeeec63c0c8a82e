"""meshcheck: topology-aware collective placement — the port of
``paddle_tpu/analysis/meshcheck.py``.

hlocheck's census says how many collectives a step issues and how many
bytes; it does not say which link each one rides. This module places
them on a declared topology:

1. **Topology** — :class:`MeshTopology` binds a :class:`Cluster` (hosts x
   cards a host, the two links' rates) to an ordered tuple of named
   logical mesh axes in rank-major C order (the last axis varies
   fastest).
2. **Attribution** — each collective's participant groups (the ranks of
   its process group, recorded by the census) are matched against the
   groups each axis subset would form. A collective the topology cannot
   explain is refused.
3. **Medium** — each attributed axis is classified by its real rank
   groups: within one host, or across hosts (failing closed to "across").
   The gauges keep the reference's names: ``ici`` is the link within a
   host (NVLink 4 between H100s) and ``dcn`` the network between hosts
   (a 400 Gb/s NIC a GPU). :class:`CollectiveBudget`'s per-medium arms
   are enforced in :meth:`MeshReport.check`.
4. **Link-time model** — predicted collective seconds a step from bytes
   over the link's rate with the ring factors (an all-reduce moves
   ``2 (g - 1) / g`` of its payload a rank) plus a latency a hop.

The cluster facts (:data:`DEVICE_SPECS`) are the H100's data-sheet
figures, never a TPU's. Two ranks sharing one card (the gloo path the
port's smoke run takes) is a single-host topology of two ranks: its
*predicted* time is NVLink's, and the measured gloo time, which stages
every payload through the host, is far above it.

The engine feeds this at its first-call audit under ``debug_checks``:
``serving_ici_bytes_per_token`` / ``serving_dcn_bytes_per_token`` /
``serving_collective_time_predicted_s``. ``python -m
paddle_tpu_torch.analysis meshcheck`` certifies the registry entries.
"""
from __future__ import annotations

import itertools
import json
import math
import os
from dataclasses import dataclass, field, replace

from .hlocheck import (CollectiveBudget, CollectiveBudgetError, CollectiveOp,
                       HloCheckError, _fmt_bytes)

__all__ = ["Cluster", "DEVICE_SPECS", "MeshTopology", "MeshCheckError",
           "single_host_topology", "multi_host_topology", "attribute",
           "predicted_seconds", "MeshRow", "MeshReport", "analyze",
           "bank_path", "record", "diff_banked", "MESH_REGISTRY",
           "run_entry", "main"]


class MeshCheckError(HloCheckError):
    """A placement audit failed: a collective the declared topology cannot
    attribute to any axis subset, a topology that does not cover its
    cluster, or a drifted bank."""


# ----------------------------------------------------------------- cluster
#: per-card facts. "h100": NVIDIA H100 SXM5 data sheet — NVLink 4, 900
#: GB/s a card in both directions together (450 GB/s each way, the rate
#: a ring step moves at); latency a hop 2 us (NCCL's order for one
#: NVLink hop)
DEVICE_SPECS: dict[str, dict] = {
    "h100": dict(peak_flops=989e12, hbm_bytes=80e9, hbm_bandwidth=3.35e12,
                 ici_bandwidth=450e9, ici_latency=2e-6),
}


@dataclass
class Cluster:
    """hosts x cards a host, NVLink within a host (``ici``), the network
    across hosts (``dcn``). ``dcn_bandwidth`` is a host's NIC rate in
    bytes/s, by default a 400 Gb/s ConnectX-7 a GPU (a DGX H100's eight
    give 3.2 Tb/s a host), shared by the host's cards; ``dcn_latency``
    5 us (an InfiniBand NDR round)."""
    accelerator_type: str = "h100"
    n_hosts: int = 1
    chips_per_host: int = 8
    dcn_bandwidth: float | None = None  # None: 50e9 bytes/s a card
    dcn_latency: float = 5e-6

    def __post_init__(self):
        if self.dcn_bandwidth is None:
            self.dcn_bandwidth = 50e9 * self.chips_per_host

    @property
    def n_chips(self) -> int:
        return self.n_hosts * self.chips_per_host

    def device(self, key: str) -> float:
        return DEVICE_SPECS[self.accelerator_type][key]

    def host_of(self, rank: int) -> int:
        return rank // self.chips_per_host

    def axis_medium(self, group_size: int, stride: int = 1,
                    groups=None) -> str:
        """'ici' when every group (given, or the strided tiling of the
        cluster) lives inside one host, else 'dcn'; no group at all fails
        closed to 'dcn'."""
        if groups is None:
            groups = (
                [base + i * stride for i in range(group_size)]
                for base in range(self.n_chips)
                if (base // stride) % group_size == 0
                and base + (group_size - 1) * stride < self.n_chips)
        checked = False
        for g in groups:
            checked = True
            if len({self.host_of(int(r)) for r in g}) > 1:
                return "dcn"
        return "ici" if checked else "dcn"


# --------------------------------------------------------------- topology
@dataclass(frozen=True)
class MeshTopology:
    """hosts x cards a host x named logical axes: ``axes`` is the ordered
    ``(name, size)`` tuple, rank-major C order (axis ``i``'s stride is the
    product of the sizes after it). The sizes must multiply out to the
    cluster's card count."""
    cluster: Cluster
    axes: tuple = ()

    def __post_init__(self):
        n = 1
        for _, s in self.axes:
            if int(s) < 1:
                raise MeshCheckError(f"axis sizes must be >= 1: {self.axes}")
            n *= int(s)
        if n != self.cluster.n_chips:
            raise MeshCheckError(
                f"topology axes {self.axes} cover {n} ranks but the "
                f"cluster has {self.cluster.n_chips} cards "
                f"({self.cluster.n_hosts} host(s) x "
                f"{self.cluster.chips_per_host}/host) — the declared mesh "
                f"must tile the whole cluster")
        names = [a for a, _ in self.axes]
        if len(set(names)) != len(names):
            raise MeshCheckError(f"duplicate axis names: {names}")

    @property
    def n_devices(self) -> int:
        return math.prod(int(s) for _, s in self.axes)

    @property
    def axis_names(self) -> tuple:
        return tuple(a for a, _ in self.axes)

    def axis_size(self, name: str) -> int:
        for a, s in self.axes:
            if a == name:
                return int(s)
        raise KeyError(name)

    def _strides(self) -> tuple:
        strides, acc = [], 1
        for _, s in reversed(self.axes):
            strides.append(acc)
            acc *= int(s)
        return tuple(reversed(strides))

    def subset_groups(self, names) -> tuple:
        """Rank groups of a collective over the axis subset ``names``:
        each group varies those axes and pins the rest."""
        names = tuple(names)
        for n in names:
            self.axis_size(n)  # KeyError on an unknown axis
        sizes = [int(s) for _, s in self.axes]
        strides = self._strides()
        varying = [i for i, (a, _) in enumerate(self.axes) if a in names]
        pinned = [i for i in range(len(self.axes)) if i not in varying]
        groups = []
        for pin in itertools.product(*(range(sizes[i]) for i in pinned)):
            base = sum(p * strides[i] for i, p in zip(pinned, pin))
            groups.append(tuple(sorted(
                base + sum(v * strides[i] for i, v in zip(varying, var))
                for var in itertools.product(
                    *(range(sizes[i]) for i in varying)))))
        return tuple(sorted(groups))

    def medium_of(self, names) -> str:
        groups = self.subset_groups(tuple(names))
        return self.cluster.axis_medium(len(groups[0]) if groups else 0,
                                        groups=groups)

    def describe(self) -> str:
        ax = " x ".join(f"{a}={s}" for a, s in self.axes) or "(scalar)"
        return (f"{self.cluster.accelerator_type} "
                f"{self.cluster.n_hosts}h x {self.cluster.chips_per_host}c "
                f"[{ax}]")


def single_host_topology(degree: int, axis: str = "tp",
                         accelerator_type: str = "h100") -> MeshTopology:
    """One host of ``degree`` cards, one tensor-parallel axis: everything
    rides NVLink, so a zero-DCN budget binds (a misattributed group fails
    closed to 'dcn' and trips it)."""
    return MeshTopology(Cluster(accelerator_type=accelerator_type,
                                n_hosts=1, chips_per_host=degree),
                        ((axis, degree),))


def multi_host_topology(n_hosts: int, chips_per_host: int, axes,
                        accelerator_type: str = "h100",
                        **cluster_kw) -> MeshTopology:
    """A multi-host mesh: an axis whose groups straddle the
    ``chips_per_host`` boundary classifies DCN."""
    return MeshTopology(
        Cluster(accelerator_type=accelerator_type, n_hosts=n_hosts,
                chips_per_host=chips_per_host, **cluster_kw),
        tuple((str(a), int(s)) for a, s in axes))


# ------------------------------------------------------------- attribution
def _normalize_groups(groups) -> tuple:
    return tuple(sorted(tuple(sorted(int(r) for r in g)) for g in groups))


def attribute(op: CollectiveOp, topology: MeshTopology):
    """``(axis_label, medium, group_size)`` of one collective — the axis
    name, ``"a+b"`` for a joint reduce or ``"global"`` for a collective
    that named no group — or None when the topology cannot explain its
    groups (the caller refuses to certify)."""
    n = topology.n_devices
    every = tuple(range(n))
    groups = _normalize_groups(op.replica_groups)
    if not groups:
        return "global", topology.cluster.axis_medium(n, groups=(every,)), n
    names = topology.axis_names
    for r in range(1, len(names) + 1):
        for subset in itertools.combinations(names, r):
            if groups == topology.subset_groups(subset):
                return ("+".join(subset), topology.medium_of(subset),
                        len(groups[0]))
    if groups == (every,):
        return "global", topology.cluster.axis_medium(n, groups=(every,)), n
    return None


# --------------------------------------------------------- link-time model
# ring traffic factors: share of the payload each rank moves, and latency
# hops, per collective
_TIME_MODEL = {
    "all-reduce": (lambda g: 2 * (g - 1) / g, lambda g: 2 * (g - 1)),
    "all-gather": (lambda g: (g - 1) / g, lambda g: g - 1),
    "reduce-scatter": (lambda g: (g - 1) / g, lambda g: g - 1),
    "all-to-all": (lambda g: (g - 1) / g, lambda g: g - 1),
    "collective-permute": (lambda g: 1.0, lambda g: 1),
    "collective-broadcast": (lambda g: 1.0, lambda g: g - 1),
}


def predicted_seconds(kind: str, nbytes: int, group_size: int,
                      medium: str, cluster: Cluster) -> float:
    """Wall time of one collective on its link: ring bytes over the
    link's rate plus hops x the link's latency. Across hosts a card gets
    its share of the host's NIC (``dcn_bandwidth / chips_per_host``)."""
    g = max(int(group_size), 1)
    if g == 1:
        return 0.0  # a self-group moves nothing
    bytes_f, hops_f = _TIME_MODEL.get(kind, (lambda g: 1.0, lambda g: 1))
    if medium == "ici":
        bw, lat = cluster.device("ici_bandwidth"), cluster.device(
            "ici_latency")
    else:
        bw = cluster.dcn_bandwidth / cluster.chips_per_host
        lat = cluster.dcn_latency
    return bytes_f(g) * nbytes / bw + hops_f(g) * lat


# ------------------------------------------------------------------ report
@dataclass(frozen=True)
class MeshRow:
    """One collective, placed."""
    kind: str
    nbytes: int
    axis: str | None
    medium: str | None
    group_size: int
    group_count: int
    predicted_s: float
    instr: str


@dataclass(frozen=True)
class MeshReport:
    """Per-medium roll-up of one step's collectives on one topology."""
    name: str
    topology: MeshTopology = field(repr=False)
    rows: tuple = ()

    @property
    def unattributed(self) -> tuple:
        return tuple(r for r in self.rows if r.axis is None)

    def _bytes(self, medium: str) -> int:
        return sum(r.nbytes for r in self.rows if r.medium == medium)

    def _ops(self, medium: str) -> int:
        return sum(1 for r in self.rows if r.medium == medium)

    @property
    def ici_bytes(self) -> int:
        return self._bytes("ici")

    @property
    def dcn_bytes(self) -> int:
        return self._bytes("dcn")

    @property
    def ici_ops(self) -> int:
        return self._ops("ici")

    @property
    def dcn_ops(self) -> int:
        return self._ops("dcn")

    @property
    def predicted_s(self) -> float:
        return sum(r.predicted_s for r in self.rows)

    @property
    def axis_media(self) -> dict:
        return {r.axis: r.medium for r in self.rows if r.axis is not None}

    def check(self, budget: CollectiveBudget) -> "MeshReport":
        """Enforce the per-medium arms of ``budget``: MeshCheckError when a
        collective went unattributed, CollectiveBudgetError (naming the
        axis, the medium and the bytes) when a cap is breached."""
        bad = self.unattributed
        if bad:
            lines = "; ".join(f"{r.kind} {r.instr} groups x{r.group_count}"
                              for r in bad[:4])
            raise MeshCheckError(
                f"meshcheck({self.name!r}): {len(bad)} collective(s) the "
                f"declared topology {self.topology.describe()} cannot "
                f"attribute to any axis subset: {lines}")
        for medium, cap in (("dcn", budget.max_dcn_bytes),
                            ("ici", budget.max_ici_bytes)):
            if cap is None:
                continue
            measured = self._bytes(medium)
            if measured > cap:
                axes = sorted({r.axis for r in self.rows
                               if r.medium == medium})
                raise CollectiveBudgetError(
                    f"meshcheck({self.name!r}): axis "
                    f"{'+'.join(axes)!r} rides {medium.upper()} — "
                    f"{self._ops(medium)} collective(s), {measured} bytes "
                    f"({_fmt_bytes(measured)}) > max_{medium}_bytes={cap} "
                    f"on topology {self.topology.describe()}")
        if budget.max_dcn_ops is not None and \
                self.dcn_ops > budget.max_dcn_ops:
            axes = sorted({r.axis for r in self.rows if r.medium == "dcn"})
            raise CollectiveBudgetError(
                f"meshcheck({self.name!r}): axis {'+'.join(axes)!r} rides "
                f"DCN — {self.dcn_ops} collective(s) > max_dcn_ops="
                f"{budget.max_dcn_ops} ({self.dcn_bytes} bytes across the "
                f"host boundary) on topology {self.topology.describe()}")
        return self

    def summary(self) -> str:
        head = (f"meshcheck {self.name!r} on {self.topology.describe()}: "
                f"{len(self.rows)} collective(s) — "
                f"ici {self.ici_ops} op(s)/{_fmt_bytes(self.ici_bytes)}, "
                f"dcn {self.dcn_ops} op(s)/{_fmt_bytes(self.dcn_bytes)}, "
                f"predicted {self.predicted_s * 1e6:.1f} us/step")
        return head


def analyze(collectives, topology: MeshTopology,
            name: str = "step") -> MeshReport:
    """Place every collective of one step on the declared topology."""
    rows = []
    for op in collectives:
        placed = attribute(op, topology)
        if placed is None:
            rows.append(MeshRow(op.kind, op.nbytes, None, None, 0,
                                op.group_count, 0.0, op.instr))
            continue
        axis, medium, group_size = placed
        rows.append(MeshRow(
            op.kind, op.nbytes, axis, medium, group_size,
            op.group_count or 1,
            predicted_seconds(op.kind, op.nbytes, group_size, medium,
                              topology.cluster), op.instr))
    return MeshReport(name=name, topology=topology, rows=tuple(rows))


# -------------------------------------------------------------------- bank
#: structural keys pinned exactly by the bank; the modeled seconds may
#: drift 25% before warning
ANALYTIC_KEYS = ("collectives", "ici_bytes", "dcn_bytes", "ici_ops",
                 "dcn_ops", "axes")


def bank_path() -> str:
    """``paddle_tpu_torch/analysis/meshcheck_bank.json``."""
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "meshcheck_bank.json")


def record(report: MeshReport) -> dict:
    return {"topology": report.topology.describe(),
            "collectives": len(report.rows),
            "ici_bytes": report.ici_bytes, "dcn_bytes": report.dcn_bytes,
            "ici_ops": report.ici_ops, "dcn_ops": report.dcn_ops,
            "axes": dict(sorted(report.axis_media.items())),
            "predicted_s": round(report.predicted_s, 9)}


def diff_banked(records: dict, banked: dict) -> list[str]:
    """Drift of fresh records against the bank: ``"error: ..."`` for a
    structural key that moved or a missing entry, ``"warn: ..."`` for the
    modeled seconds beyond 25%."""
    out = []
    for name, rec in sorted(records.items()):
        old = banked.get(name)
        if old is None:
            out.append(f"error: {name}: no banked placement — run `python "
                       f"-m paddle_tpu_torch.analysis meshcheck --bank`")
            continue
        for key in ANALYTIC_KEYS:
            if rec.get(key) != old.get(key):
                out.append(f"error: {name}: {key} drifted from banked "
                           f"{old.get(key)!r} to {rec.get(key)!r}")
        new_s, old_s = rec.get("predicted_s", 0.0), old.get("predicted_s")
        if old_s is not None and not math.isclose(
                new_s, old_s, rel_tol=0.25, abs_tol=1e-12):
            out.append(f"warn: {name}: predicted_s drifted {old_s:.3e} -> "
                       f"{new_s:.3e} (>25%)")
    return out


# ----------------------------------------------------------------- registry
def _all_ici_budget(base: CollectiveBudget) -> CollectiveBudget:
    """1-host contract: every byte rides NVLink, the DCN arms are ZERO."""
    return replace(base, max_ici_bytes=base.max_collective_bytes,
                   max_dcn_bytes=0, max_dcn_ops=0)


def _all_dcn_budget(base: CollectiveBudget) -> CollectiveBudget:
    """2-host x 1-card contract: the tp axis has no intra-host pair, so
    every collective classifies DCN under the step's own caps."""
    ops = (base.all_reduce + base.all_gather + base.reduce_scatter
           + base.collective_permute + base.all_to_all
           + base.collective_broadcast)
    return replace(base, max_ici_bytes=0,
                   max_dcn_bytes=base.max_collective_bytes, max_dcn_ops=ops)


@dataclass(frozen=True)
class MeshStepSpec:
    """An hlocheck registry step placed on a declared topology, with its
    per-medium budget derived from the step's own budget."""
    name: str
    doc: str
    hlo_step: str
    topology: object = field(repr=False)   # () -> MeshTopology
    budget: object = field(repr=False)     # (base budget) -> budget


MESH_REGISTRY: dict = {s.name: s for s in (
    MeshStepSpec("tp2_engine_prefill_1host",
                 "TP=2 prefill on one host: 2L+1 all-reduces on axis "
                 "'tp', all NVLink, DCN=0 binding", "tp2_engine_prefill",
                 lambda: single_host_topology(2), _all_ici_budget),
    MeshStepSpec("tp2_engine_decode_1host",
                 "TP=2 decode on one host: DCN=0 binding",
                 "tp2_engine_decode", lambda: single_host_topology(2),
                 _all_ici_budget),
    MeshStepSpec("tp2_engine_verify_spec_1host",
                 "TP=2 verify on one host: the proposer adds nothing",
                 "tp2_engine_verify_spec", lambda: single_host_topology(2),
                 _all_ici_budget),
    MeshStepSpec("tp2_engine_decode_2host",
                 "the same TP=2 decode declared on 2 hosts x 1 card: axis "
                 "'tp' crosses the host boundary, every all-reduce rides "
                 "the network", "tp2_engine_decode",
                 lambda: multi_host_topology(2, 1, (("tp", 2),)),
                 _all_dcn_budget),
)}


def run_entry(name: str, audited=None):
    """hlocheck-audit the entry's step (its own budget enforced first:
    meshcheck never weakens that gate), place it on the declared topology
    and enforce the per-medium budget derived from the step's. ``audited``:
    the step's ``(report, budget)`` already made (``hlocheck.run_step``).
    Returns the MeshReport."""
    from . import hlocheck

    spec = MESH_REGISTRY.get(name)
    if spec is None:
        raise KeyError(f"unknown meshcheck entry {name!r} "
                       f"(have: {', '.join(MESH_REGISTRY)})")
    report, base = audited or hlocheck.run_step(spec.hlo_step)
    mesh = analyze(report.collectives, spec.topology(), name=name)
    return mesh.check(spec.budget(base))


def main(argv=None, audits: dict | None = None) -> int:
    """``audits``: hlocheck's ``run_steps`` results already made in this
    process (``check_all`` passes hlocheck's); the steps missing from it
    are audited here, all in one ``run_steps`` call."""
    import argparse

    from . import hlocheck

    parser = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.analysis meshcheck",
        description="Topology-aware collective placement: attribute every "
                    "collective to its mesh axis, classify NVLink vs the "
                    "network, enforce per-medium budgets, bank the "
                    "link-time model.")
    parser.add_argument("--step", action="append", default=None,
                        metavar="NAME")
    parser.add_argument("--list-steps", action="store_true")
    parser.add_argument("--bank", action="store_true",
                        help="(re)write the bank from this run")
    args = parser.parse_args(argv)
    if args.list_steps:
        for s in MESH_REGISTRY.values():
            print(f"{s.name}  {s.doc}")
        return 0
    names = args.step or list(MESH_REGISTRY)
    unknown = [n for n in names if n not in MESH_REGISTRY]
    if unknown:
        print(f"unknown entry(s): {', '.join(unknown)}")
        return 2
    profile = bank_path()
    failed = 0
    records: dict = {}
    audits = {} if audits is None else audits
    steps = list(dict.fromkeys(MESH_REGISTRY[n].hlo_step for n in names))
    audits.update(hlocheck.run_steps([s for s in steps if s not in audits]))
    for name in names:
        spec = MESH_REGISTRY[name]
        try:
            audited = audits[spec.hlo_step]
            if isinstance(audited, Exception):
                raise audited
            mesh = run_entry(name, audited)
            print(mesh.summary())
            records[name] = record(mesh)
        except Exception as e:  # noqa: BLE001 — the sweep goes on
            print(f"FAIL {name}: {type(e).__name__}: {e}")
            failed += 1
    if args.bank:
        if failed:
            print("not banking: violations above")
        else:
            merged = dict(records)
            if os.path.exists(profile):
                with open(profile) as fh:
                    merged = {**json.load(fh), **records}
            with open(profile, "w") as fh:
                json.dump(dict(sorted(merged.items())), fh, indent=2,
                          sort_keys=True)
                fh.write("\n")
            print(f"banked {len(records)} placement(s) -> {profile}")
    elif records:
        if not os.path.exists(profile):
            print(f"no banked placements at {profile} — run --bank")
            failed += len(records)
        else:
            with open(profile) as fh:
                banked = json.load(fh)
            for line in diff_banked(records, banked):
                print(line)
                failed += line.startswith("error")
    if failed:
        print(f"{failed} entry(s) in violation")
    else:
        print(f"meshcheck clean: {len(names)} entry(s) within per-medium "
              f"budget")
    return 1 if failed else 0
