"""``paddle_tpu_torch.analysis.meshcheck`` against
``paddle_tpu.analysis.meshcheck``: the same topologies and the same
collectives give the same rank groups, the same attribution (axis, medium,
group size), the same per-medium budget verdicts and — on a cluster whose
link figures are set equal in both — the same link-time predictions. The
port's cluster facts are the H100's (NVLink within a host, a 400 Gb/s NIC
a GPU across hosts); the engine-level placement is held in
``tests/test_torch_hlocheck_tp.py``."""
import itertools
import json

import pytest

from paddle_tpu.analysis import hlocheck as jhc
from paddle_tpu.analysis import meshcheck as jmc
from paddle_tpu_torch.analysis import hlocheck as thc
from paddle_tpu_torch.analysis import meshcheck as tmc

TOPOLOGIES = [
    (1, 2, (("tp", 2),)),
    (1, 8, (("dp", 2), ("tp", 4))),
    (2, 4, (("dp", 2), ("tp", 4))),
    (2, 1, (("tp", 2),)),
    (4, 2, (("pp", 2), ("dp", 2), ("tp", 2))),
]


def _pair(hosts, per_host, axes):
    return (jmc.multi_host_topology(hosts, per_host, axes),
            tmc.multi_host_topology(hosts, per_host, axes))


@pytest.mark.parametrize("topo", TOPOLOGIES, ids=str)
def test_groups_and_media_equal_reference(topo):
    ref, mine = _pair(*topo)
    assert mine.n_devices == ref.n_devices
    names = mine.axis_names
    for r in range(1, len(names) + 1):
        for subset in itertools.combinations(names, r):
            assert mine.subset_groups(subset) == ref.subset_groups(subset)
            assert mine.medium_of(subset) == ref.medium_of(subset)


def _ops(pkg, groups, nbytes=4096):
    Op = pkg.CollectiveOp
    return [Op(kind="all-reduce", nbytes=nbytes, instr=f"ar{i}", line="",
               replica_groups=g, group_count=len(g))
            for i, g in enumerate(groups)]


@pytest.mark.parametrize("topo", TOPOLOGIES, ids=str)
def test_attribution_equals_reference(topo):
    ref, mine = _pair(*topo)
    every = tuple(range(mine.n_devices))
    cases = [mine.subset_groups(s) for r in range(1, len(mine.axes) + 1)
             for s in itertools.combinations(mine.axis_names, r)]
    cases += [(), ((0, 1, 2, 3, 4, 5, 6, 7, 8, 9)[:1],),
              (every[::-1],)]
    for groups in cases:
        want = jmc.attribute(_ops(jhc, [groups])[0], ref)
        got = tmc.attribute(_ops(thc, [groups])[0], mine)
        assert got == want, groups


def test_topology_validation_like_reference():
    for pkg in (jmc, tmc):
        with pytest.raises(pkg.MeshCheckError, match="tile the whole"):
            pkg.multi_host_topology(2, 4, (("tp", 4),))
        with pytest.raises(pkg.MeshCheckError, match="duplicate"):
            pkg.multi_host_topology(1, 4, (("tp", 2), ("tp", 2)))
        with pytest.raises(pkg.MeshCheckError, match=">= 1"):
            pkg.multi_host_topology(1, 4, (("tp", 0), ("dp", 4)))


def test_link_time_model_equals_reference_on_equal_figures():
    """The ring model: an all-reduce over g ranks moves 2 (g - 1) / g of
    its payload a rank and pays 2 (g - 1) hops. With both clusters given
    the H100 figures (the reference's through its overrides) the
    predictions agree for every kind, size and medium."""
    c = tmc.Cluster(n_hosts=2, chips_per_host=4)
    h100 = tmc.DEVICE_SPECS["h100"]
    ref = jmc.single_host_topology(4).cluster.__class__(
        accelerator_type="cpu-test", n_hosts=2, chips_per_host=4,
        dcn_bandwidth=c.dcn_bandwidth, dcn_latency=c.dcn_latency,
        overrides={"ici_bandwidth": h100["ici_bandwidth"],
                   "ici_latency": h100["ici_latency"]})
    for kind in ("all-reduce", "all-gather", "reduce-scatter",
                 "all-to-all", "collective-permute", "collective-broadcast"):
        for g, medium in ((1, "ici"), (2, "ici"), (4, "ici"), (2, "dcn"),
                          (8, "dcn")):
            want = jmc.predicted_seconds(kind, 1 << 20, g, medium, ref)
            got = tmc.predicted_seconds(kind, 1 << 20, g, medium, c)
            assert got == pytest.approx(want, rel=1e-12), (kind, g, medium)
    two = 2 * (2 - 1) / 2
    assert tmc.predicted_seconds("all-reduce", 1 << 20, 2, "ici", c) == \
        pytest.approx(two * (1 << 20) / 450e9 + 2 * 2e-6)
    # across hosts a card gets its NIC: 400 Gb/s = 50e9 bytes/s
    assert tmc.predicted_seconds("all-reduce", 1 << 20, 2, "dcn", c) == \
        pytest.approx(two * (1 << 20) / 50e9 + 2 * 5e-6)


def test_budget_arms_equal_reference():
    """The per-medium arms: a one-host placement passes a zero-DCN budget;
    the same collectives declared on two hosts x one card ride DCN, and
    the zero-DCN budget raises naming the axis, the medium and the
    bytes — in both packages."""
    for hosts, per_host in ((1, 2), (2, 1)):
        ref, mine = _pair(hosts, per_host, (("tp", 2),))
        jrep = jmc.analyze(_ops(jhc, [((0, 1),)] * 5), ref, name="decode")
        trep = tmc.analyze(_ops(thc, [((0, 1),)] * 5), mine, name="decode")
        for rep in (jrep, trep):
            assert (rep.ici_bytes, rep.dcn_bytes) == \
                ((5 * 4096, 0) if hosts == 1 else (0, 5 * 4096))
        jb = jhc.CollectiveBudget(all_reduce=5, max_collective_bytes=5 * 4096,
                                  max_ici_bytes=5 * 4096, max_dcn_bytes=0,
                                  max_dcn_ops=0)
        tb = thc.CollectiveBudget(all_reduce=5, max_collective_bytes=5 * 4096,
                                  max_ici_bytes=5 * 4096, max_dcn_bytes=0,
                                  max_dcn_ops=0)
        if hosts == 1:
            jrep.check(jb)
            trep.check(tb)
            continue
        with pytest.raises(jhc.CollectiveBudgetError) as want:
            jrep.check(jb)
        with pytest.raises(thc.CollectiveBudgetError) as got:
            trep.check(tb)
        for msg in (str(want.value), str(got.value)):
            assert "'tp'" in msg and "DCN" in msg and "max_dcn_bytes=0" in msg
            assert "20480 bytes" in msg


def test_unattributed_collective_is_refused():
    mine = tmc.multi_host_topology(1, 4, (("dp", 2), ("tp", 2)))
    rep = tmc.analyze(_ops(thc, [((0, 3), (1, 2))]), mine, name="step")
    with pytest.raises(tmc.MeshCheckError, match="cannot attribute"):
        rep.check(thc.CollectiveBudget(all_reduce=1))


def test_bank_pins_the_registry(tmp_path):
    """The banked placements are the registry's (the structural keys
    exact); a moved key is an error, a moved prediction a warning."""
    with open(tmc.bank_path()) as fh:
        banked = json.load(fh)
    assert set(banked) == set(tmc.MESH_REGISTRY)
    rec = dict(banked["tp2_engine_decode_1host"])
    assert tmc.diff_banked({"x": rec}, {"x": rec}) == []
    moved = dict(rec, dcn_bytes=1)
    assert any(f.startswith("error") and "dcn_bytes" in f
               for f in tmc.diff_banked({"x": moved}, {"x": rec}))
    slow = dict(rec, predicted_s=rec["predicted_s"] * 2)
    assert [f.split(":")[0] for f in
            tmc.diff_banked({"x": slow}, {"x": rec})] == ["warn"]
    assert tmc.diff_banked({"x": rec}, {})[0].startswith("error")


def test_registry_placements_from_a_census():
    """The registry's entries on a synthetic census of the toy TP=2
    decode (5 all-reduces over ranks 0 and 1): one host passes with every
    byte on NVLink, two hosts x one card with every byte across."""
    census = thc.HloAuditReport(name="decode", collectives=tuple(
        _ops(thc, [((0, 1),)] * 5, nbytes=360)))
    budget = thc.CollectiveBudget(all_reduce=5, max_collective_bytes=1800)
    one = tmc.run_entry("tp2_engine_decode_1host", (census, budget))
    two = tmc.run_entry("tp2_engine_decode_2host", (census, budget))
    assert one.axis_media == {"tp": "ici"} and one.dcn_bytes == 0
    assert two.axis_media == {"tp": "dcn"} and two.ici_bytes == 0
    assert two.predicted_s > one.predicted_s > 0
