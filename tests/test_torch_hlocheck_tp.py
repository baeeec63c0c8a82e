"""The debug checks under tensor parallelism: the port's TP=2 ranks
(gloo, spawned, ``test_torch_tp_ranks.audit_rank``) serve the reference
TP tests' model under ``ServingConfig(debug_checks=True)``, in float32
with plain and quantized logits, and the JAX engine serves the
same requests at TP=2 on the conftest's 8-device CPU mesh.

Each audited program's collective census must equal the reference's
compiled census — ``2L + 1`` all-reduces (``2L + 2`` quantized) of the
same byte sizes, over both ranks — and stay within
``TPContext.step_budget``; the ``serving_tp_collective_*`` and ``ici``
gauges equal the reference's, ``dcn`` is 0 on the default (one-host)
topology, a declared one-host topology binds zero DCN and passes, and a
declared two-host topology classifies the tp axis DCN, whose zero-DCN
budget raises naming it."""
import jax
import numpy as np
import pytest

from paddle_tpu.serving import ServingConfig as JServingConfig
from paddle_tpu.serving import ServingEngine as JServingEngine
from test_torch_tp import _jax_model
from test_torch_tp_ranks import (AUDIT_LEGS, BASE, LAYERS, MODEL, SCENARIOS,
                                 audit_rank, rids, save_params, spawn_ranks)

WORLD = 2


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    if len(jax.devices()) < WORLD:
        pytest.skip("needs the conftest 8-device CPU mesh")
    tmp = tmp_path_factory.mktemp("hlotp")
    path = str(tmp / "params.npz")
    params = save_params(path)
    jmodel = _jax_model(params["model"], MODEL)
    ref = {}
    for name, extra in AUDIT_LEGS.items():
        sc = SCENARIOS["greedy"]
        eng = JServingEngine(jmodel, JServingConfig(
            tensor_parallel=WORLD, debug_checks=True,
            **dict(BASE, **sc["cfg"], **extra)))
        for rid, (p, b) in zip(rids("greedy"), sc["reqs"]):
            eng.add_request(p, b, rid=rid)
        outs = eng.run()
        ref[name] = {"engine": eng, "snap": eng.metrics.snapshot(),
                     "outs": {r: np.asarray(o).tolist()
                              for r, o in outs.items()}}
    ranks = spawn_ranks(audit_rank, WORLD, tmp, path)
    return ref, ranks


@pytest.mark.parametrize("leg", sorted(AUDIT_LEGS))
def test_census_equals_reference(run, leg):
    ref, ranks = run
    je = ref[leg]["engine"]
    for r in ranks:
        mine = r[leg]
        assert set(mine["audits"]) == set(je.hlo_audits)
        assert mine["compile_counts"] == je.compile_counts
        for label, jr in je.hlo_audits.items():
            census = mine["audits"][label]
            want_ops = 2 * LAYERS + 1 + (leg == "quantized logits")
            assert census["ops"] == len(jr.collectives) == want_ops
            assert sorted(census["bytes"]) == \
                sorted(c.nbytes for c in jr.collectives), label
            assert all(g == ((0, 1),) for g in census["groups"])
            assert census["host_transfers"] == 0
            assert census["donated"] == (1, 1)
            budget = mine["budgets"][label]
            assert census["ops"] <= budget.all_reduce
            assert sum(census["bytes"]) <= budget.max_collective_bytes
        assert mine["outs"] == ref[leg]["outs"]


@pytest.mark.parametrize("leg", sorted(AUDIT_LEGS))
def test_tp_gauges_equal_reference(run, leg):
    ref, ranks = run
    snap = ref[leg]["snap"]
    for r in ranks:
        g = r[leg]["gauges"]
        for k in ("serving_tp_collective_ops_per_step",
                  "serving_tp_collective_bytes_per_token",
                  "serving_tp_collective_overlap_frac",
                  "serving_ici_bytes_per_token",
                  "serving_dcn_bytes_per_token",
                  "serving_analysis_retraces_total",
                  "serving_analysis_host_syncs_total"):
            assert g[k] == pytest.approx(snap[k]), k
        assert g["serving_ici_bytes_per_token"] > 0
        assert g["serving_dcn_bytes_per_token"] == 0
        assert g["serving_analysis_host_syncs_total"] == \
            g["serving_decode_steps"] + g["serving_prefills_total"]
        # NVLink's predicted time, not the gloo ranks' measured one
        assert 0 < g["serving_collective_time_predicted_s"] < 1e-3


def test_declared_topologies(run):
    _, ranks = run
    for r in ranks:
        one, two = r["one host"], r["two hosts"]
        assert one["gauges"]["serving_dcn_bytes_per_token"] == 0
        assert one["outs"] == two["outs"] == r["bf16"]["outs"]
        assert two["axis_media"] == {"tp": "dcn"}
        assert two["gauges"]["serving_dcn_bytes_per_token"] > 0
        assert two["gauges"]["serving_ici_bytes_per_token"] == 0
        assert two["gauges"]["serving_collective_time_predicted_s"] > \
            one["gauges"]["serving_collective_time_predicted_s"]
        msg = two["zero_dcn"]
        assert msg is not None and "'tp'" in msg and "DCN" in msg \
            and "max_dcn_bytes=0" in msg
