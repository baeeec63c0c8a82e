"""The kernel A/B gauges (``serving_kernel_speedup_{predicted,measured,
drift}{kernel=}``) of the port's engine against the JAX engine's.

- Both engines seed the same label sets — the reference's bank names —
  for float, int8 and speculative configurations; the port's predicted
  values are its own kernelcheck bank's (``obs.
  load_banked_kernel_speedups``), each the analytic byte ratio
  ``analysis.kernelcheck.predicted_speedup`` recomputes (the plain
  version's materialized bytes over the kernel's), never the TPU bank's.
- The engine feeds the decode leg (``ragged_paged``, or
  ``ragged_paged_q8`` over int8 pools) and the verify leg
  (``ragged_paged_verify``, float pools only); on the CPU every dispatch
  is the plain version's, so the measured half stays at its seeded zero
  in both engines while one leg has samples; a tracker fed both legs
  publishes measured = plain mean / kernel mean and drift = measured /
  predicted.
- The bank-name mapping (``kernelcheck.AB_LABELS``) covers exactly the
  reference bank's names, each mapped to a registered entry and one of
  its main-path shapes.
"""
import json
import os

import pytest

from paddle_tpu_torch.analysis import kernelcheck as kc
from paddle_tpu_torch.obs import RooflineTracker, load_banked_kernel_speedups
from paddle_tpu_torch.serving.metrics import ServingMetrics
from test_torch_engine_features import BASE, Twin, prompts

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAMILIES = ("kernel_speedup_predicted", "kernel_speedup_measured",
            "kernel_speedup_drift")


def _ab(snapshot: dict) -> dict:
    return {k: v for k, v in snapshot.items()
            if k.split("{")[0][len("serving_"):] in FAMILIES}


CONFIGS = {"float": {}, "int8": dict(kv_dtype="int8"),
           "spec": dict(spec=dict(method="ngram", depth=2)),
           "spec-int8": dict(kv_dtype="int8",
                             spec=dict(method="ngram", depth=2))}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_engine_seeds_the_reference_labels_with_port_predictions(name):
    cfg = dict(CONFIGS[name])
    tw = Twin(enable_tracing=True, spec=cfg.pop("spec", None), **BASE, **cfg)
    j, t = _ab(tw.j.metrics.snapshot()), _ab(tw.t.metrics.snapshot())
    assert set(t) == set(j) and t
    banked = load_banked_kernel_speedups()
    for label, value in banked.items():
        assert t[f"serving_kernel_speedup_predicted{{kernel={label}}}"] \
            == value
    # the measured half: one leg (the plain version's) has samples, so it
    # stays at its seeded zero in both engines
    for prompt in prompts(3, [9, 14]):
        tw.add(prompt, 6)
    tw.run()
    j, t = _ab(tw.j.metrics.snapshot()), _ab(tw.t.metrics.snapshot())
    for fam in ("measured", "drift"):
        for key in t:
            if f"_{fam}{{" in key:
                assert t[key] == 0 and j[key] == 0, key
    # a speculative engine's steps are all verify steps, and an int8
    # engine has no verify leg — both as the reference
    legs = tw.t._roofline._kernel_s
    want = {"float": {"ragged_paged"}, "int8": {"ragged_paged_q8"},
            "spec": {"ragged_paged_verify"}, "spec-int8": set()}[name]
    assert set(legs) == set(tw.j._roofline._kernel_s) == want
    assert all(acc[1] == 0 and acc[3] > 0 for acc in legs.values())


def test_predictions_are_the_analytic_byte_ratio():
    banked = load_banked_kernel_speedups()
    assert set(banked) == set(kc.AB_LABELS)
    for label, (entry, shape) in kc.AB_LABELS.items():
        spec = kc.REGISTRY[entry]
        want = kc.predicted_speedup(entry, spec.shapes[shape])
        assert banked[label] == want, label
        assert want > 1.0, label  # the plain version moves more bytes
    # the TPU bank's values are not the port's
    with open(os.path.join(ROOT, "profiles", "kernelcheck.json")) as fh:
        tpu = json.load(fh)
    assert any(banked[k] != tpu[k]["predicted_speedup"] for k in banked)


def test_bank_name_mapping_covers_the_reference_bank():
    with open(os.path.join(ROOT, "profiles", "kernelcheck.json")) as fh:
        tpu = json.load(fh)
    assert set(kc.AB_LABELS) == {k for k, v in tpu.items()
                                 if isinstance(v, dict)
                                 and "predicted_speedup" in v}
    for label, (entry, shape) in kc.AB_LABELS.items():
        assert entry in kc.REGISTRY and shape in kc.REGISTRY[entry].shapes
    assert kc.AB_LABELS["ragged_paged"] == ("ragged_paged_attention",
                                            "decode")
    assert kc.AB_LABELS["ragged_paged_q8"] == ("ragged_paged_attention_int8",
                                               "decode")
    assert kc.AB_LABELS["ragged_paged_verify"] == ("ragged_paged_attention",
                                                   "verify")


def test_measured_half_publishes_once_both_legs_have_samples():
    tracker = RooflineTracker(banked_kernels={"ragged_paged": 4.0})
    metrics = ServingMetrics()
    tracker.on_kernel_call("ragged_paged", 0.002, False)
    tracker.publish(metrics)
    assert "measured" not in tracker.gauges()["kernels"]["ragged_paged"]
    tracker.on_kernel_call("ragged_paged", 0.001, True)
    tracker.publish(metrics)
    entry = tracker.gauges()["kernels"]["ragged_paged"]
    assert entry["measured"] == pytest.approx(2.0)
    assert entry["drift"] == pytest.approx(0.5)
    assert metrics.snapshot()["serving_kernel_speedup_measured{kernel=ragged_paged}"] \
        == pytest.approx(2.0)
