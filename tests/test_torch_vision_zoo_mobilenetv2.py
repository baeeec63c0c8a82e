"""MobileNetV2 in the port against the JAX package, with the helpers and
tolerances of ``tests/test_torch_vision_zoo.py``: each parameter's
seeded key, then the eval-mode outputs and the training-mode outputs,
loss, gradients and BatchNorm buffers in float64."""
import pytest

from test_torch_vision_zoo import (_cpu, assert_same_state,  # noqa: F401
                                   build_pair, check_family)


@pytest.mark.parametrize("name", ["mobilenet_v2"])
def test_seed_gives_each_parameter_the_references_key(name):
    jm, tm = build_pair(name)
    assert_same_state(jm, tm)


@pytest.mark.parametrize("name,size", [("mobilenet_v2", 64)])
def test_family_matches_the_reference_float64(name, size):
    check_family(name, size)
