"""AlexNet and VGG in the port against the JAX package (the helpers and
tolerances of ``tests/test_torch_vision_zoo.py``): each parameter's
seeded key, AlexNet's float64 numerics at 224 x 224 (its classifier reads
256 x 6 x 6 features), VGG's features with BatchNorm in float64 and
``vgg16``'s classifier in float32."""
import numpy as np
import pytest
import torch

import paddle_tpu_torch as T
from paddle_tpu_torch.analysis.layercheck import to_numpy
from test_torch_vision_zoo import (_cpu, assert_same_state,  # noqa: F401
                                   build_pair, check_family, random_weights,
                                   reference_eval)


@pytest.mark.parametrize("name", ["alexnet", "vgg16", "vgg11-bn"])
def test_seed_gives_each_parameter_the_references_key(name):
    jm, tm = build_pair(name)
    assert_same_state(jm, tm)


def test_alexnet_matches_the_reference_float64():
    check_family("alexnet", 224, batch=1)


def test_vgg_features_match_the_reference_float64():
    """VGG with BatchNorm and no classifier (``num_classes`` 0 takes it
    out): the features and the 7 x 7 pool at 64 x 64 in float64. The
    classifier (102 million weights of 512 x 7 x 7 x 4096) is held in
    float32 below."""
    tm = check_family("vgg11-bn", 64, num_classes=0)
    assert not hasattr(tm, "classifier")


def test_vgg16_classifier_matches_the_reference_float32():
    """``vgg16(num_classes=10)`` in eval mode at 32 x 32 (the 1 x 1
    features pooled up to 7 x 7), float32: the logits within rtol 1e-4 /
    atol 1e-5 (a float32 sum's order over 25,088 inputs)."""
    jm, tm = build_pair("vgg16", num_classes=10)
    weights = random_weights(jm, 5, np.float32)
    tm.set_state_dict(weights)
    jm.eval()
    tm.eval()
    x = np.random.default_rng(6).standard_normal((2, 3, 32, 32)).astype(
        np.float32)
    want = reference_eval(jm, weights, {}, x)[0]
    with torch.no_grad():
        got = tm(T.to_tensor(x))
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), rtol=1e-4,
                               atol=1e-5)
