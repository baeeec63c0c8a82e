"""DenseNet in the port against the JAX package, with the helpers and
tolerances of ``tests/test_torch_vision_zoo.py``: each parameter's
seeded key, ``densenet121``'s eval-mode logits in float64, then the
training-mode outputs, loss, gradients and BatchNorm buffers of a
DenseNet cut to blocks of 3, 4, 3 and 2 layers (both packages' ``_CFG``
entry for 121 patched for the test). The cut keeps every code path (the
stem, dense layers, the three transitions, the final BatchNorm and the
classifier); ``densenet121``'s own backward compiles for a minute in the
reference here."""
import pytest

import paddle_tpu.vision.models.densenet as JD
import paddle_tpu_torch.vision.models.densenet as TD
from test_torch_vision_zoo import (_cpu, assert_same_state,  # noqa: F401
                                   build_pair, check_family)

CUT = (3, 4, 3, 2)


@pytest.fixture
def cut_depth(monkeypatch):
    for mod in (JD, TD):
        monkeypatch.setitem(mod._CFG, 121, CUT)


def test_seed_gives_each_parameter_the_references_key():
    jm, tm = build_pair("densenet121")
    assert_same_state(jm, tm)


def test_densenet121_eval_matches_the_reference_float64():
    check_family("densenet121", 64, train=False)


def test_cut_densenet_trains_like_the_reference_float64(cut_depth):
    tm = check_family("densenet121", 64)
    assert [len(b.layers) for b in tm.blocks[::2]] == list(CUT)
