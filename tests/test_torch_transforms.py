"""``vision.transforms`` of the port against the JAX package's, on the
CPU: every class and function the reference module defines (not only its
``__all__``), on the same seeded float32 and uint8 CHW images (and HWC
ones for ``ToTensor`` and ``Transpose``), each call after the same
``np.random.seed``. Both are host numpy, so the outputs must be equal,
dtype and shape included; the random transforms must also leave numpy's
generator in the same state. ``BaseTransform``'s keys route a tuple's
members to ``_apply_<key>``."""
import inspect

import numpy as np
import pytest

import paddle_tpu.vision.transforms as JT
import paddle_tpu_torch.vision.transforms as TT

CASES = {}


def case(name, fn, make="f32"):
    """``fn(module, img)``; ``make`` names the input."""
    CASES[name] = (fn, make)


def _image(make):
    rng = np.random.default_rng(0)
    if make == "f32":
        return rng.random((3, 20, 26)).astype(np.float32)
    if make == "u8":
        return rng.integers(0, 256, (3, 20, 26), dtype=np.uint8)
    if make == "hwc":
        return rng.integers(0, 256, (20, 26, 3), dtype=np.uint8)
    if make == "gray":
        return rng.random((20, 26)).astype(np.float32)
    raise ValueError(make)


for _kind in ("nearest", "bilinear", "bicubic", "area", "lanczos"):
    for _axis, _n in ((1, 31), (2, 11), (2, 26)):
        case(f"_resample_1d_{_kind}_{_axis}_{_n}",
             lambda M, x, k=_kind, a=_axis, n=_n: M._resample_1d(x, a, n, k))
for _make in ("f32", "u8"):
    case(f"Compose_{_make}", lambda M, x: M.Compose(
        [M.RandomHorizontalFlip(0.5), M.Normalize([0.5] * 3, [0.2] * 3)])(x),
        _make)
    case(f"Resize_int_{_make}", lambda M, x: M.Resize(12)(x), _make)
    case(f"Resize_pair_bicubic_{_make}",
         lambda M, x: M.Resize((15, 9), "bicubic")(x), _make)
    case(f"Resize_nearest_{_make}", lambda M, x: M.Resize(40, "nearest")(x),
         _make)
    case(f"resize_{_make}", lambda M, x: M.resize(x, (7, 30)), _make)
    case(f"CenterCrop_{_make}", lambda M, x: M.CenterCrop((9, 14))(x), _make)
    case(f"center_crop_{_make}", lambda M, x: M.center_crop(x, 11), _make)
    case(f"RandomCrop_{_make}", lambda M, x: M.RandomCrop(16, 4)(x), _make)
    case(f"RandomCrop_nopad_{_make}", lambda M, x: M.RandomCrop((10, 20))(x),
         _make)
    case(f"RandomHorizontalFlip_{_make}",
         lambda M, x: [M.RandomHorizontalFlip()(x) for _ in range(6)], _make)
    case(f"RandomVerticalFlip_{_make}",
         lambda M, x: [M.RandomVerticalFlip(0.3)(x) for _ in range(6)], _make)
    case(f"Pad_{_make}", lambda M, x: M.Pad([1, 2, 3, 4])(x), _make)
    case(f"Pad_int_{_make}", lambda M, x: M.Pad(2)(x), _make)
    case(f"hflip_{_make}", lambda M, x: M.hflip(x), _make)
    case(f"vflip_{_make}", lambda M, x: M.vflip(x), _make)
    case(f"crop_{_make}", lambda M, x: M.crop(x, 2, 3, 8, 9), _make)
    case(f"erase_{_make}", lambda M, x: M.erase(x, 1, 2, 5, 6, 7), _make)
    case(f"erase_inplace_{_make}",
         lambda M, x: M.erase(x.copy(), 1, 2, 5, 6, 0, inplace=True), _make)
    case(f"adjust_brightness_{_make}",
         lambda M, x: M.adjust_brightness(x, 1.7), _make)
    case(f"adjust_contrast_{_make}",
         lambda M, x: M.adjust_contrast(x, 0.4), _make)
    case(f"adjust_hue_{_make}", lambda M, x: M.adjust_hue(x, 0.23), _make)
    case(f"to_grayscale_{_make}", lambda M, x: M.to_grayscale(x, 3), _make)
    case(f"rotate_{_make}", lambda M, x: M.rotate(x, 33.0, fill=1), _make)
    case(f"affine_{_make}", lambda M, x: M.affine(
        x, 20.0, (2, -3), 1.2, (10.0, 5.0)), _make)
    case(f"affine_scalar_shear_{_make}",
         lambda M, x: M.affine(x, -15.0, (0, 1), 0.8, 12.0), _make)
    case(f"perspective_{_make}", lambda M, x: M.perspective(
        x, [(0, 0), (25, 0), (25, 19), (0, 19)],
        [(2, 1), (23, 3), (24, 18), (1, 17)]), _make)
    case(f"_affine_sample_{_make}", lambda M, x: M._affine_sample(
        x, np.array([[0.9, 0.1, 1.0], [-0.2, 1.1, -2.0]]), 3), _make)
    case(f"_clip_like_{_make}",
         lambda M, x: M._clip_like(x.astype(np.float32) * 3 - 5, x), _make)
    case(f"BrightnessTransform_{_make}",
         lambda M, x: M.BrightnessTransform(0.4)(x), _make)
    case(f"ContrastTransform_{_make}",
         lambda M, x: M.ContrastTransform(0.5)(x), _make)
    case(f"SaturationTransform_{_make}",
         lambda M, x: M.SaturationTransform(0.6)(x), _make)
    case(f"HueTransform_{_make}", lambda M, x: M.HueTransform(0.3)(x), _make)
    case(f"ColorJitter_{_make}",
         lambda M, x: M.ColorJitter(0.4, 0.4, 0.4, 0.2)(x), _make)
    case(f"Grayscale_{_make}", lambda M, x: M.Grayscale(3)(x), _make)
    case(f"RandomErasing_{_make}", lambda M, x: [
        M.RandomErasing(0.7, value=2)(x) for _ in range(4)], _make)
    case(f"RandomRotation_{_make}",
         lambda M, x: M.RandomRotation(40, fill=2)(x), _make)
    case(f"RandomAffine_{_make}", lambda M, x: [
        M.RandomAffine(30, (0.1, 0.2), (0.8, 1.2), s)(x)
        for s in (None, 15, (-5, 10), (-5, 5, -10, 10))], _make)
    case(f"RandomPerspective_{_make}", lambda M, x: [
        M.RandomPerspective(0.8, 0.4)(x) for _ in range(3)], _make)
    case(f"RandomResizedCrop_{_make}", lambda M, x: [
        M.RandomResizedCrop(12)(x) for _ in range(3)], _make)
    case(f"RandomResizedCrop_fallback_{_make}", lambda M, x: M.RandomResizedCrop(
        (8, 10), scale=(2.0, 3.0))(x), _make)
    case(f"to_tensor_{_make}", lambda M, x: M.to_tensor(x), _make)
for _mode in ("constant", "reflect", "edge", "symmetric"):
    case(f"pad_{_mode}", lambda M, x, m=_mode: [
        M.pad(x, 2, 5, m), M.pad(x, (1, 3), 0, m), M.pad(x, [1, 2, 3, 4], 1, m)])
case("ToTensor_hwc", lambda M, x: M.ToTensor()(x), "hwc")
case("ToTensor_hwc_keep", lambda M, x: M.ToTensor("HWC")(x), "hwc")
case("ToTensor_gray", lambda M, x: M.ToTensor()(x), "gray")
case("Normalize", lambda M, x: M.Normalize([0.4, 0.5, 0.6], [0.2, 0.3, 0.4],
                                           to_rgb=True)(x))
case("Normalize_hwc", lambda M, x: M.Normalize(0.5, 0.25, "HWC", True)(
    x.astype(np.float32)), "hwc")
case("normalize", lambda M, x: M.normalize(x, [0.1] * 3, [0.9] * 3))
case("Transpose", lambda M, x: M.Transpose()(x), "hwc")
case("Transpose_order", lambda M, x: M.Transpose((1, 0, 2))(x), "hwc")
case("_chw", lambda M, x: M._chw(x), "gray")
case("BaseTransform_keys", lambda M, x: M.ColorJitter(
    0.3, keys=("image", "label"))((x, np.arange(3))))
case("BaseTransform_abstract", lambda M, x: _raises(
    lambda: M.BaseTransform()(x), NotImplementedError))
case("value_checks", lambda M, x: [
    _raises(lambda: M.adjust_hue(x, 0.7), ValueError),
    _raises(lambda: M.ContrastTransform(-1), ValueError),
    _raises(lambda: M.HueTransform(0.6), ValueError),
    _raises(lambda: M._resample_1d(x, 1, 5, "box"), ValueError)])
case("zero_strength", lambda M, x: [
    M.BrightnessTransform(0)(x), M.ContrastTransform(0)(x),
    M.SaturationTransform(0)(x), M.HueTransform(0)(x)])


def _raises(fn, exc):
    with pytest.raises(exc):
        fn()
    return exc.__name__


def _flat(out):
    return [o for item in (out if isinstance(out, (list, tuple)) else [out])
            for o in _flat(item)] if isinstance(out, (list, tuple)) else [out]


@pytest.mark.parametrize("name", sorted(CASES))
def test_matches_reference(name):
    fn, make = CASES[name]
    outs, states = [], []
    for M in (TT, JT):
        np.random.seed(7)
        outs.append(_flat(fn(M, _image(make))))
        states.append(np.random.get_state()[1].copy())
    got, want = outs
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, str):
            assert g == w
            continue
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, (g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(states[0], states[1])


def _defined(mod) -> set:
    return {n for n, v in vars(mod).items()
            if (inspect.isfunction(v) or inspect.isclass(v))
            and v.__module__ == mod.__name__ and n != "annotations"}


def test_every_name_of_the_reference_module_has_a_case():
    names = _defined(JT)
    assert len(names) == 42  # 38 public, 4 private helpers
    assert names <= _defined(TT)
    assert set(JT.__all__) <= set(TT.__all__)
    covered = {n for n in names if any(c == n or c.startswith(n + "_")
                                       for c in CASES)}
    assert names - covered == set()
