"""Transforms on host numpy CHW images (reference:
``paddle_tpu/vision/transforms.py``; Paddle's
``python/paddle/vision/transforms/``).

They run on the host, before a batch goes to the card, and need neither
PIL nor torchvision (the card's machine has neither). The random ones
draw from ``np.random``'s global generator in the reference's order, so
after one ``np.random.seed`` both packages transform alike."""
from __future__ import annotations

import numpy as np

__all__ = ["Compose", "ToTensor", "Normalize", "Resize", "RandomCrop", "CenterCrop",
           "RandomHorizontalFlip", "RandomVerticalFlip", "Transpose", "Pad",
           "normalize", "to_tensor", "resize"]


class Compose:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, img):
        for t in self.transforms:
            img = t(img)
        return img


class ToTensor:
    def __init__(self, data_format="CHW"):
        self.data_format = data_format

    def __call__(self, img):
        arr = np.asarray(img, dtype=np.float32)
        if arr.ndim == 2:
            arr = arr[None]
        elif arr.ndim == 3 and arr.shape[-1] in (1, 3, 4) and self.data_format == "CHW":
            arr = arr.transpose(2, 0, 1)
        return arr / 255.0


class Normalize:
    def __init__(self, mean=0.0, std=1.0, data_format="CHW", to_rgb=False):
        shape = (-1, 1, 1) if data_format == "CHW" else (1, 1, -1)
        self.mean = np.asarray(mean, dtype=np.float32).reshape(shape)
        self.std = np.asarray(std, dtype=np.float32).reshape(shape)
        self.channel_axis = 0 if data_format == "CHW" else -1
        self.to_rgb = to_rgb

    def __call__(self, img):
        arr = np.asarray(img, dtype=np.float32)
        if self.to_rgb:
            arr = np.flip(arr, axis=self.channel_axis)
        return (arr - self.mean) / self.std


def _resample_1d(arr, axis, out_size, kind):
    """Separable 1-D resample along `axis` (half-pixel centers, the cv2/PIL
    convention — reference resize is cv2.INTER_LINEAR/CUBIC,
    python/paddle/vision/transforms/functional_cv2.py:72)."""
    in_size = arr.shape[axis]
    if in_size == out_size:
        return arr
    if kind == "nearest":
        idx = np.minimum((np.arange(out_size) * in_size // out_size), in_size - 1)
        return np.take(arr, idx, axis=axis)
    src = (np.arange(out_size) + 0.5) * (in_size / out_size) - 0.5
    if kind in ("bilinear", "area", "lanczos"):  # area/lanczos: linear approx
        i0 = np.floor(src).astype(int)
        frac = (src - i0).astype(np.float32)
        taps = np.stack([np.clip(i0, 0, in_size - 1),
                         np.clip(i0 + 1, 0, in_size - 1)])
        weights = np.stack([1.0 - frac, frac])
    elif kind == "bicubic":
        # Keys cubic kernel, a = -0.75 (cv2 INTER_CUBIC)
        a = -0.75
        i0 = np.floor(src).astype(int)
        taps, weights = [], []
        for t in range(-1, 3):
            x = np.abs(src - (i0 + t))
            w = np.where(
                x <= 1, (a + 2) * x**3 - (a + 3) * x**2 + 1,
                np.where(x < 2, a * x**3 - 5 * a * x**2 + 8 * a * x - 4 * a, 0.0))
            taps.append(np.clip(i0 + t, 0, in_size - 1))
            weights.append(w.astype(np.float32))
        taps, weights = np.stack(taps), np.stack(weights)
        weights = weights / weights.sum(0, keepdims=True)
    else:
        raise ValueError(f"unsupported interpolation: {kind!r}")
    arr = np.moveaxis(arr, axis, -1)
    out = np.einsum("...ti,ti->...i", arr.astype(np.float32)[..., taps], weights)
    return np.moveaxis(out, -1, axis)


class Resize:
    """Paddle's Resize (transforms.py:366): an int size matches the SHORTER
    edge, keeping the aspect ratio; (h, w) matches exactly. Separable
    interpolation per ``interpolation`` (:func:`_resample_1d`)."""

    def __init__(self, size, interpolation="bilinear"):
        self.size = size if isinstance(size, int) else tuple(size)
        self.interpolation = interpolation

    def __call__(self, img):
        arr = _chw(img)
        c, h, w = arr.shape
        if isinstance(self.size, int):
            if h > w:
                oh, ow = int(round(self.size * h / w)), self.size
            else:
                oh, ow = self.size, int(round(self.size * w / h))
        else:
            oh, ow = self.size
        dtype = arr.dtype
        out = _resample_1d(arr, 1, oh, self.interpolation)
        out = _resample_1d(out, 2, ow, self.interpolation)
        if dtype == np.uint8 and self.interpolation != "nearest":
            out = np.clip(np.round(out), 0, 255)
        return out.astype(dtype)


class CenterCrop:
    def __init__(self, size):
        self.size = (size, size) if isinstance(size, int) else tuple(size)

    def __call__(self, img):
        c, h, w = img.shape
        th, tw = self.size
        i = (h - th) // 2
        j = (w - tw) // 2
        return img[:, i : i + th, j : j + tw]


class RandomCrop:
    def __init__(self, size, padding=0):
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.padding = padding

    def __call__(self, img):
        if self.padding:
            img = np.pad(img, [(0, 0), (self.padding,) * 2, (self.padding,) * 2])
        c, h, w = img.shape
        th, tw = self.size
        i = np.random.randint(0, h - th + 1)
        j = np.random.randint(0, w - tw + 1)
        return img[:, i : i + th, j : j + tw]


class RandomHorizontalFlip:
    def __init__(self, prob=0.5):
        self.prob = prob

    def __call__(self, img):
        if np.random.rand() < self.prob:
            return img[:, :, ::-1].copy()
        return img


class RandomVerticalFlip:
    def __init__(self, prob=0.5):
        self.prob = prob

    def __call__(self, img):
        if np.random.rand() < self.prob:
            return img[:, ::-1].copy()
        return img


class Transpose:
    def __init__(self, order=(2, 0, 1)):
        self.order = order

    def __call__(self, img):
        return np.asarray(img).transpose(self.order)


class Pad:
    def __init__(self, padding, fill=0, padding_mode="constant"):
        self.padding = padding if isinstance(padding, (list, tuple)) else [padding] * 4

    def __call__(self, img):
        l, t, r, b = self.padding
        return np.pad(img, [(0, 0), (t, b), (l, r)])


def to_tensor(img, data_format="CHW"):
    return ToTensor(data_format)(img)


def normalize(img, mean, std, data_format="CHW", to_rgb=False):
    return Normalize(mean, std, data_format, to_rgb)(img)


def resize(img, size, interpolation="bilinear"):
    return Resize(size, interpolation)(img)


# ---- parity batch (reference: python/paddle/vision/transforms/{transforms,
# functional}.py) — all on numpy CHW float/uint8 arrays, no PIL dependency.
def _chw(img):
    arr = np.asarray(img)
    if arr.ndim == 2:
        arr = arr[None]
    return arr


def hflip(img):
    return _chw(img)[:, :, ::-1].copy()


def vflip(img):
    return _chw(img)[:, ::-1].copy()


def crop(img, top, left, height, width):
    return _chw(img)[:, top:top + height, left:left + width].copy()


def center_crop(img, output_size):
    oh, ow = ((output_size, output_size) if isinstance(output_size, int)
              else tuple(output_size))
    c, h, w = _chw(img).shape
    top, left = (h - oh) // 2, (w - ow) // 2
    return crop(img, top, left, oh, ow)


def pad(img, padding, fill=0, padding_mode="constant"):
    p = ([padding] * 4 if isinstance(padding, int) else
         [padding[0], padding[1]] * 2 if len(padding) == 2 else list(padding))
    l, t, r, b = p  # noqa: E741
    arr = _chw(img)
    if padding_mode == "constant":
        return np.pad(arr, ((0, 0), (t, b), (l, r)), constant_values=fill)
    mode = {"reflect": "reflect", "edge": "edge", "symmetric": "symmetric"}[padding_mode]
    return np.pad(arr, ((0, 0), (t, b), (l, r)), mode=mode)


def erase(img, i, j, h, w, v, inplace=False):
    arr = _chw(img) if inplace else _chw(img).copy()
    arr[:, i:i + h, j:j + w] = v
    return arr


def adjust_brightness(img, brightness_factor):
    arr = _chw(img).astype(np.float32) * brightness_factor
    return _clip_like(arr, img)


def adjust_contrast(img, contrast_factor):
    arr = _chw(img).astype(np.float32)
    mean = arr.mean()
    return _clip_like(mean + contrast_factor * (arr - mean), img)


def adjust_hue(img, hue_factor):
    """Shift hue by hue_factor (in [-0.5, 0.5]) via RGB->HSV->RGB."""
    if not -0.5 <= hue_factor <= 0.5:
        raise ValueError("hue_factor must be in [-0.5, 0.5]")
    arr = _chw(img).astype(np.float32)
    scale = 255.0 if np.asarray(img).dtype == np.uint8 else 1.0
    rgb = arr / scale
    r, g, b = rgb[0], rgb[1], rgb[2]
    maxc, minc = rgb.max(0), rgb.min(0)
    v = maxc
    d = maxc - minc
    s = np.where(maxc > 0, d / np.maximum(maxc, 1e-12), 0.0)
    dn = np.maximum(d, 1e-12)
    h = np.where(maxc == r, ((g - b) / dn) % 6,
                 np.where(maxc == g, (b - r) / dn + 2, (r - g) / dn + 4)) / 6.0
    h = np.where(d == 0, 0.0, h)
    h = (h + hue_factor) % 1.0
    i = np.floor(h * 6.0)
    f = h * 6.0 - i
    pq = v * (1 - s)
    q = v * (1 - s * f)
    t = v * (1 - s * (1 - f))
    i = i.astype(int) % 6
    out = np.select(
        [i == 0, i == 1, i == 2, i == 3, i == 4, i == 5],
        [np.stack([v, t, pq]), np.stack([q, v, pq]), np.stack([pq, v, t]),
         np.stack([pq, q, v]), np.stack([t, pq, v]), np.stack([v, pq, q])])
    return _clip_like(out * scale, img)


def to_grayscale(img, num_output_channels=1):
    arr = _chw(img).astype(np.float32)
    gray = 0.299 * arr[0] + 0.587 * arr[1] + 0.114 * arr[2]
    out = np.stack([gray] * num_output_channels)
    return _clip_like(out, img)


def _affine_sample(img, inv_matrix, fill=0.0):
    """Sample img at coordinates mapped by the INVERSE affine matrix
    [2, 3] (output pixel -> input pixel), nearest neighbor."""
    arr = _chw(img)
    c, h, w = arr.shape
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
    xin = inv_matrix[0, 0] * (xs - cx) + inv_matrix[0, 1] * (ys - cy) \
        + inv_matrix[0, 2] + cx
    yin = inv_matrix[1, 0] * (xs - cx) + inv_matrix[1, 1] * (ys - cy) \
        + inv_matrix[1, 2] + cy
    xi = np.round(xin).astype(int)
    yi = np.round(yin).astype(int)
    valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
    out = np.full_like(arr, fill, dtype=arr.dtype)
    out[:, valid] = arr[:, yi[valid], xi[valid]]
    return out


def rotate(img, angle, interpolation="nearest", expand=False, center=None,
           fill=0):
    th = np.deg2rad(angle)
    inv = np.array([[np.cos(th), np.sin(th), 0.0],
                    [-np.sin(th), np.cos(th), 0.0]], np.float32)
    return _affine_sample(img, inv, fill)


def affine(img, angle=0.0, translate=(0, 0), scale=1.0, shear=(0.0, 0.0),
           interpolation="nearest", fill=0, center=None):
    """Rotation+translate+scale+shear (reference F.affine; inverse-mapped)."""
    th = np.deg2rad(angle)
    sx, sy = (np.deg2rad(s) for s in
              (shear if isinstance(shear, (list, tuple)) else (shear, 0.0)))
    # forward matrix = R(th) @ Shear(sx, sy) * scale, then invert
    m = np.array([
        [np.cos(th + sy) / np.cos(sy), -np.cos(th + sy) * np.tan(sx) / np.cos(sy)
         - np.sin(th)],
        [np.sin(th + sy) / np.cos(sy), -np.sin(th + sy) * np.tan(sx) / np.cos(sy)
         + np.cos(th)],
    ], np.float32) * scale
    inv2 = np.linalg.inv(m)
    tx, ty = translate
    inv = np.concatenate(
        [inv2, -inv2 @ np.array([[tx], [ty]], np.float32)], axis=1)
    return _affine_sample(img, inv, fill)


def perspective(img, startpoints, endpoints, interpolation="nearest", fill=0):
    """Projective warp from 4 start to 4 end points (reference F.perspective)."""
    a = []
    bv = []
    for (sx, sy), (ex, ey) in zip(startpoints, endpoints):
        a.append([ex, ey, 1, 0, 0, 0, -sx * ex, -sx * ey])
        a.append([0, 0, 0, ex, ey, 1, -sy * ex, -sy * ey])
        bv += [sx, sy]
    coeffs = np.linalg.solve(np.asarray(a, np.float64),
                             np.asarray(bv, np.float64))
    arr = _chw(img)
    c, h, w = arr.shape
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    den = coeffs[6] * xs + coeffs[7] * ys + 1.0
    xin = (coeffs[0] * xs + coeffs[1] * ys + coeffs[2]) / den
    yin = (coeffs[3] * xs + coeffs[4] * ys + coeffs[5]) / den
    xi = np.round(xin).astype(int)
    yi = np.round(yin).astype(int)
    valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
    out = np.full_like(arr, fill)
    out[:, valid] = arr[:, yi[valid], xi[valid]]
    return out


def _clip_like(arr, ref):
    if np.asarray(ref).dtype == np.uint8:
        return np.clip(arr, 0, 255).astype(np.uint8)
    return arr.astype(np.float32)


class BaseTransform:
    """Reference BaseTransform: keys-aware transform base; subclasses
    implement _apply_image (and optionally _apply_{boxes,mask})."""

    def __init__(self, keys=None):
        self.keys = keys or ("image",)

    def __call__(self, inputs):
        if not isinstance(inputs, (list, tuple)):
            return self._apply_image(inputs)
        outs = []
        for key, data in zip(self.keys, inputs):
            fn = getattr(self, f"_apply_{key}", None)
            outs.append(fn(data) if fn else data)
        return tuple(outs)

    def _apply_image(self, img):
        raise NotImplementedError


class BrightnessTransform(BaseTransform):
    def __init__(self, value, keys=None):
        super().__init__(keys)
        self.value = float(value)

    def _apply_image(self, img):
        if self.value == 0:
            return img
        f = np.random.uniform(max(0, 1 - self.value), 1 + self.value)
        return adjust_brightness(img, f)


class ContrastTransform(BaseTransform):
    def __init__(self, value, keys=None):
        super().__init__(keys)
        if value < 0:
            raise ValueError("contrast value must be non-negative")
        self.value = float(value)

    def _apply_image(self, img):
        if self.value == 0:
            return img
        f = np.random.uniform(max(0, 1 - self.value), 1 + self.value)
        return adjust_contrast(img, f)


class SaturationTransform(BaseTransform):
    def __init__(self, value, keys=None):
        super().__init__(keys)
        self.value = float(value)

    def _apply_image(self, img):
        if self.value == 0:
            return img
        f = np.random.uniform(max(0, 1 - self.value), 1 + self.value)
        arr = _chw(img).astype(np.float32)
        gray = to_grayscale(img, 3).astype(np.float32)
        return _clip_like(gray + f * (arr - gray), img)


class HueTransform(BaseTransform):
    def __init__(self, value, keys=None):
        super().__init__(keys)
        if not 0 <= value <= 0.5:
            raise ValueError("hue value must be in [0, 0.5]")
        self.value = float(value)

    def _apply_image(self, img):
        if self.value == 0:
            return img
        return adjust_hue(img, np.random.uniform(-self.value, self.value))


class ColorJitter(BaseTransform):
    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0,
                 keys=None):
        super().__init__(keys)
        self._ts = [BrightnessTransform(brightness), ContrastTransform(contrast),
                    SaturationTransform(saturation), HueTransform(hue)]

    def _apply_image(self, img):
        order = np.random.permutation(len(self._ts))
        for i in order:
            img = self._ts[i]._apply_image(img)
        return img


class Grayscale(BaseTransform):
    def __init__(self, num_output_channels=1, keys=None):
        super().__init__(keys)
        self.num_output_channels = num_output_channels

    def _apply_image(self, img):
        return to_grayscale(img, self.num_output_channels)


class RandomErasing(BaseTransform):
    def __init__(self, prob=0.5, scale=(0.02, 0.33), ratio=(0.3, 3.3),
                 value=0, inplace=False, keys=None):
        super().__init__(keys)
        self.prob, self.scale, self.ratio, self.value = prob, scale, ratio, value

    def _apply_image(self, img):
        if np.random.rand() >= self.prob:
            return img
        arr = _chw(img)
        c, h, w = arr.shape
        area = h * w
        for _ in range(10):
            target = np.random.uniform(*self.scale) * area
            ar = np.exp(np.random.uniform(np.log(self.ratio[0]),
                                          np.log(self.ratio[1])))
            eh = int(round(np.sqrt(target * ar)))
            ew = int(round(np.sqrt(target / ar)))
            if eh < h and ew < w:
                i = np.random.randint(0, h - eh)
                j = np.random.randint(0, w - ew)
                return erase(img, i, j, eh, ew, self.value)
        return img


class RandomRotation(BaseTransform):
    def __init__(self, degrees, interpolation="nearest", expand=False,
                 center=None, fill=0, keys=None):
        super().__init__(keys)
        self.degrees = ((-degrees, degrees) if np.isscalar(degrees)
                        else tuple(degrees))
        self.fill = fill

    def _apply_image(self, img):
        angle = np.random.uniform(*self.degrees)
        return rotate(img, angle, fill=self.fill)


class RandomAffine(BaseTransform):
    def __init__(self, degrees, translate=None, scale=None, shear=None,
                 interpolation="nearest", fill=0, center=None, keys=None):
        super().__init__(keys)
        self.degrees = ((-degrees, degrees) if np.isscalar(degrees)
                        else tuple(degrees))
        self.translate, self.scale_rng, self.shear = translate, scale, shear
        self.fill = fill

    def _apply_image(self, img):
        c, h, w = _chw(img).shape
        angle = np.random.uniform(*self.degrees)
        tx = ty = 0
        if self.translate:
            tx = np.random.uniform(-self.translate[0], self.translate[0]) * w
            ty = np.random.uniform(-self.translate[1], self.translate[1]) * h
        sc = np.random.uniform(*self.scale_rng) if self.scale_rng else 1.0
        shx = shy = 0.0
        if self.shear is not None:
            s = self.shear
            if np.isscalar(s):  # number -> x-shear in (-s, s)
                shx = np.random.uniform(-s, s)
            elif len(s) == 2:  # (min, max) x-shear range
                shx = np.random.uniform(s[0], s[1])
            else:  # (xmin, xmax, ymin, ymax)
                shx = np.random.uniform(s[0], s[1])
                shy = np.random.uniform(s[2], s[3])
        return affine(img, angle, (tx, ty), sc, (shx, shy), fill=self.fill)


class RandomPerspective(BaseTransform):
    def __init__(self, prob=0.5, distortion_scale=0.5,
                 interpolation="nearest", fill=0, keys=None):
        super().__init__(keys)
        self.prob, self.distortion_scale, self.fill = prob, distortion_scale, fill

    def _apply_image(self, img):
        if np.random.rand() >= self.prob:
            return img
        c, h, w = _chw(img).shape
        d = self.distortion_scale
        half_h, half_w = int(h * d / 2), int(w * d / 2)
        tl = (np.random.randint(0, half_w + 1), np.random.randint(0, half_h + 1))
        tr = (w - 1 - np.random.randint(0, half_w + 1),
              np.random.randint(0, half_h + 1))
        br = (w - 1 - np.random.randint(0, half_w + 1),
              h - 1 - np.random.randint(0, half_h + 1))
        bl = (np.random.randint(0, half_w + 1),
              h - 1 - np.random.randint(0, half_h + 1))
        start = [(0, 0), (w - 1, 0), (w - 1, h - 1), (0, h - 1)]
        return perspective(img, start, [tl, tr, br, bl], fill=self.fill)


class RandomResizedCrop(BaseTransform):
    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                 interpolation="bilinear", keys=None):
        super().__init__(keys)
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.scale, self.ratio = scale, ratio

    def _apply_image(self, img):
        arr = _chw(img)
        c, h, w = arr.shape
        area = h * w
        for _ in range(10):
            target = np.random.uniform(*self.scale) * area
            ar = np.exp(np.random.uniform(np.log(self.ratio[0]),
                                          np.log(self.ratio[1])))
            ch = int(round(np.sqrt(target / ar)))
            cw = int(round(np.sqrt(target * ar)))
            if 0 < ch <= h and 0 < cw <= w:
                i = np.random.randint(0, h - ch + 1)
                j = np.random.randint(0, w - cw + 1)
                patch = crop(arr, i, j, ch, cw)
                return Resize(self.size)(patch)
        return Resize(self.size)(center_crop(arr, min(h, w)))


__all__ += [
    "BaseTransform", "BrightnessTransform", "ColorJitter", "ContrastTransform",
    "Grayscale", "HueTransform", "RandomAffine", "RandomErasing",
    "RandomPerspective", "RandomResizedCrop", "RandomRotation",
    "SaturationTransform", "adjust_brightness", "adjust_contrast",
    "adjust_hue", "affine", "center_crop", "crop", "erase", "hflip", "pad",
    "perspective", "rotate", "to_grayscale", "vflip",
]
