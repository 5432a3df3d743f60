"""Image transforms of the port (counterpart of
paddle_tpu/vision/transforms/; reference
python/paddle/vision/transforms/transforms.py and functional.py).

They run on the host, in the DataLoader's worker threads, on numpy arrays
(CHW when the first dim is 1, 3 or 4, else HW or HWC), as the JAX
package's do; their random draws come from numpy's global generator, so
the same ``np.random.seed`` gives both packages the same crops, flips and
jitters. ``to_tensor`` returns a torch tensor on the CPU; the DataLoader
moves batches to the device.
"""
from __future__ import annotations

import numpy as np
import torch


class Compose:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, x):
        for t in self.transforms:
            x = t(x)
        return x


class ToTensor:
    def __init__(self, data_format="CHW"):
        self.data_format = data_format

    def __call__(self, img):
        arr = np.asarray(img, np.float32)
        if arr.max() > 1.5:
            arr = arr / 255.0
        if arr.ndim == 2:
            arr = arr[None]
        elif arr.ndim == 3 and arr.shape[-1] in (1, 3, 4) and self.data_format == "CHW":
            arr = arr.transpose(2, 0, 1)
        return arr


class Normalize:
    def __init__(self, mean=0.0, std=1.0, data_format="CHW", to_rgb=False):
        self.mean = np.asarray(mean, np.float32).reshape(-1, 1, 1)
        self.std = np.asarray(std, np.float32).reshape(-1, 1, 1)

    def __call__(self, img):
        return (np.asarray(img, np.float32) - self.mean) / self.std


class Resize:
    def __init__(self, size, interpolation="bilinear"):
        self.size = (size, size) if isinstance(size, int) else tuple(size)

    def __call__(self, img):
        arr = np.asarray(img, np.float32)
        chw = arr.ndim == 3 and arr.shape[0] in (1, 3, 4)
        h_ax, w_ax = (1, 2) if chw else (0, 1)
        oh, ow = self.size
        ih, iw = arr.shape[h_ax], arr.shape[w_ax]
        ri = (np.arange(oh) * ih / oh).astype(int).clip(0, ih - 1)
        ci = (np.arange(ow) * iw / ow).astype(int).clip(0, iw - 1)
        out = np.take(np.take(arr, ri, h_ax), ci, w_ax)
        return out


class RandomHorizontalFlip:
    def __init__(self, prob=0.5):
        self.prob = prob

    def __call__(self, img):
        if np.random.rand() < self.prob:
            return np.asarray(img)[..., ::-1].copy()
        return np.asarray(img)


class CenterCrop:
    def __init__(self, size):
        self.size = (size, size) if isinstance(size, int) else tuple(size)

    def __call__(self, img):
        arr = np.asarray(img)
        chw = arr.ndim == 3 and arr.shape[0] in (1, 3, 4)
        h_ax = 1 if chw else 0
        h, w = arr.shape[h_ax], arr.shape[h_ax + 1]
        th, tw = self.size
        i, j = (h - th) // 2, (w - tw) // 2
        if chw:
            return arr[:, i:i + th, j:j + tw]
        return arr[i:i + th, j:j + tw]


class RandomVerticalFlip:
    def __init__(self, prob=0.5):
        self.prob = prob

    def __call__(self, img):
        arr = np.asarray(img)
        if np.random.rand() < self.prob:
            chw = arr.ndim == 3 and arr.shape[0] in (1, 3, 4)
            ax = 1 if chw else 0
            return np.flip(arr, axis=ax).copy()
        return arr


def _hw_axes(arr):
    chw = arr.ndim == 3 and arr.shape[0] in (1, 3, 4)
    return (1, 2) if chw else (0, 1)


def _norm_padding(padding):
    """int -> all sides; (w, h) -> (l, t, r, b); 4-tuple passes through."""
    if isinstance(padding, int):
        return (padding,) * 4
    padding = tuple(padding)
    if len(padding) == 2:
        return (padding[0], padding[1], padding[0], padding[1])
    assert len(padding) == 4, f"padding must be int, 2- or 4-tuple: {padding}"
    return padding


class RandomCrop:
    def __init__(self, size, padding=None, pad_if_needed=False):
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.padding = padding
        self.pad_if_needed = pad_if_needed

    def __call__(self, img):
        arr = np.asarray(img)
        h_ax, w_ax = _hw_axes(arr)
        if self.padding is not None:
            left, top, right, bottom = _norm_padding(self.padding)
            pads = [(0, 0)] * arr.ndim
            pads[h_ax], pads[w_ax] = (top, bottom), (left, right)
            arr = np.pad(arr, pads)
        th, tw = self.size
        h, w = arr.shape[h_ax], arr.shape[w_ax]
        if self.pad_if_needed and (h < th or w < tw):
            pads = [(0, 0)] * arr.ndim
            pads[h_ax] = (0, max(0, th - h))
            pads[w_ax] = (0, max(0, tw - w))
            arr = np.pad(arr, pads)
            h, w = arr.shape[h_ax], arr.shape[w_ax]
        if h < th or w < tw:
            raise ValueError(
                f"RandomCrop: image ({h}x{w}) smaller than crop {self.size}; "
                f"use pad_if_needed=True or a smaller crop size")
        i = np.random.randint(0, h - th + 1)
        j = np.random.randint(0, w - tw + 1)
        sl = [slice(None)] * arr.ndim
        sl[h_ax], sl[w_ax] = slice(i, i + th), slice(j, j + tw)
        return arr[tuple(sl)]


class RandomResizedCrop:
    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                 interpolation="bilinear"):
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.scale = scale
        self.ratio = ratio
        self.interpolation = interpolation

    def __call__(self, img):
        arr = np.asarray(img, np.float32)
        h_ax, w_ax = _hw_axes(arr)
        h, w = arr.shape[h_ax], arr.shape[w_ax]
        area = h * w
        for _ in range(10):
            target = area * np.random.uniform(*self.scale)
            ar = np.exp(np.random.uniform(np.log(self.ratio[0]),
                                          np.log(self.ratio[1])))
            tw = int(round(np.sqrt(target * ar)))
            th = int(round(np.sqrt(target / ar)))
            if 0 < tw <= w and 0 < th <= h:
                i = np.random.randint(0, h - th + 1)
                j = np.random.randint(0, w - tw + 1)
                sl = [slice(None)] * arr.ndim
                sl[h_ax], sl[w_ax] = slice(i, i + th), slice(j, j + tw)
                arr = arr[tuple(sl)]
                break
        return Resize(self.size, interpolation=self.interpolation)(arr)


class Pad:
    def __init__(self, padding, fill=0, padding_mode="constant"):
        self.padding = (padding,) * 4 if isinstance(padding, int) else \
            tuple(padding) * (2 if len(padding) == 2 else 1)
        self.fill = fill
        self.mode = padding_mode

    def __call__(self, img):
        arr = np.asarray(img)
        left, top, right, bottom = (self.padding if len(self.padding) == 4 else
                                    self.padding * 2)
        h_ax, w_ax = _hw_axes(arr)
        pads = [(0, 0)] * arr.ndim
        pads[h_ax], pads[w_ax] = (top, bottom), (left, right)
        if self.mode == "constant":
            return np.pad(arr, pads, constant_values=self.fill)
        return np.pad(arr, pads, mode=self.mode)


class Grayscale:
    def __init__(self, num_output_channels=1):
        self.n = num_output_channels

    def __call__(self, img):
        arr = np.asarray(img, np.float32)
        if arr.ndim == 3 and arr.shape[0] in (3, 4):  # CHW color
            g = (0.299 * arr[0] + 0.587 * arr[1] + 0.114 * arr[2])[None]
            ch_ax = 0
        elif arr.ndim == 3 and arr.shape[-1] in (3, 4):  # HWC color
            g = (arr[..., :3] @ np.array([0.299, 0.587, 0.114],
                                         np.float32))[..., None]
            ch_ax = -1
        elif arr.ndim == 3 and arr.shape[0] == 1:  # (1,H,W) already gray
            g, ch_ax = arr, 0
        elif arr.ndim == 2:  # HW: grow a trailing channel dim
            g, ch_ax = arr[..., None], -1
        else:
            raise ValueError(f"Grayscale: unsupported image shape {arr.shape}")
        reps = [1] * g.ndim
        reps[ch_ax] = self.n
        return np.tile(g, reps)


def _jitter_factor(value):
    # reference samples uniform(max(0, 1-v), 1+v): never inverts pixels
    return np.random.uniform(max(0.0, 1.0 - value), 1.0 + value)


class BrightnessTransform:
    def __init__(self, value):
        self.value = value

    def __call__(self, img):
        arr = np.asarray(img, np.float32)
        hi = 255 if arr.max() > 1.5 else 1.0
        return (arr * _jitter_factor(self.value)).clip(0, hi)


class ContrastTransform:
    def __init__(self, value):
        self.value = value

    def __call__(self, img):
        arr = np.asarray(img, np.float32)
        mean = arr.mean()
        hi = 255 if arr.max() > 1.5 else 1.0
        return ((arr - mean) * _jitter_factor(self.value) + mean).clip(0, hi)


class SaturationTransform:
    def __init__(self, value):
        self.value = value

    def __call__(self, img):
        arr = np.asarray(img, np.float32)
        f = _jitter_factor(self.value)
        gray = Grayscale(arr.shape[0] if _hw_axes(arr) == (1, 2) else
                         arr.shape[-1] if arr.ndim == 3 else 1)(arr)
        hi = 255 if arr.max() > 1.5 else 1.0
        return (gray + (arr - gray) * f).clip(0, hi)


class HueTransform:
    """Hue rotation by a uniform shift in [-value, value] (value <= 0.5 in the
    paddle API, interpreted as a fraction of the full hue circle)."""

    def __init__(self, value):
        assert 0 <= value <= 0.5, "hue value must be in [0, 0.5]"
        self.value = value

    def __call__(self, img):
        arr = np.asarray(img, np.float32)
        chw = _hw_axes(arr) == (1, 2)
        if arr.ndim != 3 or (arr.shape[0] if chw else arr.shape[-1]) < 3:
            return arr  # hue is undefined for grayscale
        rgb = arr if not chw else np.moveaxis(arr, 0, -1)
        hi = 255 if rgb.max() > 1.5 else 1.0
        x = rgb[..., :3] / hi
        # RGB hue rotation via the YIQ chroma-plane rotation matrix
        theta = 2 * np.pi * np.random.uniform(-self.value, self.value)
        c, s = np.cos(theta), np.sin(theta)
        to_yiq = np.array([[0.299, 0.587, 0.114],
                           [0.596, -0.274, -0.321],
                           [0.211, -0.523, 0.311]], np.float32)
        rot = np.array([[1, 0, 0], [0, c, -s], [0, s, c]], np.float32)
        m = np.linalg.inv(to_yiq) @ rot @ to_yiq
        out3 = (x @ m.T).clip(0, 1) * hi
        out = np.concatenate([out3, rgb[..., 3:]], -1) if rgb.shape[-1] > 3 \
            else out3
        return np.moveaxis(out, -1, 0) if chw else out


class ColorJitter:
    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0):
        self.ts = []
        if brightness:
            self.ts.append(BrightnessTransform(brightness))
        if contrast:
            self.ts.append(ContrastTransform(contrast))
        if saturation:
            self.ts.append(SaturationTransform(saturation))
        if hue:
            self.ts.append(HueTransform(hue))

    def __call__(self, img):
        order = np.random.permutation(len(self.ts)) if self.ts else []
        for i in order:
            img = self.ts[i](img)
        return img


class RandomRotation:
    def __init__(self, degrees, interpolation="nearest", expand=False,
                 center=None, fill=0):
        self.degrees = (-degrees, degrees) if np.isscalar(degrees) else degrees

    def __call__(self, img):
        arr = np.asarray(img, np.float32)
        angle = np.random.uniform(*self.degrees)
        h_ax, w_ax = _hw_axes(arr)
        # nearest-neighbor rotation via inverse mapping
        h, w = arr.shape[h_ax], arr.shape[w_ax]
        cy, cx = (h - 1) / 2, (w - 1) / 2
        th = np.deg2rad(angle)
        yy, xx = np.mgrid[0:h, 0:w]
        ys = (cy + (yy - cy) * np.cos(th) + (xx - cx) * np.sin(th)).round()
        xs = (cx - (yy - cy) * np.sin(th) + (xx - cx) * np.cos(th)).round()
        valid = (ys >= 0) & (ys < h) & (xs >= 0) & (xs < w)
        ys, xs = ys.clip(0, h - 1).astype(int), xs.clip(0, w - 1).astype(int)
        if h_ax == 1:  # CHW
            out = arr[:, ys, xs]
            out = np.where(valid[None], out, 0)
        else:
            out = arr[ys, xs]
            out = np.where(valid if out.ndim == 2 else valid[..., None], out, 0)
        return out


class Transpose:
    def __init__(self, order=(2, 0, 1)):
        self.order = order

    def __call__(self, img):
        return np.asarray(img).transpose(self.order)


# ---------------- functional API (reference vision/transforms/functional.py) ---
class BaseTransform:
    """Base for custom transforms (reference transforms.BaseTransform):
    subclasses implement _apply_image / _apply_* per data kind."""

    def __init__(self, keys=None):
        self.keys = keys or ("image",)

    def _apply_image(self, image):
        raise NotImplementedError

    def __call__(self, inputs):
        if not isinstance(inputs, (list, tuple)):
            return self._apply_image(inputs)
        out = []
        for key, data in zip(self.keys, inputs):
            fn = getattr(self, f"_apply_{key}", None)
            out.append(fn(data) if fn else data)
        return tuple(out)


def _chw(arr):
    a = np.asarray(arr)
    return a, (a.ndim == 3 and a.shape[0] in (1, 3, 4))


def to_tensor(pic, data_format="CHW"):
    """``pic`` as an f32 torch tensor on the CPU: HW grows a channel dim,
    HWC becomes CHW (at ``data_format="CHW"``), uint8 is scaled to [0, 1]."""
    a = np.asarray(pic)
    if a.ndim == 2:
        a = a[None] if data_format == "CHW" else a[..., None]
    elif a.ndim == 3 and data_format == "CHW" and a.shape[-1] in (1, 3, 4) \
            and a.shape[0] not in (1, 3, 4):
        a = a.transpose(2, 0, 1)  # HWC -> CHW
    if a.dtype == np.uint8:
        a = a.astype(np.float32) / 255.0
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))


def hflip(img):
    a, chw = _chw(img)
    return a[..., ::-1] if chw or a.ndim == 2 else a[:, ::-1]


def vflip(img):
    a, chw = _chw(img)
    return a[..., ::-1, :] if chw else a[::-1]


def resize(img, size, interpolation="bilinear"):
    return Resize(size, interpolation)(np.asarray(img))


def pad(img, padding, fill=0, padding_mode="constant"):
    return Pad(padding, fill, padding_mode)(np.asarray(img))


def rotate(img, angle, interpolation="nearest", expand=False, center=None,
           fill=0):
    arr = np.asarray(img, np.float32)
    h_ax, w_ax = _hw_axes(arr)
    h, w = arr.shape[h_ax], arr.shape[w_ax]
    cy, cx = (h - 1) / 2, (w - 1) / 2
    th = np.deg2rad(float(angle))
    yy, xx = np.mgrid[0:h, 0:w]
    ys = (cy + (yy - cy) * np.cos(th) + (xx - cx) * np.sin(th)).round()
    xs = (cx - (yy - cy) * np.sin(th) + (xx - cx) * np.cos(th)).round()
    valid = (ys >= 0) & (ys < h) & (xs >= 0) & (xs < w)
    ys, xs = ys.clip(0, h - 1).astype(int), xs.clip(0, w - 1).astype(int)
    if h_ax == 1:  # CHW
        out = arr[:, ys, xs]
        return np.where(valid[None], out, fill)
    out = arr[ys, xs]
    return np.where(valid if out.ndim == 2 else valid[..., None], out, fill)


def to_grayscale(img, num_output_channels=1):
    return Grayscale(num_output_channels)(np.asarray(img))


def crop(img, top, left, height, width):
    a, chw = _chw(img)
    if chw:
        return a[:, top:top + height, left:left + width]
    return a[top:top + height, left:left + width]


def center_crop(img, output_size):
    return CenterCrop(output_size)(np.asarray(img))


def adjust_brightness(img, brightness_factor):
    a, _ = _chw(img)
    return np.clip(a * brightness_factor, 0, 255 if a.dtype == np.uint8 else 1e9).astype(a.dtype)


def adjust_contrast(img, contrast_factor):
    arr = np.asarray(img, np.float32)
    mean = arr.mean()
    hi = 255 if arr.max() > 1.5 else 1.0
    return ((arr - mean) * contrast_factor + mean).clip(0, hi)


def adjust_hue(img, hue_factor):
    """hue_factor in [-0.5, 0.5]: fraction of the hue circle to rotate by."""
    arr = np.asarray(img, np.float32)
    chw = _hw_axes(arr) == (1, 2)
    if arr.ndim != 3 or (arr.shape[0] if chw else arr.shape[-1]) < 3:
        return arr
    rgb = arr if not chw else np.moveaxis(arr, 0, -1)
    hi = 255 if rgb.max() > 1.5 else 1.0
    x = rgb[..., :3] / hi
    theta = 2 * np.pi * float(hue_factor)
    c, s = np.cos(theta), np.sin(theta)
    to_yiq = np.array([[0.299, 0.587, 0.114],
                       [0.596, -0.274, -0.321],
                       [0.211, -0.523, 0.311]], np.float32)
    rot = np.array([[1, 0, 0], [0, c, -s], [0, s, c]], np.float32)
    m = np.linalg.inv(to_yiq) @ rot @ to_yiq
    out3 = (x @ m.T).clip(0, 1) * hi
    out = np.concatenate([out3, rgb[..., 3:]], -1) if rgb.shape[-1] > 3 else out3
    return np.moveaxis(out, -1, 0) if chw else out


def normalize(img, mean, std, data_format="CHW", to_rgb=False):
    a = np.asarray(img, np.float32)
    mean = np.asarray(mean, np.float32)
    std = np.asarray(std, np.float32)
    if data_format == "CHW":
        return (a - mean.reshape(-1, 1, 1)) / std.reshape(-1, 1, 1)
    return (a - mean) / std
