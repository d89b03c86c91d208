"""Image augmentation ops of the port (``mx.nd.image``;
``mxnet_tpu/ops/image_ops.py``, reference src/operator/image/
image_random-inl.h): flips, brightness, contrast, saturation, hue, color
jitter and PCA lighting.

Every op takes ...HWC tensors, channels last, RGB, values in [0, 255]
(float or uint8), as the reference's. The random ops draw from the op's
generator (``rng``, as ``random_ops``): one draw an op call, which the
deterministic helper then applies, so a random op at a fixed draw is the
deterministic op. Their values are torch's and never jax's: they are held
to the reference by reproducibility from a seed, by their range and by
the deterministic op at the draw. The hue round trip (RGB -> HLS -> RGB)
is branch-free ``where`` algebra, as the reference's.
"""
from __future__ import annotations

import torch

from ..base import Params, param_field
from .random_ops import _normal, uniform01
from .registry import register_op

# ITU-R BT.601 luma weights (the reference's AdjustContrastImpl coef[])
_LUMA = (0.299, 0.587, 0.114)


def _saturate(val, dtype):
    """saturate_cast: round and clamp into an integer dtype; a plain cast
    to a float one."""
    if not dtype.is_floating_point:
        info = torch.iinfo(dtype)
        return torch.clamp(torch.round(val), info.min, info.max).to(dtype)
    return val.to(dtype)


def _luma(f):
    """Each pixel's luminance: ...HWC float -> ...HW1."""
    w = torch.tensor(_LUMA, dtype=f.dtype, device=f.device)
    return (f[..., :3] * w).sum(dim=-1, keepdim=True)


def _require_rgb_or_gray(data, op_name):
    c = data.shape[-1]
    if c not in (1, 3):
        raise ValueError("%s expects 1 or 3 channels (channels-last), "
                         "got %d" % (op_name, c))


@register_op("_image_flip_left_right", input_names=("data",))
def _flip_left_right(params, data):
    return torch.flip(data, dims=(data.dim() - 2,))


@register_op("_image_flip_top_bottom", input_names=("data",))
def _flip_top_bottom(params, data):
    return torch.flip(data, dims=(data.dim() - 3,))


def _coin(rng, device):
    """One fair coin from ``rng`` (a 0-d bool tensor)."""
    return uniform01((), rng, device) < 0.5


@register_op("_image_random_flip_left_right", input_names=("data",),
             need_rng=True)
def _random_flip_left_right(params, data, rng=None):
    return torch.where(_coin(rng, data.device),
                       torch.flip(data, dims=(data.dim() - 2,)), data)


@register_op("_image_random_flip_top_bottom", input_names=("data",),
             need_rng=True)
def _random_flip_top_bottom(params, data, rng=None):
    return torch.where(_coin(rng, data.device),
                       torch.flip(data, dims=(data.dim() - 3,)), data)


class RandomEnhanceParam(Params):
    min_factor = param_field(float, required=True)
    max_factor = param_field(float, required=True)


def uniform_in(lo, hi, rng, device):
    """One draw of U[lo, hi) from ``rng`` (a 0-d float32 tensor)."""
    return lo + (hi - lo) * uniform01((), rng, device)


def adjust_brightness(data, alpha):
    return _saturate(data.to(torch.float32) * alpha, data.dtype)


def adjust_contrast(data, alpha):
    _require_rgb_or_gray(data, "adjust_contrast")
    f = data.to(torch.float32)
    gray = _luma(f) if data.shape[-1] > 1 else f
    # each image's own mean over (H, W, C)
    mean = gray.mean(dim=(-3, -2, -1), keepdim=True)
    return _saturate(f * alpha + (1.0 - alpha) * mean, data.dtype)


def adjust_saturation(data, alpha):
    """A blend toward each pixel's gray level (the reference's documented
    intent; mxnet_tpu keeps the same divergence from its kernel)."""
    _require_rgb_or_gray(data, "adjust_saturation")
    if data.shape[-1] == 1:
        return data
    f = data.to(torch.float32)
    return _saturate(f * alpha + (1.0 - alpha) * _luma(f), data.dtype)


def _rgb_to_hls(f):
    """[0, 255] RGB -> (h in degrees, l, s in [0, 1]) (RGB2HLSConvert)."""
    rgb = f / 255.0
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    vmax = torch.maximum(torch.maximum(r, g), b)
    vmin = torch.minimum(torch.minimum(r, g), b)
    diff = vmax - vmin
    l = (vmax + vmin) * 0.5
    nonzero = diff > torch.finfo(torch.float32).eps
    one = torch.ones_like(diff)
    safe = torch.where(nonzero, diff, one)
    s = torch.where(l < 0.5, safe / torch.clamp_min(vmax + vmin, 1e-12),
                    safe / torch.clamp_min(2.0 - vmax - vmin, 1e-12))
    hd = 60.0 / safe
    h = torch.where(vmax == r, (g - b) * hd,
                    torch.where(vmax == g, (b - r) * hd + 120.0,
                                (r - g) * hd + 240.0))
    h = torch.where(h < 0.0, h + 360.0, h)
    zero = torch.zeros_like(h)
    return torch.where(nonzero, h, zero), l, torch.where(nonzero, s, zero)


# c_HlsSectorData: each sector's table indices for (b, g, r)
_SECTORS = ((1, 3, 0), (1, 0, 2), (3, 0, 1), (0, 2, 1), (0, 1, 3), (2, 1, 0))


def _hls_to_rgb(h, l, s):
    """(h, l, s) -> [0, 255] RGB (HLS2RGBConvert)."""
    p2 = torch.where(l <= 0.5, l * (1.0 + s), l + s - l * s)
    p1 = 2.0 * l - p2
    hs = torch.remainder(h / 60.0, 6.0)
    sector = torch.floor(hs).to(torch.int64)
    frac = hs - sector
    tab = torch.stack([p2, p1, p1 + (p2 - p1) * (1.0 - frac),
                       p1 + (p2 - p1) * frac], dim=-1)
    idx = torch.tensor(_SECTORS, dtype=torch.int64, device=h.device)[sector]
    b, g, r = tab.gather(-1, idx).unbind(-1)
    gray = s == 0.0
    rgb = torch.stack([torch.where(gray, l, r), torch.where(gray, l, g),
                       torch.where(gray, l, b)], dim=-1)
    return rgb * 255.0


def adjust_hue(data, alpha):
    _require_rgb_or_gray(data, "adjust_hue")
    if data.shape[-1] == 1:
        return data
    h, l, s = _rgb_to_hls(data.to(torch.float32))
    return _saturate(_hls_to_rgb(h + alpha * 360.0, l, s), data.dtype)


def _enhance(adjust):
    def op(params, data, rng=None):
        return adjust(data, uniform_in(params.min_factor, params.max_factor,
                                       rng, data.device))
    return op


for _name, _adjust in (("brightness", adjust_brightness),
                       ("contrast", adjust_contrast),
                       ("saturation", adjust_saturation),
                       ("hue", adjust_hue)):
    register_op("_image_random_" + _name, param_cls=RandomEnhanceParam,
                input_names=("data",), need_rng=True)(_enhance(_adjust))


class ColorJitterParam(Params):
    brightness = param_field(float, required=True)
    contrast = param_field(float, required=True)
    saturation = param_field(float, required=True)
    hue = param_field(float, required=True)


@register_op("_image_random_color_jitter", param_cls=ColorJitterParam,
             input_names=("data",), need_rng=True)
def _random_color_jitter(params, data, rng=None):
    """Brightness, contrast, saturation and hue, each jittered by 1 +-
    its strength (hue by +- its strength), in an order drawn each call;
    a stage of strength 0 is the identity."""
    _require_rgb_or_gray(data, "random_color_jitter")
    dev = data.device
    if dev.type == "meta":
        return torch.empty_like(data)
    order = torch.argsort(uniform01((4,), rng, dev)).tolist()
    stages = []
    for strength, adjust, offset in (
            (params.brightness, adjust_brightness, 1.0),
            (params.contrast, adjust_contrast, 1.0),
            (params.saturation, adjust_saturation, 1.0),
            (params.hue, adjust_hue, 0.0)):
        alpha = offset + uniform_in(-strength, strength, rng, dev)
        stages.append((lambda img, a=alpha, f=adjust: f(img, a))
                      if strength > 0 else (lambda img: img))
    out = data
    for i in order:
        out = stages[i](out)
    return out


# AlexNet's PCA lighting: ImageNet's RGB eigenvectors times their
# eigenvalues (the reference's AdjustLightingImpl eig[][])
_LIGHT_EIG = (
    (55.46 * -0.5675, 4.794 * 0.7192, 1.148 * 0.4009),
    (55.46 * -0.5808, 4.794 * -0.0045, 1.148 * -0.8140),
    (55.46 * -0.5836, 4.794 * -0.6948, 1.148 * 0.4203),
)


def adjust_lighting(data, alpha):
    _require_rgb_or_gray(data, "adjust_lighting")
    if data.shape[-1] == 1:
        return data
    eig = torch.tensor(_LIGHT_EIG, dtype=torch.float32, device=data.device)
    pca = eig @ torch.as_tensor(alpha, dtype=torch.float32,
                                device=data.device).reshape(3)
    return _saturate(data.to(torch.float32) + pca, data.dtype)


class AdjustLightingParam(Params):
    alpha = param_field(tuple, required=True)


@register_op("_image_adjust_lighting", param_cls=AdjustLightingParam,
             input_names=("data",))
def _image_adjust_lighting(params, data):
    return adjust_lighting(data, params.alpha)


class RandomLightingParam(Params):
    alpha_std = param_field(float, default=0.05)


@register_op("_image_random_lighting", param_cls=RandomLightingParam,
             input_names=("data",), need_rng=True)
def _image_random_lighting(params, data, rng=None):
    alpha = _normal((3,), rng, data.device) * params.alpha_std
    return adjust_lighting(data, alpha)
