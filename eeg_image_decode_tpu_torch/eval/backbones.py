"""Inference-only vision backbones of the reconstruction-metric table
(counterpart of ``eeg_image_decode_tpu/eval/backbones.py``).

The reference's metric notebook takes four torchvision/hub CNNs as frozen
feature extractors (``Generation/Reconstruction_Metrics_ATM.ipynb``):

- AlexNet ``features.4`` / ``features.11`` → the 2-way rows (cell 14);
- InceptionV3 ``avgpool`` → a 2-way row (cell 16);
- EfficientNet-B1 ``avgpool`` → a correlation-distance row (cell 20);
- SwAV ResNet-50 ``avgpool`` → a correlation-distance row (cell 22).

(The CLIP ViT-L/14 row is ``recon_metrics.make_clip_extractor`` over
``models/clip_vit.py``.) Each backbone is a plain NCHW ``nn.Module`` with
torchvision's own parameter names, so a torchvision ``state_dict`` loads
with ``strict=True`` once its classifier, ``fc`` or ``AuxLogits`` keys are
dropped: that is what ``convert_alexnet`` … ``convert_efficientnet_b1`` do.
The JAX package's flax trees cross through ``utils/convert.py::
backbone_state_dict_from_flax``. BatchNorms are frozen (``model.eval()``
statistics), with the JAX package's eps: 1e-3 in InceptionV3, 1e-5
elsewhere.

Extractors take (N, H, W, 3) images in [0, 1]; ``imagenet_preprocess``
applies the notebook's bilinear resize (antialiased when it downscales, as
``jax.image.resize``) and ImageNet's normalisation. AlexNet's nodes are
flattened in (C, H, W) order, torchvision's; the JAX package flattens
(H, W, C), which permutes feature positions that both images of a pair
share, so the 2-way and distance rows are the same.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from eeg_image_decode_tpu_torch.eval.recon_metrics import resize_bilinear

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def imagenet_preprocess(images: torch.Tensor, size: int) -> torch.Tensor:
    """[0, 1] NHWC → resized to size × size, ImageNet-normalised NHWC."""
    if images.shape[1] != size or images.shape[2] != size:
        images = resize_bilinear(images, size)
    mean = images.new_tensor(IMAGENET_MEAN, dtype=torch.float32)
    std = images.new_tensor(IMAGENET_STD, dtype=torch.float32)
    return (images.float() - mean) / std


class FrozenBatchNorm2d(nn.BatchNorm2d):
    """Inference BatchNorm: ``weight``, ``bias``, ``running_mean`` and
    ``running_var`` as torchvision stores them, never updated; the JAX
    ``FrozenBN`` arithmetic, x · s + (b − m · s) with s = w / √(v + eps)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = self.weight * torch.rsqrt(self.running_var + self.eps)
        shift = self.bias - self.running_mean * inv
        return x * inv[:, None, None] + shift[:, None, None]


def init_random(model: nn.Module, seed: int) -> nn.Module:
    """Seeded random weights in place, drawn on the CPU from one
    ``torch.Generator`` in parameter order, then buffer order: conv weights
    N(0, 2/fan_in), conv biases N(0, 0.02²), BN scales 1 + N(0, 0.1²), BN
    shifts and running means N(0, 0.1²), running variances U(0.5, 1.5).
    Every term of the forward is non-trivial, which a smoke run wants."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            for name, p in m.named_parameters(recurse=False):
                v = torch.randn(p.shape, generator=g)
                if isinstance(m, nn.Conv2d) and name == "weight":
                    v = v * math.sqrt(2.0 / p[0].numel())
                elif isinstance(m, FrozenBatchNorm2d) and name == "weight":
                    v = 1.0 + 0.1 * v
                else:
                    v = (0.02 if isinstance(m, nn.Conv2d) else 0.1) * v
                p.copy_(v)
        for m in model.modules():
            if isinstance(m, FrozenBatchNorm2d):
                m.running_mean.copy_(
                    0.1 * torch.randn(m.running_mean.shape, generator=g))
                m.running_var.copy_(
                    0.5 + torch.rand(m.running_var.shape, generator=g))
    return model


def _without(sd: dict, heads: tuple[str, ...]) -> dict[str, torch.Tensor]:
    """A torchvision ``state_dict`` without the keys under ``heads``; float
    values as fp32 tensors (numpy arrays are taken too)."""
    out = {}
    for k, v in sd.items():
        if k.startswith(heads):
            continue
        v = torch.as_tensor(v)
        out[k] = v.float() if v.is_floating_point() else v
    return out


# ————————————————————————————— AlexNet —————————————————————————————


class AlexNetFeatures(nn.Module):
    """torchvision AlexNet's ``features`` trunk → ``{"f4", "f11"}``, the
    ReLUs after conv-2 and conv-5 (the notebook's return nodes), NCHW."""

    def __init__(self):
        super().__init__()
        self.features = nn.Sequential(
            nn.Conv2d(3, 64, 11, stride=4, padding=2), nn.ReLU(),
            nn.MaxPool2d(3, 2),
            nn.Conv2d(64, 192, 5, padding=2), nn.ReLU(),
            nn.MaxPool2d(3, 2),
            nn.Conv2d(192, 384, 3, padding=1), nn.ReLU(),
            nn.Conv2d(384, 256, 3, padding=1), nn.ReLU(),
            nn.Conv2d(256, 256, 3, padding=1), nn.ReLU(),
            nn.MaxPool2d(3, 2),
        )

    def forward(self, x: torch.Tensor) -> dict[str, torch.Tensor]:
        out = {}
        for i, layer in enumerate(self.features[:12]):
            x = layer(x)
            if i == 4:
                out["f4"] = x
        out["f11"] = x
        return out


def convert_alexnet(sd: dict) -> dict[str, torch.Tensor]:
    """torchvision ``alexnet`` ``state_dict`` → :class:`AlexNetFeatures`'s
    (the ``classifier`` dropped)."""
    return _without(sd, ("classifier.",))


# ————————————————————————————— ResNet-50 (SwAV) —————————————————————————————


class _Bottleneck(nn.Module):
    def __init__(self, in_ch: int, width: int, stride: int):
        super().__init__()
        self.conv1 = nn.Conv2d(in_ch, width, 1, bias=False)
        self.bn1 = FrozenBatchNorm2d(width)
        self.conv2 = nn.Conv2d(width, width, 3, stride=stride, padding=1,
                               bias=False)
        self.bn2 = FrozenBatchNorm2d(width)
        self.conv3 = nn.Conv2d(width, width * 4, 1, bias=False)
        self.bn3 = FrozenBatchNorm2d(width * 4)
        self.downsample = None
        if stride != 1 or in_ch != width * 4:
            self.downsample = nn.Sequential(
                nn.Conv2d(in_ch, width * 4, 1, stride=stride, bias=False),
                FrozenBatchNorm2d(width * 4))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class ResNet50(nn.Module):
    """torchvision ``resnet50`` (v1.5: the stride on the 3 × 3) through
    ``avgpool`` → (B, 2048). SwAV's released ResNet-50 is this trunk."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = FrozenBatchNorm2d(64)
        in_ch = 64
        for li, (width, blocks, stride) in enumerate(
                ((64, 3, 1), (128, 4, 2), (256, 6, 2), (512, 3, 2)), start=1):
            layer = []
            for bi in range(blocks):
                layer.append(_Bottleneck(in_ch, width,
                                         stride if bi == 0 else 1))
                in_ch = width * 4
            setattr(self, f"layer{li}", nn.Sequential(*layer))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, padding=1)  # pads with −inf
        for li in range(1, 5):
            x = getattr(self, f"layer{li}")(x)
        return x.mean(dim=(2, 3))


def convert_resnet50(sd: dict) -> dict[str, torch.Tensor]:
    """torchvision / SwAV ``resnet50`` ``state_dict`` → :class:`ResNet50`'s
    (``fc`` and SwAV's ``projection_head`` / ``prototypes`` dropped)."""
    return _without(sd, ("fc.", "projection_head.", "prototypes."))


# ————————————————————————————— InceptionV3 —————————————————————————————

_INCEPTION_EPS = 1e-3  # torchvision BasicConv2d: BatchNorm2d(eps=0.001)


class _BasicConv(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, kernel=1, stride=1,
                 padding=0):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, kernel, stride=stride,
                              padding=padding, bias=False)
        self.bn = FrozenBatchNorm2d(out_ch, eps=_INCEPTION_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


def _avg_pool_3x3_same(x: torch.Tensor) -> torch.Tensor:
    """torch ``avg_pool2d(3, stride=1, padding=1)``: the padding counts."""
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=True)


class _InceptionA(nn.Module):
    def __init__(self, in_ch: int, pool_features: int):
        super().__init__()
        self.branch1x1 = _BasicConv(in_ch, 64)
        self.branch5x5_1 = _BasicConv(in_ch, 48)
        self.branch5x5_2 = _BasicConv(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = _BasicConv(in_ch, 64)
        self.branch3x3dbl_2 = _BasicConv(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = _BasicConv(96, 96, 3, padding=1)
        self.branch_pool = _BasicConv(in_ch, pool_features)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(_avg_pool_3x3_same(x))
        return torch.cat([b1, b5, b3, bp], 1)


class _InceptionB(nn.Module):
    def __init__(self, in_ch: int):
        super().__init__()
        self.branch3x3 = _BasicConv(in_ch, 384, 3, stride=2)
        self.branch3x3dbl_1 = _BasicConv(in_ch, 64)
        self.branch3x3dbl_2 = _BasicConv(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = _BasicConv(96, 96, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3(x)
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([b3, bd, F.max_pool2d(x, 3, 2)], 1)


class _InceptionC(nn.Module):
    def __init__(self, in_ch: int, c7: int):
        super().__init__()
        self.branch1x1 = _BasicConv(in_ch, 192)
        self.branch7x7_1 = _BasicConv(in_ch, c7)
        self.branch7x7_2 = _BasicConv(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = _BasicConv(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = _BasicConv(in_ch, c7)
        self.branch7x7dbl_2 = _BasicConv(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = _BasicConv(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = _BasicConv(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = _BasicConv(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = _BasicConv(in_ch, 192)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for i in range(1, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        bp = self.branch_pool(_avg_pool_3x3_same(x))
        return torch.cat([b1, b7, bd, bp], 1)


class _InceptionD(nn.Module):
    def __init__(self, in_ch: int):
        super().__init__()
        self.branch3x3_1 = _BasicConv(in_ch, 192)
        self.branch3x3_2 = _BasicConv(192, 320, 3, stride=2)
        self.branch7x7x3_1 = _BasicConv(in_ch, 192)
        self.branch7x7x3_2 = _BasicConv(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = _BasicConv(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = _BasicConv(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([b3, b7, F.max_pool2d(x, 3, 2)], 1)


class _InceptionE(nn.Module):
    def __init__(self, in_ch: int):
        super().__init__()
        self.branch1x1 = _BasicConv(in_ch, 320)
        self.branch3x3_1 = _BasicConv(in_ch, 384)
        self.branch3x3_2a = _BasicConv(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = _BasicConv(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = _BasicConv(in_ch, 448)
        self.branch3x3dbl_2 = _BasicConv(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = _BasicConv(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = _BasicConv(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = _BasicConv(in_ch, 192)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
        bp = self.branch_pool(_avg_pool_3x3_same(x))
        return torch.cat([b1, b3, bd, bp], 1)


class InceptionV3(nn.Module):
    """torchvision ``inception_v3`` through ``avgpool`` → (B, 2048).

    Inputs come ImageNet-normalised and are always remapped to Inception's
    [−1, 1] convention inside, as torchvision's pretrained factory does
    (``transform_input=True``)."""

    def __init__(self):
        super().__init__()
        self.Conv2d_1a_3x3 = _BasicConv(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = _BasicConv(32, 32, 3)
        self.Conv2d_2b_3x3 = _BasicConv(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = _BasicConv(64, 80)
        self.Conv2d_4a_3x3 = _BasicConv(80, 192, 3)
        self.Mixed_5b = _InceptionA(192, 32)
        self.Mixed_5c = _InceptionA(256, 64)
        self.Mixed_5d = _InceptionA(288, 64)
        self.Mixed_6a = _InceptionB(288)
        self.Mixed_6b = _InceptionC(768, 128)
        self.Mixed_6c = _InceptionC(768, 160)
        self.Mixed_6d = _InceptionC(768, 160)
        self.Mixed_6e = _InceptionC(768, 192)
        self.Mixed_7a = _InceptionD(768)
        self.Mixed_7b = _InceptionE(1280)
        self.Mixed_7c = _InceptionE(2048)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.stack([
            x[:, i] * (IMAGENET_STD[i] / 0.5)
            + (IMAGENET_MEAN[i] - 0.5) / 0.5 for i in range(3)], 1)
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = F.max_pool2d(x, 3, 2)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = F.max_pool2d(x, 3, 2)
        for name in ("5b", "5c", "5d", "6a", "6b", "6c", "6d", "6e", "7a",
                     "7b", "7c"):
            x = getattr(self, f"Mixed_{name}")(x)
        return x.mean(dim=(2, 3))


def convert_inception_v3(sd: dict) -> dict[str, torch.Tensor]:
    """torchvision ``inception_v3`` ``state_dict`` → :class:`InceptionV3`'s
    (``AuxLogits`` and ``fc`` dropped)."""
    return _without(sd, ("AuxLogits.", "fc."))


# ————————————————————————————— EfficientNet-B1 —————————————————————————————

_EFFNET_EPS = 1e-5  # torchvision keeps BatchNorm2d's defaults for B1

#: (expand_ratio, channels, repeats, stride, kernel) per stage: B0's widths
#: with B1's depth multiplier 1.1 applied to the repeats
_EFFNET_B1_STAGES = (
    (1, 16, 2, 1, 3),
    (6, 24, 3, 2, 3),
    (6, 40, 3, 2, 5),
    (6, 80, 4, 2, 3),
    (6, 112, 4, 1, 5),
    (6, 192, 5, 2, 5),
    (6, 320, 2, 1, 3),
)


def _conv_bn(in_ch: int, out_ch: int, kernel: int = 1, stride: int = 1,
             groups: int = 1, act: bool = True) -> nn.Sequential:
    """torchvision's ``Conv2dNormActivation``: 0 conv, 1 BN, 2 SiLU."""
    layers = [nn.Conv2d(in_ch, out_ch, kernel, stride=stride,
                        padding=kernel // 2, groups=groups, bias=False),
              FrozenBatchNorm2d(out_ch, eps=_EFFNET_EPS)]
    if act:
        layers.append(nn.SiLU())
    return nn.Sequential(*layers)


class _SqueezeExcitation(nn.Module):
    def __init__(self, ch: int, squeeze: int):
        super().__init__()
        self.fc1 = nn.Conv2d(ch, squeeze, 1)
        self.fc2 = nn.Conv2d(squeeze, ch, 1)

    def forward(self, x):
        s = self.fc2(F.silu(self.fc1(x.mean(dim=(2, 3), keepdim=True))))
        return x * torch.sigmoid(s)


class _MBConv(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, expand: int, kernel: int,
                 stride: int):
        super().__init__()
        mid = in_ch * expand
        units = [_conv_bn(in_ch, mid)] if expand != 1 else []
        units += [_conv_bn(mid, mid, kernel, stride, groups=mid),
                  # squeeze to the block's input channels // 4
                  _SqueezeExcitation(mid, max(1, in_ch // 4)),
                  _conv_bn(mid, out_ch, act=False)]
        self.block = nn.Sequential(*units)
        self.residual = stride == 1 and in_ch == out_ch

    def forward(self, x):
        h = self.block(x)
        return h + x if self.residual else h  # StochasticDepth: eval


class EfficientNetB1(nn.Module):
    """torchvision ``efficientnet_b1`` through ``avgpool`` → (B, 1280):
    ``features.0`` the stem, ``features.{1..7}.{i}.block`` the MBConv units
    ([expand][depthwise][SE][project]), ``features.8`` the head."""

    def __init__(self):
        super().__init__()
        stages = [_conv_bn(3, 32, 3, 2)]
        in_ch = 32
        for t, c, n, s, k in _EFFNET_B1_STAGES:
            blocks = []
            for bi in range(n):
                blocks.append(_MBConv(in_ch, c, t, k, s if bi == 0 else 1))
                in_ch = c
            stages.append(nn.Sequential(*blocks))
        stages.append(_conv_bn(in_ch, 1280))
        self.features = nn.Sequential(*stages)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.features(x).mean(dim=(2, 3))


def convert_efficientnet_b1(sd: dict) -> dict[str, torch.Tensor]:
    """torchvision ``efficientnet_b1`` ``state_dict`` → :class:`
    EfficientNetB1`'s (the ``classifier`` dropped)."""
    return _without(sd, ("classifier.",))


# ————————————————————————————— extractor factory —————————————————————————————

#: the ``--backbone-params`` pickle's keys → the module each holds
BACKBONES = {"alexnet": AlexNetFeatures, "inception": InceptionV3,
             "effnet": EfficientNetB1, "swav": ResNet50}

#: extractor kind → its resize, the notebook's rows
_SIZES = {"alexnet2": 256, "alexnet5": 256, "inception": 342, "effnet": 255,
          "swav": 224}


def make_imagenet_extractor(kind: str, model: nn.Module
                            ) -> Callable[[torch.Tensor], torch.Tensor]:
    """``kind`` → images → (N, D) features for ``reconstruction_metrics``.

    Kinds: ``alexnet2`` / ``alexnet5`` (an :class:`AlexNetFeatures`, its
    ``f4`` / ``f11`` node at 256 px), ``inception`` (342 px), ``effnet``
    (255 px) and ``swav`` (224 px): the notebook's rows (cells 14-22) with
    their resizes. ``model`` lies on the images' device."""
    size = _SIZES[kind]
    node = {"alexnet2": "f4", "alexnet5": "f11"}.get(kind)

    @torch.no_grad()
    def extract(images: torch.Tensor) -> torch.Tensor:
        x = imagenet_preprocess(images, size).permute(0, 3, 1, 2)
        out = model(x.contiguous())
        if node is not None:
            out = out[node]
        return out.reshape(images.shape[0], -1)

    return extract
