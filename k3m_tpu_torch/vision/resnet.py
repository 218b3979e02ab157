"""ResNet-101 (caffe style, C4 split) with frozen BatchNorm, NCHW.

Counterpart of k3m_tpu/vision/resnet.py: detectron2's R101-C4 as
py-bottom-up-attention builds it (reference data_prepare.py:196-209).
conv1 7x7/2 + max-pool, res2 (3 blocks), res3 (4), res4 (23) are the
backbone; res5 (3 blocks, first stride 2) runs per RoI as the box head.

Module names are detectron2's (`stem.conv1`, `res4.7.conv2`,
`res2.0.shortcut`, each conv's BatchNorm as its `.norm`), so that the name
mapping from a caffe pkl is a near-identity and `load_state_dict(strict=
True)` checks coverage. The convolutions are cuDNN's (F.conv2d): the JAX
package runs them as XLA convolutions, with no Pallas kernel.

Padding as flax gives it: `padding=1` and `padding=3` are symmetric, and a
1x1 convolution's default "SAME" pads nothing, strided or not. The
max-pool is 3x3/2 with one cell of -inf padding on each side.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class FrozenBN(nn.Module):
    """Inference-only BatchNorm: a per-channel affine with the running
    statistics folded in (`scale` = gamma / sqrt(var + eps), `bias` =
    beta - mean * scale, at weight conversion)."""

    def __init__(self, num_features: int):
        super().__init__()
        self.register_buffer("scale", torch.ones(num_features))
        self.register_buffer("bias", torch.zeros(num_features))

    def forward(self, x):
        return x * self.scale.view(1, -1, 1, 1) + self.bias.view(1, -1, 1, 1)


class ConvBN(nn.Conv2d):
    """detectron2's Conv2d with its norm: a bias-free convolution, then the
    FrozenBN at `.norm`."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1, padding=0):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride,
                         padding=padding, bias=False)
        self.norm = FrozenBN(out_channels)

    def forward(self, x):
        return self.norm(super().forward(x))


class Bottleneck(nn.Module):
    """Caffe style: the stride sits on the 1x1 conv1 (detectron2's
    stride_in_1x1=True for caffe models). The first block of a stage has a
    projection shortcut."""

    def __init__(self, in_channels, out_channels, bottleneck_channels, stride=1,
                 has_shortcut=False):
        super().__init__()
        self.conv1 = ConvBN(in_channels, bottleneck_channels, 1, stride=stride)
        self.conv2 = ConvBN(bottleneck_channels, bottleneck_channels, 3, padding=1)
        self.conv3 = ConvBN(bottleneck_channels, out_channels, 1)
        self.shortcut = (ConvBN(in_channels, out_channels, 1, stride=stride)
                         if has_shortcut else None)

    def forward(self, x):
        out = F.relu(self.conv1(x))
        out = F.relu(self.conv2(out))
        out = self.conv3(out)
        sc = self.shortcut(x) if self.shortcut is not None else x
        return F.relu(out + sc)


class ResStage(nn.Sequential):
    def __init__(self, num_blocks, in_channels, out_channels, bottleneck_channels,
                 first_stride):
        super().__init__(*[
            Bottleneck(in_channels if i == 0 else out_channels, out_channels,
                       bottleneck_channels, stride=first_stride if i == 0 else 1,
                       has_shortcut=i == 0)
            for i in range(num_blocks)])


class Stem(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = ConvBN(3, 64, 7, stride=2, padding=3)

    def forward(self, x):
        return F.max_pool2d(F.relu(self.conv1(x)), 3, stride=2, padding=1)


class ResNet101C4Backbone(nn.Module):
    """stem + res2..res4: [B, 3, H, W] (BGR, mean-subtracted) ->
    [B, 1024, H/16, W/16]."""

    def __init__(self):
        super().__init__()
        self.stem = Stem()
        self.res2 = ResStage(3, 64, 256, 64, 1)
        self.res3 = ResStage(4, 256, 512, 128, 2)
        self.res4 = ResStage(23, 512, 1024, 256, 2)

    def forward(self, x):
        return self.res4(self.res3(self.res2(self.stem(x))))


class Res5Head(ResStage):
    """res5 on pooled RoI features: [N, 1024, 14, 14] -> [N, 2048, 7, 7]."""

    def __init__(self):
        super().__init__(3, 1024, 2048, 512, 2)
