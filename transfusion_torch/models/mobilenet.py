"""MobileNetV3-Large detection trunk (port of
``transfusion_tpu/models/mobilenet.py``): the ``model.type: mobilenet /
mobilenet_320`` backbone, torchvision's ``mobilenet_v3_large`` features
with frozen BatchNorm and the ``mobilenet_backbone`` stage outputs
(``returned_layers [1, 2, 3, 4]``: strides 4/8/16/32, channels
24/40/80/160) feeding the same FPN/RPN/RoI stack as ResNet-50.

Module names are torchvision's ``mobilenet_backbone`` body, as the ResNet
body keeps torchvision's: ``{i}`` is ``features[i]`` (``0`` the stem, block
``b`` of the setting table at ``b + 1``), a block's layers sit at
``{i}.block.{j}``, a conv + norm at ``.0`` / ``.1`` and the squeeze-excite
at ``.fc1`` / ``.fc2``. Tensors are NCHW in the channels-last memory format;
depthwise convs are grouped ``F.conv2d`` calls (XLA convs in JAX, not
Pallas kernels).

Dead blocks: JAX's trunk builds and runs blocks 13 and 14 but returns
nothing of them (the last returned level is block 12's output), so ``jit``
removes them; torchvision's ``IntermediateLayerGetter`` stops after block
12 too. Eager PyTorch would run them on every call, so the port builds
blocks 0-12 only, and ``weights.state_dict_from_jax`` skips the JAX
parameters of blocks 13 and 14.

The squeeze-excite hidden width follows JAX, ``max(8, (c // 4 + 4) // 8 *
8)``, which lacks torchvision's ``_make_divisible`` correction: at 72
expanded channels (blocks 3-5) it is 16 where torchvision has 24. The
frozen norms' eps is JAX's 1e-3.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from transfusion_torch.models.resnet import FrozenBatchNorm2d, conv

# (kernel, expanded, out, use_se, activation, stride): torchvision
# mobilenet_v3_large's inverted_residual_setting.
LARGE_SETTINGS = (
    (3, 16, 16, False, "relu", 1),
    (3, 64, 24, False, "relu", 2),
    (3, 72, 24, False, "relu", 1),
    (5, 72, 40, True, "relu", 2),
    (5, 120, 40, True, "relu", 1),
    (5, 120, 40, True, "relu", 1),
    (3, 240, 80, False, "hardswish", 2),
    (3, 200, 80, False, "hardswish", 1),
    (3, 184, 80, False, "hardswish", 1),
    (3, 184, 80, False, "hardswish", 1),
    (3, 480, 112, True, "hardswish", 1),
    (3, 672, 112, True, "hardswish", 1),
    (5, 672, 160, True, "hardswish", 2),
    (5, 960, 160, True, "hardswish", 1),
    (5, 960, 160, True, "hardswish", 1),
)
MOBILENET_CHANNELS = {"0": 24, "1": 40, "2": 80, "3": 160}
# Block index -> returned level (torchvision's stage_indices [2, 4, 7, 13]).
RETURNED = {1: "0", 3: "1", 6: "2", 12: "3"}
BUILT_BLOCKS = max(RETURNED) + 1  # blocks 13 and 14 feed nothing


def _act(x, name):
    if name is None:
        return x
    return F.hardswish(x) if name == "hardswish" else F.relu(x)


class ConvBN(nn.Sequential):
    """torchvision's Conv2dNormActivation: conv (``0``), frozen BN with eps
    1e-3 (``1``), then the activation (hardswish, relu or none)."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1, groups: int = 1,
                 activation: str | None = "hardswish", dtype=torch.float32):
        super().__init__(nn.Conv2d(cin, cout, kernel, stride, (kernel - 1) // 2, groups=groups, bias=False),
                         FrozenBatchNorm2d(cout, eps=1e-3))
        self.activation, self.dtype = activation, dtype

    def forward(self, x):
        return _act(self[1](conv(x, self[0], self.dtype)), self.activation)


class SqueezeExcite(nn.Module):
    """x * hardsigmoid(fc2(relu(fc1(mean_hw(x))))), the hidden width JAX's."""

    def __init__(self, channels: int, dtype=torch.float32):
        super().__init__()
        hidden = max(8, int((channels // 4 + 4) // 8) * 8)
        self.fc1 = nn.Conv2d(channels, hidden, 1)
        self.fc2 = nn.Conv2d(hidden, channels, 1)
        self.dtype = dtype

    def forward(self, x):
        s = x.mean(dim=(2, 3), keepdim=True)
        s = conv(F.relu(conv(s, self.fc1, self.dtype)), self.fc2, self.dtype)
        return x * F.hardsigmoid(s)


class InvertedResidual(nn.Module):
    """Expand (1x1, where the width changes), depthwise, squeeze-excite
    (where the setting has it), project (1x1, no activation); the residual
    where the stride is 1 and the width is kept."""

    def __init__(self, cin: int, kernel: int, expanded: int, out: int, use_se: bool,
                 activation: str, stride: int, dtype=torch.float32):
        super().__init__()
        layers = []
        if expanded != cin:
            layers.append(ConvBN(cin, expanded, 1, activation=activation, dtype=dtype))
        layers.append(ConvBN(expanded, expanded, kernel, stride, groups=expanded, activation=activation,
                             dtype=dtype))
        if use_se:
            layers.append(SqueezeExcite(expanded, dtype))
        layers.append(ConvBN(expanded, out, 1, activation=None, dtype=dtype))
        self.block = nn.Sequential(*layers)
        self.residual = stride == 1 and cin == out

    def forward(self, x):
        h = self.block(x)
        return h + x if self.residual else h


class MobileNetV3Features(nn.Sequential):
    """forward(x NCHW) -> {"0".."3"}: the outputs of blocks 1, 3, 6 and 12
    (strides 4/8/16/32). ``train`` is ignored: the norms are frozen, as
    JAX's are whatever ``model.batch_norm`` says."""

    def __init__(self, dtype=torch.float32):
        mods, cin = [ConvBN(3, 16, 3, 2, activation="hardswish", dtype=dtype)], 16
        for k, exp, c, se, act, s in LARGE_SETTINGS[:BUILT_BLOCKS]:
            mods.append(InvertedResidual(cin, k, exp, c, se, act, s, dtype))
            cin = c
        super().__init__(*mods)

    def forward(self, x, train: bool = False):
        out = {}
        h = self[0](x)
        for i in range(BUILT_BLOCKS):
            h = self[i + 1](h)
            if i in RETURNED:
                out[RETURNED[i]] = h
        return out
