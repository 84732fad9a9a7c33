"""Spec of the 3D-ResNet motion encoder (counterpart of the spec part of
``ipoke_tpu/models/motion_encoder.py``).  Sampling does not run the encoder;
``SecondStageSpec.validate`` needs its stride plumbing.  The network itself
waits in ROADMAP queue 1 (density direction).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class MotionEncoderSpec:
    channels: Tuple[int, ...]          # ENC_M_channels
    z_dim: int
    spatial_size: int                  # input H (= W)
    max_frames: int
    min_spatial_size: int = 8
    full_seq: bool = True
    deterministic: bool = False
    layers: Tuple[int, int, int, int] = (2, 2, 2, 2)  # resnet18

    def derived(self):
        """The reference's stride/layer plumbing:
        (channels, stride1, stride4, has_layer4, has_layer5, last_channels)."""
        channels = list(self.channels)
        first_block_down = (
            len(channels) - 1 < int(math.ceil(math.log2(self.max_frames))) or self.full_seq
        )
        stride1 = (2, 1, 1) if first_block_down else (1, 1, 1)
        stride4 = (2, 1, 1) if (self.full_seq and self.max_frames >= 16) else None
        if self.spatial_size // 2**3 > self.min_spatial_size:
            stride4 = (2, 2, 2)
        has_layer4 = stride4 is not None
        if has_layer4 and len(channels) < 5:
            channels.append(channels[-1])
        has_layer5 = self.spatial_size // 2**4 > self.min_spatial_size
        last_channels = channels[3]
        if has_layer4:
            last_channels = channels[4]
        if has_layer5:
            last_channels = channels[5]
        return channels, stride1, stride4, has_layer4, has_layer5, last_channels
