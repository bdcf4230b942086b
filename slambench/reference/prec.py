"""Precision of the reference: as the configuration states (float32 with
TF32 off, the pose graph in float64), or one step below for the control.

The control's TF32 is emulated, so it is the same on any device: the
float32 arrays a stage takes in (points, normals, transforms) and both
operands of every matmul are rounded to TF32's 10 explicit mantissa bits
(round to nearest even) and then used in float32, as a tensor core uses
them. The float64 stages (the host voxelizer's sums, the pose graph) run
in float32."""

from __future__ import annotations

from dataclasses import dataclass

import torch


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value, kept in float32."""
    if x.dtype != torch.float32:
        return x
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    rounded = (bits + 0x0FFF + lsb) & ~0x1FFF
    finite = torch.isfinite(x)
    return torch.where(finite, rounded.view(torch.float32), x)


@dataclass(frozen=True)
class Precision:
    tf32: bool = False

    def inp(self, x: torch.Tensor) -> torch.Tensor:
        """A float32 input of a stage, at this precision."""
        return to_tf32(x) if self.tf32 else x

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.matmul(self.inp(a), self.inp(b))

    @property
    def wide(self) -> torch.dtype:
        """The dtype of the configuration's float64 stages."""
        return torch.float32 if self.tf32 else torch.float64


FP32 = Precision(False)
TF32 = Precision(True)
