"""Exact comparison of a kernel's output with its plain version."""

from __future__ import annotations

import torch


def bit_mismatches(got: torch.Tensor, want: torch.Tensor) -> int:
    """The number of positions where ``got`` and ``want``, of one shape and
    dtype, differ bit for bit, except that a NaN matches any NaN: the
    kernels write the canonical NaN, the plain versions pass on the
    input's.  -0.0 and +0.0 differ."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise ValueError(f"{tuple(got.shape)} {got.dtype} against "
                         f"{tuple(want.shape)} {want.dtype}")
    if got.dtype != torch.float32:
        return int((got != want).sum())
    nan_got, nan_want = torch.isnan(got), torch.isnan(want)
    differ = (got.view(torch.int32) != want.view(torch.int32)) \
        & ~nan_got & ~nan_want
    return int((differ | (nan_got != nan_want)).sum())
