"""The cards a run uses: found or refused, never replaced by the CPU."""

from __future__ import annotations

import subprocess


class NoCard(RuntimeError):
    """The machine has fewer CUDA cards than the cell asks for."""


def require(chips: int):
    """``torch.device('cuda', 0)`` when ``chips`` cards are visible; raises
    ``NoCard`` otherwise."""
    import torch

    if not torch.cuda.is_available():
        raise NoCard("torch.cuda.is_available() is False: no CUDA card")
    if torch.cuda.device_count() < chips:
        raise NoCard(f"the cell asks for {chips} cards, "
                     f"torch.cuda.device_count() is "
                     f"{torch.cuda.device_count()}")
    return torch.device("cuda", 0)


def power_limit_w() -> str:
    """The first card's power limit as ``nvidia-smi`` reports it, or "not
    measured" where it cannot be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=20, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return "not measured"
    first = out.strip().splitlines()
    return first[0].strip() if first else "not measured"


def describe(device, chips: int) -> dict:
    """The ``device`` object of the result line, before the peak is read."""
    import torch

    if device.type != "cuda":  # only the CPU tests drive a run here
        return {"platform": "cpu", "kind": "cpu", "count": chips}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips, "power_limit_w": power_limit_w()}


def peak_bytes(device, chips: int) -> int:
    """The allocator's peak on the fullest card since the process began."""
    import torch

    if device.type != "cuda":
        return 0
    return max(torch.cuda.max_memory_allocated(i) for i in range(chips))


def synchronize(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)
