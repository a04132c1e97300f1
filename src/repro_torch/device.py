"""Device resolution: the port runs on the CUDA card unless told otherwise.

Every entry point takes an explicit ``device`` that defaults to
``"cuda"``. Asking for CUDA on a machine without a CUDA device raises
and names the argument or field that asked; nothing silently falls
back to the CPU. Tests and CPU runs pass ``device="cpu"``.
"""

from __future__ import annotations

import torch


def resolve_device(device, field: str = "device") -> torch.device:
    """``device`` as a :class:`torch.device`, checked to exist.

    A CUDA device without an index resolves to the current one, so
    ``"cuda"`` and ``"cuda:0"`` name the same device. ``field`` names the
    argument or config field in the error, so the caller knows what to set.
    """
    if device is None:
        raise ValueError(f"{field} must be given ('cuda', 'cuda:<i>' or 'cpu')")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{field}={str(device)!r} but no CUDA device is available; "
            f"pass {field}='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"{field} must be a CUDA or CPU device, got {str(device)!r}")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
