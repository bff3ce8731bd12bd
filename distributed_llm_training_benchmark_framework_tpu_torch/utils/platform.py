"""Device selection and per-card hardware peaks.

Entry points run on ``cuda`` unless the caller asks for the CPU; with no
CUDA device and no explicit ``cpu`` they raise instead of falling back
(``resolve_device``). The HBM bandwidth table lives here; the bf16 peak
table lives in ``utils.flops``.
"""

from __future__ import annotations

from typing import Optional

import torch

# HBM bandwidth per card, GB/s (decimal; NVIDIA H100 data sheet). Same
# substring-match convention and order as the peak table in utils/flops.py.
_PEAK_HBM_GBPS = (
    ("H100 PCIe", 2000.0),
    ("H100", 3350.0),
)


def device_peak_hbm_gbps(device_kind: str) -> Optional[float]:
    """HBM GB/s peak for a device name, or None if unknown (e.g. CPU)."""
    for name, peak in _PEAK_HBM_GBPS:
        if name.lower() in device_kind.lower():
            return peak
    return None


def resolve_device(device: Optional[str] = None) -> torch.device:
    """``None`` means the card. Raises when a CUDA device is asked for (or
    implied) and none is available: no silent CPU fallback."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (--device cpu) to "
            "run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r} (expected 'cuda' or 'cpu')")
    return dev


def device_kind(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
