"""Run provenance: who/what/when produced a metrics or benchmark artifact.

Port of `src/repro/obs/context.py`.  `run_context()` stamps exported
metrics documents so a run is attributable: git SHA, ISO timestamp, torch
version, CUDA version, the CUDA device name and count, python/platform.  Collected once per process
(subprocess git call + device query), then cached.
"""
from __future__ import annotations

import os
import platform
import subprocess
from datetime import datetime, timezone
from typing import Optional

__all__ = ["run_context"]

_context: Optional[dict] = None


def _git_sha() -> str:
    try:
        out = subprocess.run(
            ["git", "rev-parse", "HEAD"],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=5)
        if out.returncode == 0:
            return out.stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        pass
    return "unknown"


def run_context() -> dict:
    """Provenance dict (cached); the device fields read "none" on a
    machine without CUDA."""
    global _context
    if _context is None:
        ctx = {
            "git_sha": _git_sha(),
            "timestamp": datetime.now(timezone.utc).isoformat(
                timespec="seconds"),
            "python": platform.python_version(),
            "platform": platform.platform(),
        }
        import torch
        ctx["torch"] = torch.__version__
        ctx["cuda"] = torch.version.cuda or "none"
        if torch.cuda.is_available():
            ctx["device"] = torch.cuda.get_device_name(0)
            ctx["num_devices"] = torch.cuda.device_count()
        else:
            ctx["device"] = "none"
            ctx["num_devices"] = 0
        _context = ctx
    return dict(_context)
