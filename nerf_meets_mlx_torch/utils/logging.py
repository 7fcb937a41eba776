"""Scalar metric logging to the console and a JSONL file.

Counterpart of ``nerf_meets_mlx_tpu/utils/logging.py``: every logged step
appends one JSON line (step, loss, psnr, steps/s, ...) to ``metrics.jsonl``,
a machine-readable history that survives restarts.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path


class MetricsLogger:
    def __init__(self, path: str | Path):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)

    def log(self, **metrics):
        """Append ``{"ts": ..., **metrics}`` to the file and echo it to stderr."""
        rec = {"ts": time.time(), **metrics}
        with self.path.open("a") as f:
            f.write(json.dumps(rec) + "\n")
        parts = [
            f"{k}={v:.5g}" if isinstance(v, float) else f"{k}={v}" for k, v in metrics.items()
        ]
        print("[train] " + " ".join(parts), file=sys.stderr)
