"""JSONL logger.

The port's copy of what ``train_fused`` needs from
``active_inference_diffusion_tpu/utils/logger.py``: ``_scalarize`` and the
JSONL sink of ``Logger`` (one JSON object a line, with the step and the
wall time since the logger was made). No wandb.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np


def _scalarize(value: Any) -> Any:
    """A one-element array or tensor as its Python number, other arrays as
    lists, anything else as it is."""
    if hasattr(value, "item") and (getattr(value, "size", 2) == 1
                                   or getattr(value, "numel", lambda: 2)() == 1):
        return value.item()
    if isinstance(value, np.ndarray):
        return value.tolist()
    if hasattr(value, "tolist"):
        try:
            return value.tolist()
        except Exception:
            return str(value)
    return value


class Logger:
    """Appends each ``log`` call's metrics to ``<log_dir>/<experiment>.jsonl``."""

    def __init__(self, experiment_name: Optional[str] = None, log_dir: str = "logs"):
        self.log_dir = Path(log_dir)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self.log_file = self.log_dir / f"{experiment_name or 'experiment'}.jsonl"
        self._start = time.time()

    def log(self, metrics: Dict[str, Any], step: int) -> None:
        processed = {k: _scalarize(v) for k, v in metrics.items()}
        processed["step"] = step
        processed["wall_time"] = time.time() - self._start
        with open(self.log_file, "a") as f:
            f.write(json.dumps(processed, default=str) + "\n")
