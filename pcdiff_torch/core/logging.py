"""Metrics logging and profiling hooks.

Counterpart of :mod:`pcdiff.core.logging`: a metrics logger that writes JSONL to
``run_dir/metrics.jsonl`` (and to wandb where wandb imports and is asked for), and a
``torch.profiler`` trace around a block, written to ``log_dir``.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any, Dict, Optional

__all__ = ["MetricsLogger", "profile_trace"]


class MetricsLogger:
    """Log scalar metrics to wandb when available and enabled, and to JSONL."""

    def __init__(
        self,
        run_dir: str,
        project: Optional[str] = None,
        run_name: Optional[str] = None,
        config: Optional[Dict[str, Any]] = None,
        use_wandb: bool = False,
        is_lead_host: bool = True,
    ):
        self.is_lead_host = is_lead_host
        self._wandb = None
        self._file = None
        if not is_lead_host:
            return
        if use_wandb:
            try:
                import wandb

                self._wandb = wandb
                wandb.init(project=project, name=run_name, config=config)
            except Exception:
                self._wandb = None
        os.makedirs(run_dir, exist_ok=True)
        self._file = open(os.path.join(run_dir, "metrics.jsonl"), "a")

    def log(self, metrics: Dict[str, Any], step: Optional[int] = None) -> None:
        if not self.is_lead_host:
            return
        record = {k: float(v) for k, v in metrics.items()}
        if step is not None:
            record["step"] = step
        record["time"] = time.time()
        if self._wandb is not None:
            self._wandb.log(record, step=step)
        if self._file is not None:
            self._file.write(json.dumps(record) + "\n")
            self._file.flush()

    def finish(self) -> None:
        if self._wandb is not None:
            self._wandb.finish()
        if self._file is not None:
            self._file.close()
            self._file = None


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str], enabled: bool = True):
    """Trace the block with ``torch.profiler`` (the CPU, and the card when there is one)
    and write a Chrome trace (``trace_<time>.json``, for Perfetto) to ``log_dir``."""
    if not enabled or log_dir is None:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{int(time.time() * 1e3)}.json"))
