"""Training summaries in TensorBoard's event format.

A copy of ``bigdl_tpu/visualization/__init__.py`` (numpy only):
``TrainSummary(log_dir, app_name)`` writes Loss, LearningRate, Throughput
and the opt-in ``Parameters`` histograms (``set_summary_trigger``) under
``{log_dir}/{app_name}/train``; ``ValidationSummary`` the validation scores
under ``.../validation``; ``read_scalar`` reads a tag back. The files are
byte-compatible with the JAX package's (``tensorboard.py``).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from bigdl_tpu_torch.visualization.tensorboard import EventWriter, read_events


class Summary:
    """Base: one event-file writer under ``{log_dir}/{app_name}/{mode}``."""

    def __init__(self, log_dir: str, app_name: str, mode: str):
        self.log_dir = log_dir
        self.app_name = app_name
        self.mode = mode
        self.dir = os.path.join(log_dir, app_name, mode)
        self.writer = EventWriter(self.dir)
        self._triggers: dict = {}

    def add_scalar(self, tag: str, value: float, step: int) -> "Summary":
        self.writer.add_scalar(tag, float(value), int(step))
        return self

    def add_histogram(self, tag: str, values, step: int) -> "Summary":
        self.writer.add_histogram(tag, np.asarray(values), int(step))
        return self

    def read_scalar(self, tag: str):
        """Return [(step, value, wall_time)] for ``tag`` across this mode's
        files, ordered by ``(step, wall_time)`` — lexical filename order lies
        the moment a timestamp crosses a digit boundary or several writers
        share a second."""
        out = []
        for fname in os.listdir(self.dir):
            if ".tfevents." not in fname:
                continue
            for ev in read_events(os.path.join(self.dir, fname)):
                for t, v in ev["values"]:
                    if t == tag and v is not None:
                        out.append((ev["step"], v, ev["wall_time"]))
        out.sort(key=lambda r: (r[0], r[2]))
        return out

    def close(self) -> None:
        self.writer.close()


class TrainSummary(Summary):
    """Training-side scalars (Loss/Throughput/LearningRate) + optional parameter
    histograms enabled via ``set_summary_trigger("Parameters", trigger)``."""

    def __init__(self, log_dir: str, app_name: str):
        super().__init__(log_dir, app_name, "train")

    def set_summary_trigger(self, name: str, trigger) -> "TrainSummary":
        if name not in ("Parameters", "LearningRate", "Loss", "Throughput"):
            raise ValueError(f"unknown summary name {name!r}")
        self._triggers[name] = trigger
        return self

    def get_summary_trigger(self, name: str):
        return self._triggers.get(name)


class ValidationSummary(Summary):
    """Validation metric scalars, one point per validation round."""

    def __init__(self, log_dir: str, app_name: str):
        super().__init__(log_dir, app_name, "validation")


__all__ = ["Summary", "TrainSummary", "ValidationSummary", "EventWriter",
           "read_events"]
