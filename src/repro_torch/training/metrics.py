"""Lightweight metric logging (CSV + stdout); port of
`repro.training.metrics`, verbatim."""
from __future__ import annotations

import csv
import os
import time
from typing import Optional


class MetricLogger:
    def __init__(self, path: Optional[str] = None, print_every: int = 1):
        self.path = path
        self.print_every = print_every
        self.rows = []
        self._writer = None
        self._file = None
        self._t0 = time.time()

    def log(self, step: int, **metrics):
        row = {"step": step, "wall_s": round(time.time() - self._t0, 3),
               **{k: (float(v) if hasattr(v, "__float__") else v)
                  for k, v in metrics.items()}}
        self.rows.append(row)
        if self.path:
            new = self._file is None
            if new:
                os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
                self._file = open(self.path, "w", newline="")
            if self._writer is None:
                self._writer = csv.DictWriter(self._file,
                                              fieldnames=list(row.keys()))
                self._writer.writeheader()
            self._writer.writerow(row)
            self._file.flush()
        if self.print_every and step % self.print_every == 0:
            msg = " ".join(f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
                           for k, v in row.items())
            print(msg, flush=True)

    def close(self):
        if self._file:
            self._file.close()
