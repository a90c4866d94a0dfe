"""Structured per-step metrics (reference observability is bare std::cout
lines - optimizer.hpp:27-30,73-74, optimizer.cuh:124,158-159; here: stdout
echo + JSONL file, consumable by plotting/TensorBoard tooling). The JAX package's
``utils/metrics.py``, unchanged: the same JSONL records and stdout echo."""

from __future__ import annotations

import json
import sys
import time
from typing import IO, Optional


class MetricsLogger:
    """Append-only JSONL metrics stream with optional stdout echo.

    Used by the drivers: one record per SR iteration with energy, RSD,
    acceptance, CG iterations, lambda, wall time.
    """

    def __init__(self, path: Optional[str] = None, echo: bool = True):
        self._fh: Optional[IO[str]] = open(path, "a") if path else None
        self._echo = echo
        self._t0 = time.perf_counter()

    def log(self, step: int, **metrics) -> None:
        rec = {"step": step, "t": round(time.perf_counter() - self._t0, 4), **metrics}
        line = json.dumps(rec)
        if self._fh is not None:
            self._fh.write(line + "\n")
            self._fh.flush()
        if self._echo:
            parts = "  ".join(f"{k}={v:.7g}" if isinstance(v, float) else f"{k}={v}" for k, v in metrics.items())
            print(f"{step + 1:5d}  {parts}", file=sys.stdout, flush=True)

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
