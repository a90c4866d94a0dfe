"""-name=value command-line parsing for the training/measurement drivers
(the JAX package's ``utils/cli.py``, unchanged: options, help text,
multi-values and banner).

Behavioral port of the reference's argsparse (cpu/include/argparse.hpp:
14-239): required options with one-line help strings, defaults, --help
auto-listing, typed lookup, and comma-separated multi-values used by the
GPU drivers to sweep hyperparameter grids (e.g. -alpha=1.5,2,2.5 -
LICH-train_rbmtrsymm.cu:82-108)."""

from __future__ import annotations

from typing import Sequence


class ArgParseError(Exception):
    pass


class DriverArgs:
    def __init__(
        self,
        argv: Sequence[str],
        options: Sequence[tuple[str, str]],
        defaults: dict[str, str] | None = None,
        prog: str = "driver",
    ):
        self._help = dict(options)
        self._values = dict(defaults or {})
        self._prog = prog
        args = list(argv)
        if any(a in ("--help", "-h") for a in args):
            self.print_help()
            raise SystemExit(0)
        for a in args:
            if not a.startswith("-") or "=" not in a:
                raise ArgParseError(f"malformed option '{a}' (expected -name=value)")
            name, value = a[1:].split("=", 1)
            if name not in self._help:
                raise ArgParseError(f"unknown option -{name}")
            self._values[name] = value
        missing = [n for n in self._help if n not in self._values]
        if missing:
            self.print_help()
            raise ArgParseError("missing required options: " + ", ".join(f"-{m}" for m in missing))

    def print_help(self) -> None:
        print(f"usage: {self._prog} -name=value ...")
        for name, desc in self._help.items():
            d = f" (default: {self._values[name]})" if name in self._values else " (required)"
            print(f"  -{name:12s} {desc}{d}")

    def find(self, name: str, type_=str):
        return type_(self._values[name])

    def mfind(self, name: str, type_=str) -> list:
        """Comma-separated multi-value lookup (grid sweeps)."""
        return [type_(v) for v in self._values[name].split(",") if v != ""]

    def banner(self) -> str:
        return "\n".join(f"# {k} = {v}" for k, v in sorted(self._values.items()))
