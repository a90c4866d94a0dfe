#!/usr/bin/env python3
"""The energy kernel's float64 instance with parts taken out, on one NVIDIA GPU.

    python3 scripts/energy_f64_ablation.py [VARIANT ...]

Writes copies of the package's ``csrc/`` into its gitignored build
directory, each with one part of ``csrc/energy.cu``'s float64 instance
(namespace ``f64``) taken out or changed, and runs
``scripts/kernel_ab.py energy --no-gate`` on them beside the package's own
source ("change"): alternated rounds of device time on the LITFI
flagship's inputs, the registers, and each build's error against the plain
sum. Every variant computes wrong sums on some inputs, and is timed all
the same: what it saves of the change's time bounds what the part costs.

- ``no_state``: the per-tile state phase (``unit_state``: exp, sincos and
  expm1 per walker and unit) not run;
- ``no_barriers``: the two block barriers of a tile removed;
- ``no_y_loads``: the next tile's y and c_j not loaded;
- ``renorm8``: the products renormalised every 8 factors in place of 4
  (right only for |Re w| below about 22).

With no VARIANT, all of them. Exits as ``kernel_ab.py`` does.
"""

from __future__ import annotations

import shutil
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

# {variant: [(text of the f64 namespace, its replacement), ...]}
VARIANTS = {
    "no_state": [("if (live) unit_state<C>(", "if (false) unit_state<C>(")],
    "no_barriers": [("__syncthreads();", "")],
    "no_y_loads": [("if (it + 1 < total) unit_in(it + 1, yv, cj);", "")],
    "renorm8": [("constexpr int kRenorm = 4;", "constexpr int kRenorm = 8;")],
}


def write_variant(csrc: Path, out: Path, edits: list[tuple[str, str]]) -> None:
    """csrc copied to out, with the edits made after ``namespace f64 {`` of
    energy.cu; raises if an edit's text is not there."""
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(csrc, out)
    head, sep, f64 = (csrc / "energy.cu").read_text().partition("namespace f64 {")
    for old, new in edits:
        if old not in f64:
            raise SystemExit(f"energy_f64_ablation: {old!r} is not in energy.cu's f64 namespace")
        f64 = f64.replace(old, new)
    (out / "energy.cu").write_text(head + sep + f64)


def main() -> int:
    import kernel_ab

    from neural_network_quantum_state_tpu_torch.ops import build

    names = sys.argv[1:] or list(VARIANTS)
    unknown = [n for n in names if n not in VARIANTS]
    if unknown:
        print(f"energy_f64_ablation: unknown variants {unknown}; known: {list(VARIANTS)}", file=sys.stderr)
        return 2
    root = build.BUILD_DIR / "energy_f64_ablation"
    for name in names:
        write_variant(build.CSRC_DIR, root / name, VARIANTS[name])
    return kernel_ab.main(["energy", "--no-gate", *(f"{n}={root / n}" for n in names)])


if __name__ == "__main__":
    sys.exit(main())
