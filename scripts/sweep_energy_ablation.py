#!/usr/bin/env python3
"""The megakernel's measured choices and its phases, on one NVIDIA GPU.

    python3 scripts/sweep_energy_ablation.py [VARIANT ...] [LABEL=CSRC_DIR ...]

Writes copies of the package's ``csrc/`` into its gitignored build
directory, each with one choice of ``csrc/sweep_energy.cu`` changed or one
part taken out, and runs ``scripts/kernel_ab.py sweep_energy --no-gate`` on
them beside the package's own source ("change") and any LABEL=CSRC_DIR
given (an earlier commit's source, say): alternated rounds of device time on
the megakernel A/B's inputs at H = 64, 256 and 512 and n_beta = 1 and 8 with
the two-kernel arm beside them, the registers, and each build's error
against the plain version. The choices compute the same function; the parts
taken out give wrong results, and are timed all the same: what a build
saves of the change's time bounds what the part costs.

- ``lanes32``: one warp a walker at every H (no 16-lane instances);
- ``regs64``, ``regs128``: one register cap for every instance; ``regs85``:
  85 up to R = 8 and 128 above, the tempered and 16-lane instances too;
- ``no_accept``: every decision taken, none accepted (no state update);
- ``no_sweep``: no proposal round (the launch, the renewals, the energy);
- ``no_energy``: no site of the energy phase;
- ``no_phases``: neither (the launch, the loads and stores, the renewals).

With no VARIANT, all of them. Exits as ``kernel_ab.py`` does.
"""

from __future__ import annotations

import shutil
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

REGS = "constexpr int regs_cap(int L, int R, bool T) { return R > 8 ? 128 : T || (L == 16 && R <= 4) ? 64 : 85; }"
ROUNDS = ("const int rounds = min(p.n_sites, p.n_steps - t);", "const int rounds = 0;")
SITES = ("for (int i0 = 0; i0 < N; i0 += kSiteGroup)", "for (int i0 = 0; i0 < 0; i0 += kSiteGroup)")
# {variant: [(text of sweep_energy.cu, its replacement), ...]}
VARIANTS = {
    "lanes32": [("constexpr int kNarrowR = 4;", "constexpr int kNarrowR = 0;")],
    "regs64": [(REGS, "constexpr int regs_cap(int, int, bool) { return 64; }")],
    "regs85": [(REGS, "constexpr int regs_cap(int, int R, bool) { return R > 8 ? 128 : 85; }")],
    "regs128": [(REGS, "constexpr int regs_cap(int, int, bool) { return 128; }")],
    "no_accept": [("      if (accept) {\n        st.accept(",
                   "      accept = accept && u < 0.0f;\n      if (accept) {\n        st.accept(")],
    "no_sweep": [ROUNDS],
    "no_energy": [SITES],
    "no_phases": [ROUNDS, SITES],
}


def write_variant(csrc: Path, out: Path, edits: list[tuple[str, str]]) -> None:
    """csrc copied to out, with the edits made in sweep_energy.cu; raises if
    an edit's text is not there once."""
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(csrc, out)
    text = (csrc / "sweep_energy.cu").read_text()
    for old, new in edits:
        if text.count(old) != 1:
            raise SystemExit(f"sweep_energy_ablation: {old!r} is not in sweep_energy.cu once")
        text = text.replace(old, new)
    (out / "sweep_energy.cu").write_text(text)


def main() -> int:
    import kernel_ab

    from neural_network_quantum_state_tpu_torch.ops import build

    others = [a for a in sys.argv[1:] if "=" in a]
    names = [a for a in sys.argv[1:] if "=" not in a] or list(VARIANTS)
    unknown = [n for n in names if n not in VARIANTS]
    if unknown:
        print(f"sweep_energy_ablation: unknown variants {unknown}; known: {list(VARIANTS)}", file=sys.stderr)
        return 2
    root = build.BUILD_DIR / "sweep_energy_ablation"
    for name in names:
        write_variant(build.CSRC_DIR, root / name, VARIANTS[name])
    return kernel_ab.main(["sweep_energy", "--no-gate", *others, *(f"{n}={root / n}" for n in names)])


if __name__ == "__main__":
    sys.exit(main())
