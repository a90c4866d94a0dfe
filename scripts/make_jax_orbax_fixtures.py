#!/usr/bin/env python3
"""Write the JAX package's Orbax test fixtures: two small ``-ckpt=orbax``
runs of its train driver on the CPU, each with its reference-text
checkpoint, under ``tests/fixtures/jax_orbax/``.

    python3 scripts/make_jax_orbax_fixtures.py [--out tests/fixtures/jax_orbax]

``one/``: ``-model=LICH -ansatz=rbmtrsymm -L=16 -nf=2 -ns=512``, float32,
a few SR steps on one device (OCDBT layout, one chunk per array);
``mesh4/``: the same with ``-mesh=4`` (the walkers saved in 4 chunks). The
port reads them with no JAX (``tests/test_torch_orbax.py``,
``tests/test_torch_gpu.py`` and ``chip_smoke.py`` phase 15b); the metrics
files are dropped, and each directory keeps the text checkpoint and the
``.orbax`` directory. Needs the JAX package, Orbax and tensorstore.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ARGS = ["-model=LICH", "-ansatz=rbmtrsymm", "-L=16", "-nf=2", "-ns=512", "-nwarm=20", "-niter=5",
        "-nrec=5", "-dtype=float32", "-ckpt=orbax", "-seed=3"]
RUNS = {"one": [], "mesh4": ["-mesh=4"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=str(ROOT / "tests" / "fixtures" / "jax_orbax"))
    args = ap.parse_args(argv)
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=4").strip()
    sys.path.insert(0, str(ROOT))
    import jax

    jax.config.update("jax_platforms", "cpu")
    from neural_network_quantum_state_tpu.drivers import train

    for name, extra in RUNS.items():
        out = Path(args.out) / name
        shutil.rmtree(out, ignore_errors=True)
        out.mkdir(parents=True)
        res = train.main(ARGS + extra + [f"-path={out}"])
        prefix = Path(res[0]["prefix"])
        Path(str(prefix) + ".metrics.jsonl").unlink()
        size = sum(f.stat().st_size for f in out.rglob("*") if f.is_file())
        print(f"{out}: {prefix.name} and {prefix.name}.orbax, {size} bytes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
