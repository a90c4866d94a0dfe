"""The repo's example studies on the port (the root ``examples/`` drive the
JAX package). Each runs as ``python -m
neural_network_quantum_state_tpu_torch.examples.<name>``, on ``cuda`` unless
given ``--device cpu``, and writes only into its ``--out`` directory
(``runs_torch/`` by default, which git ignores). They read the JAX side's
recorded results under ``logs/`` where a study has one, and print them
beside their own.
"""

import os

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DEFAULT_OUT = os.path.join(REPO, "runs_torch")


def common_args(argv, description: str):
    """(namespace with ``device`` and ``out``, the other arguments): the
    options every example takes, before its own."""
    import argparse

    ap = argparse.ArgumentParser(description=description, allow_abbrev=False)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", default=DEFAULT_OUT, help="the directory this study writes into")
    ns, rest = ap.parse_known_args(argv)
    os.makedirs(ns.out, exist_ok=True)
    return ns, rest
