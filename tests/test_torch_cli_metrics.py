"""The port's CLI parsing and metrics stream against the JAX package's.

``utils/cli.py`` and ``utils/metrics.py`` are the JAX package's modules
unchanged: the same argv gives the same values, the same errors, the same
help text and banner, and the same JSONL records and stdout echo. The train
driver's option table and defaults are the JAX driver's, entry for entry.
"""

import json

import pytest

from neural_network_quantum_state_tpu.drivers import train as j_train
from neural_network_quantum_state_tpu.utils import cli as j_cli
from neural_network_quantum_state_tpu.utils import metrics as j_metrics
from neural_network_quantum_state_tpu_torch.drivers import train as t_train
from neural_network_quantum_state_tpu_torch.utils import cli as t_cli
from neural_network_quantum_state_tpu_torch.utils import metrics as t_metrics

OPTIONS = [("model", "lattice"), ("L", "# of sites"), ("nf", "hidden (comma list)"), ("alpha", "exponent")]
DEFAULTS = {"alpha": "2", "nf": "4"}


def _both(mod_j, mod_t, argv, capsys):
    """(values, stdout, error) of each package's DriverArgs on `argv`."""
    out = []
    for mod in (mod_j, mod_t):
        try:
            args = mod.DriverArgs(argv, OPTIONS, DEFAULTS, prog="t")
            got = (args.find("model"), args.find("L", int), args.mfind("nf", int), args.mfind("alpha", float),
                   args.banner())
            err = None
        except mod.ArgParseError as e:
            got, err = None, str(e)
        except SystemExit as e:
            got, err = None, f"exit {e.code}"
        out.append((got, capsys.readouterr().out, err))
    return out


@pytest.mark.parametrize(
    "argv",
    [
        ["-model=LICH", "-L=64"],
        ["-model=CH", "-L=8", "-nf=2,4,", "-alpha=1.5,2,2.5"],
        ["-model=hub=bard", "-L=32", "-nf=64"],
    ],
    ids=["defaults", "multi_values", "value_with_equals"],
)
def test_driver_args_parse_as_jax(argv, capsys):
    """Values, multi-values and the banner are the JAX package's."""
    (gj, oj, ej), (gt, ot, et) = _both(j_cli, t_cli, argv, capsys)
    assert gj is not None and gj == gt and oj == ot and ej == et


@pytest.mark.parametrize(
    "argv",
    [["-model=LICH"], ["model=LICH", "-L=8"], ["-model=LICH", "-L=8", "-bogus=1"], ["-model=LICH", "-L"],
     ["--help"], ["-h"]],
    ids=["missing", "malformed", "unknown", "no_value", "help", "help_short"],
)
def test_driver_args_errors_and_help_as_jax(argv, capsys):
    """The same errors (messages included) and the same help text."""
    (gj, oj, ej), (gt, ot, et) = _both(j_cli, t_cli, argv, capsys)
    assert gj is None and gt is None
    assert ej == et and oj == ot
    if argv[0] in ("--help", "-h"):
        assert ej == "exit 0" and "-alpha" in oj and "(default: 2)" in oj


def test_train_options_and_defaults_are_jax(capsys):
    """The train driver's option table, help strings and defaults are the
    JAX driver's, entry for entry, and so is its --help."""
    assert t_train.OPTIONS == j_train.OPTIONS
    assert t_train.DEFAULTS == j_train.DEFAULTS
    assert t_train.DEFAULTS["rsd"] == "1e-3"
    outs = []
    for mod in (j_train, t_train):
        with pytest.raises(SystemExit):
            mod.main(["--help"]) if mod is t_train else mod.DriverArgs(["--help"], mod.OPTIONS, mod.DEFAULTS,
                                                                       prog="train")
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1]


@pytest.mark.parametrize(
    "records",
    [
        [(0, dict(energy=-0.84, rsd=0.01, cg_iters=98, lam=90.0))],
        [(5, dict(energy=-1.2345678912, rsd=3.4e-7, cg_iters=3, lam=0.01)), (6, dict(energy=2.0, flag="x", n=7))],
    ],
    ids=["one_step", "two_steps_mixed_types"],
)
def test_metrics_logger_records_as_jax(records, tmp_path, capsys):
    """The same JSONL records (keys in order, values; the wall time t apart)
    and the same stdout echo."""
    lines, echoes = [], []
    for mod, name in ((j_metrics, "j.jsonl"), (t_metrics, "t.jsonl")):
        with mod.MetricsLogger(str(tmp_path / name), echo=True) as log:
            for step, m in records:
                log.log(step, **m)
        recs = [json.loads(x) for x in open(tmp_path / name)]
        assert all(isinstance(r.pop("t"), float) for r in recs)
        lines.append([list(r.items()) for r in recs])
        echoes.append(capsys.readouterr().out)
    assert lines[0] == lines[1] and echoes[0] == echoes[1]
    assert lines[1][0][0] == ("step", records[0][0])


def test_metrics_logger_without_file_or_echo(tmp_path, capsys):
    """No path writes no file; echo=False prints nothing; close is idempotent."""
    log = t_metrics.MetricsLogger(None, echo=False)
    log.log(0, energy=1.0)
    log.close()
    log.close()
    assert capsys.readouterr().out == ""
    assert list(tmp_path.iterdir()) == []
