"""Port vs JAX package: the problem registry, the CLI and the ``.dat`` IO.

The registry lists the same names with the same presets; plugins are found
and a broken one only warns.  ``mioc_tpu_torch.cli.main`` on the CPU prints
the JSON line of ``mioc_tpu.cli.main`` run with the same arguments: J to
rtol 1e-12, iterations and evaluation counts equal.  Runs without
``--no-plot`` write the JAX CLI's plot (and heat's animation) into the
working directory.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mioc_tpu import cli as jcli  # noqa: E402
from mioc_tpu.models import registry as jreg  # noqa: E402
from mioc_tpu.utils import io as jio  # noqa: E402
from mioc_tpu_torch import cli  # noqa: E402
from mioc_tpu_torch.models import registry  # noqa: E402
from mioc_tpu_torch.utils import io as tio  # noqa: E402

BASE = ["--no-plot", "--no-log", "--seed", "0"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_names_and_presets_equal_jax():
    assert registry.available() == jreg.available()
    for name in jreg.available():
        assert registry.get(name).preset == jreg.get(name).preset, name


def _json_line(out):
    return json.loads([ln for ln in out.splitlines() if ln.startswith("{")][-1])


@pytest.mark.parametrize("argv", [["fishing", "--n", "64"],
                                  ["convolution", "--n", "64"],
                                  ["convolution", "--n", "64", "--device-loop"]],
                         ids=["fishing", "convolution", "convolution-device-loop"])
def test_cli_prints_the_jax_result(capsys, argv):
    assert jcli.main(argv + BASE) == 0
    want = _json_line(capsys.readouterr().out)
    assert cli.main(argv + BASE + ["--device", "cpu"]) == 0
    got = _json_line(capsys.readouterr().out)
    assert set(got) == set(want)
    for key in ("problem", "n", "iterations", "f_evals", "df_evals", "converged"):
        assert got[key] == want[key], key
    np.testing.assert_allclose(got["J"], want["J"], rtol=1e-12)


def test_cli_multistart_and_metrics(capsys, tmp_path):
    path = tmp_path / "m.jsonl"
    assert cli.main(["doubletank", "--n", "48", "--multistart", "2", "--device", "cpu",
                     "--metrics", str(path)] + BASE) == 0
    res = _json_line(capsys.readouterr().out)
    assert res["converged"] and res["problem"] == "doubletank"
    assert path.stat().st_size > 0
    assert cli.main(["fuller", "--n", "48", "--multistart", "2", "--device-loop",
                     "--device", "cpu"] + BASE) == 0
    assert _json_line(capsys.readouterr().out)["converged"]


def _same_line(got, want):
    for key in ("problem", "n", "iterations", "f_evals", "df_evals", "converged", "J"):
        assert got[key] == want[key], key


@pytest.mark.parametrize("argv,writes", [
    (["heat", "--n", "32", "--device-loop"], ("results.png", "final-state.")),
    (["fishing", "--n", "32"], ("results.png", "data_files/v(1).dat", "data_files/y(2).dat")),
    (["fishing", "--n", "32", "--no-plot", "--dp-backend", "sharded"], ()),
], ids=["heat-device-loop-plots", "fishing-plots", "fishing-sharded"])
def test_unported_parts_raise(capsys, monkeypatch, tmp_path, argv, writes):
    """The parts that once raised run now: a run without ``--no-plot``
    writes the plot (heat: and its animation, a GIF without ffmpeg) and
    prints the ``--no-plot`` run's line; ``--dp-backend sharded`` (a world
    of one) prints the scan route's line."""
    monkeypatch.chdir(tmp_path)
    tail = ["--no-log", "--seed", "0", "--device", "cpu"]
    assert cli.main(argv + tail) == 0
    out = capsys.readouterr().out
    got = _json_line(out)
    plain = [a for a in argv if a not in ("--no-plot", "sharded", "--dp-backend")]
    extra = ["--dp-backend", "scan"] if "sharded" in argv else []
    assert cli.main(plain + ["--no-plot"] + extra + tail) == 0
    _same_line(got, _json_line(capsys.readouterr().out))
    files = sorted(str(p.relative_to(tmp_path)) for p in tmp_path.rglob("*") if p.is_file())
    for want in writes:
        assert any(f.startswith(want) for f in files), (want, files)
    if not writes:
        assert files == []
    else:
        assert "plot saved to results.png" in out


@pytest.mark.parametrize("argv", [["fishing", "--n", "32"],
                                  ["fishing", "--n", "32", "--multistart", "1"],
                                  ["fishing", "--n", "32", "--device-loop"],
                                  ["fishing", "--n", "32", "--device-loop", "--multistart", "2"],
                                  ["mixed", "--n", "32"],
                                  ["mixed", "--n", "32", "--multistart", "2"]],
                         ids=["single", "multistart-1", "device-loop", "device-multistart",
                              "mixed", "mixed-multistart-2"])
def test_runs_the_jax_cli_plots_raise_before_solving(capsys, monkeypatch, tmp_path, argv):
    """Where the JAX CLI plots (it holds an objective: a single solve, any
    device-loop run, a mixed solve), a run without --no-plot solves and then
    writes ``results.png`` and the controls' ``.dat`` exports."""
    monkeypatch.chdir(tmp_path)
    assert cli.main(argv + ["--no-log", "--seed", "0", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert _json_line(out)["n"] == 32
    assert "plot saved to results.png" in out
    assert (tmp_path / "results.png").stat().st_size > 0
    assert (tmp_path / "data_files" / "v(1).dat").exists()


def test_host_multistart_without_no_plot_runs(capsys):
    """The host-loop multistart keeps no objective, so the JAX CLI plots
    nothing after it; the port runs it to the same JSON line."""
    argv = ["fishing", "--n", "48", "--multistart", "2", "--no-log", "--seed", "0"]
    assert jcli.main(argv) == 0
    want = _json_line(capsys.readouterr().out)
    assert cli.main(argv + ["--device", "cpu"]) == 0
    got = _json_line(capsys.readouterr().out)
    for key in ("problem", "n", "iterations", "f_evals", "df_evals", "converged"):
        assert got[key] == want[key], key
    np.testing.assert_allclose(got["J"], want["J"], rtol=1e-12)


def test_dp_backend_flag(capsys):
    """The flag's values follow the solvers' rule (``solvers.trm.dp_route``):
    ``pallas`` and ``scan`` solve on the CPU, to the same result; ``scan``
    is refused for the card before anything is built; ``sharded`` is taken
    on both devices."""
    from mioc_tpu_torch.solvers.trm import dp_route

    argv = ["fishing", "--n", "32", "--device", "cpu"] + BASE
    lines = []
    for name in ("pallas", "scan"):
        assert cli.main(argv + ["--dp-backend", name]) == 0
        lines.append(_json_line(capsys.readouterr().out))
    assert lines[0] == {**lines[1], "wall_s": lines[0]["wall_s"],
                        "timings": lines[0]["timings"]}
    assert dp_route("pallas", None, torch.device("cuda")) == "pallas"
    assert dp_route(None, None, torch.device("cuda")) == "pallas"
    with pytest.raises(ValueError, match="plain versions"):
        dp_route("scan", None, torch.device("cuda"))
    for dev in ("cpu", "cuda"):
        assert dp_route("sharded", None, torch.device(dev)) == "sharded"


def test_cli_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["fishing", "--n", "16", "--no-plot", "--no-log"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        registry.build("convolution", 16)


PLUGIN = '''
from mioc_tpu_torch.models import LVMObj

PRESET = dict(beta=1e-3, delta0=1.0, p=1)


class FooObj(LVMObj):
    """A fishing variant with a shorter horizon."""

    def __init__(self, nt=64, *, device=None, dtype=None):
        super().__init__(nt, T1=6.0, device=device, dtype=dtype)
'''


def test_plugin_is_discovered_and_solved(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(registry, "_REGISTRY", dict(registry._REGISTRY))
    (tmp_path / "example_torchfoo.py").write_text(PLUGIN)
    monkeypatch.setenv("MIOC_PROBLEMS_PATH", str(tmp_path))
    assert "torchfoo" in registry.discover()
    spec = registry.get("torchfoo")
    assert spec.preset == dict(beta=1e-3, delta0=1.0, p=1)
    obj = registry.build("torchfoo", 40, device="cpu")
    assert obj.nt == 40 and obj.T1 == 6.0 and obj.device.type == "cpu"
    assert cli.main(["torchfoo", "--n", "40", "--device", "cpu"] + BASE) == 0
    assert _json_line(capsys.readouterr().out)["problem"] == "torchfoo"


def test_broken_plugin_warns_and_the_cli_runs(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(registry, "_REGISTRY", dict(registry._REGISTRY))
    (tmp_path / "example_torchbroken.py").write_text("raise RuntimeError('boom')\n")
    monkeypatch.setenv("MIOC_PROBLEMS_PATH", str(tmp_path))
    assert cli.main(["fishing", "--n", "32", "--device", "cpu"] + BASE) == 0
    captured = capsys.readouterr()
    assert "warning: plugin" in captured.err and "boom" in captured.err
    assert "torchbroken" not in registry.available()
    assert _json_line(captured.out)["problem"] == "fishing"


def test_unknown_problem_exits():
    with pytest.raises(SystemExit):
        cli.main(["nosuchproblem", "--device", "cpu", "--no-plot"])
    with pytest.raises(KeyError, match="nosuchproblem"):
        registry.get("nosuchproblem")


def test_dat_round_trip_across_packages(tmp_path):
    """A ``.dat`` file written by either package reads back equal with the
    other's reader."""
    rng = np.random.default_rng(0)
    x, y = np.linspace(0, 1, 17), rng.normal(size=17)
    d = str(tmp_path)
    tio.save_latex_format(x, y, "port", directory=d)
    jio.save_latex_format(x, y, "jax", directory=d)
    for reader, name in ((jio.import_from_latex_format, "port"),
                         (tio.import_from_latex_format, "jax"),
                         (tio.import_from_latex_format, "port")):
        xr, yr = reader(name, directory=d)
        np.testing.assert_array_equal(xr, x)
        np.testing.assert_array_equal(yr, y)
    assert (tmp_path / "port.dat").read_text() == (tmp_path / "jax.dat").read_text()
    (tmp_path / "bad.dat").write_text("x    y\n1.0 nope\n")
    with pytest.raises(ValueError):
        tio.import_from_latex_format("bad", directory=d)
