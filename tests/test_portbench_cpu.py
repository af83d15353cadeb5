"""The benchmark harness's CPU tests (``portbench/tests``) as tests of this
suite, so a change of the program that breaks the harness's use of it fails
here.

They run in one separate pytest process without this directory's
``conftest.py``: it imports JAX, and ``portbench/run.py`` refuses to report
from a process that holds JAX or the JAX package.  Each test function of a
harness test module is one case here; it passes where every one of its
cases passed in that process.  Every ``portbench/tests/test_portbench_*.py``
is collected; the harness's card tests (marked ``cuda``) are left out here
and run on the card: ``python -m pytest --noconftest -m cuda portbench/tests``.
"""

import ast
import glob
import os
import subprocess
import sys
import xml.etree.ElementTree as ET

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HARNESS_TESTS = os.path.join(ROOT, "portbench", "tests")
MODULES = sorted(glob.glob(os.path.join(HARNESS_TESTS, "test_portbench_*.py")))


def _marked_cuda(decorators) -> bool:
    return any("mark.cuda" in ast.unparse(d) for d in decorators)


def _functions():
    """``module::function`` of every test function not marked ``cuda``, read
    from the sources."""
    out = []
    for path in MODULES:
        with open(path) as fh:
            tree = ast.parse(fh.read())
        if any(isinstance(n, ast.Assign) and "pytestmark" in ast.unparse(n.targets[0])
               and "mark.cuda" in ast.unparse(n.value) for n in tree.body):
            continue
        mod = os.path.basename(path)[:-3]
        out += [f"{mod}::{n.name}" for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name.startswith("test_")
                and not _marked_cuda(n.decorator_list)]
    return out


@pytest.fixture(scope="module")
def outcomes(tmp_path_factory):
    """``{module::function: [outcome of each case]}`` from one run."""
    xml = tmp_path_factory.mktemp("portbench") / "junit.xml"
    cmd = [sys.executable, "-m", "pytest", "--noconftest", "-q", "-p", "no:cacheprovider",
           "-p", "no:randomly", "-m", "not cuda", f"--junitxml={xml}",
           *MODULES]
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=900)
    got = {}
    for case in ET.parse(xml).getroot().iter("testcase"):
        key = f"{case.get('classname').rpartition('.')[2]}::{case.get('name').split('[')[0]}"
        kind = next((c.tag for c in case if c.tag in ("failure", "error", "skipped")), "passed")
        got.setdefault(key, []).append((kind, "".join(c.text or "" for c in case)[-2000:]))
    got["_output"] = proc.stdout[-4000:] + proc.stderr[-4000:]
    return got


@pytest.mark.parametrize("test", _functions())
def test_harness_cpu_test_passes(outcomes, test):
    cases = outcomes.get(test)
    assert cases, f"{test} did not run:\n{outcomes['_output']}"
    bad = [text for kind, text in cases if kind != "passed"]
    assert not bad, "\n".join(bad)
