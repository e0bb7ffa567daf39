"""The port's invariant linter (``tpu_swirld_torch.analysis.lint`` and its
``rules``) held against the reference's: every per-rule fixture of
``tests/test_analysis.py`` gives the same rule ids and lines through both
linters (the reference's ``tpu/`` scope is the port's ``gpu/``), the rule
catalog and its scopes map one to one, SW004's torch table has its own
fixtures, and the port lints clean."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from tpu_swirld.analysis import check_source as ref_check_source
from tpu_swirld.analysis.rules import all_rules as ref_all_rules
from tpu_swirld_torch.analysis import check_source, lint_paths, lint_summary
from tpu_swirld_torch.analysis.lint import module_path
from tpu_swirld_torch.analysis.rules import all_rules

pytestmark = pytest.mark.analysis

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "tpu_swirld_torch"

_DONATED_STAGE = """\
import functools
import jax

@functools.partial(jax.jit, donate_argnums=(0,))
def stage(buf, x):
    return buf + x
"""

_WORKER = """\
import threading

class W:
    def __init__(self):
        self.count = 0

    def start(self):
        self._t = threading.Thread(target=self._loop, daemon=True)
        self._t.start()

    def _loop(self):
        self.count += 1
"""

_ASSERT = "def f(x):\n    assert x > 0, 'positive'\n    return x\n"

#: (source, the reference's module path) of every fixture in
#: tests/test_analysis.py's per-rule tests, bad snippets and fixed twins
FIXTURES = [
    # SW001
    ("import random\nx = random.randrange(10)\n", "module.py"),
    ("import random\nrng = random.Random(7)\nx = rng.randrange(10)\n", "module.py"),
    ("r = random.Random()\n", "module.py"),
    ("import numpy as np\ng = np.random.default_rng()\n", "module.py"),
    ("import numpy as np\ng = np.random.default_rng(3)\n", "module.py"),
    ("import numpy as np\nx = np.random.rand(4)\n", "module.py"),
    # SW002
    ('s = {b"a", b"b"}\nfor x in s:\n    pass\n', "oracle/node.py"),
    ('s = {b"a", b"b"}\nfor x in s:\n    pass\n', "sim.py"),
    ('s = {b"a", b"b"}\nfor x in sorted(s):\n    pass\n', "oracle/node.py"),
    ("s = set()\nn = len(s)\nm = max(s)\n", "oracle/node.py"),
    ("s = set()\nl = list(s)\n", "oracle/node.py"),
    ("s = set()\nout = []\nout.extend(s)\n", "oracle/node.py"),
    # SW003
    ("import time\nt = time.time()\ntime.sleep(0.1)\n", "transport.py"),
    ("import time\nt = time.time()\ntime.sleep(0.1)\n", "obs/tracer.py"),
    ("ticks = 0\nticks += 1\n", "transport.py"),
    # SW004
    ("import numpy as np\nidx = np.arange(10)\n", "tpu/pipeline.py"),
    ("import numpy as np\nidx = np.arange(10, dtype=np.int32)\n", "tpu/pipeline.py"),
    ("import numpy as np\nz = np.zeros((2, 2))\n", "store/archive.py"),
    ("import numpy as np\nz = np.zeros((2, 2), dtype=bool)\n", "store/archive.py"),
    ("x = y.astype(int)\n", "tpu/pipeline.py"),
    ("import numpy as np\nz = np.zeros(4, dtype=int)\n", "parallel.py"),
    ("import numpy as np\nidx = np.arange(10)\n", "sim.py"),
    # SW005
    (_DONATED_STAGE + "\ndef user(buf, x):\n    out = stage(buf, x)\n"
     "    return buf.sum()\n", "module.py"),
    (_DONATED_STAGE + "\ndef user(buf, x):\n    buf = stage(buf, x)\n"
     "    return buf.sum()\n", "module.py"),
    (_DONATED_STAGE + "\nfrom tpu_swirld import obs\n\ndef user(self, x):\n"
     '    out = obs.stage_call("s", stage, self._anc_d, x)\n'
     "    return self._anc_d.sum()\n", "module.py"),
    (_DONATED_STAGE + "\nfrom tpu_swirld import obs\n\ndef user(self, x):\n"
     '    self._anc_d = obs.stage_call("s", stage, self._anc_d, x)\n'
     "    return self._anc_d.sum()\n", "module.py"),
    # SW006
    (_WORKER, "module.py"),
    (_WORKER.replace("class W:\n", 'class W:\n    GUARDED_ATTRS = frozenset({"count"})\n\n'),
     "module.py"),
    # SW007
    (_ASSERT, "oracle/node.py"),
    (_ASSERT, "tpu/pipeline.py"),
    (_ASSERT, "sim.py"),
    ("def f(x):\n    if not x > 0:\n        raise ValueError('positive')\n"
     "    return x\n", "oracle/node.py"),
    # suppressions
    ("s = set()\nfor x in s:   # swirld-lint: disable=SW002\n    pass\n", "oracle/node.py"),
    ("s = set()\nfor x in s:   # swirld-lint: disable=unordered-iter\n    pass\n",
     "oracle/node.py"),
]


def _port_path(ref_path: str) -> str:
    """The port's module path for a reference module path."""
    return "gpu/" + ref_path[len("tpu/"):] if ref_path.startswith("tpu/") else ref_path


def _ids_lines(findings):
    return [(f.rule, f.line) for f in findings]


@pytest.mark.parametrize("source,ref_path", FIXTURES,
                         ids=[f"fixture{i}" for i in range(len(FIXTURES))])
def test_fixture_findings_match_reference(source, ref_path):
    want = _ids_lines(ref_check_source(source, module_path=ref_path))
    got = _ids_lines(check_source(source, module_path=_port_path(ref_path)))
    assert got == want


def test_fixture_set_exercises_every_rule():
    """The fixtures above hold a finding of every rule the reference's
    tests catch, so the comparison cannot pass on empty lists alone."""
    rules = {f.rule for src, path in FIXTURES
             for f in check_source(src, module_path=_port_path(path))}
    assert rules == {"SW001", "SW002", "SW003", "SW004", "SW005", "SW006",
                     "SW007"}


def test_rule_catalog_and_scopes_map_from_the_reference():
    """Same ids, names and order; every scope and note scope is the
    reference's with ``tpu/`` read as ``gpu/``: none is narrowed."""
    def table(rules, mapped):
        return [(r.id, r.name,
                 tuple(_port_path(s) if mapped else s for s in r.scope),
                 tuple(_port_path(s) if mapped else s for s in r.note_scope))
                for r in rules]

    assert table(all_rules(), False) == table(ref_all_rules(), True)
    assert {r.id: r.note_scope for r in all_rules()}["SW003"] == (
        "net/", "obs/profile.py", "soak.py")


@pytest.mark.parametrize("source,findings", [
    ("import torch\nidx = torch.arange(10)\n", 1),
    ("import torch\nidx = torch.arange(10, dtype=torch.int64)\n", 0),
    ("import torch\nz = torch.zeros((2, 2), device='cpu')\n", 1),
    ("import torch\nz = torch.zeros((2, 2), dtype=torch.bool)\n", 0),
    ("import torch\nz = torch.full((4,), -1)\n", 1),
    ("import torch\nz = torch.full((4,), -1, dtype=torch.int32)\n", 0),
    ("import torch\nz = torch.empty(3)\nw = torch.ones(3)\n", 2),
    ("import torch\nz = torch.zeros(4, dtype=int)\n", 1),
])
def test_sw004_torch_table(source, findings):
    for path in ("gpu/pipeline.py", "store/slab.py", "parallel.py"):
        got = check_source(source, module_path=path)
        assert [f.rule for f in got] == ["SW004"] * findings, path
    # host-side code keeps torch's defaults
    assert check_source(source, module_path="sim.py") == []


def test_module_path_anchors_at_the_port_package():
    assert module_path("tpu_swirld_torch/oracle/node.py") == "oracle/node.py"
    assert module_path("/x/tpu_swirld_torch/gpu/pipeline.py") == "gpu/pipeline.py"
    assert module_path("tpu_swirld/oracle/node.py") == "node.py"


def test_sw003_guards_the_port_oracle_node():
    """A wall-clock cooldown in the oracle node (ROADMAP C4's open repair)
    would be a finding that only a suppression could hide."""
    src = "import time\n\ndef cooldown():\n    return time.monotonic()\n"
    assert [f.rule for f in check_source(src, module_path="oracle/node.py")] == ["SW003"]


_CLOCK_SRC = "import time\n\ndef f():\n    return time.monotonic(){}\n"


def _sw003(path, suffix, prefix=""):
    return check_source(prefix + _CLOCK_SRC.format(suffix), module_path=path,
                        rules=["SW003"])


def test_sw003_net_scope_requires_justified_suppression():
    """tests/test_net.py's SW003 note-scope test on the port's linter."""
    assert len(_sw003("net/x.py", "")) == 1
    assert len(_sw003("net/x.py", "   # swirld-lint: disable=SW003")) == 1
    assert _sw003("net/x.py",
                  "   # swirld-lint: disable=SW003 -- deployment-edge deadline") == []
    assert len(_sw003("net/x.py", "   # swirld-lint: disable=SW001 -- wrong rule")) == 1
    assert len(_sw003("net/x.py", "", prefix="# swirld-lint: disable-file=SW003\n")) == 1


def test_sw003_note_scope_is_pinned_to_net():
    assert _sw003("sim.py", "") == []
    assert len(_sw003("transport.py", "")) == 1
    assert _sw003("transport.py", "   # swirld-lint: disable=SW003") == []


def test_net_package_wall_clock_surface_is_justified():
    """The port's net/ passes its own gate: every wall-clock read sits
    behind a justified suppression."""
    findings = lint_paths([str(PKG / "net")], rules=["SW003"])
    assert findings == [], [f.render() for f in findings]


def test_port_lints_clean():
    """``python -m tpu_swirld_torch.analysis lint tpu_swirld_torch/`` finds
    nothing on this tree."""
    findings = lint_paths([str(PKG)])
    assert findings == [], "\n".join(f.render() for f in findings)
    assert lint_summary(findings) == {"findings": 0, "clean": True, "by_rule": {}}


@pytest.mark.smoke
def test_lint_cli_smoke(tmp_path):
    """The module CLI: exit 0 on the port, exit 1 on a bad file."""
    r = subprocess.run(
        [sys.executable, "-m", "tpu_swirld_torch.analysis", "lint", str(PKG),
         "--json"],
        capture_output=True, text=True, cwd=ROOT, timeout=120,
    )
    assert r.returncode == 0, r.stdout + r.stderr
    assert json.loads(r.stdout)["clean"] is True
    bad = tmp_path / "tpu_swirld_torch" / "oracle" / "bad.py"
    bad.parent.mkdir(parents=True)
    bad.write_text("s = set()\nfor x in s:\n    pass\n")
    r = subprocess.run(
        [sys.executable, "-m", "tpu_swirld_torch.analysis", "lint", str(bad)],
        capture_output=True, text=True, cwd=ROOT, timeout=120,
    )
    assert r.returncode == 1
    assert "SW002" in r.stdout
    r = subprocess.run(
        [sys.executable, "-m", "tpu_swirld_torch.analysis", "lint", str(bad),
         "--rules", "SW001"],
        capture_output=True, text=True, cwd=ROOT, timeout=120,
    )
    assert r.returncode == 0 and "0 findings" in r.stdout


def test_scale_audit_names_its_roadmap_item():
    """The reference's flow audit is in the port since ROADMAP A5 closed:
    the package exports the port's ``scale_audit`` and
    ``scale_audit_stamp`` (``analysis/flow/``), and an unknown name still
    raises."""
    import tpu_swirld_torch.analysis as analysis
    from tpu_swirld_torch.analysis.flow import audit

    for name in ("scale_audit", "scale_audit_stamp"):
        assert getattr(analysis, name) is getattr(audit, name)
        assert name in analysis.__all__
    with pytest.raises(AttributeError, match="no attribute"):
        analysis.no_such_tool
