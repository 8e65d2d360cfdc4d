"""The port's graft-lint (``metrics_tpu_torch/analysis/{lint,baseline}.py`` and
``analysis/rules/``) against the contracts of the JAX package's
``tests/analysis/test_lint_rules.py`` and ``test_baseline_suppression.py``,
on torch versions of their snippets; the lint parity of the two packages;
and the CLI, which writes no file of the JAX package.
"""
import collections
import hashlib
import pathlib
import textwrap

import pytest

torch = pytest.importorskip("torch")

from metrics_tpu_torch import analysis as A  # noqa: E402
from metrics_tpu_torch.analysis import baseline as B  # noqa: E402
from metrics_tpu_torch.analysis import lint as L  # noqa: E402
from metrics_tpu_torch.analysis.__main__ import main as cli  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent


def ids(src, relpath="metrics_tpu_torch/some/module.py"):
    return [f.rule_id for f in L.lint_source(textwrap.dedent(src), relpath)]


# (rule, flagged snippet, clean twin): each rule's torch form of the JAX
# package's seeded cases
CASES = [
    ("GL101", "import torch\nHAVE_CUDA = torch.cuda.is_available()\n", "import torch\ndef have_cuda():\n    return torch.cuda.is_available()\n"),
    ("GL101", "from torch.cuda import device_count\nN = device_count()\n", "from torch.cuda import device_count\nif __name__ == '__main__':\n    N = device_count()\n"),
    ("GL101", "import torch\nclass C:\n    NAME = torch.cuda.get_device_name(0)\n", "import torch\nclass C:\n    def name(self):\n        return torch.cuda.get_device_name(0)\n"),
    ("GL102", "import torch\nHALF = torch.full((1,), 0.5, device='cuda')\n", "import torch\nHALF = torch.full((1,), 0.5)\n"),
    ("GL102", "import torch\nONES = torch.ones(4).cuda()\n", "import torch\nDEV = torch.device('cuda')\n"),
    ("GL102", "import torch\nONES = torch.ones(4).to('cuda:0')\n", "import torch\nONES = torch.ones(4).to(torch.float64)\n"),
    ("GL102", "import torch\ndef f(x=torch.zeros(2, device=torch.device('cuda'))):\n    return x\n", "import torch\ndef f(x=None):\n    return torch.zeros(2, device='cuda') if x is None else x\n"),
    ("GL102", "from metrics_tpu_torch.ops import _build\nLIB = _build.load('histogram.cu')\n", "from metrics_tpu_torch.ops import _build\ndef lib():\n    return _build.load('histogram.cu')\n"),
    ("GL102", "from metrics_tpu_torch.ops._build import build\nPATH = build('histogram.cu')\n", "from metrics_tpu_torch.ops._build import build\nPATHS = [build]\n"),
    ("GL301", "def f(m, v):\n    m._state['x'] = v\n", "def f(m, v):\n    m.add_state('x', v, dist_reduce_fx='sum')\n"),
    ("GL301", "def f(m, v):\n    m._state['x'], y = v, 1\n", "def f(m, v):\n    s = dict(m._state)\n    s['x'] = v\n"),
    ("GL301", "def f(m):\n    m._defaults = {}\n", "def f(m):\n    return m._defaults\n"),
    ("GL302", "class M:\n    def __init__(self):\n        self.add_state('preds', default=[], dist_reduce_fx='cat')\n",
     "class M:\n    def __init__(self):\n        self.add_state('preds', default=[], dist_reduce_fx='cat', template=None)\n"),
    ("GL302", "def init(metric):\n    metric.add_state('rows', [], 'cat')\n", "class M:\n    jittable_update = False\n    def __init__(self):\n        self.add_state('rows', [], 'cat')\n"),
    ("GL401", "import threading\nt = threading.Thread(target=print)\n", "import threading\nt = threading.Thread(target=print, daemon=True, name='worker')\n"),
    ("GL402", "class H:\n    def emit(self, e):\n        with self._lock:\n            for fn in self._listeners:\n                fn(e)\n",
     "class H:\n    def emit(self, e):\n        with self._lock:\n            fns = list(self._listeners)\n        for fn in fns:\n            fn(e)\n"),
    ("GL402", "class H:\n    def emit(self, e):\n        with self._lock:\n            self.callback(e)\n", "class H:\n    def emit(self, e):\n        with self._lock:\n            cb = self.callback\n        cb(e)\n"),
    ("GL403", "import threading\nclass C:\n    def lazy(self):\n        self._lock = threading.Lock()\n", "import threading\nclass C:\n    def __init__(self):\n        self._lock = threading.Lock()\n"),
    ("GL403", "import threading\nfrom metrics_tpu_torch.analysis.lockwitness import named_lock\nclass C:\n    def start(self):\n        self._lock = named_lock('c._lock', threading.RLock())\n",
     "import threading\nfrom metrics_tpu_torch.analysis.lockwitness import named_lock\nclass C:\n    def __deepcopy__(self, memo):\n        self._lock = named_lock('c._lock', threading.RLock())\n"),
    ("GL501", "import os\nX = os.environ.get('X')\n", "from metrics_tpu_torch.ops._envtools import EnvParse\n"),
    ("GL501", "import os\ndef f():\n    return os.getenv('X')\n", "import os\ndef f():\n    return os.path.join('a', 'b')\n"),
    ("GL502", "def f(p):\n    with open(p, 'w') as fh:\n        fh.write('x')\n", "def f(p):\n    with open(p) as fh:\n        return fh.read()\n"),
    ("GL503", "def f(xs):\n    for x in xs:\n        record_degradation('k', 'm')\n", "def f(xs):\n    for x in xs:\n        if x:\n            record_degradation('k', 'm')\n"),
]


@pytest.mark.parametrize("rule,flagged,clean", CASES, ids=[f"{c[0]}-{i}" for i, c in enumerate(CASES)])
def test_rule_flags_the_seeded_case_and_passes_its_twin(rule, flagged, clean):
    assert rule in ids(flagged)
    assert rule not in ids(clean)


def test_catalog_is_jax_less_trace_safety():
    """The port's rules keep JAX's ids and names; GL201-GL203 are not
    ported (ROADMAP D69)."""
    from metrics_tpu.analysis.rules import ALL_RULES as JAX_RULES

    jax = {r.rule_id: r.name for r in JAX_RULES if r.rule_id not in ("GL201", "GL202", "GL203")}
    port = {r.rule_id: r.name for r in A.ALL_RULES}
    assert port.keys() == jax.keys()
    assert {k: v for k, v in port.items() if k not in ("GL102",)} == {k: v for k, v in jax.items() if k != "GL102"}
    assert set(A.rule_catalog()) == set(port)


@pytest.mark.parametrize(
    "line,suppressed",
    [
        ("X = os.environ['X']  # graft-lint: disable=GL501", True),
        ("X = os.environ['X']  # graft-lint: disable=all", True),
        ("X = os.environ['X']  # graft-lint: disable=GL502", False),
        ("X = os.environ['X']  # graft-lint: disable=GL501 the bootstrap reads it", True),
        ("X = os.environ['X'] if '# graft-lint: disable=GL501' else None", False),
    ],
)
def test_trailing_suppressions(line, suppressed):
    assert ("GL501" not in ids(f"import os\n{line}\n")) is suppressed


def test_comment_block_above_suppresses_only_when_contiguous():
    above = "import os\n# graft-lint: disable=GL501 — the reason,\n# spelled out\nX = os.environ['X']\n"
    apart = "import os\n# graft-lint: disable=GL501\n\nX = os.environ['X']\n"
    assert "GL501" not in ids(above) and "GL501" in ids(apart)


def test_syntax_error_is_gl000(tmp_path):
    bad = tmp_path / "metrics_tpu_torch" / "bad.py"
    bad.parent.mkdir()
    bad.write_text("def f(:\n")
    (tmp_path / "metrics_tpu_torch" / "ok.py").write_text("import os\nX = os.getenv('X')\n")
    found = L.lint_paths(sorted((tmp_path / "metrics_tpu_torch").glob("*.py")), str(tmp_path))
    assert [f.rule_id for f in found] == ["GL000", "GL501"]


def test_baseline_round_trip_keeps_comments_and_absorbs(tmp_path):
    src = "import os\nA = os.getenv('A')\nB = os.getenv('B')\n"
    findings = L.lint_source(src, "metrics_tpu_torch/m.py")
    path = tmp_path / "baseline.txt"
    B.save_baseline(str(path), findings)
    text = path.read_text()
    path.write_text(text.replace("GL501|metrics_tpu_torch/m.py|1|A =", "# why A is benign\nGL501|metrics_tpu_torch/m.py|1|A ="))
    B.save_baseline(str(path), findings)  # regeneration keeps the comment
    assert "# why A is benign" in path.read_text()
    new, stale = B.apply_baseline(findings, B.load_baseline(str(path)))
    assert new == [] and stale == {}
    # a line shift does not stale it; paid-down debt is reported stale
    shifted = L.lint_source("\n\n" + src.replace("B = os.getenv('B')\n", ""), "metrics_tpu_torch/m.py")
    new, stale = B.apply_baseline(shifted, B.load_baseline(str(path)))
    assert new == [] and list(stale) == ["GL501|metrics_tpu_torch/m.py|B = os.getenv('B')"]
    with pytest.raises(ValueError):
        path.write_text("GL501|only-two-fields\n")
        B.load_baseline(str(path))


@pytest.fixture(scope="module")
def port_findings():
    """One lint of the whole port, shared by the tests below."""
    return L.lint_package()


def test_default_baseline_is_the_ports_own_and_the_package_is_clean(port_findings):
    path = pathlib.Path(B.default_baseline_path())
    assert path == ROOT / "metrics_tpu_torch" / "analysis" / "lint_baseline.txt"
    new, stale = B.apply_baseline(port_findings, B.load_baseline(str(path)))
    assert new == [] and stale == {}
    # every grandfathered entry states why it is benign
    block = []
    for line in path.read_text().splitlines():
        if line.startswith("#"):
            block.append(line)
        elif line:
            assert any("BENIGN" in c for c in block), line
            block = []


def test_lint_parity_with_jax(port_findings):
    """The port's findings over the port equal JAX's over JAX under the path
    map (GL201-GL203 left out), apart from the port's baseline entries that
    have no JAX counterpart."""
    from metrics_tpu.analysis.lint import lint_package as jax_lint

    jax = collections.Counter(
        (f.rule_id, "metrics_tpu_torch/" + f.path[len("metrics_tpu/"):])
        for f in jax_lint()
        if f.rule_id not in ("GL201", "GL202", "GL203")
    )
    port = collections.Counter((f.rule_id, f.path) for f in port_findings)
    assert jax - port == collections.Counter()
    assert port - jax == collections.Counter({("GL501", "metrics_tpu_torch/ops/_build.py"): 1})
    baseline = B.load_baseline(B.default_baseline_path())
    assert any(fp.startswith("GL501|metrics_tpu_torch/ops/_build.py|") for fp in baseline)


PRE_PORT = ("lint_baseline.txt", "COST_PROFILE.json", "metrics_tpu/analysis/LOCK_ORDER.md")


def _digests():
    return {p: hashlib.sha256((ROOT / p).read_bytes()).hexdigest() for p in PRE_PORT}


def test_cli_lint_locks_and_rules_write_no_pre_port_file(port_findings, monkeypatch, tmp_path, capsys):
    """``lint`` (the package linted once, by the fixture), ``locks`` and
    ``rules`` exit 0; ``--write-baseline`` writes the file it is given (the
    port's own by default), never the JAX package's files."""
    monkeypatch.setattr(L, "lint_package", lambda: port_findings)
    before = _digests()
    assert cli(["lint"]) == 0
    assert cli(["locks"]) == 0
    assert cli(["rules"]) == 0
    out = capsys.readouterr().out
    assert "graft-lint: 0 new finding(s), 4 grandfathered" in out
    assert "lock-order: 0 violation(s)" in out and "GL503" in out
    written = tmp_path / "b.txt"
    assert cli(["lint", "--write-baseline", "--baseline", str(written)]) == 0
    assert B.load_baseline(str(written)) == B.load_baseline(B.default_baseline_path())
    assert _digests() == before
