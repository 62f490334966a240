"""tridentlint over the port (``repro_torch.analysis``) against the JAX
package's analyzer (``repro.analysis``): the same findings on every JAX
fixture and on ``src/repro``; PREP001 taught the port's samplers, which
the JAX rule does not see; the port's tree clean against
``analysis/baseline_torch.json``; the baseline diff and the CLI.

Each item loops over its cases rather than being parametrised: the
analyzer is milliseconds a file, pytest items are not."""
import importlib.util
from collections import Counter
from pathlib import Path

import repro.analysis as J
import repro_torch.analysis as T
from repro.analysis.core import Module as JModule
from repro_torch.analysis.cli import main
from repro_torch.analysis.core import Module as TModule

REPO = Path(__file__).resolve().parents[1]
JAX_FIXTURES = REPO / "tests" / "fixtures" / "lint"
PORT_FIXTURES = REPO / "tests" / "fixtures" / "lint_torch"
SRC_JAX = REPO / "src" / "repro"
SRC_PORT = REPO / "src" / "repro_torch"
BASELINE = REPO / "analysis" / "baseline_torch.json"
ASH = ("PREP001", "runtime/protocols.py", "_ash_pieces")


def _jax_cases() -> dict:
    """tests/test_analysis.py's CASES: rule id -> (pretend path, count)."""
    spec = importlib.util.spec_from_file_location(
        "_jax_lint_cases", REPO / "tests" / "test_analysis.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.CASES


def _keys(findings) -> list:
    return [(f.rule, f.line, f.anchor) for f in findings]


def test_port_rules_equal_jax_rules_on_jax_fixtures():
    cases = _jax_cases()
    assert sorted(cases) == sorted(T.all_rules()) == sorted(J.all_rules())
    for rid in sorted(T.all_rules()):
        assert T.all_rules()[rid].name == J.all_rules()[rid].name, rid
    fixtures = sorted(JAX_FIXTURES.glob("*_*.py"))
    assert len(fixtures) == 26
    compared = 0
    for path in fixtures:
        rid = path.stem.split("_")[0].upper()
        relpath, count = cases[rid]
        jmod, tmod = JModule.load(path, relpath), TModule.load(path, relpath)
        # the fixture's own rule, as tests/test_analysis.py runs it
        jf = J.run_rules([jmod], rules=[rid])
        tf = T.run_rules([tmod], rules=[rid])
        assert _keys(tf) == _keys(jf), path.name
        assert len(tf) == (count if path.stem.endswith("_bad") else 0)
        # and every rule at the fixture's pretend path
        assert _keys(T.run_rules([tmod])) == _keys(J.run_rules([jmod])), \
            path.name
        compared += 1
    assert compared == 26


def test_prep001_sees_the_port_samplers():
    bad, clean = (PORT_FIXTURES / f"prep001_{k}.py" for k in ("bad", "clean"))
    rel = "runtime/protocols.py"
    tf = T.run_rules([TModule.load(bad, rel)], rules=["PREP001"])
    jf = J.run_rules([JModule.load(bad, rel)], rules=["PREP001"])
    # every marked line of the bad fixture, and only those
    marked = [i for i, line in enumerate(bad.read_text().splitlines(), 1)
              if "# PREP001" in line]
    assert [f.line for f in tf] == marked
    names = [f.message.split("`")[1] for f in tf]
    assert names == ["rt.sample_group", "torch.randint", "torch.Generator",
                     "rt.sample", "ops.lambda_masks_group",
                     "torch.empty().uniform_"]
    assert [f.anchor for f in tf] == ["mult"] * 4 + ["_leak_helper",
                                                      "jitter"]
    # the JAX rule sees only the lone rt.sample: 1 of the port rule's 6
    assert len(tf) == 6 and len(jf) == 1
    assert _keys(jf) == [k for k in _keys(tf) if k[1] == marked[3]]
    got = T.run_rules([TModule.load(clean, rel)], rules=["PREP001"])
    assert got == [], [f.render() for f in got]
    assert J.run_rules([JModule.load(clean, rel)], rules=["PREP001"]) == []


def test_port_tree_against_its_baseline_and_the_jax_tree():
    findings = T.run_rules(T.load_tree(SRC_PORT))
    new, matched, stale = T.baseline_diff(findings, T.baseline_load(BASELINE))
    assert new == [], "\n".join(f.render() for f in new)
    assert stale == []
    assert matched == len(findings) == 1
    assert [f.key for f in findings] == [ASH]
    # the gap the twin closes: the JAX rules see none of the port's draws
    assert J.run_rules(J.load_tree(SRC_PORT)) == []
    # on the JAX tree the port's rules are the JAX rules
    port_on_jax = T.run_rules(T.load_tree(SRC_JAX))
    jax_on_jax = J.run_rules(J.load_tree(SRC_JAX))
    assert _keys(port_on_jax) == _keys(jax_on_jax)
    assert [f.key for f in port_on_jax] == [ASH]
    # the port's baseline reads like the JAX one, entry for entry
    assert T.baseline_load(BASELINE) == J.baseline_load(
        REPO / "analysis" / "baseline.json") == Counter({ASH: 1})


def test_baseline_diff_and_cli(tmp_path, capsys):
    f1 = T.Finding("PREP001", "runtime/a.py", 10, "f", "m")
    f2 = T.Finding("CONC003", "serve/b.py", 20, "g", "m")
    p = tmp_path / "b.json"
    T.baseline_save(p, [f1])
    base = T.baseline_load(p)
    assert base == Counter({f1.key: 1}) == J.baseline_load(p)
    new, matched, stale = T.baseline_diff([f1, f2], base)
    assert new == [f2] and matched == 1 and stale == []
    new, matched, stale = T.baseline_diff([f2], base)
    assert new == [f2] and matched == 0 and stale == [f1.key]
    moved = T.Finding("PREP001", "runtime/a.py", 99, "f", "m")
    new, matched, stale = T.baseline_diff([moved], base)
    assert new == [] and matched == 1 and stale == []

    assert main(["--list-rules"]) == 0
    listed = [line.split()[0] for line in
              capsys.readouterr().out.splitlines()]
    assert listed == sorted(J.all_rules())
    # the default root is the port's tree
    assert main(["--baseline", str(BASELINE)]) == 0
    assert "tridentlint: clean" in capsys.readouterr().out
    empty = tmp_path / "empty"
    empty.mkdir()
    injected = {
        "np.random.randint": "import numpy as np\n\n\n"
                             "def mult(rt, x, y):\n"
                             "    return x * y + np.random.randint(0, 7)\n",
        "torch.randint": "import torch\n\n\n"
                         "def mult(rt, x, y):\n"
                         "    return x * y + torch.randint(0, 7, (1,))\n",
        "rt.sample_group": "def mult(rt, x, y):\n"
                           "    lam = rt.sample_group([((0, 1), x.shape)])\n"
                           "    return x * y + lam[0]\n",
    }
    for name, src in injected.items():
        bad = tmp_path / "injected.py"
        bad.write_text(src)
        rc = main(["--root", str(empty), "--baseline", str(BASELINE),
                   "--pretend-path", "runtime/injected.py", str(bad)])
        out = capsys.readouterr().out
        assert rc == 1, name
        assert f"PREP001 [mult] `{name}`" in out, out
    # --update-baseline round-trips
    pinned = tmp_path / "pinned.json"
    assert main(["--root", str(empty), "--baseline", str(pinned),
                 "--update-baseline", "--pretend-path",
                 "runtime/injected.py", str(bad)]) == 0
    assert T.baseline_load(pinned) == Counter(
        {("PREP001", "runtime/injected.py", "mult"): 1})
    capsys.readouterr()
    assert main(["--root", str(empty), "--baseline", str(pinned),
                 "--pretend-path", "runtime/injected.py", str(bad)]) == 0
    assert "1 pre-existing finding(s) matched" in capsys.readouterr().out
