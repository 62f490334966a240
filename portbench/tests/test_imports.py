"""Nothing the benchmark runs imports JAX or the JAX package (top-level
names compared whole: the port's name begins with the JAX package's), and
the reference imports nothing of the program."""
import ast
import subprocess
import sys

from portbench import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _top_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_source_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in harness.BENCH.rglob("*.py"):
        assert not _top_imports(path) & FORBIDDEN, path


def test_the_reference_imports_nothing_of_the_program():
    for path in (harness.BENCH / "reference").rglob("*.py"):
        assert not _top_imports(path) & (FORBIDDEN | {"repro_torch"}), path


def _loaded_after(code):
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\nprint(' '.join("
         "sorted({m.split('.')[0] for m in sys.modules})))"],
        capture_output=True, text=True, check=True, cwd=harness.ROOT,
        env={"PYTHONPATH": f"{harness.ROOT}:{harness.ROOT / 'src'}",
             "PATH": "/usr/bin:/bin"})
    return set(out.stdout.split())


def test_modules_a_run_loads():
    loaded = _loaded_after(
        "from portbench import harness, faults, readings\n"
        "from portbench.drivers import train_steps, serve_closed\n"
        "import repro_torch.nn.model, repro_torch.kernels.ops\n"
        "for m in harness.manifest()['per_layer']:\n"
        "    harness.reader(m['name'])\n")
    assert "repro_torch" in loaded
    assert not loaded & FORBIDDEN
    assert harness.forbidden_modules({"repro_torch": 1, "repro": 1,
                                      "jax.numpy": 1, "reprox": 1}) == \
        ["jax", "repro"]


def test_the_reference_alone_loads_no_program():
    loaded = _loaded_after("from portbench.reference import dense_vlm")
    assert not loaded & (FORBIDDEN | {"repro_torch"})
