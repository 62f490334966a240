"""The port's examples (``examples_torch/``) against the JAX package's
(``examples/``).  One item, on the CPU (``--device cpu``):

  * ``quickstart``: the port's run in process and JAX's run live print
    the same text: the opened relu(A @ B), its error against float64, the
    tally table and ``malicious checks passed: True``;
  * ``secure_inference_parties``: the port's P1 words, traffic, served
    predictions and serving report equal the JAX example's, pinned below
    (the JAX example takes ~10 s here);
  * the other seven byte-compile, import without running, and answer
    ``--help`` with their JAX counterpart's flags and ``--device``.

The socket and cluster examples spawn daemons that import the example by
name, so they run as scripts (on the card, phase examples of
``chip_smoke.py``), not here."""
import contextlib
import hashlib
import importlib.util
import io
import pathlib
import py_compile
import runpy

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.core.ring import words_to_numpy  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
NAMES = ("quickstart", "secure_inference", "secure_inference_offline",
         "secure_inference_parties", "secure_inference_sockets",
         "secure_training", "secure_training_parties",
         "secure_training_live_prep", "transformer_tour")
# each example's flags beside --device (its JAX counterpart's)
FLAGS = {"secure_training": ("--steps", "--batch", "--features", "--ckpt"),
         "transformer_tour": ("--arch", "--steps")}

# examples/secure_inference_parties.py run by the JAX package on the CPU
# (JAX 0.9.0): sha256 of P1's opened words (uint64, (8, 3)) and of the 24
# served predictions (float64, (24, 3)), the runtime's totals() and the
# server's report().
PARTIES_WORDS = \
    "cc19047879a1ae2950ac352f40c56963cf0d3bb524d93a2da23a4d67b0571664"
PARTIES_PREDS = \
    "35ceefb83b7b3f6505c4f07d2c99369d04381f6efb2d84112a4c63f33d94e998"
PARTIES_TOTALS = {"offline": {"rounds": 6, "bits": 58368},
                  "online": {"rounds": 7, "bits": 89088}}
PARTIES_REPORT = {
    "queries": 24, "batches": 3, "aborted": False,
    "online_rounds_per_batch": 7.0, "online_bits_per_batch": 89088.0,
    "offline_bits_per_batch": 58368.0,
    "lan_latency_ms": 2.1610880000000003,
    "wan_latency_s": 1.9260372000000001,
    "link_online_bits": {"P0->P1": 53760, "P0->P2": 53760,
                         "P0->P3": 53760, "P1->P0": 4608,
                         "P1->P2": 29184, "P1->P3": 4608,
                         "P2->P1": 4608, "P2->P3": 29184,
                         "P3->P1": 29184, "P3->P2": 4608}}


def _load(name: str):
    path = ROOT / "examples_torch" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"port_example_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(fn) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn()
    return buf.getvalue()


def _sha(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def test_examples_match_jax(capsys):
    assert sorted(p.stem for p in (ROOT / "examples").glob("*.py")) == \
        sorted(NAMES)
    for name in NAMES:
        src = ROOT / "examples_torch" / f"{name}.py"
        py_compile.compile(str(src), doraise=True)
        text = src.read_text()
        assert "import jax" not in text and "from repro." not in text \
            and "import repro\n" not in text, name

    # quickstart: the same printed text as JAX's, run live
    jax_out = _run(lambda: runpy.run_path(
        str(ROOT / "examples" / "quickstart.py"), run_name="jax_quickstart"))
    port = {}
    port_out = _run(lambda: port.update(_load("quickstart").main(
        ["--device", "cpu"])))
    assert port_out == jax_out
    assert "malicious checks passed: True" in port_out and port["ok"]
    assert port["opened"].dtype == torch.int64 and \
        tuple(port["opened"].shape) == (4, 3)

    # secure_inference_parties: JAX's words, traffic and serving report
    res = {}
    out = _run(lambda: res.update(_load("secure_inference_parties").main(
        ["--device", "cpu"])))
    assert _sha(words_to_numpy(res["words"])) == PARTIES_WORDS
    assert _sha(res["preds"].astype(np.float64)) == PARTIES_PREDS
    assert res["totals"] == PARTIES_TOTALS
    assert res["report"] == PARTIES_REPORT
    assert "bit-identical predictions across backends ✓" in out
    assert "plaintext check: True" in out

    # the others: importable without running, --help with their flags
    for name in NAMES:
        if name in ("quickstart", "secure_inference_parties"):
            continue
        mod = _load(name)
        with pytest.raises(SystemExit) as exc:
            mod.main(["--help"])
        assert exc.value.code == 0, name
    help_text = capsys.readouterr().out
    for flag in ("--device",) + sum(FLAGS.values(), ()):
        assert flag in help_text, flag
