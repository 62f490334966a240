"""The port's first slice end to end: secure NN prediction served by both
packages' PartyPredictionServer on the same seed and the same weights
(carried across by params_from_numpy), opening the same words and moving
the same bits per link; plus the port's boundary rules -- it imports
neither jax nor the JAX package, and it does not run on the CPU unless
asked to."""
import ast
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny shapes: one intra-op thread, so idle torch threads do not spin
# beside the JAX tests that share this worker
torch.set_num_threads(1)

from repro.core.ring import RING64 as J64  # noqa: E402
from repro.runtime import activations as JA  # noqa: E402
from repro.runtime import protocols as JP  # noqa: E402
from repro.serve.party_server import (  # noqa: E402
    PartyPredictionServer as JServer)
from repro.train.paper_ml import MLPNet as JNet, mlp_net_init  # noqa: E402
from repro_torch.core.context import make_context  # noqa: E402
from repro_torch.core.ring import RING64 as T64, words_to_numpy  # noqa: E402
from repro_torch.runtime import FourPartyRuntime  # noqa: E402
from repro_torch import offline  # noqa: E402
from repro_torch.runtime.kernel_backend import (  # noqa: E402
    HopperKernels, TorchKernels, make_kernel_backend)
from repro_torch.serve.engine import PredictionServer  # noqa: E402
from repro_torch.serve.party_server import PartyPredictionServer  # noqa: E402
from repro_torch.train import secure_sgd as SGD  # noqa: E402
from repro_torch.train.paper_ml import (  # noqa: E402
    MLPNet, mlp_net_predict_runtime, params_from_numpy)

ROOT = pathlib.Path(__file__).resolve().parents[1]
NET = (12, (8, 8, 4))
BATCH = 4
SEED = 13


def _jax_predict(params):
    """mlp_net_fwd's forward pass on the JAX runtime, as the port's
    mlp_net_predict_runtime runs it: share X then the weights, matmul_tr
    -> relu per hidden layer, matmul_tr -> smx at the output, open."""
    def predict(rt, X):
        h = JP.share(rt, rt.ring.encode(X))
        ws = [JP.share(rt, rt.ring.encode(params[f"w{i}"]))
              for i in range(len(params))]
        for i, w in enumerate(ws):
            z = JP.matmul_tr(rt, h, w)
            h = JA.relu(rt, z) if i < len(ws) - 1 else JA.smx_softmax(rt, z)
        return np.asarray(JP.reconstruct(rt, h)[1])
    return predict


def _serve(server, queries):
    for q in queries:
        server.submit(q)
    return server.flush()


@pytest.fixture(scope="module")
def served():
    params = mlp_net_init(np.random.RandomState(0), JNet(*NET))
    queries = np.random.RandomState(1).randn(BATCH + 2, NET[0])
    jsrv = JServer(_jax_predict(params), batch_size=BATCH, ring=J64,
                   seed=SEED)
    try:
        jwords = np.stack(_serve(jsrv, queries))
        jreport = jsrv.report()
    finally:
        jsrv.close()
    return params, queries, jwords, jreport


def test_nn_prediction_matches_jax_server(served):
    params, queries, jwords, jreport = served
    net = MLPNet(*NET)
    enc = params_from_numpy(params, T64, "cpu")
    for backend in ("torch", "hopper"):
        srv = PartyPredictionServer(
            lambda rt, X: mlp_net_predict_runtime(rt, enc, net, X),
            batch_size=BATCH, seed=SEED, kernel_backend=backend,
            device="cpu")
        words = words_to_numpy(torch.stack(_serve(srv, queries)))
        assert words.shape == (len(queries), NET[1][-1])
        assert np.array_equal(words, jwords), backend
        report = srv.report()
        assert report == jreport, backend   # per-link bits, rounds, abort
        assert report["batches"] == 2 and report["aborted"] is False


def test_params_carry_over_and_probabilities(served):
    """params_from_numpy gives the JAX package's encoding word for word,
    and the served words decode to the float64 forward pass."""
    params, queries, jwords, _ = served
    enc = params_from_numpy(params, T64, "cpu")
    for k, v in params.items():
        assert np.array_equal(words_to_numpy(enc[k]),
                              np.asarray(J64.encode(v))), k
    h = queries
    for i in range(len(params)):
        h = np.maximum(h @ params[f"w{i}"], 0.0)
    want = h / (h.sum(axis=-1, keepdims=True) + 1e-2)
    got = T64.decode(torch.from_numpy(jwords.view(np.int64))).numpy()
    np.testing.assert_allclose(got, want, atol=1e-2)


def _imported_roots(path: pathlib.Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_imports_neither_jax_nor_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    # the offline subsystem keeps its own copy of the store's format
    assert {f.name for f in files if f.parent.name == "offline"} >= {
        "__init__.py", "store.py", "dealer.py", "executor.py",
        "workload.py", "pipeline.py", "continuous.py"}
    assert {f.name for f in files if f.parent.name == "train"} >= {
        "paper_ml.py", "secure_sgd.py", "data.py", "checkpoint.py",
        "trainer.py"}
    # tridentlint over the port: its own copy of the analyzer's modules
    assert {f.name for f in files if f.parent.name == "analysis"} == {
        "__init__.py", "core.py", "baseline.py", "cli.py", "rules_prep.py",
        "rules_phase.py", "rules_obs.py", "rules_concurrency.py"}
    for f in files:
        bad = _imported_roots(f) & {"jax", "jaxlib", "repro"}
        assert not bad, f"{f.relative_to(ROOT)} imports {sorted(bad)}"


def test_entry_points_refuse_the_cpu_by_default(monkeypatch):
    """No CUDA and no device given: refuse rather than run on the CPU (the
    party runtime and its server, inline and pipelined; the dealer, the
    online-only run, the prep pipeline and the continuous dealer; the joint
    simulation's context and its server; a training step's engine in
    either world); the "torch" backend refuses CUDA; a batched ring
    matmul on a non-CPU device goes to the batched kernel's wrapper, which
    takes CUDA tensors only; the "dotp" kind runs on the "hopper"
    backend."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FourPartyRuntime(T64)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PartyPredictionServer(lambda rt, X: X)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PartyPredictionServer(lambda rt, X: X, prep="pipelined")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        offline.deal(lambda rt: None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        offline.run_online(lambda rt: None, offline.PrepStore())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        offline.PrepPipeline([lambda rt: None])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        offline.ContinuousDealer(lambda step: None)
    for world in ("runtime", "joint"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            SGD.make_engine(world, 0)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            SGD.run_step(SGD.logreg_task(features=2), {}, (), step=0,
                         world=world)
    store, rep = offline.deal(lambda rt: None, device="cpu")
    assert rep.entries == 0
    assert offline.run_online(lambda rt: 5, store, device="cpu")[0] == 5
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_context(T64)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PredictionServer(lambda ctx, X: X)
    assert FourPartyRuntime(T64, device="cpu").device.type == "cpu"
    assert make_context(T64, device="cpu").device.type == "cpu"
    srv = PredictionServer(lambda ctx, X: ctx.encode(X), batch_size=2,
                           device="cpu")
    for q in np.eye(3):
        srv.submit(q)
    assert torch.equal(torch.stack(srv.flush()), T64.encode(np.eye(3)))
    with pytest.raises(ValueError, match="CPU only"):
        make_kernel_backend("torch", torch.device("cuda"))
    lam = {j: torch.empty((2, 3, 3), dtype=torch.int64, device="meta")
           for j in (1, 2, 3)}
    with pytest.raises(ValueError, match="must be CUDA tensors"):
        HopperKernels().gamma_pieces("matmul", torch.matmul, lam, lam, lam,
                                     (1, 2, 3))
    words = {j: torch.arange(6, dtype=torch.int64).reshape(2, 3) * j - 7
             for j in (1, 2, 3)}
    masks = {j: torch.full((2,), 11 * j, dtype=torch.int64)
             for j in (1, 2, 3)}

    def dot(a, b):
        return torch.sum(a * b, dim=-1, dtype=a.dtype)

    for backend in (HopperKernels(), TorchKernels()):
        got = backend.gamma_pieces("dotp", dot, words, words, masks,
                                   (1, 2, 3))
        assert all(torch.equal(got[j], words[j].new_tensor(want)) for j, want
                   in {1: [309, 30], 2: [249, 87], 3: [255, 48]}.items())
