"""The port's first slice end to end: secure NN prediction served by both
packages' PartyPredictionServer on the same seed and the same weights
(carried across by params_from_numpy), opening the same words and moving
the same bits per link; plus the port's boundary rules -- it imports
neither jax nor the JAX package, and it does not run on the CPU unless
asked to; name for name, every public name of the JAX package has its
counterpart in the port or an entry, with its reason, in
NOT_NAME_FOR_NAME."""
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
from repro.runtime import make_runtime as jax_make_runtime  # noqa: E402
from repro_torch.runtime import FourPartyRuntime, make_runtime  # noqa: E402
from repro_torch.runtime import protocols as TP  # noqa: E402
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


# The JAX package's public names that have no namesake in the port's
# counterpart file: (JAX file, name) -> (the port's "file:name" that takes
# its place, or None where nothing does, and why).  Files are relative to
# src/repro and src/repro_torch.
NOT_NAME_FOR_NAME = {
    ("kernels/gamma_parts.py", "mult_terms"): (
        "kernels/gamma_parts.py:terms_group_cuda",
        "one launch a protocol round of csrc/gamma_parts.cu, ring mode"),
    ("kernels/gamma_parts.py", "and_terms"): (
        "kernels/gamma_parts.py:terms_group_cuda",
        "the same launch, XOR mode"),
    ("kernels/limb_matmul.py", "limb_matmul"): (
        "kernels/ring_matmul.py:ring_matmul_cuda",
        "the module is kernels/ring_matmul.py (int8 wgmma limbs)"),
    ("kernels/mpc_matmul_fused.py", "mpc_matmul_grid"): (
        "kernels/ops.py:mpc_matmul_grid",
        "ring_matmul.cu on stacked operands: no kernel file of its own"),
    ("kernels/mpc_matmul_fused.py", "mpc_matmul_fused"): (
        "kernels/mpc_matmul_fused.py:mpc_matmul_fused_cuda",
        "the launcher of csrc/mpc_matmul_fused.cu"),
    ("kernels/ppa_msb.py", "and_level"): (
        "kernels/ppa_msb.py:and_level_cuda",
        "the launcher of csrc/and_level.cu's one level"),
    ("kernels/prf_mask.py", "prf_mask"): (
        "kernels/prf_mask.py:prf_mask_group_cuda",
        "one launch a draw group"),
    ("kernels/ops.py", "INTERPRET"): (
        None, "Pallas' interpret switch: a port wrapper takes its plain "
        "version for CPU tensors and its kernel for CUDA ones"),
    ("kernels/ops.py", "bool_and_level"): (
        "kernels/ops.py:and_level", "renamed"),
    ("kernels/ops.py", "lambda_masks"): (
        "kernels/ops.py:lambda_masks_group", "one launch a draw group"),
    ("kernels/ops.py", "mpc_matmul_online"): (
        "kernels/ops.py:mpc_matmul_fused", "renamed"),
    ("kernels/ref.py", "limb_matmul_ref"): (
        "kernels/ring_matmul.py:ring_matmul_plain",
        "the oracles are the kernels' eager twins"),
    ("kernels/ref.py", "mpc_matmul_fused_ref"): (
        "kernels/mpc_matmul_fused.py:mpc_matmul_fused_plain",
        "the oracles are the kernels' eager twins"),
    ("kernels/ref.py", "ppa_msb_ref"): (
        None, "a test oracle, msb(x + y) in one line: the port's tests "
        "call JAX's (test_torch_joint), chip_smoke.py computes it inline"),
    ("kernels/ref.py", "prf_mask_ref"): (
        "kernels/prf_mask.py:prf_mask_plain",
        "core.prf.squares_stream, the stream every draw is defined by"),
    ("launch/dryrun.py", "dataclasses_replace"): (
        None, "its one caller, _batch_rescale (src/repro/launch/dryrun.py"
        ":36), is called nowhere"),
    ("launch/roofline.py", "PEAK_FLOPS"): (
        "launch/roofline.py:PEAK_INT8_OPS",
        "a TPU v5e constant: the H100's int8 tensor-core rate"),
    ("launch/roofline.py", "LINK_BW"): (
        "launch/roofline.py:NVLINK_BW",
        "a TPU v5e constant: NVLink 4 (and IB_BW between hosts)"),
    ("runtime/kernel_backend.py", "JnpKernels"): (
        "runtime/kernel_backend.py:TorchKernels", "the eager backend"),
    ("runtime/kernel_backend.py", "PallasKernels"): (
        "runtime/kernel_backend.py:HopperKernels", "the kernel backend"),
    ("train/optim.py", "tree_map2"): (
        "nn/model.py:map_params",
        "reads stacked segments from the tree (ROADMAP F6)"),
}
# JAX modules that have no file of the same name in the port
RENAMED_MODULES = {"kernels/limb_matmul.py": "kernels/ring_matmul.py",
                   "kernels/ref.py": None}


def _names(path: pathlib.Path, imports: bool = False) -> tuple:
    """(the top-level names a module binds: defs, classes, assignments and,
    with `imports`, imported names; its ``__all__`` or None), by AST."""
    names, exported = set(), None

    def targets(t):
        if isinstance(t, ast.Name):
            names.add(t.id)
        elif isinstance(t, (ast.Tuple, ast.List)):
            for e in t.elts:
                targets(e)

    def visit(body):
        nonlocal exported
        for n in body:
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef)):
                names.add(n.name)
            elif isinstance(n, (ast.Assign, ast.AnnAssign)):
                for t in getattr(n, "targets", [getattr(n, "target", None)]):
                    targets(t)
                    if isinstance(t, ast.Name) and t.id == "__all__":
                        exported = [e.value for e in n.value.elts]
            elif isinstance(n, (ast.If, ast.Try)):
                for part in (n.body, n.orelse,
                             *[h.body for h in getattr(n, "handlers", [])],
                             getattr(n, "finalbody", [])):
                    visit(part)
            elif imports and isinstance(n, (ast.Import, ast.ImportFrom)):
                names.update((a.asname or a.name).split(".")[0]
                             for a in n.names)
    visit(ast.parse(path.read_text()).body)
    return names, exported


def _check_name_for_name() -> None:
    """Every top-level public name of src/repro (and every name of its
    packages' ``__all__``) is bound in the port's counterpart file, or
    stands in NOT_NAME_FOR_NAME; every entry there is still needed, and
    names a port name that exists."""
    jax_root, port_root = ROOT / "src" / "repro", ROOT / "src" / "repro_torch"
    missing, listed = [], set()
    for jf in sorted(jax_root.rglob("*.py")):
        rel = jf.relative_to(jax_root).as_posix()
        jnames, jall = _names(jf)
        public = {n for n in jnames if not n.startswith("_")}
        tf = port_root / rel
        if tf.exists():
            tnames, tall = _names(tf, imports=True)
        else:
            assert rel in RENAMED_MODULES, f"no port module for {rel}"
            tnames, tall = set(), None
        for name in sorted(public) + sorted(set(jall or []) - public):
            ok = (name not in public or name in tnames) and \
                (name not in (jall or []) or name in (tall or []))
            key = (rel, name)
            if key in NOT_NAME_FOR_NAME:
                listed.add(key)
                assert not ok, f"{rel}: the port has {name}: drop its entry"
            elif not ok:
                missing.append(key)
    assert not missing, f"public JAX names with no counterpart: {missing}"
    assert listed == set(NOT_NAME_FOR_NAME), \
        f"entries naming no JAX name: {set(NOT_NAME_FOR_NAME) - listed}"
    for (rel, name), (target, reason) in NOT_NAME_FOR_NAME.items():
        assert reason, (rel, name)
        if target is not None:
            tfile, tname = target.split(":")
            assert tname in _names(port_root / tfile, imports=True)[0], \
                f"{rel}:{name} -> {target}, which the port lacks"
    for rel, target in RENAMED_MODULES.items():
        assert not (port_root / rel).exists() and (
            target is None or (port_root / target).exists()), rel


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
    _check_name_for_name()


def test_entry_points_refuse_the_cpu_by_default(monkeypatch):
    """No CUDA and no device given: refuse rather than run on the CPU (the
    party runtime, through ``make_runtime`` too, which opens JAX's words
    on the CPU, and its server, inline and pipelined; the dealer, the
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
        make_runtime()
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
    # make_runtime as the JAX package's: FourPartyRuntime(ring, seed, **kw)
    rt, jrt = make_runtime(seed=3, device="cpu"), jax_make_runtime(seed=3)
    assert rt.ring is T64 and rt.device.type == "cpu"
    assert np.array_equal(words_to_numpy(TP.reconstruct(
        rt, TP.share(rt, rt.encode([1.5, -2.0])))[1]), np.asarray(
        JP.reconstruct(jrt, JP.share(jrt, J64.encode(
            np.array([1.5, -2.0]))))[1]))
    assert rt.transport.per_link() == jrt.transport.per_link()
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
