"""The port's launch tooling (``repro_torch.launch``) and the LM-training
pieces it stands on (``train.data.TokenStream``; ``train.checkpoint``'s
share trees, ``host=`` shards and ``reshard``; ``train.trainer``'s
rewrapping) against the JAX package.  The launcher's train steps are held
to the JAX package's pinned digests (``LAUNCH_DIGESTS``, printed by
``tools/torch_lm_vs_jax.py --launch``): a JAX LM train step compiles every
scan body, too slow to run here.  Three items: the suite's wall time is
held near its limit."""
import importlib.util
import json
import os
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from repro.configs import get as jget  # noqa: E402
from repro.launch import roofline as JRL  # noqa: E402
from repro.launch import specs as JSP  # noqa: E402
from repro.train import checkpoint as JCK  # noqa: E402
from repro.train import data as JD  # noqa: E402
from repro_torch import configs as TCFGS  # noqa: E402
from repro_torch.core.context import make_context as tmake  # noqa: E402
from repro_torch.core.ring import RING32, RING64  # noqa: E402
from repro_torch.core.ring import words_to_numpy  # noqa: E402
from repro_torch.core.shares import AShare as TShare  # noqa: E402
from repro_torch.launch import assemble as TAS  # noqa: E402
from repro_torch.launch import dryrun as TDR  # noqa: E402
from repro_torch.launch import hillclimb as THC  # noqa: E402
from repro_torch.launch import mesh as TMESH  # noqa: E402
from repro_torch.launch import report as TREP  # noqa: E402
from repro_torch.launch import roofline as TRL  # noqa: E402
from repro_torch.launch import specs as TSP  # noqa: E402
from repro_torch.launch import steps as TST  # noqa: E402
from repro_torch.launch import sweep as TSW  # noqa: E402
from repro_torch.launch import train as TLT  # noqa: E402
from repro_torch.nn import model as TM  # noqa: E402
from repro_torch.nn.engine import TridentEngine as TEngine  # noqa: E402
from repro_torch.train import checkpoint as TCK  # noqa: E402
from repro_torch.train import data as TD  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]

# The port launcher's whisper-tiny SMOKE steps (2 encoder and 2 decoder
# layers, batch 2, seq 8, lr 2^-6, TokenStream(vocab, 0), encoder inputs
# RandomState(0) x 0.1) run through the JAX package's
# repro.nn.model.train_step under the launcher's PRF discipline (the
# parameters and inputs shared under seed 0, collapsed; step k under its
# own context seeded seed_for_step(1, k)): the sha256 of step k's new
# params' words, its loss, its context's totals() and abort flag, as
# tools/torch_lm_vs_jax.py --launch prints them (JAX 0.9.0 on the CPU;
# the tool holds the port's launcher to JAX's words leaf by leaf).
LAUNCH_DIGESTS = [
    "ea892291c89393a7a5198d0e8012b4cf128012c801f58e9db2dfd894539ea0e0",
    "d539a9910b32318bb520cfadbdf4fb7a0ce0060f8c1045b1bbfae559c92ba683",
]


def _load(path: pathlib.Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _same_tree(a, b, what: str) -> None:
    """Two port trees hold the same words (and the same Nones)."""
    la, ta = TCK._flatten(a)
    lb, tb = TCK._flatten(b)
    assert ta == tb, what
    for i, (x, y) in enumerate(zip(la, lb)):
        assert (x is None) == (y is None), (what, i)
        if x is not None:
            assert x.dtype == y.dtype and torch.equal(x.cpu(), y.cpu()), \
                (what, i)


def _zamba2_tree():
    """zamba2's SMOKE params shared on the CPU (a None segment, and the
    shared block's set)."""
    cfg = TCFGS.get("zamba2_7b").SMOKE
    eng = TEngine(tmake(RING64, seed=0, collapse=True, device="cpu"))
    return cfg, TM.params_to_engine(eng, TM.init_params(cfg, seed=0))


def _check_token_stream():
    for vocab in (128, 51865):
        for seed in (0, 5, 2**31 - 1):
            t, j = TD.TokenStream(vocab, seed), JD.TokenStream(vocab, seed)
            assert np.array_equal(t.next_tok, j.next_tok)
            for step, bsz, seq in ((0, 2, 8), (1, 3, 5), (53_021, 2, 64),
                                   (10**9 + 7, 1, 3)):
                got, want = t.batch(step, bsz, seq), j.batch(step, bsz, seq)
                for g, w in zip(got, want):
                    assert g.dtype == w.dtype == np.int32
                    assert np.array_equal(g, w), (vocab, seed, step)
                assert np.array_equal(got[0][:, 1:], got[1][:, :-1])


def _check_checkpoints_cross(tmp: str):
    """A zamba2 SMOKE share tree saved by either package is restored by
    the other; the manifests agree; host shards; RING32 words."""
    cfg, tree = _zamba2_tree()
    assert tree["segments"][1] is None and "shared_attn" in tree
    jcfg = jget("zamba2_7b").SMOKE
    jlike = JSP.param_specs(jcfg)
    jleaves, jdef = jax.tree_util.tree_flatten(jlike,
                                               is_leaf=lambda x: x is None)
    leaves, tdef = TCK._flatten(tree)
    assert tdef == str(jdef) and len(leaves) == len(jleaves)
    words = [None if x is None else words_to_numpy(x) for x in leaves]
    assert all(w is None or w.dtype == np.uint64 for w in words)

    tdir, jdir = os.path.join(tmp, "torch"), os.path.join(tmp, "jax")
    tpath = TCK.save(tdir, 3, tree, meta={"seed": 0})
    got, jman = JCK.restore(tpath, jlike)
    for w, g in zip(words, jax.tree_util.tree_leaves(
            got, is_leaf=lambda x: x is None)):
        assert (w is None and g is None) or (g.dtype == np.uint64
                                             and np.array_equal(w, g))
    jtree = jax.tree_util.tree_unflatten(jdef, words)
    jpath = JCK.save(jdir, 3, jtree, meta={"seed": 0})
    back, tman = TCK.restore(jpath, tree)
    _same_tree(TCK.rewrap(tree, back), tree, "the JAX checkpoint restored")
    assert isinstance(TCK.rewrap(tree, back)["embed"]["table"], TShare)
    for m in (jman, tman):
        m.pop("files")
    assert jman == tman
    assert TCK.latest(jdir) == jpath and JCK.latest(tdir) == tpath
    assert TCK.verify(jpath) and JCK.verify(tpath)

    # per-host shards: shard_1.npz, restored by either package at host 1
    hpath = TCK.save(os.path.join(tmp, "hosts"), 4, tree, host=1)
    assert sorted(os.listdir(hpath)) == ["manifest.json", "shard_1.npz"]
    _same_tree(TCK.rewrap(tree, TCK.restore(hpath, tree, host=1)[0]), tree,
               "host 1's shard")
    jgot, _ = JCK.restore(hpath, jlike, host=1)
    assert all(w is None or np.array_equal(w, g) for w, g in zip(
        words, jax.tree_util.tree_leaves(jgot, is_leaf=lambda x: x is None)))
    for restore, like in ((TCK.restore, tree), (JCK.restore, jlike)):
        with pytest.raises(FileNotFoundError):
            restore(hpath, like, host=0)

    # RING32 words go to disk as uint32, as the JAX package writes them
    w32 = {"w": TShare(torch.tensor([[-1, 2]] * 4, dtype=torch.int32)),
           "b": None, "f": np.arange(3.0)}
    p32 = TCK.save(os.path.join(tmp, "r32"), 0, w32)
    with np.load(os.path.join(p32, "shard_0.npz")) as f:
        assert f["leaf_2"].dtype == np.uint32 and f["leaf_1"].dtype == \
            np.float64 and "leaf_0" not in f
    back32 = TCK.rewrap(w32, TCK.restore(p32, w32)[0])
    assert torch.equal(back32["w"].data, w32["w"].data) and \
        back32["b"] is None and np.array_equal(back32["f"], w32["f"])
    assert RING32.dtype == torch.int32

    # reshard: the same verdicts and messages as the JAX package's
    for n_old, n_new in ((8, 4), (4, 8), (8, 8), (1, 5), (3, 2), (6, 4)):
        try:
            want = JCK.reshard(tree, n_old, n_new) is tree
        except ValueError as e:
            with pytest.raises(ValueError, match=str(e)):
                TCK.reshard(tree, n_old, n_new)
            continue
        assert want and TCK.reshard(tree, n_old, n_new) is tree


def test_launch_data_and_checkpoints_match_jax(tmp_path):
    """``TokenStream`` equals JAX's at any (seed, step, bsz, seq), the
    Python-int mixing of large steps included; a zamba2 SMOKE share tree
    (a None segment, ``shared_attn``) checkpointed by the port is restored
    by ``repro.train.checkpoint`` and the reverse (uint64 words, equal
    manifests, the treedef JAX prints); ``host=1`` writes and restores
    ``shard_1.npz`` in both packages; RING32 words as uint32;
    ``reshard``'s results and errors equal JAX's."""
    _check_token_stream()
    _check_checkpoints_cross(str(tmp_path))


def _check_specs():
    """param_specs == the real init for all 10 archs, in one loop; the
    caches of a prefill and a decode step == decode_cache_specs."""
    for arch in TCFGS.ARCHS:
        cfg = TCFGS.get(arch).SMOKE
        eng = TEngine(tmake(RING64, seed=0, device="cpu"))
        real = TM.params_to_engine(eng, TM.init_params(cfg, seed=0))
        spec = TSP.param_specs(cfg, RING64)
        (lr, dr), (ls, ds) = TCK._flatten(real), TCK._flatten(spec)
        assert dr == ds, arch
        for a, b in zip(lr, ls):
            assert (a is None) == (b is None), arch
            if a is not None:
                assert b.device.type == "meta", arch
                assert tuple(a.shape) == tuple(b.shape) and \
                    a.dtype == b.dtype, (arch, a.shape, b.shape)
        assert TSP.tree_bytes(real) == TSP.tree_bytes(spec), arch
    rs = np.random.RandomState(0)
    for arch in ("whisper_tiny", "xlstm_350m", "zamba2_7b"):
        cfg = TCFGS.get(arch).SMOKE
        eng = TEngine(tmake(RING64, seed=0, collapse=True, device="cpu"))
        params = TM.params_to_engine(eng, TM.init_params(cfg, seed=0))
        B, S = 2, 8
        ids = rs.randint(0, cfg.vocab, (B, S))
        kw = {}
        if cfg.family == "encdec":
            kw["enc_inputs"] = eng.from_plain(
                rs.randn(B, cfg.frontend_tokens, cfg.d_model))
        prefill = TST.make_prefill_step(cfg, collapse=True, device="cpu")
        logits, caches, abort = prefill(params, ids, **kw)
        again = prefill(params, ids, **kw)
        assert not abort and torch.equal(logits.data, again[0].data), arch
        decode = TST.make_decode_step(cfg, collapse=True, pos=S,
                                      device="cpu")
        _, new_caches, abort = decode(params, ids[:, -1:], caches)
        assert not abort, arch
        for got, positions in ((caches, S), (new_caches, S + 1)):
            want = TSP.decode_cache_specs(cfg, B, positions)
            (lg, dg), (lw, dw) = TCK._flatten(got), TCK._flatten(want)
            assert dg == dw, (arch, dg, dw)
            assert [tuple(x.shape) for x in lg] == \
                [tuple(x.shape) for x in lw], arch
        args = TSP.input_specs(cfg, "train_4k", dims=(S, B, "train"))
        assert sorted(args) == sorted(["ids", "labels"] + list(kw))
        assert tuple(args["ids"].shape) == (B, S)
    mesh = TMESH.make_mesh("cpu")
    assert (mesh.size, TMESH.data_axes(mesh), TMESH.model_axis(mesh)) == \
        (1, ("data",), "model")


def _check_roofline():
    class Cfg:
        d_model, d_ff, vocab, n_layers = 1024, 4096, 32000, 16
        n_heads, n_kv_heads, dh = 16, 16, 64
        n_experts, top_k, act, family = 0, 0, "swiglu", "dense"
    assert TRL.active_params(Cfg) == JRL.active_params(Cfg)
    for kind in ("train", "prefill", "decode"):
        assert TRL.model_flops(Cfg, 256, 4096, kind) == \
            JRL.model_flops(Cfg, 256, 4096, kind)
    for arch in TCFGS.ARCHS:
        assert TRL.active_params(TCFGS.get(arch).CONFIG) == \
            JRL.active_params(jget(arch).CONFIG), arch
    m = {"devices": 1, "collapse": True,
         "mem": {"argument_size_bytes": 6e12, "output_size_bytes": 7e11}}
    t = TRL.roofline_terms(m, Cfg, 256, 4096, "train")
    mf = 6.0 * TRL.active_params(Cfg) * 256 * 4096
    assert t["model_flops"] == mf and t["ring_macs"] == mf / 2 * 4
    assert t["t_compute_limb"] == pytest.approx(mf / 2 * 4 * 36 * 2
                                                / 1979e12)
    assert t["t_memory"] == pytest.approx(6.7e12 / 3.35e12)
    assert t["t_collective"] == 0.0 and t["t_compute"] is None
    assert t["bottleneck"] == "t_compute_limb"
    faithful = TRL.roofline_terms(dict(m, collapse=False), Cfg, 256, 4096,
                                  "train")
    assert faithful["t_compute_limb"] == pytest.approx(
        4 * t["t_compute_limb"])
    small = TRL.roofline_terms(m, Cfg, 1, 1, "decode")
    assert small["bottleneck"] == "t_memory"


def _check_dryrun_tools(tmp: str, monkeypatch):
    """dryrun --all with no card, the sweep, the hill-climb, the report
    and the assembled document."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = os.path.join(tmp, "dryrun.json")
    res = TDR.main(["--all", "--out", out])
    with open(out) as f:
        assert json.load(f) == json.loads(json.dumps(res))
    assert [(r["arch"], r["shape"]) for r in res] == \
        [(a, s) for a, s, _ in TCFGS.cells()] and len(res) == 40
    sized = [r for r in res if "mem" in r]
    assert len(sized) == 33 and all("error" not in r for r in res)
    assert {(r["arch"], r["shape"]) for r in res if "skipped" in r} == {
        (a, "long_500k") for a in TCFGS.ARCHS
        if a not in TCFGS.LONG_CONTEXT_ARCHS}
    for r in sized:
        for k in TDR.COMPILER_ONLY:
            assert r[k] is None, (r["arch"], k)
        mem = r["mem"]
        assert mem["temp_size_bytes"] is None and \
            mem["generated_code_size_bytes"] is None
        assert mem["argument_size_bytes"] == mem["param_bytes"] + \
            mem["input_bytes"] > 0
        assert r["fits"] == (mem["argument_size_bytes"]
                             + mem["output_size_bytes"] <= 80e9)
    cell = next(r for r in sized if (r["arch"], r["shape"]) ==
                ("whisper_tiny", "train_4k"))
    cfg = TCFGS.get("whisper_tiny").CONFIG
    jleaves = jax.tree_util.tree_leaves(JSP.param_specs(jget(
        "whisper_tiny").CONFIG))
    assert cell["mem"]["param_bytes"] == 8 * sum(
        int(np.prod(x.shape)) for x in jleaves)
    assert cell["mem"]["input_bytes"] == 2 * 4 * 256 * 4096 + \
        32 * 256 * cfg.frontend_tokens * cfg.d_model
    table = TREP.report(res)
    assert "33 cells sized, 0 failed, 7 skipped" in table
    assert sum(ln.startswith("| ") for ln in table.splitlines()) == 41
    assert "| - |" in table
    sweep_out = os.path.join(tmp, "sweep.json")
    swept = TSW.main(["--out", sweep_out])
    assert len(swept) == len(TSW.cell_list()) == 33
    assert TSW.main(["--out", sweep_out]) == swept       # resumes: no rerun
    perf = THC.main(["--out", os.path.join(tmp, "perf.json")])
    c0, c1 = perf["C0_fsdp"], perf["C1_nofsdp"]
    assert (c0["fsdp"], c1["fsdp"]) == (True, False)
    assert c0["mem"] == c1["mem"] and c0["fsdp_effect"] == "none on one card"
    assert perf["B1_ring32"]["mem"]["param_bytes"] * 2 == \
        perf["B0_ring64"]["mem"]["param_bytes"]
    doc = TAS.assemble(res, perf, f"# E\n\n{TAS.REPORT_PLACEHOLDER}\n\n"
                       f"{TAS.PERF_PLACEHOLDER}\n")
    assert TAS.REPORT_PLACEHOLDER not in doc and "C1_nofsdp" in doc
    assert "whisper_tiny | train_4k" in doc and "B0→B1" in doc


def test_launch_specs_dryrun_and_report(tmp_path, monkeypatch):
    """``specs.param_specs`` equals the port's real ``params_to_engine(
    init_params(SMOKE))`` leaf for leaf for all 10 archs (meta tensors),
    and ``decode_cache_specs`` the caches of ``steps``' prefill and decode
    closures (whisper, xlstm, zamba2); the one-card mesh; the roofline
    terms on a fixed record (H100 rates, 36 limb pairs, 4 or 16 products a
    secure MAC; ``model_flops``/``active_params`` equal JAX's); ``dryrun
    --all`` with no card (40 cells, the compiler's keys None), the sweep,
    the hill-climb's C0/C1 (fsdp recorded, no effect), ``report`` and
    ``assemble`` rendering the JSON."""
    _check_specs()
    _check_roofline()
    _check_dryrun_tools(str(tmp_path), monkeypatch)


def _shares(tree) -> list:
    out = []
    TM.tree_map(out.append, tree)
    return out


def _update_lambdas(before, after) -> list:
    """The lambda words (every component but m) of each leaf's update
    w - w' of the launcher's SGD step; a segment leaf is (n, 4, ...)."""
    out = []
    for key in sorted(before):
        for x, y in zip(_shares(before[key]), _shares(after[key])):
            t = x.data - y.data
            out.append(t[:, 1:] if key == "segments" else t[1:])
    return out


def test_launch_train_matches_jax_digests(tmp_path, monkeypatch):
    """The launcher (``repro_torch.launch.train``) at whisper SMOKE on the
    CPU: steps 0 and 1 equal the JAX package's ``train_step`` under each
    step's seed (``LAUNCH_DIGESTS``); a run crashed after step 1's
    checkpoint and resumed ends with the uninterrupted run's words; an
    abort restores step 1's checkpoint as shares (F8); step 1's lambda
    words differ from step 0's (F7); ``--no-smoke``; no card and no
    ``--device cpu``: refused."""
    vs = _load(ROOT / "tools" / "torch_lm_vs_jax.py", "torch_lm_vs_jax")
    steps = 4
    full, runs = vs.run_port_launch(str(tmp_path / "full"), steps)
    assert [vs.train_digest(r) for r in runs[:2]] == LAUNCH_DIGESTS, \
        "the launcher's steps differ from the JAX package's words"
    tr = full.trainer
    assert tr.events == ["ckpt@1", "ckpt@3"] and len(tr.losses) == steps
    assert full.totals() == TLT._sum_totals([r[2] for r in runs])
    assert not any(r[3] for r in runs)
    init = TLT.build(TLT.parse_args(vs.launch_argv(
        str(tmp_path / "unused"), steps) + ["--device", "cpu"])).trainer.params
    u0 = _update_lambdas(init, runs[0][0])
    u1 = _update_lambdas(runs[0][0], runs[1][0])
    assert len(u0) == len(u1) > 10
    assert not any(torch.equal(a, b) for a, b in zip(u0, u1)), \
        "step 1 reuses step 0's masks"

    ckpt = str(tmp_path / "crash")
    crashed, _ = vs.run_port_launch(ckpt, steps, crash_at=2)
    assert crashed.trainer.events == ["ckpt@1", "crash@2"]
    resumed, _ = vs.run_port_launch(ckpt, steps)
    assert resumed.trainer.events == ["resumed@2", "ckpt@3"]
    _same_tree(resumed.trainer.params, tr.params, "resumed run")
    assert resumed.trainer.losses == tr.losses[2:]
    assert TCK.verify(TCK.latest(ckpt)) and TCK.latest(ckpt).endswith(
        "step_00000003")

    # F8: an abort at step 2 restores step 1's checkpoint as shares
    ab = TLT.build(TLT.parse_args(vs.launch_argv(str(tmp_path / "abort"),
                                                 steps) + ["--device",
                                                           "cpu"]))
    inner, seen = ab.trainer.step_fn, []

    def abort_once(params, step, *batch):
        seen.append((step, params))
        new, loss, abort = inner(params, step, *batch)
        return new, loss, abort or (step == 2 and len(seen) == 3)

    ab.trainer.step_fn = abort_once
    ab.trainer.run()
    assert ab.trainer.events == ["ckpt@1", "abort@2", "ckpt@3"]
    step, restored = seen[3]
    assert step == 2
    assert all(isinstance(x, TShare) and x.dtype == torch.int64
               for x in _shares(restored))
    _same_tree(restored, seen[2][1], "the abort path's restored params")
    _same_tree(ab.trainer.params, tr.params, "the run after the abort")

    assert TLT.parse_args(["--arch", "x"]).smoke is True
    assert TLT.parse_args(["--arch", "x", "--no-smoke"]).smoke is False
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TLT.build(TLT.parse_args(["--arch", "whisper-tiny"]))
