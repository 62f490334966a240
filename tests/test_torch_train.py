"""The port's secure training (``repro_torch.train``, ``nn.runtime_engine``,
``offline.continuous``) against the JAX package's on the CPU at a small
width: ``RuntimeEngine``'s whole op surface (and linear regression's
step) against the port's joint engine; the NN and logistic-regression
steps on the port's party runtime bit-equal to
``repro.train.secure_sgd.run_step(world="joint")``, and the port's joint
world on the same trajectory, each world with the ``totals()`` of the
same world in the JAX package; prep-ahead steps online-only from a
``ContinuousDealer`` and from a bank dealt ahead, with no offline bit;
checkpoints crossing between the packages both ways; and a crashed and
resumed ``Trainer`` ending where an uninterrupted run ends.  One test
item, so the collected count stays where the tier-1 split of the slow
tests needs it."""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small shapes: one intra-op thread, so idle torch threads do not spin
# beside the JAX tests that share this worker
torch.set_num_threads(1)

from repro.train import checkpoint as JCK  # noqa: E402
from repro.train import data as JD  # noqa: E402
from repro.train import paper_ml as JML  # noqa: E402
from repro.train import secure_sgd as JS  # noqa: E402
from repro_torch.core.context import make_context  # noqa: E402
from repro_torch.core.ring import RING64  # noqa: E402
from repro_torch.nn.engine import TridentEngine  # noqa: E402
from repro_torch.nn.runtime_engine import RuntimeEngine  # noqa: E402
from repro_torch.offline import (ContinuousDealer, PrepError,  # noqa: E402
                                 PrepReplayError, run_online)
from repro_torch.runtime import FourPartyRuntime  # noqa: E402
from repro_torch.runtime import protocols as TRT  # noqa: E402
from repro_torch.train import checkpoint as TCK  # noqa: E402
from repro_torch.train import data as TD  # noqa: E402
from repro_torch.train import paper_ml as TML  # noqa: E402
from repro_torch.train import secure_sgd as TS  # noqa: E402
from repro_torch.train.trainer import (Trainer, TrainerConfig,  # noqa: E402
                                       seed_for_step)

SEED = 11
BATCH = 8
STEPS = 2


def _same_params(a: dict, b: dict, where: str) -> None:
    assert sorted(a) == sorted(b), where
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype == np.float64, (where, k)
        assert np.array_equal(x, y), f"{where}: params[{k!r}] differ"


def _trajectory(jtask, ttask, batches):
    """The JAX package's joint world against the port's runtime ("hopper"
    backend, its plain versions on the CPU) and the port's joint world,
    step by step: equal params and losses.  Each world's totals() against
    the same world's in the JAX package (the joint engine opens its
    results untallied, the runtime's openings are measured).  Returns the
    port's runtime trajectory, (params, loss, totals()) a step."""
    params = jtask.init_params(seed=0)
    _same_params(params, ttask.init_params(seed=0), "init_params")
    out = []
    for step, batch in enumerate(batches):
        seed = seed_for_step(SEED, step)
        where = f"{ttask.kind} step {step}"
        engines = {"JAX joint": (jtask, JS.make_engine("joint", seed)),
                   "JAX runtime": (jtask, JS.make_engine("runtime", seed)),
                   "runtime": (ttask, TS.make_engine("runtime", seed,
                                                     device="cpu")),
                   "joint": (ttask, TS.make_engine("joint", seed,
                                                   device="cpu"))}
        runs = {name: task.run(eng, params, batch)
                for name, (task, eng) in engines.items()}
        want, loss, _ = runs["JAX joint"]
        for name, (got, got_loss, abort) in runs.items():
            _same_params(want, got, f"{where}, {name}")
            assert got_loss == loss and np.isfinite(loss), (where, name)
            assert bool(abort) is False, (where, name)
        totals = engines["runtime"][1].rt.transport.totals()
        assert totals == engines["JAX runtime"][1].rt.transport.totals(), \
            where
        assert engines["joint"][1].ctx.tally.totals() \
            == engines["JAX joint"][1].ctx.tally.totals(), where
        params = runs["runtime"][0]
        out.append((params, runs["runtime"][1], totals))
    return out


def _check_checkpoints_cross(params, tmp):
    """A checkpoint of the NN's params written by either package is
    restored by the other, with equal manifests but for the checksums."""
    jdir, tdir = os.path.join(tmp, "jax"), os.path.join(tmp, "torch")
    like = {k: np.zeros_like(v) for k, v in params.items()}
    jpath = JCK.save(jdir, 3, params, meta={"seed": SEED})
    tpath = TCK.save(tdir, 3, params, meta={"seed": SEED})
    assert os.path.basename(jpath) == os.path.basename(tpath)
    assert TCK.latest(jdir) == jpath and JCK.latest(tdir) == tpath
    got, tman = TCK.restore(jpath, like)
    _same_params(got, params, "the JAX checkpoint restored by the port")
    back, jman = JCK.restore(tpath, like)
    _same_params(back, params, "the port's checkpoint restored by JAX")
    for m in (tman, jman):
        m.pop("files")
    assert tman == jman
    with open(os.path.join(tpath, "manifest.json")) as f:
        assert json.load(f)["treedef"] == jman["treedef"]


def _check_engine_surface():
    """Every op of ``RuntimeEngine`` -- the shared surface, each activation
    with its backward half, zeros -- against the port's ``TridentEngine``
    (newton) on one seed: the same words in every component and the same
    totals() (that engine is held to the JAX package's by
    tests/test_torch_joint.py)."""
    rng = np.random.RandomState(3)
    a, b = rng.randn(2, 3, 4), rng.randn(2, 3, 4)
    ids, table = np.array([[2, 0], [1, 1]]), rng.randn(3, 4)
    dy, mask = rng.randn(2, 2, 4), np.array([1, 0, 1, 1])

    def program(eng):
        x, y, t = (eng.from_plain(v) for v in (a, b, table))
        outs = [eng.reshape(x, (6, 4)), eng.transpose(x, (2, 0, 1)),
                eng.concat([x, y], axis=1), *eng.split(x, (1, 2), axis=1),
                eng.take(x, ids, axis=1),
                eng.pad_zeros(x, ((0, 1), (2, 0), (0, 0))),
                eng.sum(x, axis=-1, keepdims=True), eng.mean(x, axis=1),
                eng.stack_to_new_axis([x, y], axis=1), eng.embed(t, ids),
                eng.embed_bwd(t, ids, eng.from_plain(dy)),
                eng.scale(x, 4.0), eng.scale(x, -2.0), eng.scale(x, 0.3),
                eng.mul_public(x, b), eng.add_public(x, b),
                eng.lincomb_public([(x, 0.5), (y, -1.25)]),
                eng.mask_public(x, (b > 0).astype(np.int64)),
                eng.zeros((2, 3))]
        pos = eng.from_plain(np.abs(b) + 0.5)
        r, rc = eng.relu(x)
        s, sc = eng.sigmoid(x)
        p, pc = eng.softmax(x, axis=-1, mask=mask)
        u, uc = eng.silu(x)
        return outs + [
            r, eng.relu_bwd(rc, y), s, eng.sigmoid_bwd(sc, y), p,
            eng.softmax_bwd(pc, y, mask=mask), u, eng.silu_bwd(uc, y),
            eng.square(x)[0], eng.rsqrt(pos)[0], eng.reciprocal(pos),
            eng.mul(x, y),
            eng.matmul(eng.reshape(x, (6, 4)), eng.transpose(t, (1, 0)))]

    te = TridentEngine(make_context(RING64, seed=SEED, device="cpu"),
                       nonlinear="newton")
    re = RuntimeEngine(FourPartyRuntime(RING64, seed=SEED, device="cpu"))
    for i, (j, r) in enumerate(zip(program(te), program(re))):
        assert torch.equal(r.to_joint().data, j.data), f"op {i}"
    assert re.rt.transport.totals() == te.ctx.tally.totals()
    assert torch.equal(re.declassify(r), te.declassify(j))
    assert torch.equal(re.reveal(r), te.reveal(j))
    # linear regression's step and the regression predictions, runtime
    # against the joint world
    task = TS.SGDTask(kind="linreg", lr=0.25, features=6)
    batch = TD.RegressionData(features=6, n=64, seed=5).batch(0, BATCH)
    got = [TS.run_step(task, task.init_params(seed=1), batch, step=0,
                       base_seed=SEED, world=world, device="cpu")
           for world in ("runtime", "joint")]
    _same_params(got[0][0], got[1][0], "linreg step")
    assert got[0][1] == got[1][1] and not got[0][2]
    preds = []
    for eng in (TS.make_engine("runtime", SEED, device="cpu"),
                TS.make_engine("joint", SEED, device="cpu")):
        w = {"w": eng.from_plain(got[0][0]["w"])}
        X = eng.from_plain(batch[0])
        preds.append([eng.reveal(TML.reg_predict(eng, w, X, logistic=lg))
                      for lg in (False, True)])
    assert all(torch.equal(a, b) for a, b in zip(*preds))


def test_training_matches_jax(tmp_path):
    _check_engine_surface()

    # the NN, 12-8-4 on 4 classes
    jnet, tnet = JML.MLPNet(12, (8, 4)), TML.MLPNet(12, (8, 4))
    jtask, ttask = JS.nn_task(jnet, lr=0.5), TS.nn_task(tnet, lr=0.5)
    jdata = JD.MNISTLike(n=256, seed=3, features=12, classes=4)
    tdata = TD.MNISTLike(n=256, seed=3, features=12, classes=4)
    batches = []
    for step in range(STEPS):
        b = tdata.batch(step, BATCH)
        for x, y in zip(b, jdata.batch(step, BATCH)):
            assert np.array_equal(x, y)
        batches.append(b[:2])
    nn = _trajectory(jtask, ttask, batches)

    # logistic regression, 6 features
    jd = JD.RegressionData(features=6, n=256, seed=1, logistic=True)
    td = TD.RegressionData(features=6, n=256, seed=1, logistic=True)
    lbatches = [td.batch(s, BATCH) for s in range(STEPS)]
    for s, b in enumerate(lbatches):
        assert all(np.array_equal(x, y) for x, y in zip(b, jd.batch(s, BATCH)))
    _trajectory(JS.logreg_task(features=6, lr=0.5),
                TS.logreg_task(features=6, lr=0.5), lbatches)

    # prep-ahead: each step online-only from the dealer's session
    params = ttask.init_params(seed=0)
    deal_prog = TS.deal_step_program(ttask, params, batches[0])
    with ContinuousDealer(lambda s: deal_prog, base_seed=SEED, ahead=2,
                          total=STEPS, device="cpu") as dealer:
        sgd = TS.PrepAheadSGD(ttask, dealer, device="cpu")
        po = params
        for step, b in enumerate(batches):
            po, lo, ab = sgd.step_fn(po, step, *b)
            _same_params(po, nn[step][0], f"prep-ahead step {step}")
            assert lo == nn[step][1] and ab is False
            rep = sgd.reports[-1]
            assert rep.offline_bits == 0 and rep.online_bits > 0
    # the deals moved the inline steps' offline traffic, the online runs
    # their online traffic
    assert len(dealer.reports) == STEPS
    for step, (drep, orep) in enumerate(zip(dealer.reports, sgd.reports)):
        totals = nn[step][2]
        assert (drep.offline_rounds, drep.offline_bits) == (
            totals["offline"]["rounds"], totals["offline"]["bits"]), step
        assert (orep.online_rounds, orep.online_bits) == (
            totals["online"]["rounds"], totals["online"]["bits"]), step

    # the dealer's consumer side: in order, exhausted, a replay refused
    def tiny(rt):
        x = TRT.share(rt, rt.encode(np.ones(3)))
        TRT.mult_tr(rt, x, x)

    with ContinuousDealer(lambda s: tiny, base_seed=SEED, ahead=1, total=3,
                          device="cpu") as dealer:
        assert dealer.next_store().meta["step"] == 0
        assert dealer.store_for_step(2).meta["step"] == 2   # skips 1
        with pytest.raises(PrepReplayError, match="already consumed"):
            dealer.store_for_step(1)
        with pytest.raises(PrepError, match="finished after 3"):
            dealer.next_store(timeout=5.0)

    # a bank dealt ahead of the run (and saved), each session run
    # online-only: the same trajectory
    bank, _ = TS.deal_training_bank(ttask, params, batches[0], STEPS,
                                    base_seed=SEED,
                                    path=str(tmp_path / "bank"),
                                    device="cpu")
    po = params
    for step, b in enumerate(batches):
        (po, lo, ab), rep = run_online(
            TS.step_program(ttask, po, b), bank.next(), device="cpu")
        _same_params(po, nn[step][0], f"banked step {step}")
        assert lo == nn[step][1] and ab is False and rep.offline_bits == 0

    _check_checkpoints_cross(nn[-1][0], str(tmp_path))

    # the Trainer: a crash at step 1 after step 0's checkpoint, then a
    # resume that replays step 1 from its step-indexed seed
    def step_fn(p, step, *b):
        return TS.run_step(ttask, p, b, step=step, base_seed=SEED,
                           world="runtime", device="cpu")

    cfg = TrainerConfig(steps=STEPS, ckpt_dir=str(tmp_path / "ckpt"),
                        ckpt_every=1, seed=SEED)
    trainer = Trainer(cfg, step_fn, params, lambda s: batches[s])
    with pytest.raises(RuntimeError, match="injected crash at step 1"):
        trainer.run(crash_at=1)
    resumed = Trainer(cfg, step_fn, params, lambda s: batches[s])
    final = resumed.run()
    assert trainer.events == ["ckpt@0", "crash@1"]
    assert resumed.events == ["resumed@1", "ckpt@1"]
    _same_params(final, nn[-1][0], "the resumed Trainer")
    assert resumed.losses == [nn[-1][1]]
