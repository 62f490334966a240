"""Secure SGD training across four OS processes, with per-step prep, on
the port.

The SAME engine-generic training step (``paper_ml.logreg_step`` driven by
``train.secure_sgd.SGDTask``) runs three ways --

  1. TridentEngine: the joint simulation (newton nonlinearities),
  2. RuntimeEngine over the in-memory LocalTransport,
  3. RuntimeEngine inside four OS processes over the TCP mesh
     (``PartyCluster``), first interleaved, then PREP-AHEAD: a PrepBank
     with one session per training step is dealt up front and the daemons
     load it at startup, so every step executes online-only -- the mesh
     carries ZERO offline bytes, transport-enforced --

and the script checks the (params, loss) trajectories are *bit-identical*
across all paths, step by step, from the same step-indexed seeds.

    PYTHONPATH=src python examples_torch/secure_training_parties.py \
        [--device cpu]

Every world runs on the card (``--device cuda``, the default; refused
without one) or on the CPU.  The daemons import this file by name
(spawn): its top level is definitions.
"""
import argparse
import shutil
import tempfile
import time

import numpy as np

from repro_torch.core.context import resolve_device
from repro_torch.runtime.net.cluster import PartyCluster
from repro_torch.train import data as D
from repro_torch.train import secure_sgd as SGD

SEED = 17
STEPS = 3
BATCH = 8

task = SGD.logreg_task(features=6, lr=0.5)
data = D.RegressionData(features=6, n=256, seed=1, logistic=True)
params0 = task.init_params(seed=0)


def trajectory(step_fn):
    params, losses = dict(params0), []
    for step in range(STEPS):
        params, loss, abort = step_fn(params, step, *data.batch(step, BATCH))
        assert not abort
        losses.append(loss)
    return params, losses


def world_step(world, device):
    def step_fn(params, step, *batch):
        return SGD.run_step(task, params, batch, step=step,
                            base_seed=SEED, world=world, device=device)
    return step_fn


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (refused without a card) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(None if args.device == "cuda" else args.device)

    print(f"secure logreg SGD, {STEPS} steps, batch {BATCH} "
          f"(step seeds {SEED}+t)\n")
    p_joint, l_joint = trajectory(world_step("joint", device))
    print(f"[joint sim]        losses {['%.6f' % l for l in l_joint]}")
    p_local, l_local = trajectory(world_step("runtime", device))
    print(f"[runtime local]    losses {['%.6f' % l for l in l_local]}")

    # per-step prep: session t of the bank IS step t's offline material
    bank_dir = tempfile.mkdtemp(prefix="trident_train_bank_")
    try:
        _, reports = SGD.deal_training_bank(task, params0,
                                            data.batch(0, BATCH), STEPS,
                                            base_seed=SEED, path=bank_dir,
                                            device=device)
        print(f"[dealer]           {STEPS} sessions, "
              f"{reports[0].entries} entries/step -> {bank_dir}")

        t0 = time.time()
        with PartyCluster(prep_path=bank_dir, device=str(device)) as cluster:
            p_sock, l_sock = trajectory(
                SGD.ClusterSGD(cluster, task, base_seed=SEED))
            print(f"[4-proc sockets]   losses "
                  f"{['%.6f' % l for l in l_sock]}")
            prep_sgd = SGD.ClusterSGD(cluster, task, base_seed=SEED,
                                      prep="bank")
            p_prep, l_prep = trajectory(prep_sgd)
            print(f"[4-proc prep-ahead] losses "
                  f"{['%.6f' % l for l in l_prep]} (offline bits on mesh: "
                  f"{prep_sgd.offline_bits_on_mesh()})")
            assert prep_sgd.offline_bits_on_mesh() == 0
        wall = time.time() - t0
    finally:
        shutil.rmtree(bank_dir, ignore_errors=True)

    for other in (p_local, p_sock, p_prep):
        for k in p_joint:
            assert np.array_equal(np.asarray(p_joint[k]),
                                  np.asarray(other[k]))
    assert l_joint == l_local == l_sock == l_prep
    print(f"\nall four trajectories BIT-IDENTICAL "
          f"(cluster wall {wall:.1f}s)")
    print("malicious checks passed: True")
    return {"params": p_joint, "losses": l_joint}


if __name__ == "__main__":
    main()
