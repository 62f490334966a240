"""Open-ended secure SGD with LIVE prep streaming into running daemons, on
the port.

A ``PartyCluster`` starts with an EMPTY bank and a ``DealerDaemon`` -- a
separate OS process wrapping ``ContinuousDealer`` -- streams session t's
offline material over the cluster's per-rank control queues while step
t-1 runs online:

    dealer process ──(control queue, mp)──> party daemon's LivePrepBank
                                                  │  (watermark, bounded
                                                  │   look-ahead)
    driver ──submit(prep="live", session=t)──> task blocks until session
                                               t arrives, then runs
                                               ONLINE-ONLY on the mesh

The TCP mesh never carries an offline byte (transport-enforced: offline
sends raise during the task), and the (params, loss) trajectory is
bit-identical to the joint simulation from the same step-indexed seeds.
The dealer keeps ``DEFAULT_LIVE_AHEAD`` = 2 sessions ahead (ROADMAP D2).

    PYTHONPATH=src python examples_torch/secure_training_live_prep.py \
        [--device cpu]

Every process runs on the card (``--device cuda``, the default; refused
without one) or on the CPU.  The daemons import this file by name
(spawn): its top level is definitions.
"""
import argparse
import time

import numpy as np

from repro_torch.core.context import resolve_device
from repro_torch.runtime.net.cluster import PartyCluster
from repro_torch.train import data as D
from repro_torch.train import secure_sgd as SGD

SEED = 17
STEPS = 4
BATCH = 8

task = SGD.logreg_task(features=6, lr=0.5)
data = D.RegressionData(features=6, n=256, seed=1, logistic=True)
params0 = task.init_params(seed=0)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (refused without a card) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(None if args.device == "cuda" else args.device)

    print(f"live-streamed secure logreg SGD, {STEPS} steps, batch {BATCH} "
          f"(step seeds {SEED}+t)\n")

    # reference: the joint simulation, step-indexed seeds
    p_joint, l_joint = dict(params0), []
    for step in range(STEPS):
        p_joint, loss, _ = SGD.run_step(task, p_joint,
                                        data.batch(step, BATCH), step=step,
                                        base_seed=SEED, world="joint",
                                        device=device)
        l_joint.append(loss)
    print(f"[joint sim]     losses {['%.6f' % l for l in l_joint]}")

    t0 = time.time()
    with PartyCluster(live_prep=True, device=str(device)) as cluster:
        # the daemons are up, their banks EMPTY -- now attach the dealer
        # (total=None would stream for as long as training runs)
        with SGD.attach_live_dealer(cluster, task, params0,
                                    data.batch(0, BATCH), base_seed=SEED,
                                    total=STEPS) as dealer:
            sgd = SGD.ClusterSGD(cluster, task, base_seed=SEED,
                                 prep="live", dealer=dealer)
            p_live, l_live = dict(params0), []
            for step in range(STEPS):
                p_live, loss, abort = sgd.step_fn(p_live, step,
                                                  *data.batch(step, BATCH))
                assert not abort
                l_live.append(loss)
                wall = max(r.wall_s for r in sgd.results[-1])
                print(f"[live 4-proc]   step {step}: loss {loss:.6f} "
                      f"online {wall*1e3:6.1f} ms "
                      f"(dealer watermark {dealer.dealt})")
            offline_bits = sgd.offline_bits_on_mesh()
    wall = time.time() - t0

    assert l_live == l_joint
    for k in p_joint:
        assert np.array_equal(np.asarray(p_joint[k]),
                              np.asarray(p_live[k]))
    assert offline_bits == 0
    print(f"\nbank started EMPTY; all {STEPS} sessions streamed over the "
          "control channel;")
    print(f"offline bits on the TCP mesh: {offline_bits} "
          "(transport-enforced)")
    print(f"trajectory BIT-IDENTICAL to the joint simulation "
          f"(cluster wall {wall:.1f}s)")
    print("malicious checks passed: True")
    return {"params": p_joint, "losses": l_joint}


if __name__ == "__main__":
    main()
