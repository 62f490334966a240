"""Offline preprocessing walkthrough on the port: dealer -> PrepStore ->
online-only executor -> pipelined serving.

Trident's offline-online paradigm, end to end:

  1. the DEALER walks the inference program's data-independent half ahead
     of time (only shapes needed -- zeros stand in for the inputs) and
     serializes per-party PrepStore material to disk;
  2. the ONLINE-ONLY executor later runs the same program from the store:
     the transport forbids offline-phase traffic (zero offline bytes,
     enforced), and the predictions are bit-identical to the interleaved
     path;
  3. the PIPELINED mode overlaps the two: a background dealer streams one
     store per batch into a bounded queue while batches execute
     online-only -- preprocessing leaves the serving critical path.

    PYTHONPATH=src python examples_torch/secure_inference_offline.py \
        [--device cpu]

Dealer and consumer run on the card (``--device cuda``, the default;
refused without one) or on the CPU.
"""
import argparse
import shutil
import tempfile

import numpy as np

from repro_torch.core.context import resolve_device
from repro_torch.core.ring import RING64
from repro_torch.offline import PrepStore, deal, run_online
from repro_torch.runtime import FourPartyRuntime
from repro_torch.runtime import activations as RA
from repro_torch.runtime import protocols as RT
from repro_torch.serve.party_server import PartyPredictionServer

SEED = 11
rng = np.random.RandomState(0)
W1 = rng.randn(6, 4) * 0.4
W2 = rng.randn(4, 2) * 0.4
X = rng.randn(3, 6)
QUERIES = rng.randn(6, 6)


def predict(rt, Xb):
    """share -> linear+trunc -> relu -> linear+trunc -> sigmoid -> open."""
    xs = RT.share(rt, rt.encode(Xb))
    w1 = RT.share(rt, rt.encode(W1))
    w2 = RT.share(rt, rt.encode(W2))
    h = RA.relu(rt, RT.matmul_tr(rt, xs, w1))
    out = RA.sigmoid(rt, RT.matmul_tr(rt, h, w2))
    return RING64.decode(RT.reconstruct(rt, out)[1])


def program(rt):
    return predict(rt, X)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (refused without a card) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(None if args.device == "cuda" else args.device)

    # -- reference: the classic interleaved run --------------------------
    rt = FourPartyRuntime(RING64, seed=SEED, device=device)
    want = program(rt).cpu()
    totals = rt.transport.totals()
    print(f"interleaved : offline {totals['offline']}, "
          f"online {totals['online']}")

    # -- 1. deal ahead of time (shapes only) and serialize ---------------
    store, drep = deal(lambda r: predict(r, np.zeros_like(X)),
                       ring=RING64, seed=SEED, device=device)
    prep_dir = tempfile.mkdtemp(prefix="prepstore-")
    try:
        store.save(prep_dir)
        print(f"dealer      : {drep.entries} entries, "
              f"{drep.offline_bits} offline bits in {drep.offline_rounds} "
              f"rounds -> {prep_dir}")
        print(f"              per-kind: {drep.summary}")

        # -- 2. online-only execution from the serialized store ----------
        got, orep = run_online(program, PrepStore.load(prep_dir),
                               ring=RING64, device=device)
    finally:
        shutil.rmtree(prep_dir, ignore_errors=True)
    print(f"online-only : {orep.online_bits} online bits in "
          f"{orep.online_rounds} rounds, {orep.offline_bits} offline bits "
          f"(transport-enforced)")
    assert np.array_equal(got.cpu().numpy(), want.numpy()), \
        "split changed the bits!"
    assert orep.offline_bits == 0 and not orep.abort
    print("              predictions bit-identical to interleaved  [ok]")

    # -- 3. pipelined serving: background dealer + online-only batches ---
    srv = PartyPredictionServer(predict, batch_size=3, seed=SEED,
                                prep="pipelined", device=device)
    try:
        for q in QUERIES:
            srv.submit(q)
        srv.flush()
        rep = srv.report()
    finally:
        srv.close()
    print(f"pipelined   : {rep['batches']} batches, "
          f"online-only {rep['online_only_ms_per_batch']:.1f} ms/batch "
          f"(offline dealt in background: "
          f"{rep['offline_deal_s_per_batch']*1e3:.1f} ms/batch), "
          f"offline bytes on the serving path: "
          f"{rep['offline_bits_per_batch']:.0f}")
    assert rep["offline_bits_per_batch"] == 0 and not rep["aborted"]
    print("malicious checks passed:", not rep["aborted"])
    print("\nOffline material provisioned ahead -> the online phase is a "
          "standalone, measurable wall-clock.")
    return {"want": want, "report": rep}


if __name__ == "__main__":
    main()
