#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

from the root of a checkout.  In order, it

  1. prints the card's name and power limit (nvidia-smi), then runs
     tridentlint over the shipped port (phase "lint": every rule of
     ``repro_torch.analysis`` over ``src/repro_torch`` against
     ``analysis/baseline_torch.json``), prints ``{"lint": {...}}`` (the
     findings per rule, new, matched and stale counts, the wall and the
     card) and fails on any new finding or stale baseline entry;
  2. builds every Hopper kernel from ``src/repro_torch/kernels/csrc`` (one
     nvcc per source, all at once);
  3. holds each kernel against its plain PyTorch version at the shapes the
     main path gives it (``torch.equal``: ring words are exact) and times
     kernel and plain version.  The two sources on the int8 tensor-core
     limb core (``ring_matmul.cu``, ``mpc_matmul_fused.cu``) must not
     serialize their wgmma (ptxas C7520) and, where cuobjdump exists, their
     SASS must hold integer GMMA instructions.  The ring matmul is also
     checked on all-ones words with K past one chunk of its exactness
     bound; its bound is given by bytes and by int8 limb-pair operations;
     its device time is split into a fixed cost a block and a cost a
     main-loop step; and a cuBLAS int8 GEMM of the stacked limb planes
     (``torch._int_mm``, B in both layouts) is timed as a yardstick of the
     int8 stage.  ``mpc_matmul_fused`` is held and timed at the NN's three
     layer shapes (beside its bound and the time the ring matmul's fit
     gives its grid), on all-ones words in chunks at the exactness bound
     and on 32-bit words.  The PRF row (one launch a draw group) times
     the wrapper the paths call on the main path's largest group (the three
     lambda streams of the (128, 784) input share), a lone draw of that
     size, a lone 128-word draw and the joint adder's 78 streams, and holds
     mixed groups (shifts, empty and odd streams, 120 streams, outputs off
     the 16-byte grid, streams longer than a wave) at both widths; its
     compute bound counts the integer instructions of one word in the
     library's SASS (cuobjdump).  The ``ppa_msb`` row is the whole
     msb(x + y) in one launch, held against its loop and the exact sum's
     msb at n = 4096 and 1001, both widths.  Rows 1-3 and 8 are also read
     without the profiler: CUDA events around launches queued behind a
     spin kernel.  The grouped gamma-piece kernel (``mult_terms``/
     ``and_terms``, one launch per protocol round) is held against its
     plain version on ragged, unaligned, broadcast, expanded and 32-bit
     groups and over more groups than one launch takes; its rows are the
     round launches of one Pi_Mult on (128, 128) words and one AND on
     (128, 1), captured from a runtime on the card, each beside the
     per-party sequence it replaces (staging stacks, one stacked launch
     per party, the combine), its bound from the unique bytes the launch
     moves.  The ``and_level`` row
     is the joint paths' whole-chain launches (the Sklansky adder and the
     prefix-OR, faithful and collapsed, at n = 128 and 2^20 and on 32-bit
     words) beside the single level and the split twins of the chains (one
     AND, the adder and the prefix-OR, offline and online, held at the same
     sizes, the adder and the prefix-OR timed at n = 128);
  4. serves 2 batches of 128 queries of the paper's 784-128-128-10 NN
     through ``PartyPredictionServer`` on the card with the "hopper"
     backend (its batches run on the serving gateway's collector thread),
     and checks that every kernel of that path was launched while
     serving, that no party aborted, that the opened words, ``per_link()``
     and ``totals()`` equal a CPU run of the port with the "torch" backend
     on the same seed, that the probabilities are close to a float64
     numpy forward pass, and that ``mult_terms``/``and_terms`` launched as
     often a batch as the grouped wrappers are called in a CPU batch with
     the "hopper" backend; then profiles one more batch, whose device
     operations must number at least its kernel launches;
  5. the runtime's offline-online split (phase "runtime-offline-online"):
     deals batch 0's preprocessing on the card (``repro_torch.offline``;
     its offline rounds and bits those of the inline batch, no online
     bit, no abort), saves the store to a temporary directory outside the
     checkout and loads it back, runs batch 0 online-only from the store
     (words bit-identical to step 4's, the same online ``per_link()``, no
     offline bit, no ``prf_mask`` launch, and per kernel deal + online
     launches equal to the inline batch's) and from the loaded store (the
     same words); holds Pi_DotP's two rounds on the "hopper" backend
     (kernel route K1: one ``mult_terms`` launch a round, contracted
     after) at (128, 784) . (128, 784) against the "torch" backend on the
     CPU; serves 3 batches through ``PartyPredictionServer(prep=
     "pipelined")`` (dealer thread on its own CUDA stream), each equal to
     an inline runtime at its seed, with no offline bit; and times the
     inline, deal, online-only and pipelined batch walls and profiles an
     online-only and a deal batch;
  6. joint path A: serves the same 2 batches through the joint simulation's
     ``PredictionServer`` (faithful mode, Newton-Raphson division) and
     checks the kernels of that path launched, no abort, the opened words
     and ``ServeStats`` equal to a CPU run of the port, ``and_level`` and
     ``mpc_matmul_fused`` launched as often a batch as that CPU run called
     their wrappers, the words and ``totals()`` equal to the runtime
     path's, and the probabilities; then profiles one more joint batch;
  7. joint path B: one batch on a collapsed context (the
     ``mpc_matmul_fused`` route): the kernels launched, the words equal to
     a CPU run and the launches to its wrapper calls, ``totals()`` equal to
     path A's, and the probabilities; then profiles one more batch;
  8. the joint simulation's offline-online split (phase "joint-split"):
     batch 0 of path A's program through ``train.trainer.
     split_offline_online`` on the card, faithful and then collapsed, an
     offline run and an online run on its materials, each a driven path:
     the online words equal path A's (faithful) or path B's (collapsed)
     batch 0 and a CPU run of the split, every material consumed, no
     abort, the offline run's offline totals and the online run's online
     totals those of the fused batch, every kernel launched as often in
     each run as the CPU run called its wrapper, and the split
     ``and_level`` entries 2 offline and 2 online (A2B's subtractor, smx's
     prefix-OR); the offline and online walls (driven and again) beside
     the fused batch's;
  9. the ABY3 baseline (phase "aby3"): ``core.aby3.matmul_tr`` at (128,
     784) @ (784, 128) and at linear regression's (128, 784) @ (784, 1)
     and (784, 128) @ (128, 1), ``mult`` on (128, 128), and Trident's
     ``activations.argmax_tournament`` on (128, 10), one driven path: words
     and tallies equal to a CPU run of the port, decoded values within
     1e-2 of float64, one ``mpc_matmul_grid`` launch an ABY3 matmul and one
     ``mult_terms`` launch an ABY3 mult; it prints each op's executed
     per-element rounds and bits beside ``paper_costs``' ABY3 figures (not
     asserted equal: the truncation pair's offline bits differ from
     ``dotp_tr_cost``'s) and ABY3's and Trident's ``matmul_tr`` walls on
     the same shapes;
 10. secure training on the party runtime (phase "runtime-train"): 3
     steps of the NN (``secure_sgd.nn_task()``, lr 0.5, weights from
     ``init_params(seed=0)``, ``MNISTLike(n=8192, seed=2)`` batches of
     128) through ``secure_sgd.run_step`` on the card, each step's
     (params, loss) and ``totals()`` equal to a CPU run with the "torch"
     backend, its launches per kernel equal to a CPU step's wrapper calls;
     the same 3 steps in the joint world on the card (the same params and
     losses); params after step 1 within 1e-2 of one float64 SGD step with
     the truncations' mean bias, and within 5e-2 of it without; 3
     steps of logistic regression on 784 features, equal to the CPU run;
     the NN steps dealt and run online-only (equal to the inline steps, the
     inline traffic split exactly, no ``prf_mask`` or ``ring_matmul``
     launch online, deal + online launches = inline per kernel);
     ``PrepAheadSGD`` over a ``ContinuousDealer`` (the same trajectory,
     no offline bit); a ``Trainer`` crashed at step 1 and resumed from its
     checkpoint ending on the uninterrupted params; steady step walls, a
     profiled NN step, and each kernel at the training step's new shapes
     against its plain version, timed beside its bound;
 11. the four parties as four processes over TCP (phase "cluster"): one
     ``PartyCluster(device="cuda", live_prep=True, net_model=LAN)`` of four
     daemon processes on the card serves step 4's 2 batches through
     ``serve_over_sockets`` (batch k at seed SEED + k), each batch's words,
     ``totals()``, ``per_link()`` and modeled LAN time equal to the
     in-process runtime's on the card, all four daemons agreeing, no abort,
     and every daemon's launches of the five runtime kernels a batch (read
     inside the daemons by ``daemon_stats``, set to 0 before the path)
     equal to the in-process batch's; on the same cluster 3 NN steps of
     ``ClusterSGD(prep="live")`` fed by ``attach_live_dealer`` (a dealer
     process on the card) bit-equal to ``run_step`` in process, with 0
     offline bits on the mesh; one ``ShardedClusterSGD`` step over the
     cluster twice (2 shards of 64), the mean of the in-process members;
     ``serve_over_sockets(prep="live")`` on a cluster of its own (the
     inline words, 0 offline bits); and a ``run_four_parties`` run with a
     tampered ``.g2`` in which every daemon aborts.  It prints the boot
     seconds, each batch's round-trip wall beside the in-process wall, frames
     and wire bytes a batch, the live step walls, the dealer's lead and
     each daemon's peak device memory, each beside the card's name and
     power limit;
 12. the observability plane (phase "obs"; tracing is off in every other
     phase): step 4's batch 0 served untraced and traced in turns (off,
     on, on, off), each under a fresh metrics registry, the first traced
     batch a driven path of its own ("obs_runtime"): its words,
     ``per_link()``, ``totals()`` and launches per kernel equal to step
     4's batch 0, the tracer's and the registry's link bits equal to
     ``per_link()``, the ``kernel.*`` spans per kind equal to
     ``trident_kernel_launches_total`` per kind, every kernel span with a
     finite ``device_ms`` >= 0 (CUDA events read when the trace is
     drained), each kernel's summed ``device_ms`` (the stream's window
     around its calls) at least its device time in step 4's profiled
     batch, the categories protocol, wire.round, wire.send and kernel
     present, and ``render_prometheus()`` one sample line for each sample
     of the snapshot; batch 0 traced through the pipelined server (dealt
     on the dealer thread's CUDA stream, served on the gateway's collector
     thread, the thread of its ``serve.batch.online`` span): step 4's
     words, its spans per kind the registry's launches, kernel spans on
     exactly those two threads, and each thread's windows by kernel at
     least step 5's profiled online-only and deal runs; then one
     ``PartyCluster(device="cuda", trace=True,
     metrics=True, live_prep=True, net_model=LAN)``: a warm-up task (its
     registry bits, tasks 1, inflight 0, ``merged_link_bits`` equal to
     ``per_link()``), step 4's 2 batches inline through
     ``serve_over_sockets(metrics=True)`` (the in-process words and
     traffic, every daemon's launches a batch those of the in-process
     batch, its batches' kernel spans per kind equal to its scraped
     launches and its windows by kernel at least twice step 4's profile),
     the same batches through ``serve_over_sockets(prep="live",
     metrics=True, cluster=...)`` (the words, no offline bit, and an
     end-of-stream health document that is healthy with four ranks alive
     and scraped and the dealer scraped), four scrapes each holding its
     daemon's ``per_link()`` with no task in flight, the merged timeline
     saved under TMPDIR with a pid for each rank and the dealer, and a
     terminated daemon reported as ``rank_down``.  Health documents are
     taken only between tasks or at a stream's end: the probes are
     age-gated.  It prints the walls traced and untraced, trace events
     and chunk bytes a batch, each kernel's summed ``device_ms`` beside
     step 4's profiled device time, the scrape and health walls and the
     traced cluster batches beside phase cluster's untraced ones.  The
     in-process references of the cluster checks are phase cluster's;
 13. the serving gateway (phase "gateway", tracing off): a
     ``ServingGateway(pool=2, prep="live", device="cuda", metrics=True)``
     boots two clusters of four daemons on the card concurrently and one
     shared dealer process, and serves the paper's NN (``cluster_predict``,
     step 4's weights) in dynamic batches padded to 128: a burst of 3 x
     128 queries from 4 threads, then 9 dispatches one at a time (the
     members take turns; the reference design's scheduler sends them all
     to one member and the dealer stalls on the other).  Every row equals
     the in-process runtime on the card for its dispatch's padded batch at
     seed SEED + session; each session is consumed once across the pool
     (the daemons' ``trident_prep_sessions_consumed_total``), no offline
     bit and no abort; every daemon launched a dispatch what the
     in-process online-only batch of step 5 launches, and the dealer's
     registry holds its PRF and gamma launches.  Then member 0's daemons
     are stopped, two batches queued, and the daemons killed once one
     batch was dispatched to them: that batch is re-dispatched, every
     query resolves on member 1 to its in-process row, the dealer
     streams on, and ``health()`` names member 0 evicted and the dealer
     not failed.  Each step prints a line before it runs.  It prints the
     pool's boot seconds, each dispatch's wall, queries/s, query latency
     p50/p95/p99, per-member utilization, the dealer's largest lead and the
     host bytes it implies, and each daemon's peak device memory;
 14. the LM stack's serving path (phase "lm"): (a) with the kernel rows
     of step 3, the batched ring matmul (kernel route K2) held against
     ``torch.matmul`` of the same words on the CPU at the full-width
     qwen3 serve's products (a query chunk's scores and probs @ v, a
     decode step's scores, an expert product), a broadcast batch, K past
     one chunk and 32-bit words, each timed beside its bound; (b) the
     SMOKE configs of qwen3-1.7b, mixtral-8x7b, whisper-tiny and
     phi-3-vision at 2 layers and qwen3 at d_model 256 (128 ids, two
     query chunks) served (``serve_prefill`` and decode) on the card and
     on the CPU, faithful and collapsed: equal logits and cache words,
     equal ``totals()``, no abort, the card's launches each run's CPU
     wrapper calls; (c) the main path: qwen3-1.7b's CONFIG (d_model 2048,
     16 heads and 8 KV heads of 128, d_ff 6144, vocab 151,936, qk_norm,
     q_chunk 512) cut to 2 of 28 layers, random weights from a seed,
     shared on the card, a prefill of 1,024 ids (two query chunks) and 3
     decode steps, batch 1, faithful, the embedding table at scale 0.5:
     words exact at the main path's largest sizes (``prf_mask`` of a group
     of three 311 M-word streams against its plain version, the shared
     embedding and ``lm_head`` opened equal to their encoded weights, the
     ring matmul at the ``lm_head`` product equal to ``torch.matmul`` on
     the CPU), no abort, the KV cache's shape, the logits against
     ``PlainEngine`` in float64 on the card within the bounds of the CPU
     rehearsal (``tools/torch_lm_rehearsal.py``), which all-zero or
     shuffled logits fail.  It prints the sharing time, the prefill and
     decode walls, launches per kernel per prefill and per decode step,
     and the peak device memory;
 15. the recurrent families' serving path (phase "lm-recurrent"): (a) K2
     held against ``torch.matmul`` on the CPU at the recurrent paths' new
     shapes (zamba2's and xlstm's chunk products, zamba2's shared block's
     scores with K = 112 and probs @ v with N = 112, a decode step's
     outer product with K = 1 and its M = 1 product, sLSTM's public decay
     contractions with the encoded matrix broadcast over the components
     and the batch), each timed beside its bound; (b) zamba2's and
     xlstm's SMOKE configs uncut (zamba2's shared block applied twice)
     served with 16 ids (two chunks) and 2 decode steps on the card and
     on the CPU, faithful and collapsed, and zamba2 with ``long_ctx`` and
     long_window 12: equal logits and cache words, equal ``totals()``,
     no abort, the card's launches the CPU's wrapper calls; (c) the main
     paths: zamba2-7b's CONFIG (d_model 3,584, 32 heads, ssm_state 64,
     d_ff 14,336, vocab 32,000) cut to 2 of 81 layers (one retention
     segment of 2, then the shared block) and xlstm-350m's (d_model
     1,024, 4 heads, vocab 50,304) cut to 4 of 24 layers (2 pairs),
     random weights from a seed shared on the card, a prefill of 1,024
     ids and 3 decode steps, batch 1, faithful, the embedding at scale
     0.5, zamba2 once more with ``long_ctx`` and long_window 512: no
     abort, the states' and KV caches' shapes after every step (the
     long run's shared block 512 positions throughout), ``ring_matmul``
     at every shape the driven runs gave it (among them zamba2's (1,
     1,024, 3,584) @ (3,584, 14,336) projections and both lm_heads) equal
     to ``torch.matmul`` on the CPU and ``and_level`` at every n they gave
     it (zamba2's shared MLP: 14.7 M words) equal to its plain version,
     the logits
     against ``PlainEngine`` in float64 on the card within the bounds of
     the full-width rehearsal (``tools/torch_lm_rehearsal.py --cases
     full``), which all-zero or shuffled logits fail.  It prints each
     config with its cuts, the sharing time, the prefill and decode
     walls, launches per kernel per prefill and per decode step, the
     profiled busy share of a prefill and the peak device memory.
 16. LM training of the attention families (phase "lm-train"): with the
     kernel rows of step 3, the ring matmul held against ``torch.matmul``
     on the CPU at the LM's largest 2-D products (phase lm's MLP and the
     train step's weight gradient, MLP dY W^T and lm_head dx), each timed
     beside its bound; (b) the SMOKE configs of qwen3-1.7b, mixtral-8x7b
     (public and dense routing), whisper-tiny and phi-3-vision at 2
     layers, qwen3's also with microbatch 2, and qwen3 at d_model 256
     with 128 ids: one ``train_step`` each on the card and on the CPU,
     faithful and collapsed: equal new params words, loss, ``totals()``,
     no abort, the card's launches the CPU run's wrapper calls; (c) the
     main path: phi-3-vision-4.2b's CONFIG (d_model 3,072, 32 heads of
     96, d_ff 8,192, vocab 32,064, remat) cut to 2 of 32 layers, 128 ids
     and labels behind its 576 frontend embeddings, batch 1, faithful,
     the embedding at scale 0.5: two driven steps (``loss_and_grads``
     then ``sgd_update``, each part's wall kept) and a profiled
     ``train_step``, no abort, ``ring_matmul`` (2-D and K2) and
     ``and_level`` at every shape the steps gave them exact against the
     CPU and the plain version, and the first step's loss and gradients
     against float64 with fixed point's mean error on the card
     (``tools/torch_lm_rehearsal.py``'s model; all-zero and shuffled
     gradients fail its bounds) and against plain float64 (printed:
     ROADMAP N6).  It prints the sharing time, the steps' walls, the busy
     share and top device operations, launches per step and the peak
     device memory.
 17. LM training of the recurrent families (phase "lm-recurrent-train"):
     (a) with the kernel rows of step 3, K2 held against ``torch.matmul``
     on the CPU at the training shapes not timed before (the retention
     backward's new chunk products at zamba2's and xlstm's widths, the
     sLSTM backward's public contractions, zamba2's shared block at 512
     positions, phase lm-train's attention at 704), each timed beside its
     bound; (b) zamba2's and xlstm's SMOKE configs uncut (zamba2's shared
     block applied twice), (2, 16) ids and labels (two chunks): one
     ``train_step`` each on the card and on the CPU, faithful and
     collapsed, and two steps of xlstm through ``train.optim.Momentum``,
     collapsed: equal new params and momentum buffers, losses,
     ``totals()``, no abort, the card's launches the CPU run's wrapper
     calls; (c) zamba2-7b's CONFIG (d_model 3,584, 32 heads, ssm_state 64,
     d_ff 14,336, vocab 32,000, remat) cut to 2 of 81 layers with the
     shared block after each (its gradient summed over two uses) and (d)
     xlstm-350m's CONFIG at 8 of 24 layers (whole until PR 28; cut for
     the run's time limit), 512 ids and labels each (two
     chunks of 256), batch 1, faithful, the embedding at scale 0.5: per
     model two driven steps and a profiled one, as step 16's main path,
     with the gradients held against the fixed-point model within the
     bounds of ``tools/torch_lm_rehearsal.py --train --cases
     full-recurrent``.  It prints the same figures as step 16 for each.
 18. The LM launcher (phase "launch"), ``repro_torch.launch.train``
     through the entry points a user calls (``parse_args``, ``build``,
     ``Trainer.run``), collapsed, garbled, each step under its own
     context (``seed_for_step``): (a) whisper-tiny's and phi-3-vision's
     SMOKE configs, 2 steps each on the card and on the CPU: equal losses,
     final params words, ``totals()``, no abort, the card's launches the
     CPU run's wrapper calls; (b) the main path: whisper-tiny's CONFIG
     whole (4 encoder and 4 decoder layers, d_model 384, 6 heads, d_ff
     1,536, vocab 51,865, 1,500 encoder frames, remat) with
     ``--no-smoke --steps 4 --batch 2 --seq 64``, uninterrupted (a driven
     path), then crashed after step 1's checkpoint (at step 2) and resumed
     from it: the resumed run's final params equal the uninterrupted run's
     bit for bit, no abort, ``latest()`` verifies; (c) the dry run's
     argument bytes for that cell equal the parameter tree and inputs on
     the card; (d) ``mpc_matmul_fused`` (every collapsed 2-D product: the
     weight gradients) and ``ring_matmul`` (2-D and K2) at every shape the
     steps gave them, exact against the CPU; each fused shape timed beside
     its bound.  It prints the steps' walls, a profiled step's busy share,
     launches per step, the peak device memory and the checkpoints' save
     and restore walls and bytes.

Each path (the deal and the online-only run of steps 5 and 10 and the
offline and online runs of step 8 being two each; step 11's, 12's and
13's daemons count in their own processes) is
driven with the launch counts set to 0 just before it and read
just after; the kernel rows report the sum over the paths, and each path
prints its ``prf_mask`` launches, draw groups and PRF streams per batch or
step (one launch a group, and on the runtime, joint and training paths as
many as a CPU run's draw groups).  Any
failure exits nonzero.  It prints the wall of each phase; before the
last lines come
``{"offline_online": {...}}`` (step 5's times),
``{"joint_split": {...}}`` (step 8's), ``{"aby3": {...}}`` (step 9's),
``{"runtime_train": {...}}`` (step 10's), ``{"cluster": {...}}`` (step
11's), ``{"obs": {...}}`` (step 12's), ``{"gateway": {...}}`` (step 13's),
``{"lm": {...}}`` (step 14's), ``{"lm_recurrent": {...}}`` (step 15's),
``{"lm_train": {...}}`` (step 16's), ``{"lm_recurrent_train": {...}}``
(step 17's), ``{"launch": {...}}`` (step 18's) and ``{"kernels":
[...]}``, then
the card's name and power limit; the last line is ``{"ok": true,
"device": {...}}``.  Without CUDA, or outside a checkout, it exits nonzero
and prints no result.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, os.path.join(ROOT, "tools"))

# H100 SXM rates: HBM3 bandwidth and the dense int8 tensor-core rate, which
# bounds the ring matmul's limb-pair products (NVIDIA data sheet); and the
# INT32 rate of the CUDA cores, which bounds the other kernels' integer
# instructions: 64 results a clock an SM for 32-bit integer add, multiply-
# add, logic and shift (CUDA C++ Programming Guide, arithmetic instruction
# throughput, compute capability 9.0) x 132 SMs x 1.98 GHz (the boost clock
# the data sheet's 67 TFLOP/s float32 implies: 67e12 / (132 x 128 x 2)).
HBM_BYTES_PER_S = 3.35e12
INT8_TC_OPS_PER_S = 1979e12
INT32_OPS_PER_S = 64 * 132 * 1.98e9

BATCH = 128
N_BATCHES = 2
SEED = 11
# Probabilities of the secure forward pass are fixed point with 13
# fractional bits, through three truncating matmuls and a Newton-Raphson
# reciprocal (three iterations): a few 1e-3 at most on the CPU at this
# seed, so 1e-2 absolute leaves room without hiding a wrong answer.
PROB_ATOL = 1e-2


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def gpu_name_and_limit() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def lint_phase(card: str) -> dict:
    """tridentlint over the shipped port against its committed baseline:
    any new finding or stale entry fails the run."""
    from collections import Counter
    from pathlib import Path

    from repro_torch.analysis import (baseline_diff, baseline_load,
                                      load_tree, run_rules)
    t0 = time.perf_counter()
    modules = load_tree(Path(ROOT, "src", "repro_torch"))
    findings = run_rules(modules)
    new, matched, stale = baseline_diff(findings, baseline_load(
        Path(ROOT, "analysis", "baseline_torch.json")))
    wall = time.perf_counter() - t0
    out = {"files": len(modules),
           "findings_by_rule": dict(sorted(
               Counter(f.rule for f in findings).items())),
           "new": len(new), "matched": matched, "stale": len(stale),
           "wall_s": wall, "card": card}
    print(json.dumps({"lint": out}))
    check(not new, "lint: new findings against analysis/baseline_torch."
          "json:\n" + "\n".join(f.render() for f in new))
    check(not stale, f"lint: stale baseline entries {stale}")
    return out


def cuda_ms(fn, reps: int = 50, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_kernels(fn, reps: int = 20, warmup: int = 1,
                   windows: int = 3) -> dict:
    """{device function name: device ms per call of `fn`} from the
    profiler's CUDA activity, after `warmup` calls; {} if the profiler saw
    no device activity in `windows` windows.  CUPTI on the H100 has now
    and then recorded nothing for a window when several smoke runs
    followed one another on one card, so an empty window is taken again."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        seen = {e.key: e.device_time_total / reps / 1e3
                for e in prof.key_averages() if e.device_time_total > 0}
        if seen:
            return seen
        time.sleep(0.5)
    return {}


def device_ms(fn, match: str | None = None, reps: int = 20,
              warmup: int = 1) -> float:
    """Device time per call of `fn`: the kernels whose name contains
    `match` (every kernel when None).  Fails if the profiler saw no device
    time for them."""
    ms = sum(t for k, t in device_kernels(fn, reps, warmup).items()
             if match is None or match in k)
    check(ms > 0, f"the profiler saw no device time for {match or fn}")
    return ms


def host_ms(fn, reps: int = 5) -> float:
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e3


def spin_gated_ms(fn, reps: int = 50, spin_cycles: int = 20_000_000) -> dict:
    """Device time a call of `fn` without the profiler: CUDA events around
    `reps` calls queued behind a spin kernel (torch.cuda._sleep), so the
    host enqueues them all while the card spins and the card then runs them
    back to back (each call's kernel plus the card's own gap between
    launches; no host gap).  The spin doubles until it outlasts the
    enqueue: the start event must still be pending when the last call is
    queued.  {"ms": per call, "spin_cycles": ..., "enqueue_ms": host time
    to queue the calls}."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for _ in range(6):
        torch.cuda._sleep(spin_cycles)
        start.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        gated = not start.query()
        end.record()
        torch.cuda.synchronize()
        if gated:
            return {"ms": start.elapsed_time(end) / reps,
                    "spin_cycles": spin_cycles, "enqueue_ms": enqueue_ms}
        spin_cycles *= 4
    check(False, f"spin-gated timing: the spin never outlasted the enqueue "
          f"of {reps} calls of {fn}")


def sass(build, source: str) -> str | None:
    """The SASS of one source's library (cuobjdump -sass), or None where
    the toolkit has no cuobjdump."""
    cuobjdump = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    if not os.path.exists(cuobjdump):
        return None
    return subprocess.run([cuobjdump, "-sass", str(build._target(source))],
                          capture_output=True, text=True, timeout=120).stdout


def prf_word_instructions(build) -> tuple:
    """(instructions, {opcode: count}) of one squares() word: the SASS of
    the prf_mask library's squares_probe, its parameter loads, thread
    index read and one store left out (and NOP/EXIT/BRA); (None, {})
    where the toolkit has no cuobjdump."""
    text = sass(build, "prf_mask")
    if text is None:
        return None, {}
    ops_, inside = {}, False
    for line in text.splitlines():
        if "Function :" in line:
            inside = line.split("Function :")[1].strip() == "squares_probe"
            continue
        if not inside or "/*" not in line or ";" not in line:
            continue
        body = line.split("*/", 1)[1].split(";")[0].strip()
        if body.startswith("@"):                   # a predicate guard
            body = body.split(None, 1)[1]
        op = body.split()[0] if body else ""
        if op and op.split(".")[0] not in ("NOP", "EXIT", "BRA", "LDC",
                                           "ULDC", "STG", "S2R", "S2UR"):
            ops_[op] = ops_.get(op, 0) + 1
    check(ops_, "squares_probe not found in the prf_mask library's SASS")
    return sum(ops_.values()), ops_


def prf_bound(words: int, instructions: int | None,
              elsize: int = 8) -> tuple:
    """prf_mask's bound for `words` words of `elsize` bytes: the words
    written once against `instructions` integer instructions a word at the
    INT32 rate (bytes alone where they were not counted)."""
    return bound(elsize * words, (instructions or 0) * words)


def bound(nbytes: int, ops: int, ops_per_s: float = INT32_OPS_PER_S
          ) -> tuple:
    tb = nbytes / HBM_BYTES_PER_S
    to = ops / ops_per_s
    return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")


def ring_matmul_bound(M: int, K: int, N: int) -> dict:
    """The ring matmul's bound: its bytes (each operand read once, C written
    once) against its limb-pair int8 operations (36 pairs of 8-bit limbs,
    2 M N K each) at the tensor-core rate; beside it, the count of 2 M N K
    64-bit operations at the INT32 rate that bounded the earlier
    native-uint64 kernel."""
    nbytes = 8 * (M * K + K * N + M * N)
    b_ms, b_by = bound(nbytes, 36 * 2 * M * N * K, INT8_TC_OPS_PER_S)
    return {"bound_ms": b_ms, "bound_by": b_by,
            "bound_ms_bytes": nbytes / HBM_BYTES_PER_S * 1e3,
            "bound_ms_int8_ops": 36 * 2 * M * N * K / INT8_TC_OPS_PER_S
            * 1e3,
            "bound_ms_u64_cuda_core": bound(nbytes, 2 * M * N * K)[0]}


# the words of the and_level kernels' large check
BIG_N = 1 << 20
# the collapsed secure matmuls of the NN's three layers (batch 128)
FUSED_SHAPES = ((BATCH, 784, 128), (BATCH, 128, 128), (BATCH, 128, 10))


def fused_bound(M: int, K: int, N: int) -> dict:
    """mpc_matmul_fused's bound: its bytes (the 8 operand planes read
    once, mm, cross and gamma written once) against its limb-pair int8
    operations (4 quadrants x 36 pairs x 2 M N K) at the tensor-core
    rate."""
    nbytes = 8 * (4 * M * K + 4 * K * N + 3 * M * N)
    nops = 4 * 36 * 2 * M * N * K
    b_ms, b_by = bound(nbytes, nops, INT8_TC_OPS_PER_S)
    return {"bound_ms": b_ms, "bound_by": b_by,
            "bound_ms_bytes": nbytes / HBM_BYTES_PER_S * 1e3,
            "bound_ms_int8_ops": nops / INT8_TC_OPS_PER_S * 1e3}


def fused_shape_row(MF, ins, ins_cpu, fit: dict, dev) -> dict:
    """mpc_matmul_fused at one shape: held against its plain version; its
    device time, call time and plain time; its bound; its grid; and the
    time the ring matmul's fit (`fit`: fixed a block + a 32-word step,
    measured in this run) gives a block of its steps."""
    import torch
    from repro_torch.kernels import ring_matmul as RM
    (M, K), N = ins[0].shape, ins[2].shape[1]
    got = MF.mpc_matmul_fused_cuda(*ins)
    want = MF.mpc_matmul_fused_plain(*ins_cpu)
    torch.cuda.synchronize()
    check(all(torch.equal(g.cpu(), w) for g, w in zip(got, want)),
          f"mpc_matmul_fused disagrees at {M}x{K}x{N}")
    chunk = MF.quadrant_chunk(M, N, K, RM._sm_count(dev))
    steps = -(-min(chunk, K) // RM.STEP_K)
    tiles = -(-M // RM.TILE) * -(-N // RM.TILE)
    return {"shape": f"{M}x{K}x{N}",
            "max_abs_err": max((g.cpu() - w).abs().max().item()
                               for g, w in zip(got, want)),
            "ms": device_ms(lambda: MF.mpc_matmul_fused_cuda(*ins),
                            "mpc_matmul_fused_kernel", reps=50, warmup=5),
            "call_ms": cuda_ms(lambda: MF.mpc_matmul_fused_cuda(*ins)),
            "plain_ms": host_ms(lambda: MF.mpc_matmul_fused_plain(*ins_cpu)),
            **fused_bound(M, K, N), "k_chunk": chunk,
            "blocks": 4 * tiles * -(-K // chunk), "steps_a_block": steps,
            "fit_ms": fit["fixed_ms"] + fit["per_step_ms"] * steps}


def chain_bound(n: int, streams: int, adder: bool) -> tuple:
    """The adder's or prefix-OR's bound at n words: bytes (the input
    stacks and every AND's draws read once, the output stack written
    once) against its integer operations (about 30 an AND level, plus the
    masks, shifts, smears and NOTs between levels) at the CUDA-core
    rate."""
    ands, stacks, ops_ = chain_shape(adder)
    return bound(8 * n * (4 * stacks + ands * streams), ops_ * n)


def chain_shape(adder: bool) -> tuple:
    """(ANDs, share stacks read and written, integer operations a word) of
    the adder or the prefix-OR at ell = 64."""
    levels = 6
    if adder:
        ands = 2 * levels + 1
        return ands, 3, 30 * ands + 32 * levels + 8 * levels * (levels - 1) \
            + 21
    return levels, 2, 37 * levels


def split_bound(n: int, streams: int, adder: bool, online: bool) -> tuple:
    """A split chain's bound at n words: its bytes (the input stacks read
    once; offline every AND's draws read and its three gammas written
    once, online its three lambdas and three gammas read once; the output
    stack written once) against its integer operations (as
    ``chain_bound``'s)."""
    ands, stacks, ops_ = chain_shape(adder)
    planes = 6 if online else streams + 3
    return bound(8 * n * (4 * stacks + ands * planes), ops_ * n)


def split_rows(words, words32) -> dict:
    """The split twins of the chains (the joint offline and online runs):
    one AND, the adder (cin = 1) and the prefix-OR, offline and online,
    faithful and collapsed, held against their plain versions at n = 128
    (smx's words of (128, 1)) and 2^20 and on 32-bit words; the adder and
    the prefix-OR timed at n = 128."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import ppa_msb as PPA
    timed = {}
    for make, ell, sizes in ((words, 64, (BATCH, BIG_N)),
                             (words32, 32, (5000,))):
        for S, world in ((6, "faithful"), (3, "collapsed")):
            for n in sizes:
                x, y = make(4, n), make(4, n)
                for kind, arg in (("and", 0), ("add", 1), ("or", -1)):
                    A = PPA.split_ands(kind, ell)
                    d, lz, gm = make(A, S, n), make(A, 3, n), make(A, 3, n)
                    yy = None if kind == "or" else y
                    got = PPA.and_chain_offline_cuda(kind, x, yy, d, arg)
                    want = PPA.and_chain_offline_plain(kind, x, yy, d, arg)
                    check(all(torch.equal(g, w) for g, w in zip(got, want)),
                          f"and_chain_offline ({kind}) disagrees with its "
                          f"plain version: {ell}-bit, {world}, n = {n}")
                    check(torch.equal(
                        PPA.and_chain_online_cuda(kind, x, yy, lz, gm, arg),
                        PPA.and_chain_online_plain(kind, x, yy, lz, gm,
                                                   arg)),
                          f"and_chain_online ({kind}) disagrees with its "
                          f"plain version: {ell}-bit, {world}, n = {n}")
                    if n != BATCH or kind == "and":
                        continue
                    for online in (False, True):
                        if online:
                            args = (kind, x, yy, lz, gm, arg)
                            kern, plain = (PPA.and_chain_online_cuda,
                                           PPA.and_chain_online_plain)
                            call = ops.and_chain_online
                        else:
                            args = (kind, x, yy, d, arg)
                            kern, plain = (PPA.and_chain_offline_cuda,
                                           PPA.and_chain_offline_plain)
                            call = ops.and_chain_offline
                        phase = "online" if online else "offline"
                        b_ms, b_by = split_bound(n, S, kind == "add", online)
                        timed.setdefault(world, {})[f"{phase}_{kind}"] = {
                            "ms": device_ms(lambda: kern(*args),
                                            f"and_chain_{phase}_kernel",
                                            reps=50, warmup=5),
                            "call_ms": cuda_ms(lambda: call(*args)),
                            "plain_ms": device_ms(lambda: plain(*args)),
                            "plain_device_ops": device_ops(
                                lambda: plain(*args))[1],
                            "bound_ms": b_ms, "bound_by": b_by}
    return timed


def and_level_rows(words, words32, dev) -> dict:
    """The and_level row: the whole-chain launches of the main path (the
    Sklansky adder and the prefix-OR), faithful and collapsed, held
    against their plain versions at n = 128 (smx's words of (128, 1)) and
    2^20, and on 32-bit words; timed at n = 128, the faithful adder
    (A2B's subtractor, cin = 1) being the row."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import ppa_msb as PPA
    chains = {}
    for make, ell, sizes in ((words, 64, (BATCH, BIG_N)),
                             (words32, 32, (5000,))):
        A_add, A_or = PPA.chain_ands(ell, True), PPA.chain_ands(ell, False)
        for S, world in ((6, "faithful"), (3, "collapsed")):
            for n in sizes:
                x, y = make(4, n), make(4, n)
                da, do = make(A_add, S, n), make(A_or, S, n)
                for cin in (0, 1):
                    check(torch.equal(PPA.ppa_add_cuda(x, y, da, cin),
                                      PPA.ppa_add_plain(x, y, da, cin)),
                          f"ppa_add disagrees with its plain version: "
                          f"{ell}-bit, {world}, n = {n}, cin = {cin}")
                check(torch.equal(PPA.prefix_or_cuda(x, do, -1),
                                  PPA.prefix_or_plain(x, do, -1)),
                      f"prefix_or disagrees with its plain version: "
                      f"{ell}-bit, {world}, n = {n}")
                if n != BATCH:
                    continue
                timed = {}
                for name, kern, plain, call, adder in (
                        ("ppa_add", lambda: PPA.ppa_add_cuda(x, y, da, 1),
                         lambda: PPA.ppa_add_plain(x, y, da, 1),
                         lambda: ops.ppa_add(x, y, da, 1), True),
                        ("prefix_or", lambda: PPA.prefix_or_cuda(x, do, -1),
                         lambda: PPA.prefix_or_plain(x, do, -1),
                         lambda: ops.prefix_or(x, do, -1), False)):
                    b_ms, b_by = chain_bound(n, S, adder)
                    timed[name] = {
                        "ms": device_ms(kern, f"{name}_kernel", reps=50,
                                        warmup=5),
                        "call_ms": cuda_ms(call),
                        "plain_ms": device_ms(plain),
                        "plain_device_ops": device_ops(plain)[1],
                        "bound_ms": b_ms, "bound_by": b_by}
                chains[world] = timed
    add = chains["faithful"]["ppa_add"]
    split = split_rows(words, words32)
    return {ops.AND_LEVEL.name: {
        "name": ops.AND_LEVEL.name, "route": "cuda",
        "source": ops.AND_LEVEL.source, "replaces": ops.AND_LEVEL.replaces,
        "launches": 0, "max_abs_err": 0, "ms": add["ms"],
        "call_ms": add["call_ms"], "plain_ms": add["plain_ms"],
        "bound_ms": add["bound_ms"], "bound_by": add["bound_by"],
        "library_ms": None, "chains_at_n_128": chains,
        "split_at_n_128": split}}


def ring_matmul_phases(M: int, N: int, K: int, chunk: int, dev) -> dict:
    """The ring matmul's device time split into a fixed cost per block
    (staging of the first step, the partial-tile epilogue, the atomic adds)
    and a cost per 32-word step of its main loop: the main path's grid
    (same tiles, same number of K chunks) run with 1 to 4 times its steps a
    block, each result held against torch.matmul, and a line fitted to the
    times."""
    import torch
    from repro_torch.kernels import ring_matmul as RM
    from repro_torch.kernels.build import launch
    chunks = -(-K // chunk)
    main_steps = chunk // RM.STEP_K
    steps = sorted({1, main_steps, 2 * main_steps, 4 * main_steps})
    gen = torch.Generator().manual_seed(SEED)
    times = []
    for st in steps:
        kk = chunks * st * RM.STEP_K
        a = torch.randint(-2**63, 2**63 - 1, (M, kk), dtype=torch.int64,
                          generator=gen)
        b = torch.randint(-2**63, 2**63 - 1, (kk, N), dtype=torch.int64,
                          generator=gen)
        a_d, b_d = a.to(dev), b.to(dev)

        def run(kk=kk, a_d=a_d, b_d=b_d, st=st):
            out = torch.zeros((M, N), dtype=torch.int64, device=dev)
            launch("ring_matmul", "ring_matmul_u64", dev, a_d.data_ptr(),
                   b_d.data_ptr(), out.data_ptr(), M, N, kk,
                   st * RM.STEP_K)
            return out

        check(torch.equal(run().cpu(), RM.ring_matmul_plain(a, b)),
              f"ring_matmul disagrees at {M}x{kk}x{N}, {st} steps a block")
        times.append(device_ms(run, "ring_matmul_kernel", reps=50,
                               warmup=5))
    slope, fixed = np.polyfit(np.array(steps, float), np.array(times), 1)
    return {"blocks": -(-M // RM.TILE) * -(-N // RM.TILE) * chunks,
            "steps_a_block": steps, "ms": times, "fixed_ms": float(fixed),
            "per_step_ms": float(slope), "main_path_steps": main_steps}


def int_mm_yardstick(M: int, K: int, N: int, dev) -> dict:
    """Yardstick of the int8 stage, never called by the port and not a
    library call of the same function (none computes a ring matmul): one
    cuBLAS int8 GEMM of the stacked limb planes, (8M, K) @ (K, 8N), a
    superset of the 36 limb-pair products.  Timed with B row-major and
    with B column-major (cuBLAS's "TN" int8 layout), after 10 warm-up
    calls, with the device functions each call ran."""
    import torch
    a8 = torch.randint(-128, 128, (8 * M, K), dtype=torch.int8, device=dev)
    b8 = torch.randint(-128, 128, (K, 8 * N), dtype=torch.int8, device=dev)
    out = {"shape": f"{8 * M}x{K}x{8 * N}",
           "bound_ms_int8_ops": 2 * 64 * M * N * K / INT8_TC_OPS_PER_S
           * 1e3}
    for label, b in (("b_row_major", b8),
                     ("b_col_major", b8.t().contiguous().t())):
        try:
            ks = device_kernels(lambda b=b: torch._int_mm(a8, b), reps=50,
                                warmup=10)
            out[label] = ({"ms": sum(ks.values()),
                           "kernels": {k[:100]: v for k, v in ks.items()}}
                          if ks else {"ms": None,
                                      "error": "no device activity seen"})
        except RuntimeError as exc:
            out[label] = {"ms": None, "error": str(exc)[:200]}
    return out


# kernel route K2 (the LM stack): the batched entry of ring_matmul.cu at
# the full-width qwen3-1.7b serve's products (batch x M x K x N): a query
# chunk's scores and probs @ v (16 heads, chunks of 512 of 1,024 keys), a
# decode step's scores over 1,025 keys (1 row of a 64-row tile), and an
# expert product of a MoE layer (8 experts, 40 slots)
K2_SHAPES = (("scores", (1, 16, 512, 128), (1, 16, 128, 1024)),
             ("probs_v", (1, 16, 512, 1024), (1, 16, 1024, 128)),
             ("decode", (1, 16, 1, 128), (1, 16, 128, 1025)),
             ("experts", (8, 40, 64), (8, 64, 128)))


def batched_bound(sa: tuple, sb: tuple) -> dict:
    """K2's bound: the bytes (each operand read once, C written once)
    against the limb-pair int8 operations, 36 x 2 x batch x M x N x K, at
    the tensor-core rate."""
    import torch
    batch = tuple(torch.broadcast_shapes(sa[:-2], sb[:-2]))
    nb = int(np.prod(batch)) if batch else 1
    (M, K), N = sa[-2:], sb[-1]
    nbytes = 8 * (int(np.prod(sa)) + int(np.prod(sb)) + nb * M * N)
    ops_ = 36 * 2 * nb * M * N * K
    b_ms, b_by = bound(nbytes, ops_, INT8_TC_OPS_PER_S)
    return {"bound_ms": b_ms, "bound_by": b_by,
            "bound_ms_bytes": nbytes / HBM_BYTES_PER_S * 1e3,
            "bound_ms_int8_ops": ops_ / INT8_TC_OPS_PER_S * 1e3}


def batched_rows(rng, dev) -> dict:
    """The batched ring matmul (K2) against torch.matmul of the same words
    on the CPU (``torch.equal``) at the LM serve's shapes, a broadcast
    batch (stride 0), an odd shape, K past one 4,128-word chunk on
    all-ones words and 32-bit words; each shape timed (device ms by the
    profiler, the wrapper call by CUDA events, the CPU's torch.matmul on
    the host clock) beside its bound.  The scores product is the row."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import ring_matmul as RM

    def words(shape, dt=torch.int64):
        info = torch.iinfo(dt)
        return torch.from_numpy(rng.randint(
            info.min, info.max, size=shape, dtype=np.int64)).to(dt)

    shapes = []
    for name, sa, sb in K2_SHAPES:
        a, b = words(sa), words(sb)
        a_d, b_d = a.to(dev), b.to(dev)
        got = ops.ring_matmul(a_d, b_d)
        torch.cuda.synchronize()
        want = torch.matmul(a, b)
        check(torch.equal(got.cpu(), want),
              f"ring_matmul_batched disagrees with torch.matmul at {name} "
              f"{sa} @ {sb}")
        shapes.append({
            "shape": name, "a": list(sa), "b": list(sb),
            "max_abs_err": 0,
            "ms": device_ms(lambda: RM.ring_matmul_batched_cuda(a_d, b_d),
                            "ring_matmul_kernel"),
            "call_ms": cuda_ms(lambda: ops.ring_matmul(a_d, b_d), reps=20),
            "plain_ms": host_ms(lambda: torch.matmul(a, b), reps=2),
            **batched_bound(sa, sb)})
    cases = [(words((3, 65, 33)), words((33, 7))),          # 2-D kernel
             (words((5, 64)), words((3, 64, 6))),           # stride 0
             (words((2, 1, 9, 16)), words((1, 3, 16, 10))),  # expanded
             (words((3, 65, 33), torch.int32),
              words((3, 33, 70), torch.int32))]             # 32-bit
    K = RM.max_k_chunk(64) + 64
    cases.append((torch.full((2, 65, K), -1, dtype=torch.int64),
                  torch.full((2, K, 66), -1, dtype=torch.int64)))
    for a, b in cases:
        got = ops.ring_matmul(a.to(dev), b.to(dev))
        check(torch.equal(got.cpu(), torch.matmul(a, b)),
              f"ring_matmul_batched disagrees at {tuple(a.shape)} @ "
              f"{tuple(b.shape)} ({a.dtype})")
    k = ops.RING_MATMUL_BATCHED
    row = shapes[0]
    return {k.name: {
        "name": k.name, "route": "cuda", "source": k.source,
        "replaces": k.replaces, "launches": 0, "max_abs_err": 0,
        **{f: row[f] for f in ("ms", "call_ms", "plain_ms", "bound_ms",
                               "bound_by")},
        "library_ms": None, "shape": "x".join(map(str, row["a"])) + " @ "
        + "x".join(map(str, row["b"])), "batched_shapes": shapes}}


def prf_rows(rng, dev, instructions: int | None) -> dict:
    """The prf_mask row: each case (the largest group of a batch, lone
    draws, the joint adder's 78 streams) held against the plain version on
    the card, one launch a call, read two ways (the profiler's kernel time;
    CUDA events around launches queued behind a spin), with the wrapper
    call's time and the bound; then mixed groups at both widths (shifts,
    empty and odd streams, more than 8 streams, MAX_STREAMS streams, an
    output off the 16-byte grid, streams longer than one wave of tiles).
    `instructions`: a squares() word's, for the bound."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import prf_mask as PM
    kd = (int(rng.randint(0, 2**32)), int(rng.randint(0, 2**32)))
    cases = {
        "largest_group": [(kd, c, (BATCH, 784), 0) for c in range(3)],
        "lone_draw": [(kd, 3, (BATCH, 784), 0)],
        "lone_small_draw": [(kd, 4, (BATCH, 1), 0)],
        # lam_z (3) and the Pi_Zero streams (3) of each of 13 ANDs
        "adder_group_78": [(kd, 5 + c, (BATCH, 1), 0) for c in range(78)],
    }
    out = {}
    for name, draws in cases.items():
        sized = [(k, c, int(np.prod(shape)), sh) for k, c, shape, sh in draws]
        words = sum(n for _, _, n, _ in sized)
        ops.reset_launches()
        got = ops.lambda_masks_group(draws, torch.int64, dev, flat=True)
        check(ops.PRF_MASK.launches == 1,
              f"prf_mask ({name}, {len(draws)} streams): "
              f"{ops.PRF_MASK.launches} launches for one call")
        want = PM.prf_mask_group_plain(sized, torch.int64, dev)
        torch.cuda.synchronize()
        check(torch.equal(got, want),
              f"prf_mask disagrees with its plain version ({name})")
        raw = torch.empty(words, dtype=torch.int64, device=dev)
        b_ms, b_by = prf_bound(words, instructions)
        out[name] = {
            "streams": len(draws), "words": words,
            "ms": device_ms(lambda d=draws: ops.lambda_masks_group(
                d, torch.int64, dev), "squares_group_kernel", reps=50,
                warmup=5),
            "spin_gated": spin_gated_ms(
                lambda s=sized, r=raw: PM.launch_group(s, r)),
            "call_ms": cuda_ms(lambda d=draws: ops.lambda_masks_group(
                d, torch.int64, dev)),
            "host_ms": host_ms(lambda d=draws: ops.lambda_masks_group(
                d, torch.int64, dev), reps=200),
            "plain_ms": device_ms(lambda s=sized: PM.prf_mask_group_plain(
                s, torch.int64, dev)),
            "max_abs_err": (got - want).abs().max().item(),
            "bound_ms": b_ms, "bound_by": b_by,
            "bound_ms_bytes": 8 * words / HBM_BYTES_PER_S * 1e3,
            "bound_ms_int32_ops": None if instructions is None else
            instructions * words / INT32_OPS_PER_S * 1e3}
    # mixed groups against the plain version, both widths
    for dt in (torch.int64, torch.int32):
        ell = torch.iinfo(dt).bits
        shapes = [(BATCH * 784, 0), (5, ell - 1), (0, 0), (1000, 20), (3, 1),
                  (257, 0), (1, 4), (64, ell - 13), (0, 3), (511, 2)]
        mixed = [(kd, 2**32 + c, m, s) for c, (m, s) in
                 enumerate(shapes + shapes[1:])]
        wide = [(kd, 77 + c, 1 + (c * 37) % 300, c % 5) for c in
                range(PM.MAX_STREAMS)]
        # longer than one wave of tiles: the persistent loop, across streams
        long_ = [(kd, 9, 1 << 24, 0), (kd, 10, 7, 1), (kd, 11, (1 << 23) + 3,
                                                        0)]
        for what, group in (("mixed", mixed), ("MAX_STREAMS", wide),
                            ("longer than a wave", long_)):
            total = sum(m for _, _, m, _ in group)
            want = PM.prf_mask_group_plain(group, dt, dev)
            for skew in range(4):
                buf = torch.empty(total + skew, dtype=dt, device=dev)
                got = PM.prf_mask_group_cuda(group, buf[skew:])
                check(torch.equal(got, want),
                      f"prf_mask's grouped draw disagrees ({ell}-bit words, "
                      f"{what}, {len(group)} streams, output {skew} words "
                      f"off its allocation)")
    first = out["largest_group"]
    k = ops.PRF_MASK
    row = {"name": k.name, "route": "cuda", "source": k.source,
           "replaces": k.replaces, "launches": 0,
           **{f: first[f] for f in ("max_abs_err", "ms", "call_ms",
                                    "plain_ms", "bound_ms", "bound_by")},
           "library_ms": None, "ms_spin_gated": first["spin_gated"]["ms"],
           "word_instructions": instructions, "cases": out}
    return {k.name: row}


# the ppa_msb row's sizes: n = 4096 and an odd n, at both widths
MSB_SIZES = (4096, 1001)


def msb_rows(rng, dev) -> dict:
    """The ppa_msb row: the one-launch kernel (``ops.msb_of_sum_words``)
    against its plain version (the Python loop over and_level_plain, on
    the card) and the exact msb(x + y), on zero shares that XOR to 0 and
    on shares that do not (then against the loop alone), at MSB_SIZES and
    both widths; one launch a call; timed two ways (profiler, spin-gated
    events) beside the wrapper call, the plain loop and the earlier route
    (the loop over one and_level launch a level), with the bound by bytes
    (x, y, 2 L x 3 draws, the output: (2 + 6 L + 1) words an element)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import ppa_msb as PPA
    sizes = {}
    for dt in (torch.int64, torch.int32):
        ell = torch.iinfo(dt).bits
        L = int(np.log2(ell)) + 1
        lo, hi = -2**(ell - 1), 2**(ell - 1) - 1
        for n in MSB_SIZES:
            def words(*shape):
                return torch.from_numpy(rng.randint(
                    lo, hi, size=shape, dtype=np.int64)).to(dt).to(dev)
            x, y, lamz = words(n), words(n), words(L, 3, n)
            zero = torch.stack([lamz[:, 0], lamz[:, 1],
                                lamz[:, 0] ^ lamz[:, 1]], dim=1)
            for z, xor0 in ((zero, True), (words(L, 3, n), False)):
                ops.reset_launches()
                got = ops.msb_of_sum_words(x, y, lamz, z)
                check(ops.PPA_MSB.launches == 1 and ops.AND_LEVEL.launches
                      == 0, f"ppa_msb: {ops.PPA_MSB.launches} ppa_msb and "
                      f"{ops.AND_LEVEL.launches} and_level launches a call")
                loop = PPA.ppa_msb(x, y, lamz, z, PPA.and_level_plain)
                torch.cuda.synchronize()
                check(torch.equal(got, loop),
                      f"ppa_msb disagrees with its loop ({ell}-bit, n = {n},"
                      f" zero shares XOR to 0: {xor0})")
                if xor0:
                    exact = ((x + y) >> (ell - 1)) & 1
                    check(torch.equal(got, exact),
                          f"ppa_msb disagrees with the exact msb(x + y) "
                          f"({ell}-bit, n = {n})")
            b_ms, b_by = bound((2 + 2 * L * 3 + 1) * n * (ell // 8),
                               L * 2 * 30 * n)
            sizes[f"{ell}-bit n = {n}"] = {
                "ms": device_ms(lambda: PPA.ppa_msb_cuda(x, y, lamz, zero),
                                "ppa_msb_kernel", reps=50, warmup=5),
                "spin_gated": spin_gated_ms(
                    lambda: PPA.ppa_msb_cuda(x, y, lamz, zero)),
                "call_ms": cuda_ms(lambda: ops.msb_of_sum_words(
                    x, y, lamz, zero)),
                "plain_ms": device_ms(lambda: PPA.ppa_msb(
                    x, y, lamz, zero, PPA.and_level_plain)),
                "and_level_loop_ms": device_ms(lambda: PPA.ppa_msb(
                    x, y, lamz, zero, PPA.and_level_cuda)),
                "and_level_loop_call_ms": cuda_ms(lambda: PPA.ppa_msb(
                    x, y, lamz, zero, PPA.and_level_cuda), reps=10),
                "max_abs_err": 0, "bound_ms": b_ms, "bound_by": b_by}
    first = sizes[f"64-bit n = {MSB_SIZES[0]}"]
    k = ops.PPA_MSB
    return {k.name: {
        "name": k.name, "route": "cuda", "source": k.source,
        "replaces": k.replaces, "launches": 0,
        **{f: first[f] for f in ("max_abs_err", "ms", "call_ms", "plain_ms",
                                 "bound_ms", "bound_by")},
        "library_ms": None, "ms_spin_gated": first["spin_gated"]["ms"],
        "sizes": sizes}}


def kernel_phase(rng, ptxas: dict, prf_instructions: int | None) -> list:
    """Each kernel against its plain version at main-path shapes; `ptxas`:
    {source: compiler lines (registers, spills)} from the build;
    `prf_instructions`: a squares() word's (prf_mask's compute bound)."""
    import torch
    from repro_torch.kernels import gamma_parts as GP
    from repro_torch.kernels import mpc_matmul_fused as MF
    from repro_torch.kernels import ops
    from repro_torch.kernels import ppa_msb as PPA
    from repro_torch.kernels import ring_matmul as RM
    from repro_torch.kernels.build import launch

    dev = torch.device("cuda")

    def words(*shape):
        return torch.from_numpy(rng.randint(
            -2**63, 2**63 - 1, size=shape, dtype=np.int64)).to(dev)

    def words32(*shape):
        return torch.from_numpy(rng.randint(
            -2**31, 2**31 - 1, size=shape, dtype=np.int64).astype(
                np.int32)).to(dev)

    rows = {}

    def row(k, out, ref, timed, plain_ms, nbytes, ops_):
        """`timed` = (kernel call, name of its CUDA function, or None for
        every device operation of the call)."""
        torch.cuda.synchronize()
        check(torch.equal(out.cpu(), ref.cpu()),
              f"{k.name}: kernel disagrees with its plain version")
        b_ms, b_by = bound(nbytes, ops_)
        diff = (out.cpu() - ref.cpu()).abs().max().item()
        rows[k.name] = {
            "name": k.name, "route": "cuda", "source": k.source,
            "replaces": k.replaces, "launches": 0, "max_abs_err": diff,
            "ms": device_ms(*timed), "call_ms": cuda_ms(timed[0]),
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None}

    # prf_mask: one launch a draw group.  Its row is the main path's
    # largest group, the three lambda streams of the (128, 784) input
    # share, through the wrapper the paths call (ops.lambda_masks_group:
    # output allocated, one launch, keys derived on the card, a view per
    # stream); beside it a lone draw of the same size, a lone smx-sized
    # draw (128 words: the floor of a near-empty launch) and the joint
    # adder's group of 78 streams (13 ANDs x 6) of 128 words.
    rows.update(prf_rows(rng, dev, prf_instructions))

    # ring_matmul: layer 1's gamma piece, three terms fused on K; and
    # mpc_matmul_grid: layer 1's online 3x3 grid, (3*128, 784) @ (784,
    # 3*128) -- both the int8 tensor-core kernel of ring_matmul.cu
    for k, (M, K, N) in ((ops.RING_MATMUL, (BATCH, 3 * 784, 128)),
                         (ops.MPC_MATMUL_GRID, (3 * BATCH, 784, 3 * 128))):
        a, b = words(M, K), words(K, N)
        a_c, b_c = a.cpu(), b.cpu()
        row(k, RM.ring_matmul_cuda(a, b), RM.ring_matmul_plain(a_c, b_c),
            (lambda: RM.ring_matmul_cuda(a, b), "ring_matmul_kernel"),
            host_ms(lambda: RM.ring_matmul_plain(a_c, b_c)), 0, 0)
        r = rows[k.name]
        r.update(ring_matmul_bound(M, K, N))
        r["shape"] = f"{M}x{K}x{N}"
        r["k_chunk"] = RM.k_chunk(M, N, K, RM._sm_count(dev))
        # the kernel alone (the wrapper may zero its output first), read
        # without the profiler
        acc = torch.zeros((M, N), dtype=torch.int64, device=dev)
        r["spin_gated"] = spin_gated_ms(lambda: launch(
            "ring_matmul", "ring_matmul_u64", dev, a.data_ptr(), b.data_ptr(),
            acc.data_ptr(), M, N, K, r["k_chunk"]))
        r["ms_spin_gated"] = r["spin_gated"]["ms"]
        r["ptxas"] = ptxas.get("ring_matmul", [])
        r["phases"] = ring_matmul_phases(M, N, K, r["k_chunk"], dev)
        r["yardstick_int_mm_limb_planes"] = int_mm_yardstick(M, K, N, dev)
    # all-ones words maximise every limb sum: K past one chunk of the
    # exactness bound (two chunks meeting by atomicAdd), held against
    # torch.matmul on the CPU
    for dt in (torch.int64, torch.int32):
        K = RM.max_k_chunk(torch.iinfo(dt).bits) + 64
        a = torch.full((BATCH, K), -1, dtype=dt)
        b = torch.full((K, 128), -1, dtype=dt)
        check(torch.equal(RM.ring_matmul_cuda(a.to(dev), b.to(dev)).cpu(),
                          RM.ring_matmul_plain(a, b)),
              f"ring_matmul disagrees on all-ones words at K = {K} "
              f"({dt})")

    # the batched entry (kernel route K2): phase lm's part (a), and phase
    # lm-recurrent's (the profiler reads a kernel's device time reliably
    # here, before the paths' many profiled windows)
    rows.update(batched_rows(rng, dev))
    rows[ops.RING_MATMUL_BATCHED.name]["recurrent_shapes"] = \
        recurrent_k2_rows(np.random.RandomState(LM_SEED))
    rows[ops.RING_MATMUL_BATCHED.name]["train_shapes"] = recurrent_k2_rows(
        np.random.RandomState(LM_SEED), LMRT_K2_SHAPES, "lm-recurrent-train")
    # the 2-D entry at the LM's shapes (phases lm and lm-train)
    rows[ops.RING_MATMUL.name]["lm_shapes"] = lm_matmul_rows(
        np.random.RandomState(LM_SEED))

    # mult_terms / and_terms: the grouped gamma-piece kernel, held against
    # its plain version on ragged, unaligned, broadcast, expanded and
    # 32-bit groups and over more groups than one launch takes; then its
    # rows at the main path's round launches (``round_rows``)
    check_grouped_cases(rng, dev)
    rows.update(round_rows(dev))

    # mpc_matmul_fused: the collapsed secure matmuls of the three layers,
    # on the limb core (quadrants x K chunks in one launch); the first,
    # 128x784x128, is the row
    fit = rows[ops.RING_MATMUL.name]["phases"]
    shapes = []
    for M, K, N in FUSED_SHAPES:
        mm_in = (words(M, K), words(3, M, K), words(K, N), words(3, K, N))
        shapes.append(fused_shape_row(MF, mm_in, [t.cpu() for t in mm_in],
                                      fit, dev))
    k = ops.MPC_MATMUL_FUSED
    rows[k.name] = {
        "name": k.name, "route": "cuda", "source": k.source,
        "replaces": k.replaces, "launches": 0,
        **{f: shapes[0][f] for f in ("max_abs_err", "ms", "call_ms",
                                     "plain_ms", "bound_ms", "bound_by")},
        "library_ms": None, "shapes": shapes,
        "ptxas": ptxas.get("mpc_matmul_fused", [])}
    # all-ones words maximise every limb sum: chunks at the exactness
    # bound, K past one of them, quadrants and chunks meeting by atomicAdd
    for dt in (torch.int64, torch.int32):
        top = RM.max_k_chunk(torch.iinfo(dt).bits)
        K = top + 64
        ones = (torch.full((BATCH, K), -1, dtype=dt),
                torch.full((3, BATCH, K), -1, dtype=dt),
                torch.full((K, 10), -1, dtype=dt),
                torch.full((3, K, 10), -1, dtype=dt))
        got = MF.mpc_matmul_fused_cuda(*(t.to(dev) for t in ones),
                                       chunk=top)
        check(all(torch.equal(g.cpu(), w) for g, w in zip(
            got, MF.mpc_matmul_fused_plain(*ones))),
            f"mpc_matmul_fused disagrees on all-ones words at K = {K} in "
            f"chunks of {top} ({dt})")
    # phase launch's shapes (the whisper-tiny step's weight gradients),
    # timed here, where the profiler reads a kernel's device time reliably
    rows[ops.MPC_MATMUL_FUSED.name]["launch_shapes"] = launch_fused_rows(
        launch_fused_shapes())

    # and_level: the main path's launches are whole chains on smx's words
    # of (128, 1) -- the Sklansky adder (A2B's subtractor, cin = 1) and the
    # prefix-OR -- faithful (6 draws an AND) and collapsed (3); each held
    # against its plain version at n = 128 and 2^20 and on 32-bit words;
    # the adder's faithful launch at n = 128 is the row.  Beside them the
    # single level (the ppa_msb driver's and the lone ANDs' launch).
    rows.update(and_level_rows(words, words32, dev))
    lv = [words(4, BATCH), words(4, BATCH), words(3, BATCH),
          words(3, BATCH)]
    single = {"ms": device_ms(lambda: PPA.and_level_cuda(*lv),
                              "and_level_kernel"),
              "call_ms": cuda_ms(lambda: ops.and_level(*lv)),
              "plain_ms": device_ms(lambda: PPA.and_level_plain(*lv))}
    check(torch.equal(PPA.and_level_cuda(*lv), PPA.and_level_plain(*lv)),
          "and_level disagrees with its plain version (one level)")
    big = [words(4, BIG_N), words(4, BIG_N), words(3, BIG_N),
           words(3, BIG_N)]
    check(torch.equal(PPA.and_level_cuda(*big), PPA.and_level_plain(*big)),
          "and_level disagrees at n = 2^20")
    check(torch.equal(PPA.and_level_cuda(*big[:3]),
                      PPA.and_level_plain(*big[:3])),
          "and_level disagrees with zero = None (collapsed) at n = 2^20")
    b_ms, b_by = bound(8 * 18 * BIG_N, 30 * BIG_N)
    single["at_n_2^20"] = {
        "ms": device_ms(lambda: PPA.and_level_cuda(*big), "and_level_kernel"),
        "plain_ms": device_ms(lambda: PPA.and_level_plain(*big)),
        "bound_ms": b_ms, "bound_by": b_by}
    rows[ops.AND_LEVEL.name]["single_level"] = single
    lv32 = [words32(4, 5000), words32(4, 5000), words32(3, 5000),
            words32(3, 5000)]
    check(torch.equal(PPA.and_level_cuda(*lv32), PPA.and_level_plain(*lv32)),
          "and_level disagrees on 32-bit words")

    # ppa_msb: the whole Sklansky msb(x + y) in one launch
    rows.update(msb_rows(rng, dev))

    # 32-bit ring words through the same sources (not on the main path)
    a32 = torch.from_numpy(rng.randint(-2**31, 2**31 - 1, size=(70, 300),
                                       dtype=np.int64).astype(np.int32))
    b32 = torch.from_numpy(rng.randint(-2**31, 2**31 - 1, size=(300, 65),
                                       dtype=np.int64).astype(np.int32))
    check(torch.equal(RM.ring_matmul_cuda(a32.to(dev), b32.to(dev)).cpu(),
                      RM.ring_matmul_plain(a32, b32)),
          "ring_matmul disagrees on 32-bit words")
    g32 = [torch.from_numpy(rng.randint(-2**31, 2**31 - 1, size=s,
                                        dtype=np.int64).astype(np.int32))
           for s in ((2, 3, 1000), (2, 3, 1000), (2, 1000))]
    g32_dev = [t.to(dev) for t in g32]
    check(torch.equal(ops.mult_terms(*g32_dev, (1, -1, 1)).cpu(),
                      GP.mult_terms_plain(*g32, (1, -1, 1))),
          "mult_terms disagrees on 32-bit words (stacked form)")
    check(torch.equal(ops.and_terms(*g32_dev).cpu(),
                      GP.and_terms_plain(*g32)),
          "and_terms disagrees on 32-bit words (stacked form)")
    m32 = (words32(70, 300), words32(3, 70, 300), words32(300, 65),
           words32(3, 300, 65))
    check(all(torch.equal(g.cpu(), w) for g, w in zip(
        MF.mpc_matmul_fused_cuda(*m32),
        MF.mpc_matmul_fused_plain(*(t.cpu() for t in m32)))),
        "mpc_matmul_fused disagrees on 32-bit words")
    return [rows[k.name] for k in ops.KERNELS]


def device_ops(fn, reps: int = 20, warmup: int = 2) -> tuple:
    """(device ms, device operations) per call of `fn`, every device
    operation of the call counted, from the profiler's CUDA activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.key_averages() if e.device_time_total > 0]
    check(evs, f"the profiler saw no device time for {fn}")
    return (sum(e.device_time_total for e in evs) / reps / 1e3,
            sum(e.count for e in evs) / reps)


def check_grouped_cases(rng, dev) -> None:
    """The grouped gamma-piece kernel against its plain version on groups
    that cycle through 1-3 term pairs, 0-2 constants, signs, ragged word
    counts, views one word into a buffer (unaligned), one-word (broadcast)
    operands and expanded views, on 64- and 32-bit words, over 1, 9 and
    37 groups (three launches)."""
    import torch
    from repro_torch.kernels import gamma_parts as GP
    from repro_torch.kernels import ops
    for dt in (torch.int64, torch.int32):
        info = torch.iinfo(dt)

        def words(*shape):
            return torch.from_numpy(rng.randint(
                info.min, info.max, size=shape, dtype=np.int64)).to(dt)

        for count in (1, 9, 2 * GP.MAX_GROUPS + 5):
            cpu, card = [], []
            for k in range(count):
                T, nc = 1 + k % 3, k % 3
                n = (1, 5, 128, 1000, 16385)[k % 5]
                shape = (n,) if k % 4 else (n // 5 + 1, 5)
                opnds = []
                for slot in range(2 * T + nc):
                    if (slot + k) % 5 == 0:
                        w = words(*(1,) * len(shape))
                        opnds.append((w, w.to(dev)))
                    elif len(shape) == 2 and (slot + k) % 5 == 1:
                        w = words(shape[0], 1)
                        opnds.append((w.expand(shape),
                                      w.to(dev).expand(shape)))
                    elif k % 2:
                        w = words(int(np.prod(shape)) + 1)
                        opnds.append((w[1:].view(shape),
                                      w.to(dev)[1:].view(shape)))
                    else:
                        w = words(*shape)
                        opnds.append((w, w.to(dev)))
                signs = tuple(-1 if (k + t) % 2 else 1 for t in range(T))
                for side, out in ((0, cpu), (1, card)):
                    v = [o[side] for o in opnds]
                    out.append(([(v[2 * t], v[2 * t + 1])
                                 for t in range(T)], tuple(v[2 * T:]),
                                signs))
            for xor in (False, True):
                kern = ops.AND_TERMS if xor else ops.MULT_TERMS
                before = kern.launches
                if xor:
                    got = ops.and_terms_group([g[:2] for g in card])
                    want = GP.and_terms_group_plain(cpu)
                else:
                    got = ops.mult_terms_group(card)
                    want = GP.mult_terms_group_plain(cpu)
                check(kern.launches - before == -(-count // GP.MAX_GROUPS),
                      f"{kern.name}: {kern.launches - before} launches for "
                      f"{count} groups")
                torch.cuda.synchronize()
                for k, (g, w) in enumerate(zip(got, want)):
                    check(torch.equal(g.cpu(), w),
                          f"{kern.name} disagrees with its plain version: "
                          f"group {k} of {count}, {dt}")


def _flat(shape, *arrs):
    import torch
    return torch.stack([torch.broadcast_to(a, shape).reshape(-1)
                        for a in arrs])


def per_party_gamma(lam_x, lam_y, masks, js, xor: bool) -> dict:
    """One party's gamma pieces as the runtime computed them before the
    round call: its operands staged into (J, 3, n) stacks, one stacked
    launch (the same kernel), the pieces cut out."""
    import torch
    from repro_torch.core.algebra import GAMMA_TERMS
    from repro_torch.kernels import ops
    terms = {j: GAMMA_TERMS[j] for j in js}
    p0, q0 = terms[js[0]][0]
    full = torch.broadcast_shapes(lam_x[p0].shape, lam_y[q0].shape)
    a = torch.stack([_flat(full, *(lam_x[p] for p, _ in terms[j]))
                     for j in js])
    b = torch.stack([_flat(full, *(lam_y[q] for _, q in terms[j]))
                     for j in js])
    c = torch.stack([torch.broadcast_to(masks[j], full).reshape(-1)
                     for j in js])
    s = ops.and_terms(a, b, c) if xor else ops.mult_terms(a, b, c,
                                                          (1, 1, 1))
    return {j: s[k].reshape(full) for k, j in enumerate(js)}


def per_party_online(m_x, m_y, lam_x, lam_y, gammas, lam_zs, js,
                     xor: bool) -> tuple:
    """One party's online parts and m_x op m_y as the runtime computed them
    before the round call: staging, one stacked launch, then the combine
    with gamma_j and lambda_z_j."""
    import torch
    from repro_torch.kernels import ops
    full = torch.broadcast_shapes(m_x.shape, m_y.shape)
    zero = torch.zeros((), dtype=m_x.dtype, device=m_x.device)
    a = torch.stack([_flat(full, lam_x[j], m_x) for j in js]
                    + [_flat(full, m_x, zero)])
    b = torch.stack([_flat(full, m_y, lam_y[j]) for j in js]
                    + [_flat(full, m_y, zero)])
    if xor:
        c = torch.stack([torch.broadcast_to(gammas[j] ^ lam_zs[j],
                                            full).reshape(-1) for j in js]
                        + [torch.zeros(full, dtype=m_x.dtype,
                                       device=m_x.device).reshape(-1)])
        s = ops.and_terms(a, b, c)
        parts = {j: s[k].reshape(full) for k, j in enumerate(js)}
    else:
        c = torch.zeros((a.shape[0], a.shape[2]), dtype=a.dtype,
                        device=a.device)
        s = ops.mult_terms(a, b, c, (1, 1))
        parts = {j: gammas[j] + lam_zs[j] - s[k].reshape(full)
                 for k, j in enumerate(js)}
    return s[len(js)].reshape(full), parts


def capture_rounds(dev) -> dict:
    """The backend round calls of one Pi_Mult on (128, 128) words (BitExt's
    shape at the hidden layers) and one AND on (128, 1) words (smx's adder),
    run on the card through a runtime whose backend records them:
    {(round, world): (op, requests)}."""
    import torch
    from repro_torch.core.ring import RING64
    from repro_torch.runtime import FourPartyRuntime
    from repro_torch.runtime import boolean as RB
    from repro_torch.runtime import protocols as RP
    from repro_torch.runtime.kernel_backend import HopperKernels

    class Recorder(HopperKernels):
        def __init__(self):
            super().__init__()
            self.rounds = {}

        def gamma_pieces_round(self, kind, op, requests):
            self.rounds[("offline", kind)] = (op, requests)
            return super().gamma_pieces_round(kind, op, requests)

        def online_parts_round(self, kind, op, requests):
            self.rounds[("online", kind)] = (op, requests)
            return super().online_parts_round(kind, op, requests)

        def bool_gamma_pieces_round(self, requests):
            self.rounds[("offline", "bool")] = (None, requests)
            return super().bool_gamma_pieces_round(requests)

        def bool_online_parts_round(self, requests):
            self.rounds[("online", "bool")] = (None, requests)
            return super().bool_online_parts_round(requests)

    rec = Recorder()
    rt = FourPartyRuntime(RING64, seed=SEED, kernel_backend=rec,
                          device=dev)
    gen = torch.Generator().manual_seed(SEED)
    x, y = (RP.share(rt, torch.randint(-2**40, 2**40, (BATCH, 128),
                                       generator=gen)) for _ in range(2))
    RP.mult(rt, x, y)
    a, b = (RB.vsh_bool(rt, lambda p, v=v: v, (1, 2), (BATCH, 1),
                        tag=rt.next_tag("in"))
            for v in (torch.randint(-2**62, 2**62, (BATCH, 1),
                                    generator=gen).to(dev)
                      for _ in range(2)))
    RB.and_bshare(rt, a, b)
    check(not rt.abort_flag(), "the captured mult and AND aborted")
    return rec.rounds


def terms_bound(groups) -> tuple:
    """(unique bytes, bound ms, bound by) of one grouped gamma-piece
    launch: each distinct operand read once, each output written once;
    2 operations a term pair and 1 a constant per output word."""
    from repro_torch.kernels import gamma_parts as GP
    seen = {}
    for pairs, consts, *_ in groups:
        for t in (*(v for pr in pairs for v in pr), *consts):
            seen[t.data_ptr()] = max(seen.get(t.data_ptr(), 0),
                                     t.numel() * t.element_size())
    shapes = [GP.group_shape(g) for g in groups]
    n_out = sum(int(np.prod(sh)) for sh in shapes)
    nbytes = sum(seen.values()) + 8 * n_out
    nops = sum(int(np.prod(sh)) * (2 * len(g[0]) + len(g[1]))
               for sh, g in zip(shapes, groups))
    return (nbytes, *bound(nbytes, nops))


def round_rows(dev) -> dict:
    """The mult_terms and and_terms rows: each round launch of the main
    path's Pi_Mult (6 groups x 3 terms offline, 9 groups online at
    (128, 128)) and AND (the same at (128, 1)), from requests captured on
    the card.  For each round: the round call's results against the
    per-party sequence's (staging stacks, one stacked launch per party,
    the combine) and the plain version's; the launch's device time, the
    round call's time and device operations beside the per-party
    sequence's; the bound from the unique bytes the launch moves."""
    import torch
    from repro_torch.kernels import gamma_parts as GP
    from repro_torch.kernels import ops
    from repro_torch.runtime.kernel_backend import (HopperKernels,
                                                    gamma_groups,
                                                    online_groups)
    rounds = capture_rounds(dev)
    hk = HopperKernels()
    out = {}
    for kern, world, xor in ((ops.MULT_TERMS, "mul", False),
                             (ops.AND_TERMS, "bool", True)):
        info = {}
        for stage in ("offline", "online"):
            op, reqs = rounds[(stage, world)]
            if stage == "offline":
                groups = gamma_groups(reqs, xor)
                new = (lambda reqs=reqs: hk.bool_gamma_pieces_round(reqs)) \
                    if xor else \
                    (lambda reqs=reqs, op=op: hk.gamma_pieces_round(
                        "mul", op, reqs))

                def old(reqs=reqs, xor=xor):
                    return [per_party_gamma(*r, xor=xor) for r in reqs]

                def flat(res):
                    return [t for d in res for t in d.values()]
            else:
                groups = online_groups(reqs, xor)
                new = (lambda reqs=reqs: hk.bool_online_parts_round(reqs)) \
                    if xor else \
                    (lambda reqs=reqs, op=op: hk.online_parts_round(
                        "mul", op, reqs))

                def old(reqs=reqs, xor=xor):
                    return [per_party_online(*r, xor=xor) for r in reqs]

                def flat(res):
                    return [t for mm, parts in res
                            for t in (*parts.values(), mm)]
            plain = GP.and_terms_group_plain if xor else \
                GP.mult_terms_group_plain

            def launch_only(g=groups, xor=xor):
                return (ops.and_terms_group if xor else
                        ops.mult_terms_group)(g)
            got, was, ref = flat(new()), flat(old()), plain(groups)
            torch.cuda.synchronize()
            check(len(got) == len(was) == len(ref) == len(groups) and all(
                torch.equal(g, w) and torch.equal(g, r)
                for g, w, r in zip(got, was, ref)),
                f"{kern.name}: the {stage} round call disagrees with the "
                f"per-party sequence or the plain version")
            nbytes, b_ms, b_by = terms_bound(groups)
            shapes = [GP.group_shape(g) for g in groups]
            old_ms, old_n = device_ops(old)
            new_ms, new_n = device_ops(new)
            info[stage] = {
                "groups": len(groups),
                "terms": [len(g[0]) for g in groups],
                "shape": list(shapes[0]),
                "ms": device_ms(launch_only, "terms_group_kernel"),
                "call_ms": cuda_ms(new),
                "launch_call_ms": cuda_ms(launch_only),
                "device_ms_all_ops": new_ms, "device_ops": new_n,
                "plain_ms": device_ms(lambda g=groups, f=plain: f(g)),
                "bound_ms": b_ms, "bound_by": b_by,
                "unique_bytes": nbytes,
                "per_party": {"device_ms": old_ms, "device_ops": old_n,
                              "call_ms": cuda_ms(old)}}
        off = info["offline"]
        out[kern.name] = {
            "name": kern.name, "route": "cuda", "source": kern.source,
            "replaces": kern.replaces, "launches": 0, "max_abs_err": 0,
            "ms": off["ms"], "call_ms": off["call_ms"],
            "plain_ms": off["plain_ms"], "bound_ms": off["bound_ms"],
            "bound_by": off["bound_by"], "library_ms": None,
            "rounds": info}
    return out


def forward_float64(params: dict, X: np.ndarray) -> np.ndarray:
    """The NN in float64 numpy with relu / (sum relu + 0.01) as smx."""
    h = X
    n = len(params)
    for i in range(n):
        h = h @ params[f"w{i}"]
        if i < n - 1:
            h = np.maximum(h, 0.0)
    r = np.maximum(h, 0.0)
    return r / (r.sum(axis=-1, keepdims=True) + 1e-2)


def serve(device: str, backend: str, params: dict, net, queries) -> tuple:
    import torch
    from repro_torch.core.ring import RING64
    from repro_torch.serve.party_server import PartyPredictionServer
    from repro_torch.train.paper_ml import (mlp_net_predict_runtime,
                                            params_from_numpy)

    enc = params_from_numpy(params, RING64, device)
    srv = PartyPredictionServer(
        lambda rt, X: mlp_net_predict_runtime(rt, enc, net, X),
        batch_size=BATCH, seed=SEED, kernel_backend=backend, device=device)
    for q in queries:
        srv.submit(q)
    words = torch.stack(srv.flush())
    srv.close()
    return srv, words


def serve_joint(device: str, params: dict, net, queries) -> tuple:
    """Joint path A: the joint simulation's PredictionServer, faithful
    mode, Newton-Raphson division (the runtime's program)."""
    import torch
    from repro_torch.core.ring import RING64
    from repro_torch.serve.engine import PredictionServer
    from repro_torch.train.paper_ml import (mlp_net_predict_joint,
                                            params_from_numpy)

    enc = params_from_numpy(params, RING64, device)
    srv = PredictionServer(
        lambda ctx, X: mlp_net_predict_joint(ctx, enc, net, X),
        batch_size=BATCH, seed=SEED, device=device)
    for q in queries:
        srv.submit(q)
    words = torch.stack(srv.flush())
    return srv, words


def predict_collapsed(device: str, params: dict, net, X) -> tuple:
    """Joint path B: one batch on a collapsed context (the entry the JAX
    package's launch/steps.py uses)."""
    from repro_torch.core.context import make_context
    from repro_torch.core.ring import RING64
    from repro_torch.train.paper_ml import (mlp_net_predict_joint,
                                            params_from_numpy)

    ctx = make_context(RING64, SEED, collapse=True, device=device)
    words = mlp_net_predict_joint(
        ctx, params_from_numpy(params, RING64, device), net, X).cpu()
    return ctx, words


def profile_batch(label: str, run, steady_wall_s: float,
                  unit: str = "batch", by_name: dict | None = None) -> tuple:
    """One more batch (`run()`; a training step where `unit` says so)
    under the profiler (CUDA activity): device busy time against the
    unprofiled steady wall, and device time by kernel name (into
    `by_name`, ms by profiler key, where given).  Returns (busy ms, device
    operations)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    # an empty window is taken again, as in device_kernels
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        evs = sorted(prof.key_averages(),
                     key=lambda e: -e.device_time_total)
        busy_ms = sum(e.device_time_total for e in evs) / 1e3
        if busy_ms > 0:
            break
        print(f"profiled {label} {unit}: the profiler saw no device time; "
              f"once more")
        time.sleep(0.5)
    check(busy_ms > 0, f"the profiler saw no device time in the {label} "
          f"{unit}")
    # device operations (kernels, copies, fills) against every profiler
    # event, which also counts the host's runtime API calls (launches,
    # copies, synchronizations)
    device_ops = sum(e.count for e in evs if e.device_time_total > 0)
    events = sum(e.count for e in evs)
    if by_name is not None:
        by_name.update({e.key: e.device_time_total / 1e3 for e in evs})
    print(f"profiled {label} {unit}: device busy {busy_ms:.3f} ms in "
          f"{device_ops} device ops ({events} profiler events with the "
          f"runtime API calls); wall {wall * 1e3:.1f} ms profiled, "
          f"{steady_wall_s * 1e3:.1f} ms unprofiled -> busy share "
          f"{busy_ms / (steady_wall_s * 1e3):.4f} of the unprofiled wall")
    for e in evs[:16]:
        print(f"  {e.device_time_total / 1e3:9.3f} ms {e.count:6d}x "
              f"{e.key[:90]}")
    for e in evs[16:]:
        if "terms_group_kernel" in e.key:
            print(f"  {e.device_time_total / 1e3:9.3f} ms {e.count:6d}x "
                  f"{e.key[:90]}")
    return busy_ms, device_ops


def tensor_core_instructions(build, source: str) -> tuple | None:
    """(GMMA, IGMMA) counts of warpgroup MMA instructions in the SASS of
    one source's library, the integer ones being IGMMA; None where the
    toolkit has no cuobjdump."""
    text = sass(build, source)
    if text is None:
        return None
    lines = [ln for ln in text.splitlines() if "GMMA" in ln]
    return len(lines), sum("IGMMA" in ln for ln in lines)


def drive(path: str, kernels: list, needed: tuple, run, batches: int,
          unit: str = "batch", threads: int = 1):
    """Run one path (`batches` batches, or training steps where `unit`
    says so) with every launch count set to 0 just before it; read the
    counts just after, add them to the kernel rows, and fail if a kernel
    of the path was not launched, or (one thread drawing: two threads may
    lose each other's counts) if a prf_mask call was not one launch."""
    import torch
    from repro_torch.kernels import ops
    ops.reset_launches()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in ops.KERNELS}
    for k in kernels:
        k["launches"] += launches[k["name"]]
        k.setdefault("launches_by_path", {})[path] = launches[k["name"]]
        if k["name"] == ops.PRF_MASK.name:
            k.setdefault("streams_by_path", {})[path] = ops.PRF_MASK.streams
    missing = [n for n in needed if launches[n] == 0]
    check(not missing, f"{path}: kernels of the path not launched: "
          f"{missing} ({launches})")
    check(threads > 1 or ops.PRF_MASK.launches == ops.PRF_MASK.calls,
          f"{path}: {ops.PRF_MASK.launches} prf_mask launches for "
          f"{ops.PRF_MASK.calls} draw groups")
    print(f"{path}: {wall:.3f} s; launches "
          f"{ {n: c for n, c in launches.items() if c} }")
    print(f"{path}: prf_mask {ops.PRF_MASK.launches / batches:g} launches "
          f"for {ops.PRF_MASK.calls / batches:g} draw groups and "
          f"{ops.PRF_MASK.streams / batches:g} streams per {unit}")
    return out, wall


def check_calls(path: str, kernels: list, batches: int) -> None:
    """The joint paths' whole-chain and_level, mpc_matmul_fused and
    prf_mask launches a batch on the card against the wrapper calls a batch
    of the CPU run just made (plain versions; each call is the launch the
    card makes)."""
    from repro_torch.kernels import ops
    for k in (ops.AND_LEVEL, ops.MPC_MATMUL_FUSED, ops.PRF_MASK):
        on_card = next(r for r in kernels if r["name"] == k.name)[
            "launches_by_path"][path] / batches
        check(on_card == k.calls / batches,
              f"{path}: {k.name} {on_card:g} launches a batch on the card, "
              f"{k.calls / batches:g} wrapper calls a batch on the CPU")
        print(f"{path}: {k.name} {on_card:g} launches a batch, equal to the "
              f"CPU run's wrapper calls")


def check_probs(path: str, words, want: np.ndarray) -> None:
    from repro_torch.core.ring import RING64
    probs = RING64.decode(words.cpu()).numpy()
    check(probs.shape == want.shape and np.isfinite(probs).all(),
          f"{path}: probabilities are not finite or of the wrong shape")
    err = float(np.abs(probs - want).max())
    check(err <= PROB_ATOL, f"{path}: probabilities off by {err} > "
          f"{PROB_ATOL}")
    print(f"{path}: probabilities within {err:.3e} of the float64 forward "
          f"pass (tolerance {PROB_ATOL})")


def dotp_rounds(dev) -> dict:
    """Pi_DotP's two rounds on the "hopper" backend (kernel route K1: one
    grouped mult_terms launch a round, the last axis contracted after) at
    a main-path-like shape, (128, 784) . (128, 784): the words on the card
    against the "torch" backend's on the CPU, one launch a round, and the
    launch's and the round call's times."""
    import torch
    from repro_torch.core.algebra import GAMMA_LOCAL, PART_HOLDERS
    from repro_torch.kernels import ops
    from repro_torch.runtime.kernel_backend import (HopperKernels,
                                                    TorchKernels,
                                                    gamma_groups,
                                                    online_groups)
    gen = torch.Generator().manual_seed(SEED)

    def words(*shape):
        return torch.randint(-2**62, 2**62, shape, generator=gen)

    def dot(a, b):
        return torch.sum(a * b, dim=-1, dtype=a.dtype)

    lx, ly = ({j: words(BATCH, 784) for j in (1, 2, 3)} for _ in range(2))
    masks, gammas, lam_zs = ({j: words(BATCH) for j in (1, 2, 3)}
                             for _ in range(3))
    mx, my = words(BATCH, 784), words(BATCH, 784)
    gamma_reqs = [(lx, ly, masks, (1, 2, 3))] + [
        (lx, ly, masks, (j,)) for j in GAMMA_LOCAL]
    online_reqs = [(mx, my, lx, ly, gammas, lam_zs,
                    tuple(j for j in (1, 2, 3) if p in PART_HOLDERS[j]))
                   for p in (1, 2, 3)]

    def on(reqs):
        return [tuple(({j: t.to(dev) for j, t in x.items()}
                       if isinstance(x, dict) else
                       x.to(dev) if torch.is_tensor(x) else x) for x in r)
                for r in reqs]

    hk, tk = HopperKernels(), TorchKernels()
    out = {}
    for stage, reqs, groups in (
            ("offline", gamma_reqs, gamma_groups(gamma_reqs, consts=False)),
            ("online", online_reqs, online_groups(online_reqs,
                                                  consts=False))):
        call = (hk.gamma_pieces_round if stage == "offline"
                else hk.online_parts_round)
        plain = (tk.gamma_pieces_round if stage == "offline"
                 else tk.online_parts_round)
        dreqs = on(reqs)
        ops.reset_launches()
        got = call("dotp", dot, dreqs)
        check(ops.MULT_TERMS.launches == 1,
              f"dotp {stage} round: {ops.MULT_TERMS.launches} mult_terms "
              f"launches, not 1")
        want = plain("dotp", dot, reqs)

        def flat(res):
            return [t for r in res for t in
                    ((*r[1].values(), r[0]) if isinstance(r, tuple)
                     else r.values())]
        torch.cuda.synchronize()
        check(all(torch.equal(g.cpu(), w)
                  for g, w in zip(flat(got), flat(want))),
              f"dotp {stage} round: the card's words differ from the "
              f"'torch' backend's on the CPU")
        copies = {}

        def card(t):
            if id(t) not in copies:
                copies[id(t)] = t.to(dev)
            return copies[id(t)]
        dgroups = [([(card(a), card(b)) for a, b in pairs], consts, signs)
                   for pairs, consts, signs in groups]
        # unique bytes: each distinct operand read once, each output
        # written once
        seen = {id(t): t.numel() * t.element_size()
                for pairs, _, _ in groups for pr in pairs for t in pr}
        n_out = sum(BATCH * 784 for _ in groups)
        b_ms, b_by = bound(sum(seen.values()) + 8 * n_out,
                           sum(BATCH * 784 * 2 * len(g[0]) for g in groups))
        out[stage] = {
            "groups": len(groups),
            "ms": device_ms(lambda g=dgroups: ops.mult_terms_group(g),
                            "terms_group_kernel"),
            "call_ms": cuda_ms(lambda: call("dotp", dot, dreqs), reps=20),
            "plain_cpu_ms": host_ms(lambda: plain("dotp", dot, reqs)),
            "bound_ms": b_ms, "bound_by": b_by}
        print(f"dotp {stage} round (K1), {len(groups)} groups of "
              f"{BATCH}x784 words: equal to the CPU's 'torch' backend; "
              f"launch {out[stage]['ms']:.5f} ms on the device (bound "
              f"{b_ms:.5f} ms by {b_by}), round call "
              f"{out[stage]['call_ms']:.5f} ms, CPU plain "
              f"{out[stage]['plain_cpu_ms']:.3f} ms")
    return out


def check_prep_handoff(dev, n: int = 1 << 20,
                       spin_cycles: int = 200_000_000) -> dict:
    """The store handoff between two streams, under stress (a dealt store
    is read on another stream than the one that wrote it, with no host
    wait between).  `deal` itself reads its abort flag, which waits for the
    dealer's stream, so on the served paths the ready event has always
    fired before a consumer gets the store; here nothing waits on the host:

    (a) the dealer stream writes a store's words behind a spin of
        `spin_cycles` (torch.cuda._sleep); the consumer pops the store and
        reads the words at once.  Without the wait on `store.ready` the
        read sees the words' earlier value (-1).
    (b) the dealer stream writes the words at once; the consumer pops
        them and holds its read behind a spin; the host drops every
        reference, and the dealer stream allocates blocks of the same size
        and writes -2 into them.  Without `record_stream` the allocator
        gives the dealer the blocks the consumer is about to read.

    Fails unless both reads give the dealt words."""
    import torch
    from repro_torch.offline import OnlinePrep, PrepStore

    want = torch.arange(4 * n, dtype=torch.int64).view(4, n) * 3 + 1
    side = torch.cuda.Stream(dev)
    out = {}
    # a first pass with no spins loads every kernel these cases launch (a
    # module loaded lazily mid-case would wait for the spinning stream)
    for case in ("warm-up", "a", "b"):
        # set-up, not the handoff: an idle card and an empty cache, so the
        # dealer's freed blocks are the only ones of their size (b)
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        store = PrepStore()
        with torch.cuda.stream(side):
            recs = [torch.full((n,), -1, dtype=torch.int64, device=dev)
                    for _ in range(4)]
            torch.cuda._sleep(spin_cycles if case == "a" else 1)
            for i, r in enumerate(recs):
                torch.arange(i * n, (i + 1) * n, out=r)
                r.mul_(3).add_(1)
            store.put("handoff#0", "handoff", [{"w": r} for r in recs])
            store.mark_ready(dev)
        del recs, r
        parts = OnlinePrep(store, dev).acquire("handoff#0", "handoff", None)
        dealer_busy = not side.query()
        torch.cuda._sleep(spin_cycles if case == "b" else 1)
        got = torch.stack([p["w"] for p in parts])
        del parts
        if case == "b":
            with torch.cuda.stream(side):
                scribble = [torch.full((n,), -2, dtype=torch.int64,
                                       device=dev) for _ in range(8)]
            del scribble
        check(torch.equal(got.cpu(), want),
              f"handoff ({case}): the consumer read other words than the "
              "dealt ones")
        if case != "warm-up":
            out[case] = {"dealer_busy_at_pop": dealer_busy}
    check(out["a"]["dealer_busy_at_pop"],
          "handoff (a): the dealer's stream was idle when the store was "
          "popped: the check did not test the wait")
    torch.cuda.synchronize(dev)
    print(f"handoff under stress: a store popped while its dealer stream "
          f"still spun ({out['a']}) read the dealt words (ready event); "
          f"popped blocks freed on the host and scribbled by the dealer "
          f"stream while the read waited ({out['b']}) read the dealt words "
          f"(record_stream)")
    return out


def offline_online_phase(params, net, X, kernels, srv, words) -> dict:
    """The offline-online split of the runtime path at its width: deal one
    batch, save and load the store, run it online-only, and serve three
    batches through the pipelined server, each checked against the inline
    runtime path of this run (`srv`, `words`: its server and its opened
    words)."""
    import tempfile

    import torch
    from repro_torch import offline
    from repro_torch.core.ring import RING64
    from repro_torch.runtime import FourPartyRuntime
    from repro_torch.serve.party_server import PartyPredictionServer
    from repro_torch.train.paper_ml import (mlp_net_predict_runtime,
                                            params_from_numpy)

    enc = params_from_numpy(params, RING64, "cuda")
    kw = {"device": "cuda", "runtime_kwargs": {"kernel_backend": "hopper"}}
    zeros = np.zeros_like(X)
    inline_links, inline_totals = srv.batch_traffic[0]
    inline_launches = {k["name"]: k["launches_by_path"]["runtime"]
                       / N_BATCHES for k in kernels}

    def deal_batch():
        return offline.deal(
            lambda rt: mlp_net_predict_runtime(rt, enc, net, zeros),
            seed=SEED, **kw)

    def online_batch(store):
        return offline.run_online(
            lambda rt: mlp_net_predict_runtime(rt, enc, net, X), store, **kw)

    # 1. deal
    (store, drep), _ = drive(
        "offline_deal", kernels, ("prf_mask", "ring_matmul", "mult_terms",
                                  "and_terms"), deal_batch, 1)
    check(not drep.abort, "deal: the dealer aborted")
    check((drep.offline_rounds, drep.offline_bits)
          == (inline_totals["offline"]["rounds"],
              inline_totals["offline"]["bits"]),
          f"deal: offline rounds/bits {drep.offline_rounds}/"
          f"{drep.offline_bits} differ from the inline batch's "
          f"{inline_totals['offline']}")
    print(f"deal: {drep.entries} entries, {drep.offline_rounds} offline "
          f"rounds, {drep.offline_bits} offline bits (the inline batch's), "
          f"0 online bits; {drep.wall_s * 1e3:.1f} ms")
    # 2. the disk round trip, outside the checkout
    with tempfile.TemporaryDirectory(prefix="prepstore-") as tmp:
        t0 = time.perf_counter()
        store.save(tmp)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded = offline.PrepStore.load(tmp)
        load_s = time.perf_counter() - t0
    nbytes = store.nbytes()
    check(len(loaded) == len(store) and loaded.nbytes() == nbytes,
          "the loaded store differs from the saved one")
    print(f"store: {nbytes} bytes ({store.nbytes(1)} for P1); saved in "
          f"{save_s:.3f} s, loaded in {load_s:.3f} s")
    # 3. online-only
    (online_words, orep), _ = drive(
        "online_only", kernels, ("mpc_matmul_grid", "mult_terms",
                                 "and_terms"), lambda: online_batch(store), 1)
    launches = {k["name"]: k["launches_by_path"] for k in kernels}
    check(torch.equal(online_words.cpu(), words[:BATCH].cpu()),
          "online-only: opened words differ from the inline runtime path's")
    check(not orep.abort and orep.offline_bits == 0,
          f"online-only: abort {orep.abort}, offline bits "
          f"{orep.offline_bits}")
    check((orep.online_rounds, orep.online_bits)
          == (inline_totals["online"]["rounds"],
              inline_totals["online"]["bits"]),
          "online-only: online rounds/bits differ from the inline batch's")
    check(launches["prf_mask"]["online_only"] == 0,
          "online-only: prf_mask launched")
    for name, want in inline_launches.items():
        got = launches[name]["offline_deal"] + launches[name]["online_only"]
        check(got == want, f"{name}: deal + online launches {got} != the "
              f"inline batch's {want:g}")
    print(f"online-only: words equal to the inline runtime path's; "
          f"{orep.online_rounds} rounds, {orep.online_bits} bits, 0 offline"
          f" bits; deal + online launches = inline launches per kernel "
          f"{ {n: (launches[n]['offline_deal'], launches[n]['online_only']) for n in inline_launches} }")
    got, lrep = online_batch(loaded)
    check(torch.equal(got.cpu(), words[:BATCH].cpu()) and not lrep.abort,
          "online-only from the loaded store: words differ")
    # per_link() of the online phase, on a transport of its own
    from repro_torch.runtime import LocalTransport
    tp = LocalTransport()
    store2, _ = deal_batch()
    offline.run_online(
        lambda rt: mlp_net_predict_runtime(rt, enc, net, X), store2,
        transport=tp, **kw)
    check({k: v["online"] for k, v in tp.per_link().items()}
          == {k: v["online"] for k, v in inline_links.items()}
          and all(v["offline"] == 0 for v in tp.per_link().values()),
          "online-only: per_link() differs from the inline batch's")
    print("online-only: per_link() of the online phase equal to the inline "
          "batch's; the loaded store opens the same words")
    handoff = check_prep_handoff(torch.device("cuda"))
    # 4. K1
    rounds = dotp_rounds(torch.device("cuda"))
    # 5. pipelined serving: two flushes of three batches each, batch k at
    # seed SEED + k (the second flush's walls are the steady ones: its
    # dealer stream's allocator blocks are warm)
    queries = np.random.RandomState(SEED + 2).randn(6 * BATCH, net.features)
    psrv = PartyPredictionServer(
        lambda rt, Xb: mlp_net_predict_runtime(rt, enc, net, Xb),
        batch_size=BATCH, seed=SEED, prep="pipelined", device="cuda")
    pipe_walls = []
    for flush in range(2):
        for q in queries[flush * 3 * BATCH:(flush + 1) * 3 * BATCH]:
            psrv.submit(q)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pwords = torch.stack(psrv.flush())
        torch.cuda.synchronize()
        pipe_walls.append((time.perf_counter() - t0) / 3)
        for k in range(3 * flush, 3 * flush + 3):
            rows = slice(k * BATCH, (k + 1) * BATCH)
            twin = mlp_net_predict_runtime(
                FourPartyRuntime(RING64, seed=SEED + k, device="cuda"),
                enc, net, queries[rows])
            check(torch.equal(pwords[rows.start - 3 * flush * BATCH:
                                     rows.stop - 3 * flush * BATCH].cpu(),
                              twin.cpu()),
                  f"pipelined batch {k}: predictions differ from the "
                  f"inline runtime at seed {SEED + k}")
    prep = psrv.report()
    psrv.close()
    check(prep["batches"] == 6 and not prep["aborted"]
          and prep["offline_bits_per_batch"] == 0,
          f"pipelined: {prep['batches']} batches, aborted "
          f"{prep['aborted']}, offline bits {prep['offline_bits_per_batch']}")
    pipe_wall = pipe_walls[1]
    online_in_pipe = [w * 1e3 for w in psrv.stats.batch_walls_s]
    print(f"pipelined: 2 x 3 batches equal to their inline twins, 0 offline "
          f"bits; {pipe_walls[0] * 1e3:.1f} ms then "
          f"{pipe_walls[1] * 1e3:.1f} ms a batch; each batch's online-only "
          f"wall in the pipeline {[round(w, 1) for w in online_in_pipe]} ms;"
          f" deal {prep['offline_deal_s_per_batch'] * 1e3:.1f} ms a batch "
          f"on the dealer thread")
    # 6. times: steady deal and online-only walls, then profiled batches
    deal_s, online_s = [], []
    for _ in range(3):
        st, rep = deal_batch()
        deal_s.append(rep.wall_s)
        _, rep = online_batch(st)
        online_s.append(rep.wall_s)
    inline_ms = min(srv.stats.batch_walls_s[1:] or srv.stats.batch_walls_s)
    st = deal_batch()[0]
    # device ms by profiler key of each profiled run: phase obs holds the
    # traced pipelined batch's device windows to them
    by_name = {"online_only": {}, "deal": {}}
    on_busy, on_ops = profile_batch("online-only", lambda: online_batch(st),
                                    min(online_s),
                                    by_name=by_name["online_only"])
    deal_busy, deal_ops = profile_batch("deal", deal_batch, min(deal_s),
                                        by_name=by_name["deal"])
    times = {"inline_batch_ms": inline_ms * 1e3,
             "deal_ms": [t * 1e3 for t in deal_s],
             "online_only_ms": [t * 1e3 for t in online_s],
             "pipelined_ms_per_batch": pipe_wall * 1e3,
             "pipelined_first_flush_ms_per_batch": pipe_walls[0] * 1e3,
             "pipelined_online_only_ms": online_in_pipe,
             "pipelined_deal_ms_per_batch":
                 prep["offline_deal_s_per_batch"] * 1e3,
             "online_only_busy_ms": on_busy, "online_only_device_ops": on_ops,
             "deal_busy_ms": deal_busy, "deal_device_ops": deal_ops,
             "store_bytes": nbytes, "save_s": save_s, "load_s": load_s,
             "dotp_rounds": rounds, "handoff": handoff,
             "profile_by_name": by_name}
    print(f"offline-online times: inline batch {times['inline_batch_ms']:.1f}"
          f" ms; deal {[round(t, 1) for t in times['deal_ms']]} ms; "
          f"online-only {[round(t, 1) for t in times['online_only_ms']]} ms;"
          f" pipelined {times['pipelined_ms_per_batch']:.1f} ms a batch; "
          f"online-only busy {on_busy:.3f} ms in {on_ops} device ops, deal "
          f"{deal_busy:.3f} ms in {deal_ops}")
    return times


# the joint simulation's offline-online split (phase joint-split): path A's
# program on batch 0, an offline run, then an online run on its materials
SPLIT_WORLDS = ((False, "faithful"), (True, "collapsed"))


def split_batch(device: str, params: dict, net, X, collapse: bool,
                kernels: list | None = None,
                needed: dict | None = None) -> dict:
    """Batch 0 through ``split_offline_online`` of path A's program
    (``mlp_net_predict_joint``, Newton division) on `device`: the online
    words, both contexts, the materials and each run's wall.  With
    `kernels` each run is a driven path whose launches go into the kernel
    rows (`needed`: {mode: {kernel: CPU wrapper calls}}); without, each
    run's wrapper calls are recorded."""
    import torch
    from repro_torch.core.ring import RING64
    from repro_torch.kernels import ops
    from repro_torch.train.paper_ml import (mlp_net_predict_joint,
                                            params_from_numpy)
    from repro_torch.train.trainer import split_offline_online

    enc = params_from_numpy(params, RING64, device)
    seen = []

    def program(ctx):
        seen.append(ctx)
        return mlp_net_predict_joint(ctx, enc, net, X)

    def offline():
        return split_offline_online(program, seed=SEED, device=device,
                                    collapse=collapse)

    def online():
        return online_fn()

    world = "collapsed" if collapse else "faithful"
    out = {"walls_s": {}, "calls": {}}
    online_fn = None
    for mode, run in (("offline", offline), ("online", online)):
        if kernels is None:
            ops.reset_launches()
            t0 = time.perf_counter()
            res = run()
            if device != "cpu":
                torch.cuda.synchronize()
            out["walls_s"][mode] = time.perf_counter() - t0
            out["calls"][mode] = {k.name: k.calls for k in ops.KERNELS}
        else:
            res, out["walls_s"][mode] = drive(
                f"joint_split_{mode}_{world}", kernels,
                tuple(n for n, c in needed[mode].items() if c), run, 1)
        if mode == "offline":
            out["materials"], online_fn = res
        else:
            out["words"], out["on_ctx"] = res[0].cpu(), res[1]
    out["off_ctx"] = seen[0]
    return out


def joint_split_phase(params, net, X, kernels: list, fused: dict,
                      card: str) -> dict:
    """Phase joint-split.  `fused`: {world: (words, totals(), steady batch
    wall s)} of batch 0 on path A (faithful) and path B (collapsed)."""
    import torch
    from repro_torch.kernels import ops
    report = {}
    for collapse, world in SPLIT_WORLDS:
        t0 = time.perf_counter()
        ref = split_batch("cpu", params, net, X, collapse)
        cpu_s = time.perf_counter() - t0
        got = split_batch("cuda", params, net, X, collapse, kernels,
                          ref["calls"])
        words, totals, fused_wall = fused[world]
        on_ctx, off_ctx = got["on_ctx"], got["off_ctx"]
        check(torch.equal(got["words"], words),
              f"joint-split {world}: the online words differ from the fused "
              f"path's batch 0")
        check(torch.equal(got["words"], ref["words"]),
              f"joint-split {world}: the online words differ from the CPU "
              f"run's")
        check(on_ctx._mat_idx == len(got["materials"]) > 0,
              f"joint-split {world}: {on_ctx._mat_idx} of "
              f"{len(got['materials'])} materials consumed")
        check(not on_ctx.abort_flag() and not off_ctx.abort_flag(),
              f"joint-split {world}: the split aborted")
        off_t, on_t = off_ctx.tally.totals(), on_ctx.tally.totals()
        check(off_t["offline"] == totals["offline"]
              and on_t["online"] == totals["online"],
              f"joint-split {world}: the offline run's totals {off_t} or the "
              f"online run's {on_t} differ from the fused run's {totals}")
        check(off_t == ref["off_ctx"].tally.totals()
              and on_t == ref["on_ctx"].tally.totals(),
              f"joint-split {world}: totals() differ from the CPU run's")
        launches = {}
        for mode in ("offline", "online"):
            path = f"joint_split_{mode}_{world}"
            launches[mode] = {k["name"]: k["launches_by_path"][path]
                              for k in kernels}
            for name, n in launches[mode].items():
                check(n == ref["calls"][mode][name],
                      f"{path}: {name} {n} launches on the card, "
                      f"{ref['calls'][mode][name]} wrapper calls on the CPU")
        check(launches["offline"][ops.AND_LEVEL.name] == 2
              and launches["online"][ops.AND_LEVEL.name] == 2,
              f"joint-split {world}: and_level launches {launches}, not 2 "
              f"offline and 2 online (A2B's subtractor, smx's prefix-OR)")
        # steady walls: the same split again, undriven
        again = split_batch("cuda", params, net, X, collapse)
        check(torch.equal(again["words"], words),
              f"joint-split {world}: a second split opened other words")
        r = report[world] = {
            "offline_ms": [got["walls_s"]["offline"] * 1e3,
                           again["walls_s"]["offline"] * 1e3],
            "online_ms": [got["walls_s"]["online"] * 1e3,
                          again["walls_s"]["online"] * 1e3],
            "fused_batch_ms": fused_wall * 1e3, "cpu_split_s": cpu_s,
            "materials": len(got["materials"]), "launches": launches,
            "offline_totals": off_t["offline"],
            "online_totals": on_t["online"]}
        print(f"joint-split {world}: online words equal to the fused path's "
              f"and to the CPU run's, {r['materials']} materials all "
              f"consumed, no abort, offline and online totals the fused "
              f"run's; launches offline "
              f"{ {n: c for n, c in launches['offline'].items() if c} }, "
              f"online { {n: c for n, c in launches['online'].items() if c} }"
              f" (the CPU run's wrapper calls)")
        print(f"joint-split {world}: offline run "
              f"{[round(t, 1) for t in r['offline_ms']]} ms, online run "
              f"{[round(t, 1) for t in r['online_ms']]} ms (driven, steady), "
              f"beside the fused batch's {r['fused_batch_ms']:.1f} ms; CPU "
              f"split {cpu_s:.1f} s ({card})")
    return report


# phase aby3: the ABY3 baseline's products at the NN's first layer and at
# linear regression's two products, one Pi_Mult-sized mult, and Trident's
# argmax_tournament over the NN's output width
ABY3_MATMULS = ((BATCH, 784, 128), (BATCH, 784, 1), (784, BATCH, 1))
ABY3_MULT = (BATCH, 128)
ARGMAX_SHAPE = (BATCH, 10)


def aby3_data() -> dict:
    rng = np.random.RandomState(SEED + 3)
    data = {"matmul_tr": [(rng.randn(M, K) * 0.5, rng.randn(K, N) * 0.05)
                          for M, K, N in ABY3_MATMULS],
            "mult": (rng.randn(*ABY3_MULT), rng.randn(*ABY3_MULT)),
            "argmax": rng.randn(*ARGMAX_SHAPE)}
    return data


def aby3_runs(device: str, data: dict) -> list:
    """Each op of phase aby3 on a fresh context on `device` (RING64, seed
    SEED): (name, opened words, by_op before the opening, the op's own
    rounds and bits per phase (the sharing and the opening left out),
    output elements)."""
    from repro_torch.core import aby3 as AB
    from repro_torch.core import activations as ACT
    from repro_torch.core import protocols as PR
    from repro_torch.core.context import make_context
    from repro_torch.core.ring import RING64

    runs = []

    def record(name, ctx, op, reveal):
        before = ctx.tally.totals()
        out = op()
        after = ctx.tally.totals()
        own = {ph: {k: after[ph][k] - before[ph][k] for k in after[ph]}
               for ph in after}
        by_op = dict(ctx.tally.by_op)
        runs.append((name, reveal(ctx, out).cpu(), by_op, own,
                     int(np.prod(out.shape))))

    for (a, b), shape in zip(data["matmul_tr"], ABY3_MATMULS):
        ctx = make_context(RING64, SEED, device=device)
        x, w = AB.share(ctx, ctx.encode(a)), AB.share(ctx, ctx.encode(b))
        record(f"matmul_tr {'x'.join(map(str, shape))}", ctx,
               lambda: AB.matmul_tr(ctx, x, w), AB.reveal)
    ctx = make_context(RING64, SEED, device=device)
    x, y = (AB.share(ctx, ctx.encode(v)) for v in data["mult"])
    record(f"mult {'x'.join(map(str, ABY3_MULT))}", ctx,
           lambda: AB.mult(ctx, x, y), AB.reveal)
    ctx = make_context(RING64, SEED, device=device)
    z = PR.share(ctx, ctx.encode(data["argmax"]))
    record(f"argmax_tournament {'x'.join(map(str, ARGMAX_SHAPE))}", ctx,
           lambda: ACT.argmax_tournament(ctx, z), PR.reconstruct)
    return runs


def best_wall_ms(fn, reps: int = 3) -> float:
    import torch
    best = None
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        t = (time.perf_counter() - t0) * 1e3
        best = t if best is None else min(best, t)
    return best


def aby3_phase(kernels: list, card: str) -> dict:
    """Phase aby3: the ops on the card (a driven path) against a CPU run
    of the port, words and tallies; decoded values against float64; one
    mpc_matmul_grid launch an ABY3 matmul and one mult_terms launch an
    ABY3 mult; executed per-element bits and rounds beside paper_costs'
    ABY3 figures; walls beside Trident's matmul_tr on the same shapes."""
    import torch
    from repro_torch.core import aby3 as AB
    from repro_torch.core import paper_costs as PC
    from repro_torch.core import protocols as PR
    from repro_torch.core.context import make_context
    from repro_torch.core.ring import RING64
    from repro_torch.kernels import ops

    data = aby3_data()
    runs, _ = drive("aby3", kernels, ("prf_mask", "mpc_matmul_grid",
                                      "mult_terms"),
                    lambda: aby3_runs("cuda", data), 1)
    on_card = {k["name"]: k["launches_by_path"]["aby3"] for k in kernels}
    check(on_card[ops.MPC_MATMUL_GRID.name] == len(ABY3_MATMULS)
          and on_card[ops.MULT_TERMS.name] == 1,
          f"aby3: {on_card} launches, not one mpc_matmul_grid an ABY3 "
          f"matmul ({len(ABY3_MATMULS)}) and one mult_terms an ABY3 mult")
    ops.reset_launches()
    ref = aby3_runs("cpu", data)
    check(ops.MPC_MATMUL_GRID.calls == len(ABY3_MATMULS)
          and ops.MULT_TERMS.calls == 1,
          f"aby3: the CPU run made {ops.MPC_MATMUL_GRID.calls} grid and "
          f"{ops.MULT_TERMS.calls} grouped wrapper calls")
    want = [a @ b for a, b in data["matmul_tr"]]
    want += [data["mult"][0] * data["mult"][1],
             data["argmax"].max(axis=1, keepdims=True)]
    report = {}
    scale = float(RING64.scale)
    for (name, words, by_op, totals, n), (rname, rwords, rby, rtot, _), \
            w in zip(runs, ref, want):
        check(name == rname and torch.equal(words, rwords),
              f"aby3: {name}: words differ from the CPU run's")
        check(by_op == rby and totals == rtot,
              f"aby3: {name}: tallies differ from the CPU run's")
        vals = RING64.decode(words).numpy()
        if name.startswith("mult"):
            vals = vals / scale                  # 2f fractional bits
        err = float(np.abs(vals - w).max())
        check(np.isfinite(vals).all() and vals.shape == w.shape
              and err <= 1e-2,
              f"aby3: {name}: off by {err} from float64 (shape "
              f"{vals.shape})")
        r = report[name] = {
            "max_abs_err": err,
            "executed_per_element": {
                "offline_rounds": totals["offline"]["rounds"],
                "offline_bits": totals["offline"]["bits"] / n,
                "online_rounds": totals["online"]["rounds"],
                "online_bits": totals["online"]["bits"] / n}}
        if name.startswith("matmul_tr"):
            d = int(name.split()[1].split("x")[1])
            r["paper_costs_aby3"] = PC.dotp_tr_cost("aby3", RING64.ell, d)
        elif name.startswith("mult"):
            r["paper_costs_aby3"] = PC.ABY3["mult"](RING64.ell)
        print(f"aby3: {name}: words and tallies equal to the CPU run, "
              f"within {err:.2e} of float64; executed per element "
              f"{r['executed_per_element']}"
              + (f"; paper_costs ABY3 (off rounds, off bits, on rounds, on "
                 f"bits) {r['paper_costs_aby3']}"
                 if "paper_costs_aby3" in r else ""))
    # walls: ABY3's matmul_tr beside Trident's (faithful joint) on the same
    # shares' shapes
    for (a, b), shape in zip(data["matmul_tr"], ABY3_MATMULS):
        ctx = make_context(RING64, SEED, device="cuda")
        x, w = AB.share(ctx, ctx.encode(a)), AB.share(ctx, ctx.encode(b))
        tx, tw = PR.share(ctx, ctx.encode(a)), PR.share(ctx, ctx.encode(b))
        key = f"matmul_tr {'x'.join(map(str, shape))}"
        report[key]["aby3_ms"] = best_wall_ms(
            lambda: AB.matmul_tr(ctx, x, w))
        report[key]["trident_ms"] = best_wall_ms(
            lambda: PR.matmul_tr(ctx, tx, tw))
        print(f"aby3: {key}: ABY3 {report[key]['aby3_ms']:.3f} ms, Trident "
              f"{report[key]['trident_ms']:.3f} ms a call, best of 3 "
              f"({card})")
    report["launches"] = on_card
    return report


# the training phase (runtime-train): the paper's NN and logistic
# regression at batch 128, TRAIN_STEPS steps from the step-indexed seeds
# SEED + step
TRAIN_STEPS = 3
TRAIN_LR = 0.5
# the products a training step gives the kernels that no serving path
# gives them, (M, K, N) at batch 128: X^T dz0, dz2 w2^T, h2^T dz2, and
# logistic regression's X w and X^T err.  Each is one gamma piece
# (M, 3K) @ (3K, N) a piece and one online grid (3M, K) @ (K, 3N) a party.
TRAIN_PRODUCTS = ((784, BATCH, 128), (BATCH, 10, 128), (128, BATCH, 10),
                  (BATCH, 784, 1), (784, BATCH, 1))
# One secure step against one float64 step in numpy.  Each truncating
# product of the protocols (Pi_MultTr, Pi_MatMulTr, the public scalings)
# ends 0-2 units of 2^-13 low, 1 on average: scripts/torch_trunc_bias.py
# measures means of -0.997 to -1.000 units (standard error 0.0016) over
# 65,536 words of each, the output floor(v / 2^13) or one below it in
# equal shares.  The backward pass sums 128 such words a gradient, so
# against the plain float64 step w0 comes out about 0.015 off after one
# step (the JAX package's words are the same).  The tolerance of 1e-2
# holds the step against the float64 step with that mean of -2^-13 a
# truncating product; the plain one is held to 5e-2, the bias summed over
# the batch: 0.5 (lr) x 128 x 3 (|X|) x 2 x 2^-13 = 0.047 at most.  A
# wrong sign or a missing mask moves a weight by its whole update (up to
# about 0.15 at step 1).
PARAM_ATOL = 1e-2
PLAIN_PARAM_ATOL = 5e-2
# the five kernels of the runtime's training step
TRAIN_KERNELS = ("prf_mask", "ring_matmul", "mpc_matmul_grid", "mult_terms",
                 "and_terms")


def sgd_float64(params: dict, X: np.ndarray, onehot: np.ndarray,
                lr: float, trunc: float = 0.0) -> dict:
    """One SGD step of the NN in float64 numpy: ``forward_float64``'s smx,
    dlogits = (p - onehot) / B passed straight to the last layer (as
    ``mlp_net_bwd`` does), ReLU's 0/1 derivative; each product that the
    protocols truncate less `trunc`."""
    n = len(params)
    hs, zs, h = [X], [], X
    for i in range(n):
        zs.append(h @ params[f"w{i}"])
        h = np.maximum(zs[-1], 0.0)
        hs.append(h)
    p = hs[-1] / (hs[-1].sum(axis=-1, keepdims=True) + 1e-2)
    dz = (p - onehot) / X.shape[0] - trunc
    new = {}
    for i in reversed(range(n)):
        grad = hs[i].T @ dz - trunc
        new[f"w{i}"] = params[f"w{i}"] - (lr * grad - trunc)
        if i > 0:
            dz = (dz @ params[f"w{i}"].T - trunc) * (zs[i - 1] > 0)
    return new


def same_params(a: dict, b: dict) -> bool:
    return sorted(a) == sorted(b) and all(
        a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]) for k in a)


def train_steps(task, params: dict, batches, *, device, world: str = "runtime",
                backend: str = "hopper") -> list:
    """``secure_sgd.run_step`` over `batches`, step k from seed SEED + k:
    [(params, loss, totals() of the runtime's transport or None, wall s)]
    a step.  A step ends with its results on the host, so its wall holds
    its device work."""
    from repro_torch.runtime import LocalTransport
    from repro_torch.train import secure_sgd as SGD
    out = []
    for step, batch in enumerate(batches):
        tp = LocalTransport() if world == "runtime" else None
        t0 = time.perf_counter()
        params, loss, abort = SGD.run_step(
            task, params, batch, step=step, base_seed=SEED, world=world,
            transport=tp, device=device, kernel_backend=backend)
        wall = time.perf_counter() - t0
        check(not abort, f"{world} step {step} on {device}: aborted")
        check(np.isfinite(loss) and all(np.isfinite(v).all()
                                        for v in params.values()),
              f"{world} step {step} on {device}: a value is not finite")
        out.append((params, loss, None if tp is None else tp.totals(),
                    wall))
    return out


def check_trajectory(what: str, got: list, want: list) -> None:
    """Equal params and loss at every step (bit for bit), and equal
    totals() where both carry them."""
    check(len(got) == len(want), f"{what}: {len(got)} steps, {len(want)}")
    for step, (g, w) in enumerate(zip(got, want)):
        check(same_params(g[0], w[0]) and g[1] == w[1],
              f"{what}: params or loss differ at step {step}")
        if g[2] is not None and w[2] is not None:
            check(g[2] == w[2], f"{what}: totals() differ at step {step}")


def capture_train_calls(task, params, batch, dev) -> dict:
    """One NN training step on the card through a backend that records
    the largest PRF group (by words) and the largest Pi_Mult and AND round
    call of each stage: {"prf": draws, (stage, world): (op, requests)}."""
    from repro_torch.core.ring import RING64
    from repro_torch.nn.runtime_engine import RuntimeEngine
    from repro_torch.runtime import FourPartyRuntime
    from repro_torch.runtime.kernel_backend import HopperKernels

    def words(t) -> int:
        return int(t.numel())

    class Recorder(HopperKernels):
        def __init__(self):
            super().__init__()
            self.calls, self._size = {}, {}

        def _keep(self, key, size, value):
            if size > self._size.get(key, -1):
                self._size[key], self.calls[key] = size, value

        def prf_bits_group(self, draws, ring, device):
            self._keep("prf", sum(int(np.prod(d[2])) for d in draws),
                       draws)
            return super().prf_bits_group(draws, ring, device)

        def gamma_pieces_round(self, kind, op, requests):
            if kind == "mul":
                self._keep(("offline", "mul"), sum(
                    words(r[2][r[3][0]]) for r in requests), (op, requests))
            return super().gamma_pieces_round(kind, op, requests)

        def online_parts_round(self, kind, op, requests):
            if kind == "mul":
                self._keep(("online", "mul"), sum(
                    words(r[4][r[6][0]]) for r in requests), (op, requests))
            return super().online_parts_round(kind, op, requests)

        def bool_gamma_pieces_round(self, requests):
            self._keep(("offline", "bool"), sum(
                words(r[2][r[3][0]]) for r in requests), (None, requests))
            return super().bool_gamma_pieces_round(requests)

        def bool_online_parts_round(self, requests):
            self._keep(("online", "bool"), sum(
                words(r[4][r[6][0]]) for r in requests), (None, requests))
            return super().bool_online_parts_round(requests)

    rec = Recorder()
    rt = FourPartyRuntime(RING64, seed=SEED, kernel_backend=rec, device=dev)
    _, _, abort = task.run(RuntimeEngine(rt), params, batch)
    check(not abort, "the recorded training step aborted")
    return rec.calls


def train_shape_rows(task, params, batch, dev, instructions) -> dict:
    """Each of the five kernels at the training step's new shapes, held
    against its plain version, timed on the device beside its bound and
    the plain version's time: ring_matmul at each TRAIN_PRODUCTS gamma
    piece, mpc_matmul_grid at each online grid (the plain int64 matmul on
    the CPU, as PyTorch has none on CUDA); prf_mask, mult_terms and
    and_terms at the largest PRF group and the largest Pi_Mult and AND
    round of an NN training step, recorded on the card (plain versions on
    the card); `instructions`: a squares() word's, for prf_mask's bound.
    {kernel name: [row, ...]}."""
    import torch
    from repro_torch.core.ring import RING64
    from repro_torch.kernels import gamma_parts as GP
    from repro_torch.kernels import ops
    from repro_torch.kernels import prf_mask as PM
    from repro_torch.kernels import ring_matmul as RM
    from repro_torch.runtime.kernel_backend import (HopperKernels,
                                                    gamma_groups,
                                                    online_groups)
    rng = np.random.RandomState(SEED + 3)

    def words(*shape):
        return torch.from_numpy(rng.randint(
            -2**63, 2**63 - 1, size=shape, dtype=np.int64))

    rows = {name: [] for name in TRAIN_KERNELS}
    for M, K, N in TRAIN_PRODUCTS:
        for name, (m, k, n) in (("ring_matmul", (M, 3 * K, N)),
                                ("mpc_matmul_grid", (3 * M, K, 3 * N))):
            a, b = words(m, k), words(k, n)
            da, db = a.to(dev), b.to(dev)
            got = RM.ring_matmul_cuda(da, db)
            check(torch.equal(got.cpu(), RM.ring_matmul_plain(a, b)),
                  f"{name} disagrees with its plain version at "
                  f"{m}x{k}x{n}")
            rows[name].append({
                "product": f"{M}x{K}x{N}", "shape": f"{m}x{k}x{n}",
                "ms": device_ms(lambda: RM.ring_matmul_cuda(da, db),
                                "ring_matmul_kernel"),
                "plain_ms": host_ms(lambda: RM.ring_matmul_plain(a, b),
                                    reps=2),
                "max_abs_err": 0, **ring_matmul_bound(m, k, n)})
        # the grid through the wrapper, the transposed operand a permuted
        # view (not contiguous), as the backward pass hands it over
        xs = [words(K, M).t() for _ in range(3)]
        ys = [words(K, N) for _ in range(3)]
        grid = ops.mpc_matmul_grid([x.to(dev) for x in xs],
                                   [y.to(dev) for y in ys])
        want = RM.ring_matmul_plain(torch.cat(xs), torch.cat(ys, dim=1))
        check(all(torch.equal(grid[i][j].cpu(),
                              want[i * M:(i + 1) * M, j * N:(j + 1) * N])
                  for i in range(3) for j in range(3)),
              f"mpc_matmul_grid disagrees on permuted operands at "
              f"{M}x{K}x{N}")
    calls = capture_train_calls(task, params, batch, dev)
    hk = HopperKernels()
    draws = calls["prf"]
    n = sum(int(np.prod(d[2])) for d in draws)
    got = hk.prf_bits_group(draws, RING64, dev)
    want = hk.prf_bits_group(draws, RING64, torch.device("cpu"))
    check(all(torch.equal(g.cpu(), w) for g, w in zip(got, want)),
          "prf_mask disagrees with its plain version on the training "
          "step's largest group")
    group = [(key.data, ctr, int(np.prod(shape)),
              0 if bits is None else RING64.ell - bits)
             for key, ctr, shape, bits in draws]
    b_ms, b_by = prf_bound(n, instructions)
    rows["prf_mask"].append({
        "shape": [list(d[2]) for d in draws], "words": n,
        "ms": device_ms(lambda: hk.prf_bits_group(draws, RING64, dev),
                        "squares_group_kernel"),
        "plain_ms": device_ms(lambda: PM.prf_mask_group_plain(
            group, torch.int64, dev)),
        "max_abs_err": 0, "bound_ms": b_ms, "bound_by": b_by})
    for name, world, xor in (("mult_terms", "mul", False),
                             ("and_terms", "bool", True)):
        plain = GP.and_terms_group_plain if xor else \
            GP.mult_terms_group_plain
        launch = ops.and_terms_group if xor else ops.mult_terms_group
        for stage in ("offline", "online"):
            _, reqs = calls[(stage, world)]
            groups = (gamma_groups if stage == "offline"
                      else online_groups)(reqs, xor)
            got, ref = launch(groups), plain(groups)
            torch.cuda.synchronize()
            check(all(torch.equal(g, r) for g, r in zip(got, ref)),
                  f"{name}: the training step's {stage} round disagrees "
                  f"with the plain version")
            nbytes, b_ms, b_by = terms_bound(groups)
            rows[name].append({
                "stage": stage, "groups": len(groups),
                "shape": list(GP.group_shape(groups[0])),
                "ms": device_ms(lambda g=groups, f=launch: f(g),
                                "terms_group_kernel"),
                "plain_ms": device_ms(lambda g=groups, f=plain: f(g)),
                "max_abs_err": 0, "unique_bytes": nbytes,
                "bound_ms": b_ms, "bound_by": b_by})
    return rows


def runtime_train_phase(kernels: list) -> dict:
    """Secure training on the party runtime at full width (the NN,
    784-128-128-10, and logistic regression on 784 features; batch 128),
    each path driven with the launch counts reset before and read after;
    see the module docstring, step 10."""
    import tempfile

    import torch
    from repro_torch import offline
    from repro_torch.configs.paper_models import LOGREG
    from repro_torch.kernels import ops
    from repro_torch.train import secure_sgd as SGD
    from repro_torch.train.data import MNISTLike, RegressionData
    from repro_torch.train.trainer import Trainer, TrainerConfig

    dev = torch.device("cuda")
    task = SGD.nn_task(lr=TRAIN_LR)
    params = task.init_params(seed=0)
    data = MNISTLike(n=8192, seed=2)
    batches = [data.batch(step, BATCH)[:2] for step in range(TRAIN_STEPS)]

    # 1. the NN inline on the card, against the CPU ("torch" backend)
    nn, _ = drive("train_runtime", kernels, TRAIN_KERNELS,
                  lambda: train_steps(task, params, batches, device=dev),
                  TRAIN_STEPS, "step")
    t0 = time.perf_counter()
    check_trajectory("runtime-train: the card against the CPU", nn,
                     train_steps(task, params, batches, device="cpu",
                                 backend="torch"))
    print(f"runtime-train: {TRAIN_STEPS} NN steps, (params, loss) and "
          f"totals() equal to the CPU run's ({time.perf_counter() - t0:.1f}"
          f" s); per step {nn[0][2]}")
    # launches a step on the card against the wrapper calls of one step on
    # the CPU ("hopper" backend, plain versions): each call is one launch
    # of the card (a PRF group is one launch; no round of this step has
    # more than MAX_GROUPS groups)
    ops.reset_launches()
    train_steps(task, params, batches[:1], device="cpu")
    per_step = {}
    for k in kernels:
        if k["name"] in TRAIN_KERNELS:
            on_card = k["launches_by_path"]["train_runtime"] / TRAIN_STEPS
            cpu = next(c.calls for c in ops.KERNELS if c.name == k["name"])
            check(on_card == cpu, f"runtime-train: {k['name']} {on_card:g} "
                  f"launches a step on the card, {cpu} wrapper calls a "
                  f"step on the CPU")
            per_step[k["name"]] = on_card
    print(f"runtime-train: launches per NN step {per_step}, equal to a CPU "
          f"step's wrapper calls")
    # 2. the joint world on the card: the same trajectory
    joint, _ = drive("train_joint", kernels,
                     ("prf_mask", "ring_matmul", "and_level"),
                     lambda: train_steps(task, params, batches,
                                         world="joint", device=dev),
                     TRAIN_STEPS, "step")
    check_trajectory("runtime-train: the joint world against the runtime",
                     joint, nn)
    # 3. accuracy: step 0 against one float64 SGD step, with the
    # truncations' mean and without (PARAM_ATOL, PLAIN_PARAM_ATOL)
    errs = {}
    for trunc, tol in ((2.0**-13, PARAM_ATOL), (0.0, PLAIN_PARAM_ATOL)):
        want = sgd_float64(params, *batches[0], TRAIN_LR, trunc)
        errs[trunc] = err = max(float(np.abs(nn[0][0][k] - want[k]).max())
                                for k in want)
        check(err <= tol, f"runtime-train: params after step 0 off by "
              f"{err} > {tol} from float64 SGD (truncation mean {trunc})")
    param_err, plain_err = errs[2.0**-13], errs[0.0]
    update = max(float(np.abs(want[k] - params[k]).max()) for k in want)
    losses = [s[1] for s in nn]
    print(f"runtime-train: joint world's (params, loss) equal to the "
          f"runtime's at every step; params after step 0 within "
          f"{param_err:.3e} of float64 SGD with the truncations' mean "
          f"(tolerance {PARAM_ATOL}), {plain_err:.3e} of plain float64 SGD "
          f"(tolerance {PLAIN_PARAM_ATOL}; largest update {update:.3e}); "
          f"losses {losses}")
    # 4. logistic regression, 784 features
    ltask = SGD.logreg_task(features=LOGREG["features"])
    lparams = ltask.init_params(seed=0)
    ldata = RegressionData(features=LOGREG["features"], n=8192, seed=1,
                           logistic=True)
    lbatches = [ldata.batch(step, BATCH) for step in range(TRAIN_STEPS)]
    logreg, _ = drive("train_logreg", kernels, TRAIN_KERNELS,
                      lambda: train_steps(ltask, lparams, lbatches,
                                          device=dev),
                      TRAIN_STEPS, "step")
    check_trajectory("runtime-train: logreg, the card against the CPU",
                     logreg, train_steps(ltask, lparams, lbatches,
                                         device="cpu", backend="torch"))
    print(f"runtime-train: {TRAIN_STEPS} logreg steps equal to the CPU "
          f"run's; losses {[s[1] for s in logreg]}")
    # 5. the split: each step dealt, then each run online-only
    deal_prog = SGD.deal_step_program(task, params, batches[0])
    dealt, _ = drive("train_deal", kernels,
                     ("prf_mask", "ring_matmul", "mult_terms", "and_terms"),
                     lambda: [offline.deal(deal_prog, seed=SEED + step,
                                           device=dev)
                              for step in range(TRAIN_STEPS)], TRAIN_STEPS,
                     "step")

    def online_steps():
        out, p = [], params
        for step, (store, _) in enumerate(dealt):
            (p, loss, abort), rep = offline.run_online(
                SGD.step_program(task, p, batches[step]), store, device=dev)
            check(not abort and not rep.abort,
                  f"online-only step {step}: aborted")
            out.append((p, loss, None, rep))
        return out

    online, _ = drive("train_online_only", kernels,
                      ("mpc_matmul_grid", "mult_terms", "and_terms"),
                      online_steps, TRAIN_STEPS, "step")
    check_trajectory("runtime-train: online-only against inline", online,
                     nn)
    for step, ((_, drep), (*_, orep), inline) in enumerate(
            zip(dealt, online, nn)):
        tot = inline[2]
        check((drep.offline_rounds, drep.offline_bits, orep.online_rounds,
               orep.online_bits, orep.offline_bits)
              == (tot["offline"]["rounds"], tot["offline"]["bits"],
                  tot["online"]["rounds"], tot["online"]["bits"], 0),
              f"runtime-train: step {step}'s deal and online-only traffic "
              f"differ from the inline step's {tot}")
    launches = {k["name"]: k["launches_by_path"] for k in kernels}
    check(launches["prf_mask"]["train_online_only"] == 0
          and launches["ring_matmul"]["train_online_only"] == 0,
          "runtime-train: prf_mask or ring_matmul launched online-only")
    for name in TRAIN_KERNELS:
        got = (launches[name]["train_deal"]
               + launches[name]["train_online_only"])
        check(got == launches[name]["train_runtime"],
              f"runtime-train: {name} deal + online launches {got} != the "
              f"inline steps' {launches[name]['train_runtime']}")
    split = {n: (launches[n]["train_deal"],
                 launches[n]["train_online_only"]) for n in TRAIN_KERNELS}
    print(f"runtime-train: online-only steps equal to the inline steps, 0 "
          f"offline bits, the inline steps' traffic split exactly; deal + "
          f"online launches = inline launches per kernel {split}")

    # 6. prep-ahead: PrepAheadSGD over a ContinuousDealer dealing on its
    # own stream (two threads share the launch counters: this path's
    # counts are summed, not held to the others)
    def prep_ahead():
        with offline.ContinuousDealer(lambda step: deal_prog,
                                      base_seed=SEED, ahead=2,
                                      total=TRAIN_STEPS,
                                      device=dev) as dealer:
            sgd = SGD.PrepAheadSGD(task, dealer, device=dev)
            out, p = [], params
            for step, batch in enumerate(batches):
                t0 = time.perf_counter()
                p, loss, abort = sgd.step_fn(p, step, *batch)
                out.append((p, loss, None, time.perf_counter() - t0))
                check(not abort, f"prep-ahead step {step}: aborted")
            return out, sgd.reports, dealer.reports

    (ahead, oreps, _), _ = drive("train_prep_ahead", kernels, TRAIN_KERNELS,
                                 prep_ahead, TRAIN_STEPS, "step", threads=2)
    check_trajectory("runtime-train: prep-ahead against inline", ahead, nn)
    check(len(oreps) == TRAIN_STEPS and all(
        r.offline_bits == 0 and r.online_bits > 0 for r in oreps),
        f"runtime-train: prep-ahead offline/online bits "
        f"{[(r.offline_bits, r.online_bits) for r in oreps]}")
    print(f"runtime-train: PrepAheadSGD over a ContinuousDealer: "
          f"{TRAIN_STEPS} online-only steps equal to the inline steps, "
          f"offline bits {[r.offline_bits for r in oreps]}, online bits "
          f"{[r.online_bits for r in oreps]}")

    # 7. the Trainer: a crash at step 1 after step 0's checkpoint, then a
    # resume from it, against the uninterrupted trajectory
    def step_fn(p, step, *batch):
        return SGD.run_step(task, p, batch, step=step, base_seed=SEED,
                            world="runtime", device=dev)

    with tempfile.TemporaryDirectory(prefix="trainer-") as tmp:
        cfg = TrainerConfig(steps=TRAIN_STEPS, ckpt_dir=tmp, ckpt_every=1,
                            seed=SEED)
        crashed = Trainer(cfg, step_fn, params, lambda s: batches[s])
        try:
            crashed.run(crash_at=1)
        except RuntimeError as exc:
            check("injected crash at step 1" in str(exc), str(exc))
        else:
            check(False, "runtime-train: the Trainer did not crash")
        resumed = Trainer(cfg, step_fn, params, lambda s: batches[s])
        final = resumed.run()
    check(resumed.events[0] == "resumed@1"
          and same_params(final, nn[-1][0])
          and resumed.losses == losses[1:],
          f"runtime-train: the resumed Trainer ({resumed.events}) ends "
          f"elsewhere than the uninterrupted run")
    print(f"runtime-train: Trainer {crashed.events} then {resumed.events}: "
          f"the same params as the uninterrupted run")

    # 8. times: steady steps (2-3), a profiled step, the new shapes
    def steady(walls):
        return [w * 1e3 for w in walls[1:]]

    walls = {"nn_inline_ms": steady([s[3] for s in nn]),
             "nn_online_only_ms": steady([s[3].wall_s for s in online]),
             "nn_deal_ms": steady([rep.wall_s for _, rep in dealt]),
             "nn_prep_ahead_ms": steady([s[3] for s in ahead]),
             "logreg_inline_ms": steady([s[3] for s in logreg]),
             "nn_joint_ms": steady([s[3] for s in joint])}
    busy, nops = profile_batch(
        "runtime-train NN",
        lambda: train_steps(task, params, batches[:1], device=dev),
        min(walls["nn_inline_ms"]) / 1e3, unit="step")
    prf = next(k for k in kernels if k["name"] == ops.PRF_MASK.name)
    rows = train_shape_rows(task, params, batches[0], dev,
                            prf["word_instructions"])
    for k in kernels:
        if k["name"] in rows:
            k["training_shapes"] = rows[k["name"]]
            for r in rows[k["name"]]:
                what = r.get("product", r.get("stage", ""))
                print(f"  {k['name']} at {r['shape']} ({what}): "
                      f"{r['ms']:.5f} ms on the device, bound "
                      f"{r['bound_ms']:.5f} ms by {r['bound_by']}, plain "
                      f"{r['plain_ms']:.4f} ms")
    out = {"steps": TRAIN_STEPS, "lr": TRAIN_LR, "batch": BATCH,
           "losses": losses, "logreg_losses": [s[1] for s in logreg],
           "param_err_vs_float64_truncation_mean": param_err,
           "param_err_vs_float64": plain_err,
           "launches_per_step": per_step, **walls,
           "profiled_step_busy_ms": busy,
           "profiled_step_device_ops": nops,
           "busy_share": busy / min(walls["nn_inline_ms"]),
           "totals_per_step": nn[0][2]}
    print(f"runtime-train times (steady steps 2-{TRAIN_STEPS}): NN inline "
          f"{[round(w, 1) for w in walls['nn_inline_ms']]} ms, online-only "
          f"{[round(w, 1) for w in walls['nn_online_only_ms']]} ms, deal "
          f"{[round(w, 1) for w in walls['nn_deal_ms']]} ms, prep-ahead "
          f"{[round(w, 1) for w in walls['nn_prep_ahead_ms']]} ms, joint "
          f"{[round(w, 1) for w in walls['nn_joint_ms']]} ms; logreg inline "
          f"{[round(w, 1) for w in walls['logreg_inline_ms']]} ms; a "
          f"profiled NN step busy {busy:.3f} ms in {nops} device ops")
    return out


# --- the four parties as four processes over TCP (phase "cluster") ------
CLUSTER_TIMEOUT = 600.0
# one gamma piece of P0's outgoing wire corrupted: a receiving daemon's
# hash check must flip its abort flag
TAMPER = {"src": 0, "tag": ".g2", "delta": 5}
CLUSTER_KERNELS = ("prf_mask", "ring_matmul", "mpc_matmul_grid",
                   "mult_terms", "and_terms")


def cluster_predict(rt, X, params=None, net=None):
    """The daemons' serving program: the NN's secure prediction of batch X
    over weights encoded on the daemon's device (they travel as float64
    numpy), as the in-process server's."""
    from repro_torch.train.paper_ml import (mlp_net_predict_runtime,
                                            params_from_numpy)
    return mlp_net_predict_runtime(
        rt, params_from_numpy(params, rt.ring, rt.device), net, X)


def cluster_batch(rt, _rank, X=None, params=None, net=None):
    """``cluster_predict`` as a task of its own (the tampered run)."""
    return cluster_predict(rt, X, params=params, net=net)


def daemon_stats(rt, _rank):
    """Read inside a daemon: each kernel's launches since the last read
    (then set to 0), the daemon's peak device memory, and its running
    totals, in ms, of time blocked in receives (the wait for the peers,
    then the host-to-device copy of what arrived), in flushes (the batched
    copy to the host, then the socket writes), and of the copies alone
    (device to host in flushes, host to device of received messages)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.obs import get_registry
    reg = get_registry()
    out = {"launches": {k.name: k.launches for k in ops.KERNELS},
           "peak_bytes": torch.cuda.max_memory_allocated(rt.device),
           "recv_ms": reg.counter("trident_wire_recv_wait_us_total").value
           / 1e3,
           **{f"{w}_ms": reg.counter(f"trident_wire_{w}_us_total").value
              / 1e3 for w in ("flush", "d2h", "h2d")}}
    ops.reset_launches()
    return out


def socket_references(params, net, queries) -> list:
    """The in-process runtime on the card, batch k at seed SEED + k as
    ``serve_over_sockets`` seeds it: its words, traffic, modeled LAN time,
    launches and wall."""
    import torch
    from repro_torch.core.ring import RING64
    from repro_torch.kernels import ops
    from repro_torch.runtime import FourPartyRuntime, LocalTransport
    from repro_torch.runtime.net import LAN, NetModelTransport
    from repro_torch.train.paper_ml import (mlp_net_predict_runtime,
                                            params_from_numpy)

    dev = torch.device("cuda")
    enc = params_from_numpy(params, RING64, dev)
    ref = []
    for k in range(N_BATCHES):
        X = queries[k * BATCH:(k + 1) * BATCH]
        base = LocalTransport()
        tp = NetModelTransport(base, LAN)
        ops.reset_launches()
        t0 = time.perf_counter()
        rt = FourPartyRuntime(RING64, seed=SEED + k, transport=tp,
                              device=dev)
        words = mlp_net_predict_runtime(rt, enc, net, X).cpu()
        abort = rt.abort_flag()
        wall = time.perf_counter() - t0
        check(not abort, "the in-process socket reference aborted")
        ref.append({"words": words, "totals": base.totals(),
                    "per_link": base.per_link(), "wall_s": wall,
                    "modeled": {p: tp.seconds(p) for p in
                                ("offline", "online")},
                    "launches": {c.name: c.launches for c in ops.KERNELS}})
    return ref


def summed_traffic(ref: list) -> tuple:
    """(totals(), per_link()) summed over `ref`'s batches, as a
    ``serve_over_sockets`` report sums them."""
    totals = {p: {k: sum(r["totals"][p][k] for r in ref)
                  for k in ("rounds", "bits")}
              for p in ("offline", "online")}
    links = {}
    for r in ref:
        for link, bits in r["per_link"].items():
            acc = links.setdefault(link, dict.fromkeys(bits, 0))
            for p, b in bits.items():
                acc[p] += b
    return totals, links


def cluster_phase(params, net, queries, kernels: list, card: str) -> tuple:
    """The port's four-party deployment on the card: four daemon processes
    over a TCP mesh (``runtime.net.PartyCluster``, the LAN model), a
    dealer process streaming live prep, each against the in-process
    runtime on the card; see the module docstring, step 11.  Returns its
    numbers and the in-process references (``socket_references``)."""
    import functools

    import torch
    from repro_torch.core.ring import words_to_numpy
    from repro_torch.runtime.net import LAN, PartyCluster, run_four_parties
    from repro_torch.serve.party_server import serve_over_sockets
    from repro_torch.train import secure_sgd as SGD
    from repro_torch.train.data import MNISTLike

    dev = torch.device("cuda")
    predict = functools.partial(cluster_predict, params=params, net=net)
    out = {"card": card}

    # 1. the in-process runtime on the card
    ref = socket_references(params, net, queries)

    # 2. boot, then serve the same batches inline through the daemons
    t0 = time.perf_counter()
    cluster = PartyCluster(device="cuda", live_prep=True, net_model=LAN,
                           timeout=CLUSTER_TIMEOUT)
    out["boot_s"] = time.perf_counter() - t0
    print(f"cluster [{card}]: four daemons on the card over TCP booted in "
          f"{out['boot_s']:.2f} s (spawn, torch import, CUDA context, the "
          f"kernel libraries loaded, mesh)")
    try:
        # a fresh daemon's first task loads PyTorch's kernels as it meets
        # them; one batch first, so the served batches are warm, as the
        # in-process ones are
        t0 = time.perf_counter()
        cluster.submit(functools.partial(cluster_batch, X=queries[:BATCH],
                                         params=params, net=net),
                       seed=SEED)
        out["first_task_s"] = time.perf_counter() - t0
        print(f"cluster [{card}]: the daemons' first batch (cold) took "
              f"{out['first_task_s']:.2f} s")
        before = cluster.submit(daemon_stats)   # every count to 0
        first = len(cluster.task_walls)
        preds, rep = serve_over_sockets(
            predict, queries, batch_size=BATCH, seed=SEED, net_model=LAN,
            timeout=CLUSTER_TIMEOUT, cluster=cluster, device="cuda")
        walls = cluster.task_walls[first:first + N_BATCHES]
        stats = cluster.submit(daemon_stats)
        check(not rep["aborted"], "cluster: a daemon aborted")
        want = np.concatenate([words_to_numpy(r["words"]) for r in ref])
        check(np.array_equal(np.stack(preds), want),
              "cluster: opened words differ from the in-process runtime's")
        sum_totals, sum_links = summed_traffic(ref)
        check(rep["totals"] == sum_totals and rep["per_link"] == sum_links,
              "cluster: totals() or per_link() differ from the in-process "
              "runtime's")
        modeled = {p: sum(r["modeled"][p] for r in ref)
                   for p in ("offline", "online")}
        # a daemon's modeled time is the difference of its running clock
        # across the task, so it agrees to rounding only
        check(all(abs(rep["modeled_lan_s"][p] - modeled[p])
                  <= 1e-9 * modeled[p] for p in modeled),
              "cluster: modeled LAN time differs from the in-process one")
        per_batch = {n: sum(r["launches"][n] for r in ref) / N_BATCHES
                     for n in CLUSTER_KERNELS}
        for r in stats:
            got = {n: r.result["launches"][n] / N_BATCHES
                   for n in CLUSTER_KERNELS}
            check(got == per_batch and all(got.values()),
                  f"cluster: daemon P{r.rank} launched {got} a batch, the "
                  f"in-process batch {per_batch}")
        split = {w: [(b.result[w] - a.result[w]) / N_BATCHES
                     for a, b in zip(before, stats)]
                 for w in ("recv_ms", "flush_ms", "d2h_ms", "h2d_ms")}
        launched = stats[0].result["launches"]
        for k in kernels:
            k["launches"] += launched[k["name"]]
            k.setdefault("launches_by_path", {})["cluster"] = \
                launched[k["name"]]
        print(f"cluster [{card}]: {N_BATCHES} batches of {BATCH} served "
              f"by serve_over_sockets: words, totals(), per_link() and "
              f"modeled LAN time equal to the in-process runtime's, all "
              f"four daemons agreeing, no abort; launches a batch in every "
              f"daemon {per_batch}, equal to the in-process batch's")
        for k, (w, r) in enumerate(zip(walls, ref)):
            print(f"cluster [{card}]: batch {k}: round trip {w * 1e3:.1f} "
                  f"ms (in-process {r['wall_s'] * 1e3:.1f} ms); "
                  f"{rep['frames_per_batch'][k]} frames, "
                  f"{rep['wire_bytes_per_batch'][k]} wire bytes (all four "
                  f"daemons; tallied {sum_totals['offline']['bits'] // 8 // N_BATCHES} "
                  f"offline + {sum_totals['online']['bits'] // 8 // N_BATCHES} "
                  f"online bytes)")
        print(f"cluster [{card}]: a batch, each daemon blocked "
              f"{[round(v, 1) for v in split['recv_ms']]} ms in receives "
              f"(the peers, then the host-to-device copy) and "
              f"{[round(v, 1) for v in split['flush_ms']]} ms in flushes "
              f"(the copy to the host, the socket writes); the copies "
              f"alone: {[round(v, 1) for v in split['d2h_ms']]} ms to the "
              f"host, {[round(v, 1) for v in split['h2d_ms']]} ms to the "
              f"device")
        out.update({
            **{f"{w}_per_batch": v for w, v in split.items()},
            "serve_task_walls_ms": [w * 1e3 for w in walls],
            "serve_in_process_walls_ms": [r["wall_s"] * 1e3 for r in ref],
            "frames_per_batch": rep["frames_per_batch"],
            "wire_bytes_per_batch": rep["wire_bytes_per_batch"],
            "tallied_bytes_per_batch": sum(
                t["bits"] for t in sum_totals.values()) // 8 // N_BATCHES,
            "launches_per_batch": per_batch,
            "peak_bytes_after_serving": [r.result["peak_bytes"]
                                         for r in stats]})

        # 3. live training: 3 NN steps fed by a dealer process on the card
        task = SGD.nn_task(lr=TRAIN_LR)
        tparams = task.init_params(seed=0)
        data = MNISTLike(n=8192, seed=2)
        batches = [data.batch(step, BATCH)[:2]
                   for step in range(TRAIN_STEPS)]
        want_steps = train_steps(task, tparams, batches, device=dev)
        with SGD.attach_live_dealer(cluster, task, tparams, batches[0],
                                    base_seed=SEED,
                                    total=TRAIN_STEPS) as dealer:
            sgd = SGD.ClusterSGD(cluster, task, base_seed=SEED, prep="live")
            cluster.submit(daemon_stats)
            p, got, leads = tparams, [], []
            for step, batch in enumerate(batches):
                leads.append(dealer.dealt - step)
                t0 = time.perf_counter()
                p, loss, abort = sgd.step_fn(p, step, *batch)
                got.append((p, loss, None, time.perf_counter() - t0))
                check(not abort, f"cluster: live step {step} aborted")
            tstats = cluster.submit(daemon_stats)
            shipped = list(dealer.shipped)
        check_trajectory("cluster: live training against run_step in "
                         "process", got, want_steps)
        check(sgd.offline_bits_on_mesh() == 0,
              "cluster: live training moved offline bits on the mesh")
        tl = {n: tstats[0].result["launches"][n] / TRAIN_STEPS
              for n in CLUSTER_KERNELS}
        check(all(r.result["launches"] == tstats[0].result["launches"]
                  for r in tstats) and tl["prf_mask"] == 0
              and tl["mpc_matmul_grid"] > 0,
              f"cluster: online-only step launches {tl} (no PRF draw "
              "online, the online grids launched, every daemon alike)")
        waits = [res[0].prep_wait_s for res in sgd.results]
        out.update({
            "train_step_walls_ms": [w * 1e3 for w in
                                    cluster.task_walls[-TRAIN_STEPS - 1:-1]],
            "train_in_process_walls_ms": [s[3] * 1e3 for s in want_steps],
            "train_prep_wait_ms": [w * 1e3 for w in waits],
            "dealer_sessions_ahead_at_submit": leads,
            "dealer_blob_bytes": [b for _, b, _ in shipped],
            "train_launches_per_step": tl})
        print(f"cluster [{card}]: {TRAIN_STEPS} ClusterSGD(prep='live') NN "
              f"steps bit-equal to run_step in process, 0 offline bits on "
              f"the mesh; step walls "
              f"{[round(w, 1) for w in out['train_step_walls_ms']]} ms (in "
              f"process {[round(w, 1) for w in out['train_in_process_walls_ms']]}"
              f" ms); the dealer {leads} sessions ahead at each submit, "
              f"daemons waited {[round(w, 1) for w in out['train_prep_wait_ms']]}"
              f" ms for prep; sessions of {out['dealer_blob_bytes']} bytes "
              f"on the control queues; online-only launches a step {tl}")

        # 4. one sharded step over two members (this cluster twice)
        shards = SGD.shard_batch(batches[0], 2)
        sh = SGD.ShardedClusterSGD([cluster, cluster], task, base_seed=SEED)
        mean, _, abort = sh.step_fn(tparams, 0, *batches[0])
        members = [SGD.run_step(task, tparams, s, step=0, base_seed=SEED,
                                device=dev) for s in shards]
        check(not abort and same_params(mean, {
            k: np.mean([m[0][k] for m in members], axis=0)
            for k in tparams}),
            "cluster: the sharded step is not the mean of its members")
        print(f"cluster [{card}]: ShardedClusterSGD, 2 shards of "
              f"{BATCH // 2}: the mean of the members' in-process steps")
        final = cluster.submit(daemon_stats)
        out["peak_bytes"] = [r.result["peak_bytes"] for r in final]
        print(f"cluster [{card}]: daemon peak device memory "
              f"{[round(b / 2**20, 1) for b in out['peak_bytes']]} MiB")
    finally:
        cluster.close()

    # 5. live serving: its own cluster and dealer, the inline words
    lpreds, lrep = serve_over_sockets(
        predict, queries, batch_size=BATCH, seed=SEED, net_model=LAN,
        prep="live", timeout=CLUSTER_TIMEOUT, device="cuda")
    check(np.array_equal(np.stack(lpreds), want) and not lrep["aborted"]
          and lrep["totals"]["offline"]["bits"] == 0
          and lrep["totals"]["online"] == rep["totals"]["online"],
          "cluster: live serving's words or online traffic differ from "
          "inline serving's")
    print(f"cluster [{card}]: serve_over_sockets(prep='live'): the inline "
          f"words, 0 offline bits, party wall {lrep['party_wall_s']:.3f} s")

    # 6. a tampered gamma piece aborts
    res = run_four_parties(
        functools.partial(cluster_batch, X=queries[:BATCH], params=params,
                          net=net),
        seed=SEED, tampers=[TAMPER], timeout=CLUSTER_TIMEOUT, device="cuda")
    check(all(r.abort for r in res), "cluster: a tampered .g2 did not abort")
    print(f"cluster [{card}]: run_four_parties with {TAMPER}: every daemon "
          f"aborted")
    out["live_serve_party_wall_s"] = lrep["party_wall_s"]
    return out, ref


# --- the observability plane (phase "obs") -------------------------------
# each kernel-backend kind and the kernel its calls launch; the profiler
# tells ring_matmul.cu's one kernel apart by name only, not the gamma
# pieces' ring matmuls from the online grids, and gamma_parts.cu's kernel
# by its mode (ring: mult_terms, XOR: and_terms)
OBS_KIND_KERNELS = {
    "prf_bits": "prf_mask", "prf_bounded": "prf_mask",
    "gamma.matmul": "ring_matmul + mpc_matmul_grid",
    "online.matmul": "ring_matmul + mpc_matmul_grid",
    "gamma.mul": "mult_terms", "online.mul": "mult_terms",
    "gamma.bool": "and_terms", "online.bool": "and_terms",
}
OBS_CATEGORIES = ("protocol", "wire.round", "wire.send", "kernel")


def profiled_kernel(key: str) -> str | None:
    """The kernel of ``OBS_KIND_KERNELS`` a profiler key names, if any."""
    if "squares_group_kernel" in key:
        return "prf_mask"
    if "ring_matmul_kernel" in key:
        return "ring_matmul + mpc_matmul_grid"
    if "terms_group_kernel" in key:
        return "and_terms" if "true" in key else "mult_terms"
    return None


def nonzero_links(per_link: dict) -> dict:
    """``per_link()``'s cells that moved bits: what the tracer and the
    registry keep."""
    out = {}
    for link, per in per_link.items():
        cell = {p: b for p, b in per.items() if b}
        if cell:
            out[link] = cell
    return out


def span_counts(chunks, tid=None, other_threads: bool = False) -> dict:
    """kind -> [kernel spans, their summed device ms] over `chunks` (the
    spans of thread `tid` alone, or with `other_threads` those of every
    other thread); fails on a span without a finite device time >= 0."""
    import math
    out = {}
    for chunk in chunks:
        for e in chunk["events"]:
            if e["cat"] != "kernel" or (
                    tid is not None and (e["tid"] == tid) == other_threads):
                continue
            ms = e["args"].get("device_ms")
            check(ms is not None and math.isfinite(ms) and ms >= 0,
                  f"obs: {chunk['label']}: a {e['name']} span without a "
                  f"device time ({ms})")
            acc = out.setdefault(e["args"]["kind"], [0, 0.0])
            acc[0] += 1
            acc[1] += ms
    return out


def check_windows(what: str, spans: dict, profile: dict,
                  batches: int = 1) -> dict:
    """Each kernel's summed ``device_ms`` over `batches` batches against
    its device time in one profiled batch (`profile`: ms by profiler key).
    The timing events bracket a call's kernels on the stream that runs
    them, so the windows hold those kernels: a kernel whose windows sum to
    less than `batches` times its profiled time had its events recorded on
    another stream.  Returns (windows, profiled) ms by kernel."""
    got, floor = {}, {}
    for kind, (_, ms) in spans.items():
        name = OBS_KIND_KERNELS[kind]
        got[name] = got.get(name, 0.0) + ms
    for key, ms in profile.items():
        name = profiled_kernel(key)
        if name is not None:
            floor[name] = floor.get(name, 0.0) + ms
    check(floor, f"obs: {what}: the profile holds none of the kernels")
    for name, ms in sorted(floor.items()):
        check(got.get(name, 0.0) >= batches * ms,
              f"obs: {what}: {name}'s device windows sum to "
              f"{got.get(name, 0.0):.4f} ms, under {batches} x its "
              f"profiled {ms:.4f} ms")
    return got, floor


def registry_kinds(snap: dict) -> dict:
    """``trident_kernel_launches_total`` by kind."""
    fam = snap["metrics"].get("trident_kernel_launches_total")
    return {s["labels"]["kind"]: s["value"]
            for s in (fam["samples"] if fam else ())}


def daemon_per_link(rt, _rank):
    """Read inside a daemon: its transport's per_link() over every task."""
    return rt.transport.per_link()


def obs_phase(params, net, queries, kernels: list, step4: dict,
              cluster_out: dict, ref: list, card: str) -> dict:
    """The observability plane on the card: a traced in-process batch and
    a traced pipelined one, then a traced, scraped cluster; see the module
    docstring, step 12.  ``ref`` is phase cluster's in-process references.
    Tracing stays off in every other phase."""
    import functools
    import shutil
    import tempfile
    import threading

    import torch
    from repro_torch import obs
    from repro_torch.core.ring import RING64, words_to_numpy
    from repro_torch.runtime.net import LAN, PartyCluster
    from repro_torch.serve.party_server import (PartyPredictionServer,
                                                serve_over_sockets)
    from repro_torch.train.paper_ml import (mlp_net_predict_runtime,
                                            params_from_numpy)

    out = {"card": card}
    X0 = queries[:BATCH]

    # 1. in process: step 4's batch 0, untraced and traced in turns (off,
    # on, on, off), each under a fresh registry; the first traced batch is
    # a driven path and is checked
    def batch(traced: bool):
        tracer = obs.Tracer("obs") if traced else obs.NULL_TRACER
        reg = obs.MetricsRegistry("obs")
        prev = obs.install_tracer(tracer), obs.install_registry(reg)
        try:
            srv, words = serve("cuda", "hopper", params, net, X0)
        finally:
            obs.install_tracer(prev[0])
            obs.install_registry(prev[1])
        link_bits = tracer.link_bits() if traced else None
        t0 = time.perf_counter()
        chunk = tracer.drain()
        return {"srv": srv, "words": words, "reg": reg, "chunk": chunk,
                "link_bits": link_bits,
                "drain_s": time.perf_counter() - t0}

    walls = {"off": [], "on": []}
    runs = []
    for k, traced in enumerate((False, True, True, False)):
        if k == 1:
            run, _ = drive("obs_runtime", kernels, CLUSTER_KERNELS,
                           lambda: batch(True), 1)
        else:
            run = batch(traced)
        runs.append(run)
        walls["on" if traced else "off"].append(
            run["srv"].stats.batch_walls_s[0])
        check(torch.equal(run["words"].cpu(), step4["words"])
              and run["srv"].batch_traffic[0] == step4["traffic"],
              f"obs: batch {k} ({'traced' if traced else 'untraced'}): "
              f"words, per_link() or totals() differ from step 4's batch 0")
    t = runs[1]
    per_link = t["srv"].batch_traffic[0][0]
    check(t["link_bits"] == nonzero_links(per_link),
          "obs: the tracer's link bits differ from per_link()")
    check(t["reg"].link_bits() == nonzero_links(per_link),
          "obs: trident_wire_bits_total differs from per_link()")
    launched = {k["name"]: k["launches_by_path"]["obs_runtime"]
                for k in kernels}
    check(all(launched[n] == step4["launches"][n] for n in CLUSTER_KERNELS),
          f"obs: traced launches {launched}, untraced batch "
          f"{step4['launches']}")
    spans = span_counts([t["chunk"]])
    kinds = registry_kinds(t["reg"].snapshot())
    print(f"obs [{card}]: in process, kernel spans per kind "
          f"{ {k: v[0] for k, v in spans.items()} }; "
          f"trident_kernel_launches_total {kinds}")
    check({k: v[0] for k, v in spans.items()} == kinds,
          "obs: kernel spans per kind differ from the registry's launches")
    cats = {e["cat"] for e in t["chunk"]["events"]}
    check(all(c in cats for c in OBS_CATEGORIES),
          f"obs: categories {sorted(cats)} lack one of {OBS_CATEGORIES}")
    snap = t["reg"].snapshot()
    lines = [ln for ln in t["reg"].render_prometheus().splitlines()
             if not ln.startswith("#")]
    samples = sum(len(s["edges"]) + 3 if f["type"] == "histogram" else 1
                  for f in snap["metrics"].values() for s in f["samples"])
    check(len(lines) == samples, f"obs: {len(lines)} Prometheus sample "
          f"lines for {samples} of the snapshot")
    per_kernel, profiled = check_windows("in process", spans,
                                         step4["profile"])
    chunk_bytes = len(json.dumps(t["chunk"]))
    out.update({
        "in_process_walls_ms": {m: [w * 1e3 for w in v]
                                for m, v in walls.items()},
        "drain_ms": [r["drain_s"] * 1e3 for r in runs if r["link_bits"]],
        "trace_events_per_batch": len(t["chunk"]["events"]),
        "chunk_bytes_per_batch": chunk_bytes,
        "kernel_spans": {k: v[0] for k, v in spans.items()},
        "device_ms_by_kind": {k: v[1] for k, v in spans.items()},
        "device_ms_by_kernel": per_kernel,
        "step4_profiled_ms_by_kernel": profiled})
    print(f"obs [{card}]: batch 0 in process, walls untraced "
          f"{[round(w * 1e3, 1) for w in walls['off']]} ms, traced "
          f"{[round(w * 1e3, 1) for w in walls['on']]} ms (drain "
          f"{[round(v, 2) for v in out['drain_ms']]} ms); "
          f"{out['trace_events_per_batch']} trace events, {chunk_bytes} "
          f"chunk bytes (JSON) a batch; words, per_link(), totals() and "
          f"launches those of step 4's batch 0; tracer and registry bits "
          f"equal to per_link()")
    for name in sorted(per_kernel):
        print(f"obs [{card}]: {name}: kernel spans' device_ms "
              f"{per_kernel[name]:.4f} ms a batch (the stream's window "
              f"around the backend calls); step 4's profile "
              f"{profiled.get(name, 0.0):.4f} ms (the kernels alone)")

    # the pipelined server, traced: batch 0 dealt on the dealer thread's
    # own CUDA stream and served online-only on the serving thread's; each
    # thread's kernel windows against the profiled deal and online-only
    # runs of step 5
    tracer, reg = obs.Tracer("obs"), obs.MetricsRegistry("obs")
    prev = obs.install_tracer(tracer), obs.install_registry(reg)
    try:
        enc = params_from_numpy(params, RING64, "cuda")
        psrv = PartyPredictionServer(
            lambda rt, Xb: mlp_net_predict_runtime(rt, enc, net, Xb),
            batch_size=BATCH, seed=SEED, prep="pipelined", device="cuda")
        for q in X0:
            psrv.submit(q)
        pwords = torch.stack(psrv.flush())
        psrv.close()
    finally:
        obs.install_tracer(prev[0])
        obs.install_registry(prev[1])
    pchunk = tracer.drain()
    check(torch.equal(pwords.cpu(), step4["words"]),
          "obs: the traced pipelined batch's words differ from step 4's "
          "batch 0")
    pspans = span_counts([pchunk])
    check({k: v[0] for k, v in pspans.items()}
          == registry_kinds(reg.snapshot()),
          "obs: the pipelined batch's kernel spans differ from the "
          "registry's launches")
    # the batch runs online-only on the serving thread, the gateway's
    # collector (the thread of its serve.batch.online span), while the
    # dealer thread deals it; this thread only waits
    served = {e["tid"] for e in pchunk["events"]
              if e["name"] == "serve.batch.online"}
    check(len(served) == 1 and threading.get_ident() not in served,
          f"obs: serve.batch.online spans on threads {served}")
    server = served.pop()
    online = span_counts([pchunk], tid=server)
    dealt = span_counts([pchunk], tid=server, other_threads=True)
    kernel_tids = {e["tid"] for e in pchunk["events"] if e["cat"] == "kernel"}
    check(online and dealt and len(kernel_tids) == 2,
          f"obs: pipelined kernel spans on the serving thread "
          f"{sorted(online)}, on the dealer thread {sorted(dealt)}, on "
          f"{len(kernel_tids)} threads")
    pipe_online = check_windows("pipelined, online-only", online,
                                step4["profile_split"]["online_only"])
    pipe_deal = check_windows("pipelined, dealer thread", dealt,
                              step4["profile_split"]["deal"])
    out["pipelined_device_ms_by_kernel"] = {
        "online_only": pipe_online[0], "dealer_thread": pipe_deal[0],
        "profiled_online_only": pipe_online[1],
        "profiled_deal": pipe_deal[1]}
    for what, (got, floor) in (("online-only", pipe_online),
                               ("dealer thread", pipe_deal)):
        print(f"obs [{card}]: pipelined batch 0, {what}: device_ms by "
              f"kernel { {k: round(v, 4) for k, v in got.items()} }; "
              f"step 5's profile { {k: round(v, 4) for k, v in floor.items()} }")

    # 2. one traced, metered cluster: a warm-up task, an inline stream
    # (its batches' spans against the daemons' launches), a live stream
    # (the dealer scraped), scrapes, the merged timeline, a terminated
    # daemon.  Health documents only between tasks and at a stream's end.
    want = np.concatenate([words_to_numpy(r["words"]) for r in ref])
    sum_totals, sum_links = summed_traffic(ref)
    per_batch = {n: sum(r["launches"][n] for r in ref) / N_BATCHES
                 for n in CLUSTER_KERNELS}
    predict = functools.partial(cluster_predict, params=params, net=net)
    t0 = time.perf_counter()
    cluster = PartyCluster(device="cuda", trace=True, metrics=True,
                           live_prep=True, net_model=LAN,
                           timeout=CLUSTER_TIMEOUT)
    out["boot_s"] = time.perf_counter() - t0
    tmp = tempfile.mkdtemp(prefix="obs-trace-")
    try:
        check(sorted(cluster.metrics_ports) == [0, 1, 2, 3]
              and all(cluster.metrics_ports.values()),
              f"obs: exporter ports {cluster.metrics_ports}")
        warm = cluster.submit(functools.partial(cluster_batch, X=X0,
                                                params=params, net=net),
                              seed=SEED)
        for r in warm:
            check(np.array_equal(r.result, words_to_numpy(ref[0]["words"]))
                  and r.per_link == ref[0]["per_link"] and not r.abort,
                  f"obs: warm-up task on P{r.rank} differs from the "
                  f"in-process batch")
            check(obs.snapshot_link_bits(r.metrics)
                  == nonzero_links(r.per_link)
                  and obs.snapshot_value(r.metrics,
                                         "trident_cluster_tasks_total") == 1
                  and obs.snapshot_value(
                      r.metrics, "trident_cluster_tasks_inflight") == 0,
                  f"obs: P{r.rank}'s task metrics: bits, tasks or inflight")
        merged_bits = obs.merged_link_bits([r.trace for r in warm])
        check(merged_bits == {f"{s}->{d}": c for (s, d), c
                              in nonzero_links(ref[0]["per_link"]).items()},
              "obs: merged_link_bits of the warm-up task differ from "
              "per_link()")

        cluster.submit(daemon_stats)            # launch counts to 0
        before = cluster.scrape()
        n0 = len(cluster.trace_chunks)        # four chunks a task
        first = len(cluster.task_walls)
        preds, rep = serve_over_sockets(
            predict, queries, batch_size=BATCH, seed=SEED, net_model=LAN,
            timeout=CLUSTER_TIMEOUT, cluster=cluster, device="cuda",
            metrics=True)
        inline_walls = cluster.task_walls[first:first + N_BATCHES]
        chunks = cluster.trace_chunks[n0:n0 + 4 * N_BATCHES]
        stats = cluster.submit(daemon_stats)
        after = cluster.scrape()
        check(np.array_equal(np.stack(preds), want) and not rep["aborted"]
              and rep["totals"] == sum_totals
              and rep["per_link"] == sum_links,
              "obs: the traced inline stream's words or traffic differ from "
              "the in-process runtime's")
        print(f"obs [{card}]: inline stream health {json.dumps(rep['health'])}")
        check(rep["health"]["healthy"], "obs: the inline stream's health "
              "document is not healthy")
        check(sorted(c["rank"] for c in chunks)
              == sorted(list(range(4)) * N_BATCHES),
              f"obs: {len(chunks)} daemon chunks for {N_BATCHES} batches")
        for k in kernels:
            n = stats[0].result["launches"][k["name"]]
            k["launches"] += n
            k["launches_by_path"]["obs_cluster"] = n
        for r in stats:
            rank = r.rank
            got = {n: r.result["launches"][n] / N_BATCHES
                   for n in CLUSTER_KERNELS}
            spans = span_counts([c for c in chunks if c["rank"] == rank])
            delta = {k: v - registry_kinds(before[rank]).get(k, 0)
                     for k, v in registry_kinds(after[rank]).items()}
            print(f"obs [{card}]: P{rank}: launches a batch {got}; kernel "
                  f"spans per kind (2 batches) "
                  f"{ {k: v[0] for k, v in spans.items()} }; registry "
                  f"launches {delta}")
            check(got == per_batch, f"obs: P{rank} launched {got} a batch, "
                  f"the in-process batch {per_batch}")
            check({k: v[0] for k, v in spans.items()}
                  == {k: v for k, v in delta.items() if v},
                  f"obs: P{rank}'s kernel spans differ from its launches")
            windows, _ = check_windows(f"P{rank}", spans, step4["profile"],
                                       batches=N_BATCHES)
            out.setdefault("daemon_device_ms_by_kernel", {})[rank] = windows

        first = len(cluster.task_walls)
        lpreds, lrep = serve_over_sockets(
            predict, queries, batch_size=BATCH, seed=SEED, net_model=LAN,
            timeout=CLUSTER_TIMEOUT, cluster=cluster, device="cuda",
            prep="live", metrics=True)
        live_walls = cluster.task_walls[first:first + N_BATCHES]
        health = lrep["health"]
        print(f"obs [{card}]: live stream health {json.dumps(health)}")
        check(np.array_equal(np.stack(lpreds), want) and not lrep["aborted"]
              and lrep["totals"]["offline"]["bits"] == 0
              and lrep["totals"]["online"] == sum_totals["online"],
              "obs: the live stream's words or traffic differ")
        check(health["healthy"] and sorted(health["ranks"]) == [0, 1, 2, 3]
              and all(e["alive"] and e["scrape_ok"]
                      for e in health["ranks"].values())
              and health["dealer"] is not None
              and health["dealer"]["scrape_ok"],
              "obs: the end-of-stream health document is not healthy with "
              "four ranks and the dealer scraped")

        links = {r.rank: r.result for r in cluster.submit(daemon_per_link)}
        t0 = time.perf_counter()
        snaps = cluster.scrape()
        scrape_s = time.perf_counter() - t0
        check(sorted(snaps) == [0, 1, 2, 3] and all(snaps.values()),
              f"obs: scraped {sorted(k for k, v in snaps.items() if v)}")
        for rank, snap in snaps.items():
            check(obs.snapshot_link_bits(snap) == nonzero_links(links[rank])
                  and obs.snapshot_value(
                      snap, "trident_cluster_tasks_inflight") == 0,
                  f"obs: P{rank}'s scrape: bits differ from its per_link() "
                  f"or a task in flight")
        t0 = time.perf_counter()
        doc = cluster.health()
        health_s = time.perf_counter() - t0
        check(doc["healthy"], f"obs: health between tasks {doc}")

        dealer_chunks = [c for c in cluster.trace_chunks
                         if c["label"] == "dealer"]
        merged = cluster.save_trace(os.path.join(tmp, "cluster.json"))
        procs = sorted(merged["metadata"]["processes"])
        check(procs == ["dealer"] + [f"party-P{r}" for r in range(4)]
              and merged["metadata"]["ranks"] == [0, 1, 2, 3],
              f"obs: the merged timeline's processes {procs}")
        trace_bytes = os.path.getsize(os.path.join(tmp, "cluster.json"))

        victim = cluster._procs[3]
        victim.terminate()
        victim.join(timeout=30)
        down = cluster.health()
        print(f"obs [{card}]: after P3 was terminated: {json.dumps(down)}")
        check(not down["healthy"] and [
            (p["probe"], p.get("rank")) for p in down["probes"]]
            == [("rank_down", 3)],
            "obs: a terminated daemon is not reported rank_down")
    finally:
        cluster.close()
        shutil.rmtree(tmp, ignore_errors=True)
    untraced = cluster_out["serve_task_walls_ms"]
    out.update({
        "cluster_boot_s": out.pop("boot_s"),
        "cluster_inline_walls_ms": [w * 1e3 for w in inline_walls],
        "cluster_untraced_inline_walls_ms": untraced,
        "cluster_live_walls_ms": [w * 1e3 for w in live_walls],
        "scrape_ms": scrape_s * 1e3, "health_ms": health_s * 1e3,
        "merged_trace_bytes": trace_bytes,
        "merged_trace_events": len(merged["traceEvents"]),
        "dealer_chunks": len(dealer_chunks)})
    print(f"obs [{card}]: cluster booted traced and metered in "
          f"{out['cluster_boot_s']:.2f} s; inline batches traced "
          f"{[round(w, 1) for w in out['cluster_inline_walls_ms']]} ms "
          f"(phase cluster, untraced: {[round(w, 1) for w in untraced]} "
          f"ms); live (online-only) batches "
          f"{[round(w, 1) for w in out['cluster_live_walls_ms']]} ms; "
          f"scrape of four exporters {scrape_s * 1e3:.2f} ms, health "
          f"document {health_s * 1e3:.2f} ms; merged timeline "
          f"{out['merged_trace_events']} events, {trace_bytes} bytes, the "
          f"four ranks and the dealer ({len(dealer_chunks)} chunks)")
    return out


# --- the serving gateway (phase "gateway") --------------------------------
GW_POOL = 2
# the burst: 3 x 128 queries from 4 threads, coalesced within 50 ms; then
# the dispatches one at a time of the reference design's stall
GW_BURST = 3 * BATCH
GW_THREADS = 4
GW_WAIT_MS = 50.0
GW_SINGLES = 9
# the daemons' online-only kernels; the dealer launches prf_mask and the
# gamma pieces' ring_matmul
GW_ONLINE_KERNELS = ("mpc_matmul_grid", "mult_terms", "and_terms")


def gateway_phase(params, net, kernels: list, card: str) -> dict:
    """The serving gateway on the card: a live pool of two clusters behind
    one dynamic-batching front end and one shared dealer process, then a
    member killed with batches queued; see the module docstring, step
    11."""
    import functools
    import threading

    import torch
    from repro_torch.core.ring import RING64, words_to_numpy
    from repro_torch.obs import snapshot_value
    from repro_torch.obs.health import scrape
    from repro_torch.runtime import FourPartyRuntime
    from repro_torch.serve.gateway import ServingGateway
    from repro_torch.train.paper_ml import (mlp_net_predict_runtime,
                                            params_from_numpy)

    t_phase = time.perf_counter()
    out = {"card": card}
    predict = functools.partial(cluster_predict, params=params, net=net)
    queries = np.random.RandomState(SEED + 3).randn(
        GW_BURST + GW_SINGLES + 2 * BATCH, net.features)
    online = {n: next(k for k in kernels if k["name"] == n)[
        "launches_by_path"]["online_only"] for n in CLUSTER_KERNELS}

    def step(text: str) -> None:
        print(f"gateway [{card}]: {text}", flush=True)

    step(f"booting a live pool of {GW_POOL} clusters (4 daemons each) on "
         "the card")
    t0 = time.perf_counter()
    gw = ServingGateway(predict, pool=GW_POOL, prep="live", device="cuda",
                        metrics=True, keep_results=True, max_batch=BATCH,
                        max_wait_ms=GW_WAIT_MS, base_seed=SEED,
                        timeout=CLUSTER_TIMEOUT)
    out["boot_s"] = time.perf_counter() - t0
    step(f"pool booted in {out['boot_s']:.2f} s")
    clusters = [m.backend.cluster for m in gw._members]
    leads, sampling = [], threading.Event()

    def sample_lead():
        # sessions the dealer shipped past the next one to dispatch
        while not sampling.wait(0.05):
            if gw.dealer is not None:
                leads.append(gw.dealer.dealt - gw._session_ctr)

    sampler = threading.Thread(target=sample_lead, daemon=True)
    try:
        step("setting every daemon's launch counts to 0")
        for c in clusters:
            c.submit(daemon_stats)
        sampler.start()
        step(f"burst of {GW_BURST} queries from {GW_THREADS} threads "
             f"(window {GW_WAIT_MS:g} ms)")
        t0 = time.perf_counter()
        futs = [None] * GW_BURST

        def feed(k):
            for i in range(k, GW_BURST, GW_THREADS):
                futs[i] = gw.submit(queries[i])

        feeders = [threading.Thread(target=feed, args=(k,))
                   for k in range(GW_THREADS)]
        for t in feeders:
            t.start()
        for t in feeders:
            t.join()
        gw.drain(timeout=CLUSTER_TIMEOUT)
        out["burst_s"] = time.perf_counter() - t0
        out["burst_report"] = gw.report()
        step(f"burst served in {out['burst_s']:.2f} s: "
             f"{json.dumps(out['burst_report'])}")

        step(f"{GW_SINGLES} dispatches one at a time")
        single_walls = []
        for i in range(GW_BURST, GW_BURST + GW_SINGLES):
            t0 = time.perf_counter()
            fut = gw.submit(queries[i])
            gw.flush()
            fut.result(timeout=CLUSTER_TIMEOUT)
            single_walls.append(time.perf_counter() - t0)
            futs.append(fut)
        out["single_walls_ms"] = [w * 1e3 for w in single_walls]
        step(f"one-at-a-time walls "
             f"{[round(w, 1) for w in out['single_walls_ms']]} ms")
        sampling.set()
        sampler.join()
        rep = gw.report()
        records = [r for m in gw._members for r in m.dispatch_log]
        sessions = sorted(r["session"] for r in records)
        check(rep["evictions"] == 0 and rep["pool_size"] == GW_POOL,
              f"gateway: evictions {rep['evictions']} before the kill")
        check(sessions == list(range(len(records))),
              f"gateway: sessions dispatched {sessions}, not each once")
        singles = [r["member"] for r in sorted(
            records, key=lambda r: r["session"])[-GW_SINGLES:]]
        check(all(a != b for a, b in zip(singles, singles[1:])),
              f"gateway: the one-at-a-time dispatches went to members "
              f"{singles}, not in turns")
        step("reading every daemon's launches, consumed sessions and peak "
             "device memory")
        stats = [c.submit(daemon_stats) for c in clusters]
        snaps = [c.scrape() for c in clusters]
        per_member = {}
        for m, c, st, snap in zip(gw._members, clusters, stats, snaps):
            n = len(m.dispatch_log)
            per_member[m.idx] = n
            for r in st:
                got = {k: r.result["launches"][k] / n
                       for k in CLUSTER_KERNELS}
                check(got == online,
                      f"gateway: member {m.idx} P{r.rank} launched {got} "
                      f"a dispatch, the in-process online-only batch "
                      f"{online}")
            for rank, s in snap.items():
                consumed = snapshot_value(
                    s, "trident_prep_sessions_consumed_total")
                check(consumed == n,
                      f"gateway: member {m.idx} P{rank} consumed {consumed} "
                      f"sessions for {n} dispatches")
            for results in m.results_log:
                check(all(r.totals["offline"]["bits"] == 0 and not r.abort
                          for r in results),
                      f"gateway: member {m.idx}: offline bits on the mesh "
                      "or an abort")
        launched = {k: sum(st[0].result["launches"][k] for st in stats)
                    for k in CLUSTER_KERNELS}
        check(all(launched[k] for k in GW_ONLINE_KERNELS),
              f"gateway: the pool's launches {launched}")
        for k in kernels:
            n = launched.get(k["name"], 0)
            k["launches"] += n
            k["launches_by_path"]["gateway"] = n
        dealer_kinds = registry_kinds(scrape(gw.dealer.metrics_port))
        check(dealer_kinds.get("prf_bits", 0) > 0
              and dealer_kinds.get("gamma.matmul", 0) > 0,
              f"gateway: the dealer's kernel launches by kind {dealer_kinds}")
        out.update({
            "dispatches_per_member": per_member,
            "launches_per_dispatch": online,
            "dealer_launches_by_kind": dealer_kinds,
            "peak_bytes": {m.idx: [r.result["peak_bytes"] for r in st]
                           for m, st in zip(gw._members, stats)},
            "report": rep})
        step(f"{len(records)} dispatches, sessions 0-{len(records) - 1} "
             f"each consumed once ({per_member} a member); every daemon "
             f"launched {online} a dispatch (the in-process online-only "
             f"batch's), 0 offline bits, no abort; the dealer's launches by "
             f"kind {dealer_kinds}")

        # stopped first, so the batch dispatched to member 0 cannot finish
        # before the kill
        step(f"stopping member 0's daemons, queueing {2 * BATCH} queries "
             "and killing the daemons once a batch was dispatched to them")
        more = queries[GW_BURST + GW_SINGLES:]
        for p in clusters[0]._procs:
            os.kill(p.pid, signal.SIGSTOP)
        kfuts = [gw.submit(q) for q in more]
        gw.flush()
        kqids = {f.qid for f in kfuts}
        deadline = time.monotonic() + 60
        while not any(kqids & set(r["qids"])
                      for r in gw._members[0].dispatch_log):
            check(time.monotonic() < deadline,
                  "gateway: no queued batch was dispatched to member 0")
            time.sleep(0.01)
        dealt_at_kill = gw.dealer.dealt
        for p in clusters[0]._procs:
            p.kill()
        gw.drain(timeout=CLUSTER_TIMEOUT)
        futs += kfuts
        deadline = time.monotonic() + 60
        while gw.dealer.dealt <= dealt_at_kill:
            check(time.monotonic() < deadline and gw.dealer.failed is None,
                  f"gateway: the dealer stopped at {gw.dealer.dealt} after "
                  f"the kill ({gw.dealer.failed})")
            time.sleep(0.05)
        health = gw.health()
        step(f"after the kill: health {json.dumps(health)}")
        check(health["pool"]["0"].get("evicted")
              and [e["member"] for e in health["evictions"]] == [0]
              and health["dealer_failed"] is None
              and not health["pool"]["1"].get("evicted"),
              "gateway: health does not name member 0 evicted and the "
              "dealer alive")
        lost = {q for r in gw._members[0].dispatch_log
                for q in r["qids"]} & kqids
        out["redispatched_queries"] = len(lost)
        final = gw.report()
        out["final_report"] = final
        out["dealt_at_kill"], out["dealt_after"] = \
            dealt_at_kill, gw.dealer.dealt
        shipped = list(gw.dealer.shipped)
        blob = [b for _, b, _ in shipped]
        # the dealer's pace (a session dealt and fanned out to 8 daemons)
        # and each dispatch's wait in the daemons for its session
        out["dealer_ship_intervals_ms"] = [
            (b[2] - a[2]) * 1e3 for a, b in zip(shipped, shipped[1:])]
        out["prep_wait_ms"] = {
            m.idx: [max(r.prep_wait_s for r in res) * 1e3
                    for res in m.results_log] for m in gw._members}
    finally:
        sampling.set()
        gw.close()

    step(f"checking {len(futs)} rows against the in-process runtime")
    after_kill = {id(f) for f in kfuts}
    enc = params_from_numpy(params, RING64, "cuda")
    records = [r for m in gw._members for r in m.dispatch_log]
    want = {}
    for fut, q in zip(futs, queries):
        rec = [r for r in records if fut.qid in r["qids"]][-1]
        if id(rec) not in want:
            rt = FourPartyRuntime(RING64, seed=rec["seed"], device="cuda")
            want[id(rec)] = words_to_numpy(
                mlp_net_predict_runtime(rt, enc, net, rec["X"]).cpu())
            check(not rt.abort_flag(), "gateway: the in-process twin "
                  "aborted")
        i = rec["qids"].index(fut.qid)
        check(np.array_equal(rec["X"][i], q)
              and np.array_equal(fut.result(), want[id(rec)][i]),
              f"gateway: query {fut.qid}'s row differs from the in-process "
              f"runtime at seed {rec['seed']}")
        if id(fut) in after_kill:
            check(rec["member"] == 1, f"gateway: query {fut.qid} after the "
                  f"kill served by member {rec['member']}")
            lost.discard(fut.qid)
    check(out["redispatched_queries"] > 0 and not lost,
          f"gateway: queries {sorted(lost)} of the batch killed on member 0 "
          "were not served by member 1")
    lat = {k: final[k] for k in ("p50_ms", "p95_ms", "p99_ms")}
    out.update({
        "largest_lead_sessions": max(leads) if leads else None,
        "session_blob_bytes": max(blob),
        "lead_host_bytes": max(leads + [0]) * max(blob) * 4 * GW_POOL,
        "dispatch_walls_ms": [w * 1e3 for w in gw.meter.batch_walls],
        "achieved_qps": final["achieved_qps"], "latency_ms": lat,
        "utilization": {i: m["utilization"]
                        for i, m in final["per_member"].items()}})
    step(f"every row equal to the in-process runtime at SEED + session; "
         f"the {2 * BATCH} queries queued at the kill served by member 1, "
         f"{out['redispatched_queries']} of them re-dispatched from the "
         "batch killed on member 0")
    print(f"gateway [{card}]: pool boot {out['boot_s']:.2f} s; dispatch "
          f"walls {[round(w, 1) for w in out['dispatch_walls_ms']]} ms; "
          f"{final['queries']} queries in {final['batches']} dispatches, "
          f"{final['achieved_qps']:.1f} queries/s; query latency p50 "
          f"{lat['p50_ms']:.1f} p95 {lat['p95_ms']:.1f} p99 "
          f"{lat['p99_ms']:.1f} ms; utilization {out['utilization']}; the "
          f"dealer's largest lead {out['largest_lead_sessions']} sessions "
          f"of {out['session_blob_bytes']} bytes ("
          f"{out['lead_host_bytes'] / 2**30:.2f} GiB of host memory across "
          f"{4 * GW_POOL} daemons); daemon peak device memory "
          f"{ {i: [round(b / 2**20, 1) for b in v] for i, v in out['peak_bytes'].items()} } MiB")
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"gateway [{card}]: phase wall {out['phase_s']:.1f} s")
    print(f"gateway [{card}]: the dealer shipped a session every "
          f"{[round(w) for w in out['dealer_ship_intervals_ms']]} ms; each "
          f"dispatch waited for its session "
          f"{ {i: [round(w) for w in v] for i, v in out['prep_wait_ms'].items()} }"
          f" ms (a member's, in completion order)")
    return out


# --- phase lm: the LM stack's serving path (kernel route K2) -------------
LM_SEED = 5
LM_SMOKE_ARCHS = ("qwen3_1_7b", "mixtral_8x7b", "whisper_tiny",
                  "phi_3_vision_4_2b")
LM_SMOKE_IDS = (2, 8)
# the main path: qwen3-1.7b's CONFIG (full width) cut to LM_LAYERS of its
# 28 layers; one prefill of LM_PREFILL ids (two q-chunks of 512) and
# LM_DECODE_STEPS decode steps, batch 1, faithful
LM_LAYERS = 2
LM_PREFILL = 1024
LM_DECODE_STEPS = 3
# the secure logits against float64, the embedding table at scale 0.5
# (LM_EMBED_SCALE x init_params' 0.02; at 0.02 fixed point's 13 fractional
# bits quantize rmsnorm's mean square to a few units of 2^-13 and the
# logits lie as far from float64 as logits of their own size, ROADMAP N1):
# tools/torch_lm_rehearsal.py on the CPU, SMOKE and a middle width, 3
# seeds, faithful and collapsed: the largest error 0.0088 of the largest
# logit, relative L2 error up to 0.0076; growing about 1.4x a doubling of
# d_model (0.0105 at 512, 0.0163 at 1,024).  This phase's main path on an
# H100 at full width, weight seeds 5 and 6: 0.0218-0.0266 and
# 0.0217-0.0227.  Held within 0.06 each; all-zero logits (relative L2 1)
# and shuffled ones (1.41) fail.
LM_EMBED_SCALE = 25.0
LM_ERR_PER_LOGIT = 0.06
LM_MAX_REL_L2 = 0.06
LM_DEVICE = "cuda"


def lm_full_config():
    """The main path's config: qwen3-1.7b's CONFIG cut to LM_LAYERS."""
    from repro_torch.configs import get
    return lm_cut(get("qwen3_1_7b").CONFIG, LM_LAYERS)


def lm_cut(cfg, layers: int):
    return dataclasses.replace(cfg, n_layers=layers, n_encoder_layers=min(
        cfg.n_encoder_layers, layers))


def lm_serve(eng, cfg, params, ids, steps: int, extra=None,
             long_ctx: bool = False):
    """serve_prefill of `ids` and `steps` decode steps (each on the last
    id again) on `eng`; returns (logits of each, the last caches)."""
    from repro_torch.nn import model as LM
    pe = LM.params_to_engine(eng, params)
    kw = extra(eng) if extra else {}
    pos = ids.shape[1] + (cfg.frontend_tokens if cfg.family == "vlm" else 0)
    lg, caches = LM.serve_prefill(eng, cfg, pe, ids, long_ctx=long_ctx, **kw)
    out = [lg]
    for t in range(steps):
        lg, caches = LM.serve_decode(eng, cfg, pe, ids[:, -1:], caches,
                                     pos + t, long_ctx=long_ctx)
        out.append(lg)
    return out, caches


def lm_frontend(cfg, batch: int):
    rs = np.random.RandomState(LM_SEED + 1)
    if cfg.family == "vlm":
        fe = rs.randn(batch, cfg.frontend_tokens, cfg.d_model) * 0.5
        return lambda eng: {"frontend_embs": eng.from_plain(fe)}
    if cfg.family == "encdec":
        enc = rs.randn(batch, cfg.frontend_tokens, cfg.d_model) * 0.5
        return lambda eng: {"enc_inputs": eng.from_plain(enc)}
    return None


def lm_leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from lm_leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, t in enumerate(tree):
            yield from lm_leaves(t, f"{path}[{i}]")
    else:
        yield path, getattr(tree, "data", tree)


def lm_secure(device: str, cfg, params, ids, steps: int, collapse: bool,
              long_ctx: bool = False):
    from repro_torch.core.context import make_context
    from repro_torch.core.ring import RING64
    from repro_torch.nn.engine import TridentEngine
    ctx = make_context(RING64, seed=LM_SEED, collapse=collapse,
                       device=device)
    out, caches = lm_serve(TridentEngine(ctx), cfg, params, ids, steps,
                           lm_frontend(cfg, ids.shape[0]), long_ctx)
    return ctx, out, caches


def lm_within(want: np.ndarray, got: np.ndarray,
              bounds: tuple = (LM_ERR_PER_LOGIT, LM_MAX_REL_L2)) -> tuple:
    """(within the bounds (error per largest logit, relative L2), error /
    largest logit, relative L2 error)."""
    err = float(np.abs(want - got).max() / np.abs(want).max())
    rel = float(np.linalg.norm(want - got) / np.linalg.norm(want))
    return err <= bounds[0] and rel <= bounds[1], err, rel


def lm_close(what: str, plain: list, secure: list,
             bounds: tuple = (LM_ERR_PER_LOGIT, LM_MAX_REL_L2)) -> dict:
    """The secure logits against float64, step by step, within the
    rehearsal's bounds; all-zero logits and the float64 logits shuffled
    must fall outside them."""
    from repro_torch.core.ring import RING64
    rows = []
    for i, (p, s) in enumerate(zip(plain, secure)):
        p = p.double().cpu().numpy()
        s = RING64.decode(s.reveal().cpu()).numpy()
        check(p.shape == s.shape and np.isfinite(s).all(),
              f"{what}: step {i}'s logits are not finite or of the wrong "
              f"shape")
        ok, err, rel = lm_within(p, s, bounds)
        check(ok, f"{what}: step {i}'s logits off by {err} of the largest "
                  f"float64 logit, relative L2 {rel}; bounds {bounds}")
        shuffled = np.random.RandomState(i).permutation(p.reshape(-1))
        for name, control in (("all-zero", np.zeros_like(p)),
                              ("shuffled", shuffled.reshape(p.shape))):
            check(not lm_within(p, control, bounds)[0],
                  f"{what}: {name} logits pass the bounds at step {i}")
        rows.append({"err_per_logit": err, "rel_l2": rel,
                     "max_abs_logit": float(np.abs(p).max()),
                     "shuffled_rel_l2": lm_within(p, shuffled)[2]})
    return rows


def lm_card_vs_cpu(path: str, kernels: list, needed: tuple, cfg, params,
                   ids, steps: int, collapse: bool, card: str,
                   long_ctx: bool = False) -> dict:
    """One served run on the card (a driven path) and on the CPU: equal
    logits and cache words, equal totals(), no abort, the card's launches
    the CPU run's wrapper calls."""
    import torch
    from repro_torch.kernels import ops
    (ctx, out, caches), wall = drive(
        path, kernels, needed,
        lambda: lm_secure(LM_DEVICE, cfg, params, ids, steps, collapse,
                          long_ctx), 1, unit="run")
    card_launches = {k["name"]: k["launches_by_path"][path] for k in kernels}
    ops.reset_launches()
    t0 = time.perf_counter()
    rctx, rout, rcaches = lm_secure("cpu", cfg, params, ids, steps, collapse,
                                    long_ctx)
    cpu_s = time.perf_counter() - t0
    calls = {k.name: k.calls for k in ops.KERNELS}
    check(not ctx.abort_flag() and not rctx.abort_flag(), f"{path}: aborted")
    check(all(torch.equal(a.data.cpu(), b.data) for a, b in zip(out, rout)),
          f"{path}: logits words differ between the card and the CPU")
    la, lb = list(lm_leaves(caches)), list(lm_leaves(rcaches))
    check([p for p, _ in la] == [p for p, _ in lb] and all(
        torch.equal(a.cpu(), b) for (_, a), (_, b) in zip(la, lb)),
        f"{path}: cache words differ between the card and the CPU")
    check(ctx.tally.totals() == rctx.tally.totals(),
          f"{path}: totals() differ between the card and the CPU")
    check(card_launches == calls,
          f"{path}: launches on the card {card_launches}, wrapper calls on "
          f"the CPU {calls}")
    print(f"{path} [{card}]: logits, caches and totals() equal to the CPU "
          f"run, no abort; launches = the CPU run's wrapper calls; card "
          f"{wall:.2f} s, CPU {cpu_s:.2f} s")
    return {"wall_s": wall, "cpu_s": cpu_s, "totals": ctx.tally.totals(),
            "launches": {n: c for n, c in card_launches.items() if c},
            "cache_shapes": {p: list(a.shape) for p, a in la}}


def lm_exact_words(cfg, params, pe, card: str) -> dict:
    """The main path's words at its largest sizes, exact: (1) the shared
    embedding table and lm_head opened on the card equal to their encoded
    weights; (2) the ring matmul at the lm_head product, a (1, 2048) row of
    words @ the lm_head's first lambda component (2048 x 151,936, a 2.5 GB
    B operand), equal to torch.matmul of the same words on the CPU.  No
    launch here counts toward a path."""
    import torch
    from repro_torch.core.ring import RING64
    from repro_torch.kernels import ops
    out = {}
    for name, share, w in (("embed", pe["embed"]["table"],
                            params["embed"]["table"]),
                           ("lm_head", pe["lm_head"]["w"],
                            params["lm_head"]["w"])):
        opened = share.reveal()
        check(torch.equal(opened, RING64.encode(w, device=opened.device)),
              f"lm: the shared {name} opens to other words than its "
              f"encoded weights ({tuple(w.shape)})")
        out[f"{name}_opened_words"] = int(opened.numel())
        del opened
    b = pe["lm_head"]["w"].data[1]
    g = torch.Generator().manual_seed(LM_SEED)
    a = torch.randint(-2**62, 2**62, (1, cfg.d_model), generator=g,
                      dtype=torch.int64)
    t0 = time.perf_counter()
    got = ops.ring_matmul(a.to(b.device), b).cpu()
    want = torch.matmul(a, b.cpu())
    check(torch.equal(got, want),
          f"lm: ring_matmul disagrees with torch.matmul at the lm_head "
          f"product (1, {cfg.d_model}) @ {tuple(b.shape)}")
    out["lm_head_matmul"] = {"a": [1, cfg.d_model], "b": list(b.shape),
                             "b_bytes": b.numel() * 8, "equal": True,
                             "s": time.perf_counter() - t0}
    print(f"lm [{card}]: the shared embedding and lm_head open to their "
          f"encoded weights ({out['embed_opened_words']} and "
          f"{out['lm_head_opened_words']} words); ring_matmul at "
          f"(1, {cfg.d_model}) @ {tuple(b.shape)} equals torch.matmul on "
          f"the CPU")
    return out


def lm_prf_group_exact(cfg, card: str) -> dict:
    """prf_mask at the main path's largest draw group, three streams of
    vocab x d_model words (the lambdas of the shared embedding table or
    lm_head), against its plain version on the same card."""
    import torch
    from repro_torch.core.prf import ThreefryKey
    from repro_torch.kernels import prf_mask as PM
    n = cfg.vocab * cfg.d_model
    key = ThreefryKey.from_seed(LM_SEED)
    streams = [(key.fold_in(j).data, 7 + j, n, 0) for j in range(3)]
    dev = torch.device(LM_DEVICE)
    got = PM.prf_mask_group_cuda(streams, torch.empty(3 * n,
                                                      dtype=torch.int64,
                                                      device=dev))
    want = PM.prf_mask_group_plain(streams, torch.int64, dev)
    check(torch.equal(got, want),
          f"lm: prf_mask disagrees with its plain version on a group of 3 "
          f"streams of {n} words")
    print(f"lm [{card}]: prf_mask equals its plain version on a group of 3 "
          f"streams of {n} words ({3 * n * 8 / 1e9:.2f} GB)")
    del got, want
    torch.cuda.empty_cache()
    return {"streams": 3, "words_each": n, "equal": True}


def lm_phase(kernels: list, card: str) -> dict:
    """(b) the SMOKE configs of the four attention families on the card
    against the CPU, bit for bit, faithful and collapsed, and qwen3 at a
    middle width; (c) the main path: qwen3-1.7b at full width."""
    import torch
    from repro_torch.configs import get
    from repro_torch.core.context import make_context
    from repro_torch.core.ring import RING64
    from repro_torch.nn import model as LM
    from repro_torch.nn.engine import PlainEngine, TridentEngine

    report = {"card": card, "smoke": {}}
    # (b) card against CPU
    mid = dataclasses.replace(
        lm_cut(get("qwen3_1_7b").CONFIG, 2), d_model=256, n_heads=4,
        n_kv_heads=2, d_head=64, d_ff=768, vocab=4096, q_chunk=64)
    cases = [(arch, lm_cut(get(arch).SMOKE, 2), LM_SMOKE_IDS, 1)
             for arch in LM_SMOKE_ARCHS]
    cases.append(("qwen3_1_7b_middle", mid, (1, 128), 2))
    for name, cfg, shape, steps in cases:
        params = LM.init_params(cfg, LM_SEED)
        ids = np.random.RandomState(LM_SEED).randint(0, cfg.vocab,
                                                     size=shape)
        for collapse in (False, True):
            mode = "collapsed" if collapse else "faithful"
            path = f"lm_{name}_{mode}"
            report["smoke"][path] = lm_card_vs_cpu(
                path, kernels, ("prf_mask", "ring_matmul_batched"), cfg,
                params, ids, steps, collapse, card)

    # (c) the main path at full width
    cfg = lm_full_config()
    report["config"] = {"arch": "qwen3-1.7b", "layers": LM_LAYERS,
                        "of_layers": get("qwen3_1_7b").CONFIG.n_layers,
                        "d_model": cfg.d_model, "heads": cfg.n_heads,
                        "kv_heads": cfg.n_kv_heads, "d_head": cfg.dh,
                        "d_ff": cfg.d_ff, "vocab": cfg.vocab,
                        "q_chunk": cfg.q_chunk, "prefill": LM_PREFILL,
                        "decode_steps": LM_DECODE_STEPS, "batch": 1,
                        "mode": "faithful", "embed_scale": LM_EMBED_SCALE}
    torch.cuda.empty_cache()
    report["prf_mask_largest_group"] = lm_prf_group_exact(cfg, card)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = LM.init_params(cfg, LM_SEED)
    params["embed"]["table"] *= LM_EMBED_SCALE
    report["init_params_s"] = time.perf_counter() - t0
    ids = np.random.RandomState(LM_SEED).randint(0, cfg.vocab,
                                                 size=(1, LM_PREFILL))
    ctx = make_context(RING64, seed=LM_SEED, device=LM_DEVICE)
    eng = TridentEngine(ctx)
    t0 = time.perf_counter()
    pe = LM.params_to_engine(eng, params)
    torch.cuda.synchronize()
    report["share_s"] = time.perf_counter() - t0
    print(f"lm [{card}]: init_params {report['init_params_s']:.1f} s on "
          f"the host, weights shared on the card in {report['share_s']:.2f} "
          f"s; {torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated")
    share_peak = torch.cuda.max_memory_allocated()
    report["exact_words"] = lm_exact_words(cfg, params, pe, card)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    needed = ("prf_mask", "ring_matmul", "ring_matmul_batched")
    (lg, caches), prefill_wall = drive(
        "lm_prefill", kernels, needed,
        lambda: LM.serve_prefill(eng, cfg, pe, ids), 1, unit="prefill")
    secure = [lg]
    dec_walls = []

    def decode_steps():
        nonlocal caches
        for t in range(LM_DECODE_STEPS):
            t1 = time.perf_counter()
            lg, caches = LM.serve_decode(eng, cfg, pe, ids[:, -1:], caches,
                                         LM_PREFILL + t)
            torch.cuda.synchronize()
            dec_walls.append(time.perf_counter() - t1)
            secure.append(lg)

    _, _ = drive("lm_decode", kernels, needed, decode_steps,
                 LM_DECODE_STEPS, unit="decode step")
    check(not ctx.abort_flag(), "lm: the full-width serve aborted")
    report["prefill_wall_s"] = prefill_wall
    report["decode_walls_s"] = dec_walls
    report["launches_prefill"] = {
        k["name"]: k["launches_by_path"]["lm_prefill"] for k in kernels
        if k["launches_by_path"]["lm_prefill"]}
    report["launches_per_decode"] = {
        k["name"]: k["launches_by_path"]["lm_decode"] / LM_DECODE_STEPS
        for k in kernels if k["launches_by_path"]["lm_decode"]}
    report["max_memory_allocated_gib"] = max(
        share_peak, torch.cuda.max_memory_allocated()) / 2**30
    report["totals"] = ctx.tally.totals()
    kv = caches[0]["k"]
    check(tuple(kv.shape) == (LM_LAYERS, 2, 1, cfg.n_kv_heads,
                              LM_PREFILL + LM_DECODE_STEPS, cfg.dh),
          f"lm: KV cache of shape {tuple(kv.shape)}")
    # where the time goes: one more prefill and decode step, profiled
    for what, run, wall in (
            ("prefill", lambda: LM.serve_prefill(eng, cfg, pe, ids),
             prefill_wall),
            ("decode step", lambda: LM.serve_decode(
                eng, cfg, pe, ids[:, -1:], caches,
                LM_PREFILL + LM_DECODE_STEPS), min(dec_walls))):
        by_name = {}
        busy, dops = profile_batch("lm", run, wall, unit=what,
                                   by_name=by_name)
        top = sorted(by_name.items(), key=lambda kv_: -kv_[1])[:8]
        report[f"profile_{what.split()[0]}"] = {
            "busy_ms": busy, "device_ops": dops, "wall_s": wall,
            "top_ms": {k[:80]: v for k, v in top}}
    del pe, caches, eng
    torch.cuda.empty_cache()
    plain, _ = lm_serve(PlainEngine(device=LM_DEVICE), cfg, params, ids,
                        LM_DECODE_STEPS)
    report["logits_vs_float64"] = lm_close("lm", plain, secure)
    print(f"lm [{card}]: qwen3-1.7b at full width ({LM_LAYERS} of "
          f"{report['config']['of_layers']} layers), prefill of "
          f"{LM_PREFILL} ids {prefill_wall:.2f} s, decode steps "
          f"{[round(w, 3) for w in dec_walls]} s; no abort; launches per "
          f"prefill {report['launches_prefill']}, per decode step "
          f"{report['launches_per_decode']}; peak device memory "
          f"{report['max_memory_allocated_gib']:.1f} GiB; logits against "
          f"float64 {report['logits_vs_float64']}")
    return report


# --- phase lm-recurrent: the recurrent families' serving path -----------
# the SMOKE configs of the hybrid and ssm families, served card against
# CPU uncut (zamba2: two retention groups of 2, the shared block applied
# twice; xlstm: one mLSTM + sLSTM pair): LMR_SMOKE_IDS ids (two chunks of
# seq_chunk 8) and LMR_SMOKE_STEPS decode steps; zamba2 once more with
# long_ctx and long_window LMR_SMOKE_LONG_WINDOW, below the prefill
LMR_SMOKE_ARCHS = ("zamba2_7b", "xlstm_350m")
LMR_SMOKE_IDS = (2, 16)
LMR_SMOKE_STEPS = 2
LMR_SMOKE_LONG_WINDOW = 12
# the main paths: each CONFIG (full width) cut in depth only, to
# LMR_LAYERS of its layers (zamba2: one retention segment of 2, then the
# shared block; xlstm: 2 mLSTM + sLSTM pairs); a prefill of LMR_PREFILL ids
# (4 chunks of seq_chunk 256, 2 query chunks of 512 in zamba2's shared
# block) and LMR_DECODE_STEPS decode steps, batch 1, faithful; zamba2 once
# more with long_ctx and long_window LMR_LONG_WINDOW (cut from 8,192 so
# that the prefill crosses it)
LMR_LAYERS = {"zamba2_7b": 2, "xlstm_350m": 4}
LMR_PREFILL = 1024
LMR_DECODE_STEPS = 3
LMR_LONG_WINDOW = 512
# the secure logits against float64, the embedding at scale 0.5 (as phase
# lm), from tools/torch_lm_rehearsal.py: on the CPU (3 seeds, faithful and
# collapsed) SMOKE and d_model 256 lie within 0.0104 of the largest logit
# (relative L2 0.0081), and d_model 512 and 1,024 (one seed) within 0.0098;
# at these main paths' full widths on an H100 80GB HBM3 at 700 W
# (``--cases full --device cuda``, 3 seeds, faithful and collapsed, 1,024
# ids and 3 decode steps) xlstm within 0.0262 (relative L2 0.0283) and
# zamba2 within 0.0821 (0.0790): at d_model 3,584 fixed point's 1/n in
# rmsnorm's mean is 12.5 % low (ROADMAP N3), and against float64 with that
# 1/n (the rehearsal's ``fixed_mean_plain``) zamba2 lies within 0.0101
# (0.0086).  Held (error per largest logit, relative L2): each arch within
# LMR_BOUNDS of float64, and zamba2 within LMR_FIXED_MEAN_BOUNDS of the
# fixed-mean float64 run; all-zero logits (relative L2 1) and shuffled
# ones (about 1.4) fail all of them.
LMR_BOUNDS = {"zamba2_7b": (0.12, 0.12), "xlstm_350m": (0.06, 0.06)}
LMR_FIXED_MEAN_BOUNDS = (0.03, 0.03)
# K2 at the recurrent paths' new shapes (batch 1, the full configs'
# seq_chunk 256 and q_chunk 512): zamba2 (32 heads, d_k 64, d_v 112) and
# xlstm (4 heads, d_k 64, d_v 256): a chunk's q k^T, its masked scores @
# v, q_u @ S and (k w)^T @ v; zamba2's shared block's scores (K = 112)
# and probs @ v (N = 112); a decode step's k^T v (an outer product, K =
# 1) and q @ S' (M = 1); sLSTM's public contractions, the encoded decay
# matrix broadcast over the components and the batch (_pub_left) and the
# last row's weights (M = 1)
LMR_K2_SHAPES = (
    ("zamba2_qk", (1, 32, 256, 64), (1, 32, 64, 256)),
    ("zamba2_sv", (1, 32, 256, 256), (1, 32, 256, 112)),
    ("zamba2_qS", (1, 32, 256, 64), (1, 32, 64, 112)),
    ("zamba2_kwv", (1, 32, 64, 256), (1, 32, 256, 112)),
    ("zamba2_shared_scores", (1, 32, 512, 112), (1, 32, 112, 1024)),
    ("zamba2_shared_probs_v", (1, 32, 512, 1024), (1, 32, 1024, 112)),
    ("zamba2_step_kv", (1, 32, 64, 1), (1, 32, 1, 112)),
    ("zamba2_step_qS", (1, 32, 1, 64), (1, 32, 64, 112)),
    ("xlstm_qk", (1, 4, 256, 64), (1, 4, 64, 256)),
    ("xlstm_sv", (1, 4, 256, 256), (1, 4, 256, 256)),
    ("xlstm_qS", (1, 4, 256, 64), (1, 4, 64, 256)),
    ("xlstm_kwv", (1, 4, 64, 256), (1, 4, 256, 256)),
    ("xlstm_step_kv", (1, 4, 64, 1), (1, 4, 1, 256)),
    ("xlstm_step_qS", (1, 4, 1, 64), (1, 4, 64, 256)),
    ("slstm_pub_left", (1, 1, 4, 256, 256), (4, 1, 4, 256, 256)),
    ("slstm_last_weighted", (1, 1, 4, 1, 256), (4, 1, 4, 256, 256)))


def recurrent_k2_rows(rng, shapes: tuple = LMR_K2_SHAPES,
                      phase: str = "lm-recurrent") -> list:
    """K2 at `shapes` against torch.matmul of the same words on the CPU
    (``torch.equal``), each timed (device ms by the profiler, the wrapper
    call by CUDA events, the CPU's torch.matmul on the host clock) beside
    its bound: part (a) of phases lm-recurrent and lm-recurrent-train,
    run with the kernel rows.  No launch here counts toward a path."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import ring_matmul as RM
    dev = torch.device(LM_DEVICE)
    rows = []
    for name, sa, sb in shapes:
        a = torch.from_numpy(rng.randint(-2**63, 2**63 - 1, size=sa,
                                         dtype=np.int64))
        b = torch.from_numpy(rng.randint(-2**63, 2**63 - 1, size=sb,
                                         dtype=np.int64))
        a_d, b_d = a.to(dev), b.to(dev)
        got = ops.ring_matmul(a_d, b_d)
        torch.cuda.synchronize()
        want = torch.matmul(a, b)
        check(torch.equal(got.cpu(), want),
              f"{phase}: ring_matmul_batched disagrees with "
              f"torch.matmul at {name} {sa} @ {sb}")
        rows.append({
            "shape": name, "a": list(sa), "b": list(sb), "max_abs_err": 0,
            "ms": device_ms(lambda: RM.ring_matmul_batched_cuda(a_d, b_d),
                            "ring_matmul_kernel"),
            "call_ms": cuda_ms(lambda: ops.ring_matmul(a_d, b_d), reps=20),
            "plain_ms": host_ms(lambda: torch.matmul(a, b), reps=2),
            **batched_bound(sa, sb)})
        r = rows[-1]
        print(f"{phase}: K2 {name} {sa} @ {sb} equal to "
              f"torch.matmul: {r['ms']:.5f} ms on the device, call "
              f"{r['call_ms']:.5f} ms (CPU {r['plain_ms']:.3f} ms); bound "
              f"{r['bound_ms']:.5f} ms by {r['bound_by']}")
    return rows


def lmr_config(arch: str):
    """A main path's config: the arch's CONFIG cut to LMR_LAYERS."""
    from repro_torch.configs import get
    return lm_cut(get(arch).CONFIG, LMR_LAYERS[arch])


def lmr_cache_shapes(cfg, caches, positions: int) -> dict:
    """Check a main path's caches against the config: each retention
    state (layers, 2, 1, H, d_k, d_v), each sLSTM state (layers, 2, 1, H,
    1, d / H), the shared block's K/V (2, 1, H, positions, d_head)."""
    H, rc = cfg.n_heads, cfg.ret_cfg()
    want = []
    for (kind, count), c in zip(cfg.segments(), caches):
        if kind == "retention":
            want.append({"s": (count, 2, 1, H, rc.d_k, rc.d_v)})
        elif kind == "ret_slstm_pair":
            want.append({"s1": (count, 2, 1, H, rc.d_k, rc.d_v),
                         "s2": (count, 2, 1, H, 1, cfg.d_model // H)})
        else:
            kv = (2, 1, cfg.n_kv_heads, positions, cfg.dh)
            want.append({"k": kv, "v": kv})
    got = [{k: tuple(v.shape) for k, v in c.items()} for c in caches]
    check(got == want, f"lm-recurrent {cfg.name}: caches of shapes {got}, "
          f"want {want}")
    return {f"{i}/{k}": list(v) for i, c in enumerate(got)
            for k, v in c.items()}


def run_key(tag: str) -> str:
    return f"run{tag or '_default'}"


def record_shapes(seen: dict, run):
    """Run `run` with each kernel wrapper of ``kernels.ops`` named in
    `seen` passing its calls through unchanged after adding their
    arguments' shapes (None for a None argument) to ``seen[name]``."""
    from repro_torch.kernels import ops
    orig = {name: getattr(ops, name) for name in seen}

    def recorder(name):
        def call(*args):
            seen[name].add(tuple(None if a is None else tuple(a.shape)
                                 for a in args))
            return orig[name](*args)
        return call

    for name in seen:
        setattr(ops, name, recorder(name))
    try:
        return run()
    finally:
        for name, f in orig.items():
            setattr(ops, name, f)


def cpu_matmul(a, b, threads: int = 8):
    """torch.matmul of int64 words on the CPU (mod 2^64), b's columns
    split over `threads` threads: torch's int64 matmul runs on one."""
    import torch
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(threads) as ex:
        parts = list(ex.map(lambda part: torch.matmul(a, part),
                            b.chunk(2 * threads, dim=-1)))
    return torch.cat(parts, dim=-1)


def lmr_exact_words(arch: str, seen: dict, card: str,
                    phase: str = "lm-recurrent") -> dict:
    """The kernels at every shape a main path's driven runs gave them
    (``record_shapes``), exact: ``ops.ring_matmul`` at each distinct (A,
    B) shape, 2-D and batched, equal to torch.matmul of the same random
    words on the CPU; ``ops.and_level`` at each distinct n against its
    plain version on the card.  No launch here counts toward a path."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import ppa_msb as PPA
    dev = torch.device(LM_DEVICE)
    rng = np.random.RandomState(LM_SEED)

    def words(shape):
        return torch.from_numpy(rng.randint(-2**63, 2**63 - 1, size=shape,
                                            dtype=np.int64))

    out = {"ring_matmul": [], "and_level": []}
    t0 = time.perf_counter()
    for sa, sb in sorted(seen["ring_matmul"]):
        a, b = words(sa), words(sb)
        got = ops.ring_matmul(a.to(dev), b.to(dev)).cpu()
        check(torch.equal(got, cpu_matmul(a, b)),
              f"{phase} {arch}: ring_matmul disagrees with "
              f"torch.matmul at the main path's {sa} @ {sb}")
        out["ring_matmul"].append([list(sa), list(sb)])
    out["ring_matmul_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for shapes in sorted(seen["and_level"], key=str):
        args = [None if sh is None else words(sh).to(dev) for sh in shapes]
        check(torch.equal(ops.and_level(*args), PPA.and_level_plain(*args)),
              f"{phase} {arch}: and_level disagrees with its plain "
              f"version at the main path's {shapes}")
        out["and_level"].append(list(shapes))
        del args
    torch.cuda.synchronize()
    out["and_level_s"] = time.perf_counter() - t0
    print(f"{phase} [{card}]: {arch}: ring_matmul equals torch.matmul "
          f"on the CPU at all {len(out['ring_matmul'])} shapes of the main "
          f"path ({out['ring_matmul_s']:.1f} s): {out['ring_matmul']}; "
          f"and_level equals its plain version at all "
          f"{len(out['and_level'])} of its shapes "
          f"({out['and_level_s']:.1f} s): {out['and_level']}")
    return out


def lmr_main_path(arch: str, kernels: list, card: str) -> dict:
    """One recurrent family's main path at full width (LMR_LAYERS of its
    layers): init_params, params_to_engine on the card, a driven prefill
    and decode steps, the caches' shapes, a profiled prefill; zamba2 once
    more with long_ctx; ring_matmul and and_level at every shape the
    driven runs gave them, exact (``lmr_exact_words``); then the logits
    against PlainEngine float64 on the card."""
    import torch
    from repro_torch.configs import get
    from repro_torch.core.context import make_context
    from repro_torch.core.ring import RING64
    from repro_torch.nn import model as LM
    from repro_torch.nn.engine import PlainEngine, TridentEngine
    from torch_lm_rehearsal import fixed_mean_plain
    cfg = lmr_config(arch)
    rc = cfg.ret_cfg()
    rep = {"config": {
        "arch": cfg.name, "layers": LMR_LAYERS[arch],
        "of_layers": get(arch).CONFIG.n_layers, "segments": cfg.segments(),
        "d_model": cfg.d_model, "heads": cfg.n_heads, "d_k": rc.d_k,
        "d_v": rc.d_v, "d_ff": cfg.d_ff, "vocab": cfg.vocab,
        "seq_chunk": cfg.seq_chunk, "q_chunk": cfg.q_chunk,
        "prefill": LMR_PREFILL, "decode_steps": LMR_DECODE_STEPS,
        "batch": 1, "mode": "faithful", "embed_scale": LM_EMBED_SCALE,
        "cuts": [f"layers {LMR_LAYERS[arch]} of "
                 f"{get(arch).CONFIG.n_layers}"]
        + ([f"long_window {LMR_LONG_WINDOW} of {cfg.long_window} in the "
            f"long_ctx run"] if cfg.family == "hybrid" else [])}}
    print(f"lm-recurrent [{card}]: {arch} main path {rep['config']}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = LM.init_params(cfg, LM_SEED)
    params["embed"]["table"] *= LM_EMBED_SCALE
    rep["init_params_s"] = time.perf_counter() - t0
    rep["parameters"] = int(sum(
        np.asarray(leaf).size for _, leaf in lm_leaves(params)
        if leaf is not None))
    ids = np.random.RandomState(LM_SEED).randint(0, cfg.vocab,
                                                 size=(1, LMR_PREFILL))
    ctx = make_context(RING64, seed=LM_SEED, device=LM_DEVICE)
    eng = TridentEngine(ctx)
    t0 = time.perf_counter()
    pe = LM.params_to_engine(eng, params)
    torch.cuda.synchronize()
    rep["share_s"] = time.perf_counter() - t0
    print(f"lm-recurrent [{card}]: {arch}: {rep['parameters']} parameters, "
          f"init_params {rep['init_params_s']:.1f} s on the host, shared on "
          f"the card in {rep['share_s']:.2f} s; "
          f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated")
    needed = ("prf_mask", "ring_matmul", "ring_matmul_batched", "and_level")
    runs = [("", False)] + ([("_long", True)] if cfg.family == "hybrid"
                            else [])
    secure = {}
    seen = {"ring_matmul": set(), "and_level": set()}
    for tag, long_ctx in runs:
        run_cfg = dataclasses.replace(cfg, long_window=LMR_LONG_WINDOW) \
            if long_ctx else cfg
        kv_len = (lambda n: min(n, LMR_LONG_WINDOW)) if long_ctx else \
            (lambda n: n)
        path = f"lmr_{arch}{tag}"
        (lg, caches), prefill_wall = record_shapes(seen, lambda: drive(
            f"{path}_prefill", kernels, needed,
            lambda: LM.serve_prefill(eng, run_cfg, pe, ids,
                                     long_ctx=long_ctx), 1, unit="prefill"))
        shapes = [lmr_cache_shapes(run_cfg, caches, kv_len(LMR_PREFILL))]
        logits = [lg]
        dec_walls = []

        def decode_steps():
            nonlocal caches
            for t in range(LMR_DECODE_STEPS):
                t1 = time.perf_counter()
                lg_, caches = LM.serve_decode(
                    eng, run_cfg, pe, ids[:, -1:], caches, LMR_PREFILL + t,
                    long_ctx=long_ctx)
                torch.cuda.synchronize()
                dec_walls.append(time.perf_counter() - t1)
                logits.append(lg_)
                shapes.append(lmr_cache_shapes(
                    run_cfg, caches, kv_len(LMR_PREFILL + t + 1)))

        record_shapes(seen, lambda: drive(
            f"{path}_decode", kernels, needed, decode_steps,
            LMR_DECODE_STEPS, unit="decode step"))
        check(not ctx.abort_flag(), f"lm-recurrent: {path} aborted")
        secure[tag] = logits
        r = rep[run_key(tag)] = {
            "long_ctx": long_ctx, "prefill_wall_s": prefill_wall,
            "decode_walls_s": dec_walls, "cache_shapes": shapes,
            "launches_prefill": {
                k["name"]: k["launches_by_path"][f"{path}_prefill"]
                for k in kernels
                if k["launches_by_path"][f"{path}_prefill"]},
            "launches_per_decode": {
                k["name"]: k["launches_by_path"][f"{path}_decode"]
                / LMR_DECODE_STEPS for k in kernels
                if k["launches_by_path"][f"{path}_decode"]}}
        by_name = {}
        busy, dops = profile_batch(
            f"lm-recurrent {path}", lambda: LM.serve_prefill(
                eng, run_cfg, pe, ids, long_ctx=long_ctx), prefill_wall,
            unit="prefill", by_name=by_name)
        top = sorted(by_name.items(), key=lambda kv_: -kv_[1])[:8]
        r["profile_prefill"] = {
            "busy_ms": busy, "device_ops": dops, "wall_s": prefill_wall,
            "busy_share": busy / (prefill_wall * 1e3),
            "top_ms": {k[:80]: v for k, v in top}}
        print(f"lm-recurrent [{card}]: {path}: prefill of {LMR_PREFILL} ids "
              f"{prefill_wall:.3f} s (busy share "
              f"{r['profile_prefill']['busy_share']:.3f}), decode steps "
              f"{[round(w, 4) for w in dec_walls]} s; launches per prefill "
              f"{r['launches_prefill']}, per decode step "
              f"{r['launches_per_decode']}; cache shapes after the prefill "
              f"{shapes[0]}")
    rep["totals"] = ctx.tally.totals()
    rep["max_memory_allocated_gib"] = torch.cuda.max_memory_allocated() \
        / 2**30
    del pe, caches, eng
    torch.cuda.empty_cache()
    rep["exact"] = lmr_exact_words(arch, seen, card)
    torch.cuda.empty_cache()
    # 1/n is exact in fixed point where n divides 2^13
    fixed_mean = RING64.scale % cfg.d_model != 0
    for tag, long_ctx in runs:
        run_cfg = dataclasses.replace(cfg, long_window=LMR_LONG_WINDOW) \
            if long_ctx else cfg
        plain, _ = lm_serve(PlainEngine(device=LM_DEVICE), run_cfg, params,
                            ids, LMR_DECODE_STEPS, long_ctx=long_ctx)
        r = rep[run_key(tag)]
        r["logits_vs_float64"] = lm_close(
            f"lm-recurrent {arch}{tag}", plain, secure[tag], LMR_BOUNDS[arch])
        if fixed_mean:
            plain, _ = lm_serve(fixed_mean_plain(LM_DEVICE), run_cfg, params,
                                ids, LMR_DECODE_STEPS, long_ctx=long_ctx)
            r["logits_vs_fixed_mean_float64"] = lm_close(
                f"lm-recurrent {arch}{tag} (fixed point's 1/n in the mean)",
                plain, secure[tag], LMR_FIXED_MEAN_BOUNDS)
    torch.cuda.empty_cache()
    errs = {f"{run_key(t)} {c}": [round(s["err_per_logit"], 5)
                                   for s in rep[run_key(t)][c]]
            for t, _ in runs for c in ("logits_vs_float64",
                                       "logits_vs_fixed_mean_float64")
            if c in rep[run_key(t)]}
    print(f"lm-recurrent [{card}]: {arch}: no abort; peak device memory "
          f"{rep['max_memory_allocated_gib']:.1f} GiB; logits, error / "
          f"largest logit by step {errs}")
    return rep


def lm_recurrent_phase(kernels: list, card: str) -> dict:
    """(a) K2 at the recurrent paths' new shapes (taken with the kernel
    rows: ``recurrent_k2_rows``); (b) zamba2's and xlstm's SMOKE on the
    card against the CPU, faithful and collapsed, and zamba2 with
    long_ctx; (c) the main paths: zamba2-7b and xlstm-350m at full
    width."""
    from repro_torch.configs import get
    from repro_torch.nn import model as LM
    report = {"card": card, "smoke": {}}
    rows = next(k for k in kernels if k["name"] == "ring_matmul_batched")[
        "recurrent_shapes"]
    check([r["shape"] for r in rows] == [n for n, _, _ in LMR_K2_SHAPES],
          "lm-recurrent: K2 was not held at every recurrent shape")
    report["k2_shapes"] = [r["shape"] for r in rows]
    runs = [(arch, get(arch).SMOKE, False) for arch in LMR_SMOKE_ARCHS]
    runs.append(("zamba2_7b_long", dataclasses.replace(
        get("zamba2_7b").SMOKE, long_window=LMR_SMOKE_LONG_WINDOW), True))
    for name, cfg, long_ctx in runs:
        params = LM.init_params(cfg, LM_SEED)
        ids = np.random.RandomState(LM_SEED).randint(0, cfg.vocab,
                                                     size=LMR_SMOKE_IDS)
        for collapse in ((False,) if long_ctx else (False, True)):
            mode = "collapsed" if collapse else "faithful"
            path = f"lmr_{name}_{mode}"
            report["smoke"][path] = lm_card_vs_cpu(
                path, kernels, ("prf_mask", "ring_matmul",
                                "ring_matmul_batched"), cfg, params, ids,
                LMR_SMOKE_STEPS, collapse, card, long_ctx)
    for arch in LMR_LAYERS:
        report[arch] = lmr_main_path(arch, kernels, card)
    return report


# --- phase lm-train: LM training of the attention families ------------
LMT_LR = 2.0 ** -6
LMT_SMOKE_IDS = (2, 8)
# the main path: phi-3-vision-4.2b's CONFIG (full width, remat) cut to
# LMT_LAYERS of its 32 layers; LMT_STEPS steps of LMT_IDS ids and labels
# behind its 576 frontend embeddings, batch 1, faithful, the embedding at
# phase lm's scale 0.5
LMT_LAYERS = 2
LMT_IDS = 128
LMT_STEPS = 2
# the secure gradients against float64 with fixed point's mean behaviour
# (tools/torch_lm_rehearsal.py fixed_point_plain: each truncation -1 unit
# of 2^-13; against plain float64 the gradients are off by a multiple of
# themselves at these vocabularies, ROADMAP N6, reported, not held).
# The rehearsal (--train, the embedding at scale 0.5, 3 seeds, faithful
# and collapsed): on the CPU the four SMOKE families within relative L2
# 0.163 (error per largest entry 0.210) and qwen3 at d_model 256 within
# 0.080 (0.052); this main path on an H100 80GB HBM3 at 700 W (--cases
# full --device cuda) within 0.103 (0.136), the loss within 7.4e-5, and
# in this phase, at its own seed, 0.0994 (0.217).  Held (relative L2,
# error per largest entry) within LMT_GRAD_BOUNDS, the loss within
# LMT_LOSS_ATOL; all-zero gradients (relative L2 1) and shuffled ones
# (about 1.41) fail.
LMT_GRAD_BOUNDS = (0.25, 0.35)
LMT_LOSS_ATOL = 1e-3
# the ring matmul's 2-D products at the LM's shapes (M, K, N): phase lm's
# largest (qwen3's MLP up projection of 1,024 ids) and the train step's
# three largest (phi-3-vision at 704 positions): a weight gradient x^T @
# dY with K the positions, the MLP's dY @ W^T with K = d_ff, and the
# lm_head's dx with K = the vocabulary
LM_MATMUL_SHAPES = (("lm_prefill_mlp_up", 1024, 2048, 6144),
                    ("train_weight_grad", 3072, 704, 8192),
                    ("train_mlp_dx", 704, 8192, 3072),
                    ("train_lm_head_dx", 704, 32064, 3072))


def lm_matmul_rows(rng) -> list:
    """The ring matmul at LM_MATMUL_SHAPES against torch.matmul of the
    same words on the CPU (threaded), each timed (device ms by the
    profiler, the wrapper call by CUDA events, the CPU's product on the
    host clock) beside its bound.  No launch here counts toward a path."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import ring_matmul as RM
    dev = torch.device(LM_DEVICE)
    rows = []
    for name, M, K, N in LM_MATMUL_SHAPES:
        a = torch.from_numpy(rng.randint(-2**63, 2**63 - 1, size=(M, K),
                                         dtype=np.int64))
        b = torch.from_numpy(rng.randint(-2**63, 2**63 - 1, size=(K, N),
                                         dtype=np.int64))
        a_d, b_d = a.to(dev), b.to(dev)
        got = ops.ring_matmul(a_d, b_d).cpu()
        t0 = time.perf_counter()
        want = cpu_matmul(a, b)
        plain_ms = (time.perf_counter() - t0) * 1e3
        check(torch.equal(got, want), f"lm: ring_matmul disagrees with "
              f"torch.matmul at {name} ({M}, {K}) @ ({K}, {N})")
        rows.append({
            "shape": name, "M": M, "K": K, "N": N, "max_abs_err": 0,
            "ms": device_ms(lambda: RM.ring_matmul_cuda(a_d, b_d),
                            "ring_matmul_kernel", reps=5),
            "call_ms": cuda_ms(lambda: ops.ring_matmul(a_d, b_d), reps=5,
                               warmup=1),
            "plain_ms": plain_ms, "plain": "CPU torch.matmul, 8 threads",
            **ring_matmul_bound(M, K, N)})
        r = rows[-1]
        print(f"lm: ring_matmul {name} ({M}, {K}) @ ({K}, {N}) equal to "
              f"torch.matmul: {r['ms']:.4f} ms on the device, call "
              f"{r['call_ms']:.4f} ms (CPU {plain_ms:.1f} ms); bound "
              f"{r['bound_ms']:.4f} ms by {r['bound_by']} (bytes "
              f"{r['bound_ms_bytes']:.4f}, int8 operations "
              f"{r['bound_ms_int8_ops']:.4f})")
        del a_d, b_d, got, want
    torch.cuda.empty_cache()
    return rows


def lmt_labels(cfg, shape: tuple) -> tuple:
    """(ids, labels) of a train run, from the seed."""
    rs = np.random.RandomState(LM_SEED + 2)
    return (rs.randint(0, cfg.vocab, size=shape),
            rs.randint(0, cfg.vocab, size=shape))


def lmt_secure(device: str, cfg, params, ids, labels, collapse: bool,
               optimizer=None, steps: int = 1):
    """`steps` train_steps (plain SGD, or `optimizer`'s) on a fresh
    context; (ctx, (new params, optimizer state), [each step's loss])."""
    from repro_torch.core.context import make_context
    from repro_torch.core.ring import RING64
    from repro_torch.nn import model as LM
    from repro_torch.nn.engine import TridentEngine
    ctx = make_context(RING64, seed=LM_SEED, collapse=collapse,
                       device=device)
    eng = TridentEngine(ctx)
    extra = lm_frontend(cfg, ids.shape[0])
    pe, state, losses = LM.params_to_engine(eng, params), None, []
    for _ in range(steps):
        pe, loss, state = LM.train_step(
            eng, cfg, pe, ids, labels, lr=LMT_LR, optimizer=optimizer,
            opt_state=state, **(extra(eng) if extra else {}))
        losses.append(float(loss))
    return ctx, (pe, state), losses


def same_words(a, b) -> bool:
    """Two trees of shares (a share's data, or None) hold the same words,
    leaf for leaf; `b` on the CPU."""
    import torch
    la, lb = list(lm_leaves(a)), list(lm_leaves(b))
    return [p for p, _ in la] == [p for p, _ in lb] and all(
        (x is None and y is None) or (x is not None and y is not None
                                      and torch.equal(x.cpu(), y))
        for (_, x), (_, y) in zip(la, lb))


def lmt_card_vs_cpu(path: str, kernels: list, needed: tuple, cfg, params,
                    ids, labels, collapse: bool, card: str,
                    optimizer=None, steps: int = 1) -> dict:
    """Train steps (``lmt_secure``) on the card (a driven path) and on the
    CPU: equal new params and optimizer state words, losses, totals(), no
    abort, the card's launches the CPU run's wrapper calls."""
    from repro_torch.kernels import ops
    (ctx, new, loss), wall = drive(
        path, kernels, needed,
        lambda: lmt_secure(LM_DEVICE, cfg, params, ids, labels, collapse,
                           optimizer, steps), steps, unit="step")
    card_launches = {k["name"]: k["launches_by_path"][path] for k in kernels}
    ops.reset_launches()
    t0 = time.perf_counter()
    rctx, rnew, rloss = lmt_secure("cpu", cfg, params, ids, labels, collapse,
                                   optimizer, steps)
    cpu_s = time.perf_counter() - t0
    calls = {k.name: k.calls for k in ops.KERNELS}
    check(not ctx.abort_flag() and not rctx.abort_flag(), f"{path}: aborted")
    check(same_words(new, rnew), f"{path}: new params or optimizer state "
          f"words differ between the card and the CPU")
    check(loss == rloss, f"{path}: losses {loss} on the card, {rloss} on "
          f"the CPU")
    check(ctx.tally.totals() == rctx.tally.totals(),
          f"{path}: totals() differ between the card and the CPU")
    check(card_launches == calls,
          f"{path}: launches on the card {card_launches}, wrapper calls on "
          f"the CPU {calls}")
    print(f"{path} [{card}]: new params{', optimizer state' * bool(optimizer)}"
          f", losses {[round(v, 6) for v in loss]} and totals() equal to the "
          f"CPU run, no abort; launches = the CPU run's wrapper calls; card "
          f"{wall:.2f} s, CPU {cpu_s:.2f} s ({steps} step(s))")
    return {"wall_s": wall, "cpu_s": cpu_s, "loss": loss[-1], "losses": loss,
            "steps": steps, "totals": ctx.tally.totals(),
            "launches": {n: c for n, c in card_launches.items() if c}}


def lmt_grads_vs_float64(cfg, params, ids, labels, secure_loss: float,
                         secure: dict, card: str, phase: str = "lm-train",
                         bounds: tuple = LMT_GRAD_BOUNDS,
                         loss_atol: float = LMT_LOSS_ATOL) -> dict:
    """A main path's first step's loss and gradients (opened, float64)
    against the fixed-point model from the same weights on the card (held
    within `bounds` (relative L2, error per largest entry) and
    `loss_atol`; all-zero and shuffled gradients must fail) and against
    plain float64 (ROADMAP N6, reported)."""
    import torch
    import torch_lm_rehearsal as RH
    from repro_torch.nn.engine import PlainEngine
    extra = lm_frontend(cfg, ids.shape[0])
    out = {}
    for name, eng in (("fixed_point", RH.fixed_point_plain(LM_DEVICE)),
                      ("float64", PlainEngine(device=LM_DEVICE))):
        t0 = time.perf_counter()
        loss, want, _ = RH.loss_and_grads(eng, cfg, params, ids, labels,
                                          extra)
        gap = RH.grad_gap(want, secure)
        out[name] = dict(gap, loss=loss, loss_err=abs(loss - secure_loss),
                         s=time.perf_counter() - t0)
        if name == "fixed_point":
            def within(g):
                return g["rel_l2"] <= bounds[0] and \
                    g["err_per_max"] <= bounds[1]
            check(within(gap), f"{phase}: the gradients lie {gap} from the "
                  f"fixed-point model; bounds {bounds}")
            check(out[name]["loss_err"] <= loss_atol,
                  f"{phase}: loss {secure_loss} against the fixed-point "
                  f"model's {loss}")
            zeros = RH.grad_gap(want, {k: torch.zeros_like(v)
                                       for k, v in want.items()})
            mixed = RH.grad_gap(want, RH.shuffled(want))
            check(not within(zeros) and not within(mixed),
                  f"{phase}: all-zero ({zeros}) or shuffled ({mixed}) "
                  f"gradients pass the bounds")
            out[name]["zeros_rel_l2"] = zeros["rel_l2"]
            out[name]["shuffled_rel_l2"] = mixed["rel_l2"]
        del want
        torch.cuda.empty_cache()
    print(f"{phase} [{card}]: {cfg.name}: loss {secure_loss:.6f}; "
          f"gradients against the fixed-point model {out['fixed_point']} "
          f"(held: {bounds}, loss {loss_atol}); against plain float64 "
          f"{out['float64']} (ROADMAP N6, not held)")
    return out


def lmt_main_path(kernels: list, card: str) -> dict:
    """phi-3-vision-4.2b at full width (LMT_LAYERS of its layers), through
    ``train_main_path``."""
    from repro_torch.configs import get
    full = get("phi_3_vision_4_2b").CONFIG
    cfg = lm_cut(full, LMT_LAYERS)
    return train_main_path(
        kernels, card, "lm-train", "lmt", "phi_3_vision_4_2b", cfg,
        {"heads": cfg.n_heads, "kv_heads": cfg.n_kv_heads, "d_head": cfg.dh,
         "frontend_tokens": cfg.frontend_tokens, "layers": LMT_LAYERS,
         "of_layers": full.n_layers,
         "cuts": [f"layers {LMT_LAYERS} of {full.n_layers}"]},
        LMT_IDS, LMT_GRAD_BOUNDS, LMT_LOSS_ATOL)


def train_main_path(kernels: list, card: str, phase: str, prefix: str,
                    arch: str, cfg, about: dict, n_ids: int, bounds: tuple,
                    loss_atol: float) -> dict:
    """A training main path at full width: init_params, params_to_engine
    on the card, LMT_STEPS driven steps of `n_ids` ids and labels at batch
    1, faithful (paths ``{prefix}_step{i}``: ``loss_and_grads`` then
    ``sgd_update``, the first's gradients opened, each part's wall kept),
    one more step through ``train_step`` profiled; ring_matmul and
    and_level at every shape the steps gave them, exact; the first step's
    loss and gradients against float64 (``lmt_grads_vs_float64``).
    `about`: the config's facts and cuts for the report."""
    import torch
    from repro_torch.core.context import make_context
    from repro_torch.core.ring import RING64
    from repro_torch.nn import model as LM
    from repro_torch.nn.engine import TridentEngine
    import torch_lm_rehearsal as RH
    rep = {"config": {
        "arch": cfg.name, "segments": cfg.segments(), "d_model": cfg.d_model,
        "d_ff": cfg.d_ff, "vocab": cfg.vocab, "ids": n_ids, "batch": 1,
        "remat": cfg.remat, "mode": "faithful", "lr": LMT_LR,
        "embed_scale": LM_EMBED_SCALE, "steps": LMT_STEPS, **about}}
    print(f"{phase} [{card}]: main path {rep['config']}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = LM.init_params(cfg, LM_SEED)
    params["embed"]["table"] *= LM_EMBED_SCALE
    rep["init_params_s"] = time.perf_counter() - t0
    rep["parameters"] = int(sum(np.asarray(leaf).size
                                for _, leaf in lm_leaves(params)
                                if leaf is not None))
    ids, labels = lmt_labels(cfg, (1, n_ids))
    ctx = make_context(RING64, seed=LM_SEED, device=LM_DEVICE)
    eng = TridentEngine(ctx)
    front = lm_frontend(cfg, 1)
    extra = front(eng) if front else {}
    t0 = time.perf_counter()
    pe = LM.params_to_engine(eng, params)
    torch.cuda.synchronize()
    rep["share_s"] = time.perf_counter() - t0
    print(f"{phase} [{card}]: {cfg.name}: {rep['parameters']} parameters, "
          f"init_params {rep['init_params_s']:.1f} s on the host, shared on "
          f"the card in {rep['share_s']:.2f} s; "
          f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated")
    needed = ("prf_mask", "ring_matmul", "ring_matmul_batched", "and_level")
    seen = {"ring_matmul": set(), "and_level": set()}
    steps, losses, first = [], [], {}

    def step():
        nonlocal pe
        walls = {}
        t0 = time.perf_counter()
        loss, grads = LM.loss_and_grads(eng, cfg, pe, ids, labels, **extra)
        torch.cuda.synchronize()
        walls["loss_and_grads_s"] = time.perf_counter() - t0
        if not first:
            # opened on the host: the card holds the trees
            first["grads"] = {k: v.cpu() for k, v in
                              RH.grads_plain(eng, grads).items()}
        t0 = time.perf_counter()
        pe = LM.sgd_update(eng, pe, grads, LMT_LR)
        torch.cuda.synchronize()
        walls["sgd_update_s"] = time.perf_counter() - t0
        walls["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        steps.append(walls)
        losses.append(float(loss))

    for i in range(LMT_STEPS):
        _, wall = record_shapes(seen, lambda: drive(
            f"{prefix}_step{i + 1}", kernels, needed, step, 1, unit="step"))
        steps[-1]["wall_s"] = wall
        check(np.isfinite(losses[-1]), f"{phase}: {cfg.name} step {i + 1}'s "
              f"loss {losses[-1]}")
    check(not ctx.abort_flag(), f"{phase}: the {cfg.name} step aborted")
    rep["steps"] = steps
    rep["losses"] = losses
    last = f"{prefix}_step{LMT_STEPS}"
    rep["launches_per_step"] = {
        k["name"]: k["launches_by_path"][last] for k in kernels
        if k["launches_by_path"][last]}
    rep["totals"] = ctx.tally.totals()
    by_name = {}
    busy, dops = profile_batch(
        f"{phase} {cfg.name}", lambda: LM.train_step(
            eng, cfg, pe, ids, labels, lr=LMT_LR, **extra),
        steps[-1]["wall_s"], unit="training step", by_name=by_name)
    top = sorted(by_name.items(), key=lambda kv_: -kv_[1])[:8]
    rep["profile_step"] = {
        "busy_ms": busy, "device_ops": dops, "wall_s": steps[-1]["wall_s"],
        "busy_share": busy / (steps[-1]["wall_s"] * 1e3),
        "top_ms": {k[:80]: v for k, v in top}}
    check(not ctx.abort_flag(), f"{phase}: the profiled {cfg.name} step "
          f"aborted")
    rep["max_memory_allocated_gib"] = torch.cuda.max_memory_allocated() \
        / 2**30
    print(f"{phase} [{card}]: {cfg.name} at full width ({about['cuts']}), "
          f"{n_ids} ids: steps "
          f"{[{k: round(v, 3) for k, v in s.items()} for s in steps]}"
          f"; losses {losses}; launches per step "
          f"{rep['launches_per_step']}; busy share "
          f"{rep['profile_step']['busy_share']:.3f}; peak device memory "
          f"{rep['max_memory_allocated_gib']:.1f} GiB; no abort")
    del pe, eng, extra
    torch.cuda.empty_cache()
    rep["exact"] = lmr_exact_words(arch, seen, card, phase=phase)
    rep["grads_vs_float64"] = lmt_grads_vs_float64(
        cfg, params, ids, labels, losses[0], first.pop("grads"), card, phase,
        bounds, loss_atol)
    torch.cuda.empty_cache()
    return rep


def lm_train_phase(kernels: list, card: str) -> dict:
    """(b) the four attention families' SMOKE at 2 layers and qwen3 at
    phase lm's middle width, one train step each on the card against the
    CPU, bit for bit, faithful and collapsed (mixtral with both routings,
    qwen3 SMOKE also with microbatch 2); (c) the main path: a train step
    of phi-3-vision-4.2b at full width."""
    from repro_torch.configs import get
    from repro_torch.nn import model as LM
    report = {"card": card, "smoke": {}}
    mid = dataclasses.replace(
        lm_cut(get("qwen3_1_7b").CONFIG, 2), d_model=256, n_heads=4,
        n_kv_heads=2, d_head=64, d_ff=768, vocab=4096, q_chunk=64)
    cases = [(arch, lm_cut(get(arch).SMOKE, 2), LMT_SMOKE_IDS)
             for arch in LM_SMOKE_ARCHS]
    cases.append(("mixtral_8x7b_dense", dataclasses.replace(
        lm_cut(get("mixtral_8x7b").SMOKE, 2), moe_routing="dense"),
        LMT_SMOKE_IDS))
    cases.append(("qwen3_1_7b_microbatch", dataclasses.replace(
        lm_cut(get("qwen3_1_7b").SMOKE, 2), microbatch=2), LMT_SMOKE_IDS))
    cases.append(("qwen3_1_7b_middle", mid, (1, LMT_IDS)))
    for name, cfg, shape in cases:
        params = LM.init_params(cfg, LM_SEED)
        ids, labels = lmt_labels(cfg, shape)
        for collapse in (False, True):
            mode = "collapsed" if collapse else "faithful"
            path = f"lmt_{name}_{mode}"
            report["smoke"][path] = lmt_card_vs_cpu(
                path, kernels, ("prf_mask", "ring_matmul",
                                "ring_matmul_batched"), cfg, params, ids,
                labels, collapse, card)
    report["main_path"] = lmt_main_path(kernels, card)
    return report


# --- phase lm-recurrent-train: LM training of the recurrent families ----
# (b) the SMOKE configs uncut (zamba2: two retention groups of 2, the
# shared block applied twice; xlstm: one mLSTM + sLSTM pair), one
# train_step of LMRT_SMOKE_IDS ids and labels (two chunks of seq_chunk 8)
# each, faithful and collapsed, and LMRT_MOMENTUM_STEPS steps of xlstm
# through train.optim.Momentum, collapsed
LMRT_SMOKE_IDS = (2, 16)
LMRT_MOMENTUM_STEPS = 2
# (c), (d) the main paths (tools/torch_lm_rehearsal.py
# full_recurrent_train_cases): zamba2-7b's CONFIG at 2 of 81 layers with
# its shared block after each, and xlstm-350m's at 8 of 24 layers (whole
# until PR 28, whose launch phase needed the time; the xlstm readings
# below are the whole model's), 512 ids and labels each (two chunks of
# 256), batch 1, faithful, remat, LMT_STEPS steps.
# The gradients against the fixed-point model, as phase lm-train's
# (relative L2, error per largest entry): tools/torch_lm_rehearsal.py
# --train --cases recurrent on the CPU (3 seeds, faithful and collapsed):
# at d_model 256 zamba2 0.099-0.163 (0.051-0.172), xlstm 0.055-0.063
# (0.045-0.089); SMOKE up to 0.359 (0.377), zamba2 at one seed, where
# one gate of a 32-wide model flips; --cases full-recurrent --device
# cuda on an H100 80GB HBM3 at 700 W (these main paths, 3 seeds, both
# modes): zamba2 0.125-0.161 (0.054-0.131), xlstm 0.037-0.039
# (0.050-0.074), the loss within 8.7e-5; in this phase, at its own seed,
# zamba2 0.163 (0.192) and xlstm 0.038 (0.045).  Held within
# LMRT_GRAD_BOUNDS, the loss within LMRT_LOSS_ATOL; all-zero gradients
# (relative L2 1) and shuffled ones (about 1.41) fail.  Against plain
# float64 they lie 246-334x (zamba2) and 13,036-15,490x (xlstm) their
# norm away (ROADMAP N6: xlstm's softmax sums 50,304 entries' bias).
LMRT_GRAD_BOUNDS = {"zamba2_7b": (0.25, 0.35), "xlstm_350m": (0.1, 0.15)}
LMRT_LOSS_ATOL = 1e-3
# K2 at the training shapes not timed before: the retention backward's
# new products (zamba2: 32 heads, C 256, d_k 64, d_v 112; xlstm: 4 heads,
# d_v 256): dY V^T, dS_qk K (and dS_qk^T Q), dY Sm^T (and V dS^T);
# sLSTM's backward public contractions (the transposed decay matrix
# broadcast over the components and the batch, and the carry gradient's
# weights a^{i+1}, M = 1); zamba2's shared block at 512 positions
# (scores, and probs @ v, the shapes of its backward products too); and
# phase lm-train's attention at phi-3-vision's 704 positions
LMRT_K2_SHAPES = (
    ("zamba2_bwd_dy_vT", (1, 32, 256, 112), (1, 32, 112, 256)),
    ("zamba2_bwd_dsqk_k", (1, 32, 256, 256), (1, 32, 256, 64)),
    ("zamba2_bwd_dy_SmT", (1, 32, 256, 112), (1, 32, 112, 64)),
    ("xlstm_bwd_dsqk_k", (1, 4, 256, 256), (1, 4, 256, 64)),
    ("slstm_bwd_pub_left_Dt", (1, 1, 4, 256, 256), (4, 1, 4, 256, 256)),
    ("slstm_bwd_weighted_sum", (1, 1, 4, 1, 256), (4, 1, 4, 256, 256)),
    ("zamba2_shared_train_scores", (1, 32, 512, 112), (1, 32, 112, 512)),
    ("zamba2_shared_train_probs_v", (1, 32, 512, 512), (1, 32, 512, 112)),
    ("phi3v_train_scores", (1, 32, 704, 96), (1, 32, 96, 704)),
    ("phi3v_train_probs_v", (1, 32, 704, 704), (1, 32, 704, 96)))


def lm_recurrent_train_phase(kernels: list, card: str) -> dict:
    """(a) K2 at the training shapes (taken with the kernel rows:
    ``recurrent_k2_rows``); (b) zamba2's and xlstm's SMOKE uncut, a train
    step each on the card against the CPU, faithful and collapsed, and
    xlstm's Momentum steps; (c), (d) the main paths: a train step of
    zamba2-7b (2 of 81 layers, the shared block after each) and of
    xlstm-350m at 8 of 24 layers, at full width (``train_main_path``)."""
    from repro_torch.configs import get
    from repro_torch.nn import model as LM
    from repro_torch.train.optim import Momentum
    import torch_lm_rehearsal as RH
    phase = "lm-recurrent-train"
    report = {"card": card, "smoke": {}}
    rows = next(k for k in kernels if k["name"] == "ring_matmul_batched")[
        "train_shapes"]
    check([r["shape"] for r in rows] == [n for n, _, _ in LMRT_K2_SHAPES],
          f"{phase}: K2 was not held at every training shape")
    report["k2_shapes"] = [r["shape"] for r in rows]
    needed = ("prf_mask", "ring_matmul", "ring_matmul_batched")
    runs = [(arch, False, None, 1) for arch in LMR_SMOKE_ARCHS]
    runs += [(arch, True, None, 1) for arch in LMR_SMOKE_ARCHS]
    runs.append(("xlstm_350m", True, Momentum(lr=LMT_LR),
                 LMRT_MOMENTUM_STEPS))
    for arch, collapse, opt, steps in runs:
        cfg = get(arch).SMOKE
        params = LM.init_params(cfg, LM_SEED)
        ids, labels = lmt_labels(cfg, LMRT_SMOKE_IDS)
        path = f"lmrt_{arch}_{'collapsed' if collapse else 'faithful'}" + \
            ("_momentum" if opt else "")
        report["smoke"][path] = lmt_card_vs_cpu(
            path, kernels, needed, cfg, params, ids, labels, collapse, card,
            opt, steps)
    for _, cfg, shape in RH.full_recurrent_train_cases(get):
        arch = "zamba2_7b" if cfg.family == "hybrid" else "xlstm_350m"
        full = get(arch).CONFIG
        rc = cfg.ret_cfg()
        cuts = [] if cfg.n_layers == full.n_layers else \
            [f"layers {cfg.n_layers} of {full.n_layers}"]
        if cfg.family == "hybrid":
            cuts.append(f"shared_attn_every {cfg.shared_attn_every} of "
                        f"{full.shared_attn_every}")
        report[arch] = train_main_path(
            kernels, card, phase, f"lmrt_{arch}", arch, cfg,
            {"layers": cfg.n_layers, "of_layers": full.n_layers,
             "heads": cfg.n_heads, "d_k": rc.d_k, "d_v": rc.d_v,
             "seq_chunk": cfg.seq_chunk, "cuts": cuts},
            shape[1], LMRT_GRAD_BOUNDS[arch], LMRT_LOSS_ATOL)
    return report


# --- phase launch: the LM launcher (repro_torch.launch.train) ------------
# (a) SMOKE configs through the launcher, card against CPU
LAUNCH_SMOKE_ARCHS = ("whisper_tiny", "phi_3_vision_4_2b")
LAUNCH_SMOKE_STEPS = 2
# (b) the main path: whisper-tiny's CONFIG whole, the launcher's flags
# --no-smoke --steps 4 --batch 2 --seq 64; crashed at step 2, after step
# 1's checkpoint (ckpt_every = steps // 2), and resumed
LAUNCH_ARCH = "whisper_tiny"
LAUNCH_STEPS = 4
LAUNCH_BATCH, LAUNCH_SEQ = 2, 64
LAUNCH_CRASH_AT = 2
LAUNCH_KERNELS = ("prf_mask", "ring_matmul", "ring_matmul_batched",
                  "mpc_matmul_fused")


def launch_argv(arch: str, steps: int, ckpt: str, device: str,
                smoke: bool = True, batch: int = 2, seq: int = 8) -> list:
    return ["--arch", arch, "--steps", str(steps), "--batch", str(batch),
            "--seq", str(seq), "--ckpt", ckpt, "--device", device,
            "--smoke" if smoke else "--no-smoke"]


def launch_run(argv: list, crash_at: int | None = None,
               walls: list | None = None):
    """``launch.train.build`` then ``Trainer.run`` (an injected crash
    caught); each step's wall (synchronized) into `walls`."""
    import torch
    from repro_torch.launch import train as LT
    launch = LT.build(LT.parse_args(argv))
    tr = launch.trainer
    if walls is not None:
        inner = tr.step_fn

        def timed(params, step, *batch):
            t0 = time.perf_counter()
            out = inner(params, step, *batch)
            if launch.device.type == "cuda":
                torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            return out

        tr.step_fn = timed
    try:
        tr.run(crash_at=crash_at)
    except RuntimeError as e:
        if crash_at is None or "injected crash" not in str(e):
            raise
    return launch


def same_tree_words(a, b) -> bool:
    """Two trees of shares hold the same words, leaf for leaf, on any
    devices."""
    import torch
    la, lb = list(lm_leaves(a)), list(lm_leaves(b))
    return [p for p, _ in la] == [p for p, _ in lb] and all(
        (x is None and y is None) or (
            x is not None and y is not None and x.dtype == y.dtype
            and torch.equal(x, y.to(x.device)))
        for (_, x), (_, y) in zip(la, lb))


class checkpoint_timer:
    """While active, ``train.checkpoint``'s save, latest, restore and
    rewrap (as the trainer calls them) log (name, wall s, shard bytes)."""

    NAMES = ("save", "latest", "restore", "rewrap")

    def __init__(self):
        self.log = []

    def __enter__(self):
        import torch
        from repro_torch.train import checkpoint as CK
        self.orig = {n: getattr(CK, n) for n in self.NAMES}
        depth = [0]

        def wrap(name):
            def call(*args, **kw):
                if depth[0]:                 # rewrap's own recursion
                    return self.orig[name](*args, **kw)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                depth[0] += 1
                try:
                    out = self.orig[name](*args, **kw)
                finally:
                    depth[0] -= 1
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                path = out if name in ("save", "latest") else (
                    args[0] if name == "restore" else None)
                shard = None if not isinstance(path, str) else \
                    os.path.join(path, "shard_0.npz")
                self.log.append((name, wall, os.path.getsize(shard)
                                 if shard and os.path.exists(shard)
                                 else None))
                return out
            return call

        for n in self.NAMES:
            setattr(CK, n, wrap(n))
        return self

    def __exit__(self, *exc):
        from repro_torch.train import checkpoint as CK
        for n, f in self.orig.items():
            setattr(CK, n, f)
        return False


def launch_smoke(arch: str, kernels: list, card: str) -> dict:
    """(a) one SMOKE config through the launcher on the card (a driven
    path) and on the CPU: equal losses, final params words, totals(), no
    abort; the card's launches the CPU run's wrapper calls."""
    from repro_torch.kernels import ops
    path = f"launch_{arch}_smoke"
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        runs["cuda"], wall = drive(
            path, kernels, LAUNCH_KERNELS, lambda: launch_run(launch_argv(
                arch, LAUNCH_SMOKE_STEPS, os.path.join(tmp, "cuda"),
                "cuda")), LAUNCH_SMOKE_STEPS, unit="step")
        card_launches = {k["name"]: k["launches_by_path"][path]
                         for k in kernels}
        ops.reset_launches()
        t0 = time.perf_counter()
        runs["cpu"] = launch_run(launch_argv(
            arch, LAUNCH_SMOKE_STEPS, os.path.join(tmp, "cpu"), "cpu"))
        cpu_s = time.perf_counter() - t0
        calls = {k.name: k.calls for k in ops.KERNELS}
    dev, host = runs["cuda"], runs["cpu"]
    check(not any(dev.step_aborts.values())
          and not any(host.step_aborts.values()), f"{path}: aborted")
    check(dev.trainer.losses == host.trainer.losses,
          f"{path}: losses {dev.trainer.losses} on the card, "
          f"{host.trainer.losses} on the CPU")
    check(same_tree_words(dev.trainer.params, host.trainer.params),
          f"{path}: final params words differ between the card and the CPU")
    check(dev.totals() == host.totals(),
          f"{path}: totals() differ between the card and the CPU")
    check(card_launches == calls, f"{path}: launches on the card "
          f"{card_launches}, wrapper calls on the CPU {calls}")
    print(f"{path} [{card}]: losses {dev.trainer.losses}, final params "
          f"words and totals() equal to the CPU run, no abort; launches = "
          f"the CPU run's wrapper calls; card {wall:.2f} s, CPU "
          f"{cpu_s:.2f} s ({LAUNCH_SMOKE_STEPS} steps, events "
          f"{dev.trainer.events})")
    return {"wall_s": wall, "cpu_s": cpu_s, "losses": dev.trainer.losses,
            "totals": dev.totals(), "events": dev.trainer.events,
            "launches": {n: c for n, c in card_launches.items() if c}}


def fused_plain_threaded(mx, lx, my, ly) -> tuple:
    """``mpc_matmul_fused_plain`` with each quadrant's product by
    ``cpu_matmul`` (threads over the columns)."""
    from repro_torch.kernels import mpc_matmul_fused as MF
    xs = (mx, lx[0] + lx[1] + lx[2])
    ys = (my, ly[0] + ly[1] + ly[2])
    return MF._combine(lambda i, j: cpu_matmul(xs[i], ys[j]),
                       mx.shape[0], my.shape[1], mx.dtype, mx.device)


def launch_fused_shapes() -> list:
    """The operand shapes phase launch's steps give ``mpc_matmul_fused``:
    the weight gradients x^T dY (every collapsed 2-D product; the forward
    and dx products are 3-D) of whisper-tiny's CONFIG at the launcher's
    batch and ids, K the decoder's tokens or the encoder's frames."""
    from repro_torch.configs import get
    cfg = get(LAUNCH_ARCH).CONFIG
    d, f, V = cfg.d_model, cfg.d_ff, cfg.vocab
    dec, enc = LAUNCH_BATCH * LAUNCH_SEQ, LAUNCH_BATCH * cfg.frontend_tokens
    mkn = [(d, dec, d), (d, dec, f), (d, dec, V), (f, dec, d), (d, enc, d),
           (d, enc, f), (f, enc, d)]
    return [((M, K), (3, M, K), (K, N), (3, K, N)) for M, K, N in mkn]


def launch_fused_rows(shapes: list) -> list:
    """``mpc_matmul_fused`` at each of `shapes` (its four operands'):
    random words on the card against the plain version on the CPU
    (exact), the kernel's device time (profiler), the wrapper call's
    (CUDA events), beside its bound.  No launch here counts toward a
    path."""
    import torch
    from repro_torch.kernels import mpc_matmul_fused as MF
    from repro_torch.kernels import ring_matmul as RM
    dev = torch.device(LM_DEVICE)
    rng = np.random.RandomState(LM_SEED + 3)
    rows = []
    for ops_shapes in shapes:
        (M, K), N = ops_shapes[0], ops_shapes[2][1]
        ins = [torch.from_numpy(rng.randint(-2**63, 2**63 - 1, size=sh,
                                            dtype=np.int64))
               for sh in ops_shapes]
        ins_d = [t.to(dev) for t in ins]
        got = [g.cpu() for g in MF.mpc_matmul_fused_cuda(*ins_d)]
        t0 = time.perf_counter()
        want = fused_plain_threaded(*ins)
        plain_ms = (time.perf_counter() - t0) * 1e3
        check(all(torch.equal(g, w) for g, w in zip(got, want)),
              f"launch: mpc_matmul_fused disagrees with its plain version "
              f"at the main path's {M}x{K}x{N}")
        chunk = MF.quadrant_chunk(M, N, K, RM._sm_count(dev))
        rows.append({
            "shape": f"{M}x{K}x{N}", "max_abs_err": 0,
            "ms": device_ms(lambda: MF.mpc_matmul_fused_cuda(*ins_d),
                            "mpc_matmul_fused_kernel", reps=10),
            "call_ms": cuda_ms(lambda: MF.mpc_matmul_fused_cuda(*ins_d),
                               reps=10, warmup=1),
            "plain_ms": plain_ms, "plain": "CPU torch.matmul, 8 threads",
            "k_chunk": chunk, "blocks": 4 * -(-M // RM.TILE)
            * -(-N // RM.TILE) * -(-K // chunk),
            **fused_bound(M, K, N)})
        r = rows[-1]
        print(f"launch: mpc_matmul_fused {r['shape']} exact: "
              f"{r['ms']:.5f} ms on the device, call {r['call_ms']:.5f} ms "
              f"(CPU {plain_ms:.1f} ms); bound {r['bound_ms']:.5f} ms by "
              f"{r['bound_by']} (bytes {r['bound_ms_bytes']:.5f}, int8 "
              f"operations {r['bound_ms_int8_ops']:.5f}); {r['blocks']} "
              f"blocks, k_chunk {chunk}")
        del ins_d, got
    torch.cuda.empty_cache()
    return rows


def launch_phase(kernels: list, card: str) -> dict:
    """(a) the SMOKE configs through the launcher, card against CPU; (b)
    whisper-tiny's CONFIG whole through the launcher: 4 steps, then a
    crashed run and its resume, equal words; (c) the dry run's bytes
    against the trees on the card; (d) the kernels at the steps' shapes."""
    import torch
    from repro_torch.configs import get
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch import specs as SP
    from repro_torch.train import checkpoint as CK
    report = {"card": card, "smoke": {}}
    for arch in LAUNCH_SMOKE_ARCHS:
        report["smoke"][arch] = launch_smoke(arch, kernels, card)

    cfg = get(LAUNCH_ARCH).CONFIG
    report["config"] = {
        "arch": cfg.name, "segments": cfg.segments(), "d_model": cfg.d_model,
        "heads": cfg.n_heads, "d_ff": cfg.d_ff, "vocab": cfg.vocab,
        "frontend_tokens": cfg.frontend_tokens, "remat": cfg.remat,
        "steps": LAUNCH_STEPS, "batch": LAUNCH_BATCH, "seq": LAUNCH_SEQ,
        "mode": "collapsed", "cuts": []}
    print(f"launch [{card}]: main path {report['config']}")
    tmp = tempfile.mkdtemp(prefix="trident_launch_")
    try:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        path = "launch_whisper_full"
        seen = {"mpc_matmul_fused": set(), "ring_matmul": set(),
                "and_level": set()}
        walls = []
        with checkpoint_timer() as ck_full:
            full, wall = record_shapes(seen, lambda: drive(
                path, kernels, LAUNCH_KERNELS, lambda: launch_run(
                    launch_argv(LAUNCH_ARCH, LAUNCH_STEPS,
                                os.path.join(tmp, "full"), "cuda", False,
                                LAUNCH_BATCH, LAUNCH_SEQ), walls=walls),
                LAUNCH_STEPS, unit="step"))
        tr = full.trainer
        check(tr.events == ["ckpt@1", "ckpt@3"] and not any(
            full.step_aborts.values()), f"launch: the uninterrupted run's "
            f"events {tr.events}, aborts {full.step_aborts}")
        check(all(np.isfinite(v) for v in tr.losses)
              and len(tr.losses) == LAUNCH_STEPS,
              f"launch: losses {tr.losses}")
        report["run_wall_s"] = wall
        report["step_walls_s"] = list(walls)
        steady = min(walls)
        report["losses"] = tr.losses
        report["totals"] = full.totals()
        report["max_memory_allocated_gib"] = \
            torch.cuda.max_memory_allocated() / 2**30
        report["checkpoints_uninterrupted"] = ck_full.log

        # (c) the dry run's argument bytes against the trees on the card
        cell = DR.run_cell(LAUNCH_ARCH, "launch", cfg=cfg,
                           dims=(LAUNCH_SEQ, LAUNCH_BATCH, "train"),
                           collapse=True, verbose=False)
        on_card = SP.tree_bytes(tr.params)
        ids, labels = tr.batch_fn(0)
        inputs = SP.tree_bytes(full.inputs) + ids.nbytes + labels.nbytes
        check(all(x is None or x.device.type == "cuda"
                  for _, x in lm_leaves(tr.params)),
              "launch: a parameter leaf is not on the card")
        check(cell["mem"]["param_bytes"] == on_card
              and cell["mem"]["input_bytes"] == inputs,
              f"launch: the dry run's bytes {cell['mem']} against "
              f"{on_card} of params and {inputs} of inputs on the card")
        report["dryrun"] = {"mem": cell["mem"], "fits": cell["fits"],
                            "params_on_card_bytes": on_card,
                            "inputs_bytes": inputs,
                            "t_compute_limb": cell["t_compute_limb"],
                            "t_memory": cell["t_memory"]}
        print(f"launch [{card}]: the dry run's argument bytes "
              f"{cell['mem']['argument_size_bytes']} = the params on the "
              f"card ({on_card}) + the inputs ({inputs}); its bound "
              f"t_compute_limb {cell['t_compute_limb']:.4f} s a step")

        # one more step (step index LAUNCH_STEPS), profiled and driven:
        # a step's launches without the sharing's
        by_name = {}
        step_path = "launch_whisper_profiled_step"
        (busy, dops), _ = drive(step_path, kernels, LAUNCH_KERNELS,
                                lambda: profile_batch(
            f"launch {cfg.name}", lambda: tr.step_fn(
                tr.params, LAUNCH_STEPS, *tr.batch_fn(LAUNCH_STEPS)),
            steady, unit="training step", by_name=by_name), 1, unit="step")
        report["launches_per_step"] = {
            k["name"]: k["launches_by_path"][step_path] for k in kernels
            if k["launches_by_path"][step_path]}
        check(all(k["launches_by_path"][path] >= LAUNCH_STEPS
                  * k["launches_by_path"][step_path] for k in kernels),
              "launch: the uninterrupted run launched less than its steps")
        top = sorted(by_name.items(), key=lambda kv_: -kv_[1])[:8]
        report["profile_step"] = {
            "busy_ms": busy, "device_ops": dops, "wall_s": steady,
            "busy_share": busy / (steady * 1e3),
            "top_ms": {k[:80]: v for k, v in top}}
        check(not full.step_aborts[LAUNCH_STEPS],
              "launch: the profiled step aborted")

        # the same run crashed at step 2 (after step 1's checkpoint), then
        # resumed from it
        ck_dir = os.path.join(tmp, "crash")
        crash_walls, resume_walls = [], []
        with checkpoint_timer() as ck_crash:
            crashed = launch_run(launch_argv(
                LAUNCH_ARCH, LAUNCH_STEPS, ck_dir, "cuda", False,
                LAUNCH_BATCH, LAUNCH_SEQ), crash_at=LAUNCH_CRASH_AT,
                walls=crash_walls)
        check(crashed.trainer.events == ["ckpt@1", "crash@2"],
              f"launch: the crashed run's events {crashed.trainer.events}")
        del crashed
        torch.cuda.empty_cache()
        with checkpoint_timer() as ck_resume:
            resumed = launch_run(launch_argv(
                LAUNCH_ARCH, LAUNCH_STEPS, ck_dir, "cuda", False,
                LAUNCH_BATCH, LAUNCH_SEQ), walls=resume_walls)
        rtr = resumed.trainer
        check(rtr.events == ["resumed@2", "ckpt@3"] and not any(
            resumed.step_aborts.values()), f"launch: the resumed run's "
            f"events {rtr.events}, aborts {resumed.step_aborts}")
        check(same_tree_words(rtr.params, tr.params),
              "launch: the resumed run's final params differ from the "
              "uninterrupted run's")
        check(rtr.losses == tr.losses[LAUNCH_CRASH_AT:],
              f"launch: resumed losses {rtr.losses}, uninterrupted "
              f"{tr.losses}")
        last = CK.latest(ck_dir)
        check(last is not None and last.endswith(
            f"step_{LAUNCH_STEPS - 1:08d}") and CK.verify(last),
              f"launch: latest() {last} does not verify")
        report["resume"] = {"events": rtr.events, "crash_step_walls_s":
                            crash_walls, "resume_step_walls_s": resume_walls,
                            "checkpoints_crashed": ck_crash.log,
                            "checkpoints_resumed": ck_resume.log}
        print(f"launch [{card}]: {cfg.name} whole at full width: steps "
              f"{[round(w, 3) for w in report['step_walls_s']]} s; losses {tr.losses}; "
              f"launches per step {report['launches_per_step']}; busy share "
              f"{report['profile_step']['busy_share']:.3f}; peak device "
              f"memory {report['max_memory_allocated_gib']:.1f} GiB; "
              f"checkpoints (name, s, bytes): uninterrupted {ck_full.log}, "
              f"crashed {ck_crash.log}, resumed {ck_resume.log}; the "
              f"resumed run (steps {[round(w, 3) for w in resume_walls]} s) "
              f"ends with the uninterrupted run's words, no abort, latest() "
              f"verifies")
        del full, resumed, tr, rtr
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # (d) the kernels at every shape the main path's steps gave them: the
    # ring matmul's here, mpc_matmul_fused's with the kernel rows
    report["exact"] = lmr_exact_words(LAUNCH_ARCH, seen, card, phase="launch")
    fused = sorted(seen["mpc_matmul_fused"])
    check(fused == sorted(launch_fused_shapes()),
          f"launch: mpc_matmul_fused was held at {launch_fused_shapes()}, "
          f"the steps gave it {fused}")
    report["fused_shapes"] = [f"{s[0][0]}x{s[0][1]}x{s[2][1]}"
                              for s in fused]
    print(f"launch [{card}]: mpc_matmul_fused exact at all {len(fused)} "
          f"shapes of the steps (the kernel rows' launch_shapes): "
          f"{report['fused_shapes']}")
    return report


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs.paper_models import NN
    from repro_torch.kernels import build
    from repro_torch.train.paper_ml import MLPNet, mlp_net_init

    t_start = time.perf_counter()
    # the wall of each phase, from the end of the one before it
    walls = {}
    t_mark = [t_start]

    def lap(phase: str) -> None:
        now = time.perf_counter()
        walls[phase] = round(now - t_mark[0], 1)
        t_mark[0] = now

    card = gpu_name_and_limit()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    print("phase lint")
    lint_phase(card)
    lap("lint")

    t0 = time.perf_counter()
    build.build_all()
    print(f"built {list(build.SOURCES)} in {time.perf_counter() - t0:.1f} s")
    # each library's compiler log, kept beside it by the build
    logs = {name: build.compile_log(name) for name in build.SOURCES}
    ptxas = {}
    for name, log in sorted(logs.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
                ptxas.setdefault(name, []).append(line.strip())
    # the two sources on the int8 tensor-core limb core; ptxas note C7520:
    # wgmma serialized, the tensor-core route lost
    for src in ("ring_matmul", "mpc_matmul_fused"):
        check("C7520" not in logs.get(src, ""),
              f"{src}: ptxas serialized its wgmma instructions (C7520)")
        gmma = tensor_core_instructions(build, src)
        if gmma is None:
            print(f"{src}: GMMA instructions not counted (no cuobjdump)")
        else:
            print(f"{src}: {gmma[0]} GMMA (tensor-core) instructions in the "
                  f"library's SASS, {gmma[1]} of them IGMMA")
            check(gmma[1] > 0, f"{src}: no integer GMMA in its SASS")

    # integer instructions of one squares() word: the compute side of
    # prf_mask's bound
    prf_instructions, prf_sass = prf_word_instructions(build)
    print(f"prf_mask: {prf_instructions} integer instructions a squares() "
          f"word in the SASS of squares_probe: {prf_sass}")

    lap("build")
    rng = np.random.RandomState(SEED)
    kernels = kernel_phase(rng, ptxas, prf_instructions)
    lap("kernels")
    for k in kernels:
        print(f"kernel {k['name']}: {k['ms']:.4f} ms on the device, "
              f"{k['call_ms']:.4f} ms per wrapper call (plain "
              f"{k['plain_ms']:.4f} ms, bound {k['bound_ms']:.4f} ms by "
              f"{k['bound_by']}) equal to plain")
        if "bound_ms_int8_ops" in k:
            print(f"  {k['shape']}, k_chunk {k['k_chunk']}: bound by bytes "
                  f"{k['bound_ms_bytes']:.5f} ms, by int8 limb-pair "
                  f"operations {k['bound_ms_int8_ops']:.5f} ms (64-bit "
                  f"operations on CUDA cores: "
                  f"{k['bound_ms_u64_cuda_core']:.5f} ms)")
            ph = k["phases"]
            print(f"  phases ({ph['blocks']} blocks): "
                  f"{ph['fixed_ms']:.5f} ms fixed a block + "
                  f"{ph['per_step_ms']:.5f} ms a step x "
                  f"{ph['main_path_steps']} steps on the main path; "
                  f"steps {ph['steps_a_block']} took "
                  f"{[round(t, 5) for t in ph['ms']]} ms")
            y = k["yardstick_int_mm_limb_planes"]
            print(f"  yardstick torch._int_mm of the stacked limb planes "
                  f"{y['shape']} (bound {y['bound_ms_int8_ops']:.5f} ms): "
                  f"B row-major {y['b_row_major']}, B column-major "
                  f"{y['b_col_major']}")
        for stage, r in k.get("rounds", {}).items():
            pp = r["per_party"]
            print(f"  {stage} round, {r['groups']} groups of {r['shape']} "
                  f"words, terms {r['terms']}: launch {r['ms']:.5f} ms on "
                  f"the device (bound {r['bound_ms']:.5f} ms by "
                  f"{r['bound_by']}, {r['unique_bytes']} unique bytes; "
                  f"plain {r['plain_ms']:.5f} ms); round call "
                  f"{r['call_ms']:.5f} ms, {r['device_ops']:g} device ops "
                  f"in {r['device_ms_all_ops']:.5f} ms; per-party sequence "
                  f"{pp['call_ms']:.5f} ms, {pp['device_ops']:g} device ops "
                  f"in {pp['device_ms']:.5f} ms")
        for r in k.get("shapes", []):
            print(f"  {r['shape']}: {r['ms']:.5f} ms on the device, call "
                  f"{r['call_ms']:.5f} ms (plain {r['plain_ms']:.3f} ms); "
                  f"bound {r['bound_ms']:.5f} ms by {r['bound_by']} (bytes "
                  f"{r['bound_ms_bytes']:.5f}, int8 operations "
                  f"{r['bound_ms_int8_ops']:.5f}); {r['blocks']} blocks of "
                  f"{r['steps_a_block']} steps (k_chunk {r['k_chunk']}): "
                  f"the ring matmul's fit gives {r['fit_ms']:.5f} ms")
        for world, chains in k.get("chains_at_n_128", {}).items():
            for name, r in chains.items():
                print(f"  {name} ({world}, n = {BATCH}): {r['ms']:.5f} ms "
                      f"on the device, wrapper call {r['call_ms']:.5f} ms, "
                      f"plain {r['plain_ms']:.5f} ms in "
                      f"{r['plain_device_ops']:g} device ops, bound "
                      f"{r['bound_ms']:.7f} ms by {r['bound_by']}")
        for world, entries in k.get("split_at_n_128", {}).items():
            for name, r in entries.items():
                print(f"  split {name} ({world}, n = {BATCH}): "
                      f"{r['ms']:.5f} ms on the device, wrapper call "
                      f"{r['call_ms']:.5f} ms, plain {r['plain_ms']:.5f} ms "
                      f"in {r['plain_device_ops']:g} device ops, bound "
                      f"{r['bound_ms']:.7f} ms by {r['bound_by']}")
        for r in k.get("batched_shapes", []):
            print(f"  {r['shape']} {r['a']} @ {r['b']}: {r['ms']:.5f} ms on "
                  f"the device, call {r['call_ms']:.5f} ms (CPU "
                  f"torch.matmul {r['plain_ms']:.3f} ms); bound "
                  f"{r['bound_ms']:.5f} ms by {r['bound_by']} (bytes "
                  f"{r['bound_ms_bytes']:.5f}, int8 operations "
                  f"{r['bound_ms_int8_ops']:.5f})")
        if "single_level" in k:
            r = k["single_level"]
            print(f"  one level (n = {BATCH}): {r['ms']:.5f} ms on the "
                  f"device, call {r['call_ms']:.5f} ms, plain "
                  f"{r['plain_ms']:.5f} ms; at n = 2^20 "
                  f"{r['at_n_2^20']['ms']:.5f} ms (bound "
                  f"{r['at_n_2^20']['bound_ms']:.5f} ms)")
        if "ms_spin_gated" in k:
            print(f"  spin-gated CUDA events: {k['ms_spin_gated']:.5f} ms a "
                  f"launch back to back")
        for case, r in k.get("cases", {}).items():
            print(f"  {case} ({r['streams']} streams, {r['words']} words): "
                  f"{r['ms']:.5f} ms on the device (profiler), "
                  f"{r['spin_gated']['ms']:.5f} ms spin-gated; call "
                  f"{r['call_ms']:.5f} ms, host {r['host_ms']:.5f} ms; plain "
                  f"{r['plain_ms']:.5f} ms; bound {r['bound_ms']:.5f} ms by "
                  f"{r['bound_by']} (bytes {r['bound_ms_bytes']:.5f}, INT32 "
                  f"instructions {r['bound_ms_int32_ops']:.5f})")
        for size, r in k.get("sizes", {}).items():
            print(f"  {size}: {r['ms']:.5f} ms on the device (profiler), "
                  f"{r['spin_gated']['ms']:.5f} ms spin-gated; call "
                  f"{r['call_ms']:.5f} ms; plain {r['plain_ms']:.5f} ms; the "
                  f"loop over and_level {r['and_level_loop_ms']:.5f} ms on "
                  f"the device, call {r['and_level_loop_call_ms']:.5f} ms; "
                  f"bound {r['bound_ms']:.7f} ms by {r['bound_by']}")

    net = MLPNet(NN["features"], NN["layers"])
    params = mlp_net_init(np.random.RandomState(SEED), net)
    queries = np.random.RandomState(SEED + 1).randn(N_BATCHES * BATCH,
                                                    net.features)
    want = forward_float64(params, queries)

    # --- the party runtime ----------------------------------------------
    (srv, words), wall = drive(
        "runtime", kernels, ("prf_mask", "ring_matmul", "mpc_matmul_grid",
                             "mult_terms", "and_terms"),
        lambda: serve("cuda", "hopper", params, net, queries), N_BATCHES)
    check(not srv.stats.aborted, "runtime: a party aborted on the card")
    for i, w in enumerate(srv.stats.batch_walls_s):
        print(f"runtime batch {i}: {w * 1e3:.1f} ms, {BATCH / w:.1f} "
              f"queries/s")
    print(f"runtime served {srv.stats.queries} queries in {wall:.3f} s: "
          f"{srv.stats.queries / wall:.1f} queries/s")

    t0 = time.perf_counter()
    ref_srv, ref_words = serve("cpu", "torch", params, net, queries)
    print(f"runtime cpu reference ('torch' backend) in "
          f"{time.perf_counter() - t0:.1f} s")
    check(not ref_srv.stats.aborted, "runtime: a party aborted on the CPU")
    check(torch.equal(words.cpu(), ref_words),
          "runtime: opened words differ between the card and the CPU")
    check(srv.batch_traffic == ref_srv.batch_traffic,
          "runtime: per_link() or totals() differ between the card and the "
          "CPU")
    print(f"runtime: words, per_link() and totals() equal to the CPU run; "
          f"per batch {srv.batch_traffic[0][1]}")
    # the grouped kernel's launches per batch against the wrapper calls of
    # one batch on the CPU ("hopper" backend, plain versions), where each
    # call is the launch the card makes
    from repro_torch.kernels import ops
    on_card = {k["name"]: k["launches_by_path"]["runtime"] / N_BATCHES
               for k in kernels}
    ops.reset_launches()
    _, hop_words = serve("cpu", "hopper", params, net, queries[:BATCH])
    check(torch.equal(hop_words, ref_words[:BATCH]),
          "runtime: the 'hopper' backend's CPU words differ from 'torch''s")
    for k in (ops.MULT_TERMS, ops.AND_TERMS, ops.PRF_MASK):
        check(on_card[k.name] == k.calls,
              f"runtime: {k.name} {on_card[k.name]:g} launches a batch on "
              f"the card, {k.calls} round calls a batch on the CPU")
    print(f"runtime: launches per batch {on_card}; mult_terms "
          f"{ops.MULT_TERMS.calls} and and_terms {ops.AND_TERMS.calls} "
          f"round calls, prf_mask {ops.PRF_MASK.calls} draw groups a batch "
          f"on the CPU")
    check_probs("runtime", words, want)
    step4 = {"words": words[:BATCH].cpu(), "traffic": srv.batch_traffic[0],
             "launches": on_card, "profile": {}}
    # the batch runs on the gateway's collector thread: the profiler's
    # CUDA activity must still hold its launches
    _, profiled_ops = profile_batch(
        "runtime", lambda: serve("cuda", "hopper", params, net,
                                 queries[:BATCH]),
        min(srv.stats.batch_walls_s[1:] or srv.stats.batch_walls_s),
        by_name=step4["profile"])
    check(profiled_ops >= sum(on_card.values()),
          f"runtime: the profiled batch holds {profiled_ops} device ops, "
          f"fewer than its {sum(on_card.values()):g} kernel launches")

    lap("runtime")
    # --- the runtime's offline-online split ------------------------------
    print("phase runtime-offline-online")
    split = offline_online_phase(params, net, queries[:BATCH], kernels, srv,
                                 words)
    next(k for k in kernels if k["name"] == "mult_terms")[
        "dotp_rounds"] = split.pop("dotp_rounds")
    step4["profile_split"] = split.pop("profile_by_name")

    lap("runtime-offline-online")
    # --- joint path A: faithful joint simulation, served ------------------
    (jsrv, jwords), wall = drive(
        "joint_faithful", kernels, ("prf_mask", "ring_matmul", "and_level"),
        lambda: serve_joint("cuda", params, net, queries), N_BATCHES)
    check(not jsrv.stats.aborted, "joint A: the joint world aborted")
    for i, w in enumerate(jsrv.batch_walls_s):
        print(f"joint A batch {i}: {w * 1e3:.1f} ms, {BATCH / w:.1f} "
              f"queries/s")
    print(f"joint A served {jsrv.stats.queries} queries in {wall:.3f} s: "
          f"{jsrv.stats.queries / wall:.1f} queries/s")
    t0 = time.perf_counter()
    ops.reset_launches()
    jref_srv, jref_words = serve_joint("cpu", params, net, queries)
    print(f"joint A cpu reference in {time.perf_counter() - t0:.1f} s")
    check_calls("joint_faithful", kernels, N_BATCHES)
    check(torch.equal(jwords.cpu(), jref_words),
          "joint A: opened words differ between the card and the CPU")
    stat_keys = ("batches", "queries", "online_rounds", "online_bits",
                 "offline_bits", "aborted")
    check(all(getattr(jsrv.stats, f) == getattr(jref_srv.stats, f)
              for f in stat_keys),
          "joint A: ServeStats differ between the card and the CPU")
    check(torch.equal(jwords.cpu(), words.cpu()),
          "joint A: opened words differ from the runtime path's")
    check(jsrv.batch_totals == [t for _, t in srv.batch_traffic],
          "joint A: totals() differ from the runtime path's")
    print(f"joint A: words and ServeStats equal to the CPU run; words and "
          f"totals() equal to the runtime path's; per batch "
          f"{jsrv.batch_totals[0]}")
    check_probs("joint A", jwords, want)
    profile_batch("joint A", lambda: serve_joint("cuda", params, net,
                                                 queries[:BATCH]),
                  min(jsrv.batch_walls_s[1:] or jsrv.batch_walls_s))

    lap("joint-faithful")
    # --- joint path B: collapsed joint simulation, one batch --------------
    X = queries[:BATCH]
    (ctx, cwords), wall = drive(
        "joint_collapsed", kernels,
        ("prf_mask", "mpc_matmul_fused", "and_level"),
        lambda: predict_collapsed("cuda", params, net, X), 1)
    print(f"joint B batch: {wall * 1e3:.1f} ms, {BATCH / wall:.1f} "
          f"queries/s (the first collapsed batch)")
    check(not ctx.abort_flag(), "joint B: the joint world aborted")
    ops.reset_launches()
    cref_ctx, cref_words = predict_collapsed("cpu", params, net, X)
    check_calls("joint_collapsed", kernels, 1)
    check(torch.equal(cwords, cref_words),
          "joint B: opened words differ between the card and the CPU")
    check(ctx.tally.totals() == cref_ctx.tally.totals()
          == jsrv.batch_totals[0],
          "joint B: totals() differ from the CPU run or from path A")
    print("joint B: words equal to the CPU run; totals() equal to path A")
    check_probs("joint B", cwords, want[:BATCH])
    t0 = time.perf_counter()
    predict_collapsed("cuda", params, net, X)
    torch.cuda.synchronize()
    b_wall = time.perf_counter() - t0
    profile_batch("joint B", lambda: predict_collapsed("cuda", params, net,
                                                       X), b_wall)

    lap("joint-collapsed")
    # --- the joint simulation's offline-online split ----------------------
    print("phase joint-split")
    joint_split = joint_split_phase(params, net, X, kernels, {
        "faithful": (jwords[:BATCH].cpu(), jsrv.batch_totals[0],
                     min(jsrv.batch_walls_s[1:] or jsrv.batch_walls_s)),
        "collapsed": (cwords, ctx.tally.totals(), b_wall)}, card)
    lap("joint-split")

    # --- the ABY3 baseline ------------------------------------------------
    print("phase aby3")
    aby3 = aby3_phase(kernels, card)
    lap("aby3")
    # --- secure training on the party runtime -----------------------------
    print("phase runtime-train")
    train = runtime_train_phase(kernels)
    lap("runtime-train")

    # --- the four parties as four processes over TCP ----------------------
    print("phase cluster")
    cluster, cluster_ref = cluster_phase(params, net, queries, kernels,
                                         card)
    lap("cluster")

    # --- the observability plane ------------------------------------------
    print("phase obs")
    observed = obs_phase(params, net, queries, kernels, step4, cluster,
                         cluster_ref, card)
    lap("obs")

    # --- the serving gateway -----------------------------------------------
    print("phase gateway")
    gateway = gateway_phase(params, net, kernels, card)
    lap("gateway")

    # --- the LM stack's serving path ---------------------------------------
    print("phase lm")
    lm = lm_phase(kernels, card)
    lap("lm")

    # --- the recurrent families' serving path -------------------------------
    print("phase lm-recurrent")
    lm_recurrent = lm_recurrent_phase(kernels, card)
    lap("lm-recurrent")

    # --- LM training of the attention families -----------------------------
    print("phase lm-train")
    lm_train = lm_train_phase(kernels, card)
    lap("lm-train")

    # --- LM training of the recurrent families -----------------------------
    print("phase lm-recurrent-train")
    lm_recurrent_train = lm_recurrent_train_phase(kernels, card)
    lap("lm-recurrent-train")

    # --- the LM launcher ----------------------------------------------------
    print("phase launch")
    launch = launch_phase(kernels, card)
    lap("launch")

    print(f"phase walls (s): {walls}")
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all")
    print(json.dumps({"offline_online": split}))
    print(json.dumps({"joint_split": joint_split}))
    print(json.dumps({"aby3": aby3}))
    print(json.dumps({"runtime_train": train}))
    print(json.dumps({"cluster": cluster}))
    print(json.dumps({"obs": observed}))
    print(json.dumps({"gateway": gateway}))
    print(json.dumps({"lm": lm}))
    print(json.dumps({"lm_recurrent": lm_recurrent}))
    print(json.dumps({"lm_train": lm_train}))
    print(json.dumps({"lm_recurrent_train": lm_recurrent_train}))
    print(json.dumps({"launch": launch}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except ImportError as exc:
        print(f"chip_smoke: the port is not importable here ({exc}); run "
              "from the root of a checkout", file=sys.stderr)
        sys.exit(2)
