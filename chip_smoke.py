#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``asyncframework_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, one JSON line each (a phase that fails raises, and the script then
exits non-zero without a result line):

1. device -- the card's name and power limit, the kernels' build time, and
   the TF32 switches (both off, so every f32 product is full f32);
2. kernel -- each CUDA kernel against its plain PyTorch version on the
   card, at the shapes the main paths give it: error against the stated
   tolerance, bit-equality of two launches, and the median time of the
   kernel, the plain version and a library yardstick, beside the least
   time the card could take (its bound).  masked_grad at the epsilon and
   mnist8m shapes, its compacted form at phase 15's LibSVM-file task (a
   256-row shard of 2,048 x 2,000, 56 slots) and at a 512-row shard of
   4,096 x 500 (96 slots), both on the tiled route, its two ASAGA forms (saga_grad, xt_coeff) at the epsilon
   and mnist8m shards, each with the route it took (staged or tiled) and
   the other route's time (pinned; on the staged route that is the earlier
   design) taken in turns with it, and chunk_attention at a ring block (f),
   a Ulysses block (g),
   small f32 shapes (h) and the tensor-core route's bf16 edges (i), each
   with the route it took, its bound at the bf16 tensor-core rate (bf16)
   or the f32 FMA rate (f32), and SDPA in f32 and bf16 beside it; and
   kernel S1 (sparse_grad's fused launch, ``compacted_grad``: residual,
   stable radix sort and segment sums in one cooperative launch, on the
   local or the global route, which it picks from the data and which each
   shape must take; the global route also timed in turns where the local
   one runs) at
   rcv1's compacted task (4,752 slots of an 87,205 x 80 shard, d =
   47,236), its full shard, the edges (no valid slot, d = 1, every update
   in one column, K = 8) and a Zipf(1.0)-skewed task (its largest column
   ~30,000 entries, summed in chunks of L = 4,096), each bit-equal to its
   plain version on CPU copies and across launches, within 1e-5 of
   index_add_ and of an f64 sum, timed in turns with the earlier
   three-launch chain (ell_residual, torch.sort, segment_sum) and the
   library chain (a gather-and-sum residual, then index_add_); the
   coefficient form (``grad_sum``, ASAGA's table delta) and the residual
   alone (the evaluation, full shard) beside it, and whether the fused
   launch is captured by a CUDA graph; and the DCN ASAGA worker's per-slot
   forms, B1's ``saga_slots_grad`` at 5,408 slots of an epsilon shard
   (``sparse_step_capacity(0.1, 50,000)``) and S1's ``saga_slots_grad`` at
   rcv1's 4,752-slot task, each against its plain version; and the ML
   library's two B1 forms at epsilon's whole 400,000 x 2,000 f32 (one
   rank): the logistic full form (``logreg_epsilon_full``) and
   ``xt_coeff`` (``xt_epsilon_full``, with the SVM iteration's matmul pair
   ``X w``, ``X^T c`` timed beside the library's ``X^T c``);
3. main path -- ASGD ``run()`` and ``run_sync()`` on the full-size epsilon
   deployment (400,000 x 2,000 f32, 8 workers, b = 0.1) generated on the
   card, with every kernel's launch count set to 0 just before and read
   just after (every task on masked_grad's staged route); then the same
   solver on a small input, on the card and on the CPU (plain path), must
   agree;
4. long_context -- ``ring_attention`` and ``ulysses_attention`` at
   Llama-2-7B's attention width (32 heads x 128) over a 32,768-token bf16
   sequence on a 4-rank mesh of this one card, through the chunk_attention
   kernel's tensor-core route: 256 query rows against exact f32
   attention, the two paths against each other, the launch counts per
   route, and each path's share in the kernel;
5. asaga -- ASAGA ``run()`` and ``run_sync()`` on the same epsilon
   deployment through the masked_grad kernel's history forms: the
   objective halves, ``alpha_bar`` is the history table's mean, and the
   launch counts (every task and commit on masked_grad's staged route);
6. fused, epsilon -- ``run_fused()`` (chunks of 16 rounds, each one
   CUDA-graph replay): ``fused_graph`` lines (a chunk captured and
   replayed, bit-equal to the same chunk run eagerly from the same state
   and generator states; ASGD and ASAGA), then ASGD (5,000 updates, gamma
   100) and ASAGA (2,000, gamma 0.5) at bench.py's recipe, each gated as
   phases 3 and 5 (and ``alpha_bar`` within the JAX package's fused band),
   each task one staged B1 launch; phase 2's ``b1_graph`` line records B1's
   cooperative launch under capture beside S1's ``s1_graph``;
7. sparse -- the rcv1 deployment (``tools/rcv1.py``: 697,641 x 47,236
   padded ELL, K = 80, generated on the card, 8 workers): its bytes, pad
   width and skew, then ASGD ``run()`` (bench.py's recipe, 1,200 updates)
   and ``run_sync()``, ASAGA ``run()`` and ``run_sync()``, then
   ``fused_graph`` and ``run_fused()`` of both, each held to the JAX
   package's gate and run through kernel S1 (its launches set to 0 just
   before each run and read just after: one fused launch a task, one
   coefficient-form launch an ASAGA table delta, no launch of the earlier
   chain's segment sum, 0 calls of its plain versions);
8. mnist8m -- 8,100,000 x 784 bf16 (12.7 GB) generated on the card, 8
   workers, b = 0.1, gamma 39.2: ``fused_graph``, ASGD ``run_fused()``
   (5,000 updates) and ``run()`` (1,000), each below 1/10 of the objective
   at w = 0, every task one staged B1 launch;
9. features -- every ``run()`` switch (``tools/features.py``): on the
   epsilon deployment generated anew (same seed), ASGD ``run()`` (1,000
   updates, phase 3's settings, worker 0 a straggler at 3x the calibrated
   task time) with every switch off, then the same run with every switch
   on (checkpoints every 250 updates, the event log, CSV and JSONL
   metrics, tracing at 1/16, speculation with copies past 5 ms, dynamic
   allocation), then a ``run()`` to 2,000 that resumes from the
   checkpoint at k = 1,000 and passes phase 3's gate; each sink file's
   bytes, parsed, the event log rendered, the spans per stage, the
   checkpoint's bytes and save time, and updates/s with the switches off
   and on side by side (``features_cost``; nothing is claimed).  Then rcv1
   ASAGA ``run()`` at gamma 50 (600 updates) with checkpoints, a restore
   whose history table and ``alpha_bar`` read back bit-equal to the
   checkpoint's, and a run resumed to 1,200 below the objective at w = 0.
   Every run's launches counted from 0 and read after, every ASGD task
   through B1's staged route;
10. dcn -- the DCN parameter-server plane (``tools/dcn.py``): the wire
   codecs built with g++ (``dcn_natives``), the merge drain bit-equal to
   serial applies on the card (``dcn_merge``), then one PS process and two
   worker processes (``tools/ps_child.py``, 4 logical workers each) on this
   card over loopback and the shm ring, with delta pulls, pipeline depth 2
   (ASAGA: the serial loop) and the native codecs: epsilon ASGD (500
   updates) and ASAGA (2,000, phase 5's budget), rcv1 ASGD (400, bench.py's
   recipe at a third of its budget) and ASAGA (600); then epsilon ASGD
   (300) with the PS and its workers as threads of this process.  Each ``dcn`` line carries updates/s, accepted and
   dropped, max staleness, tasks per accepted update, wire bytes per
   update, pull replies by shape, merge batches, each worker process's
   launches per accepted update, ``python_fallbacks`` and each process's
   peak device memory, and its gates: the budget reached, every push
   counted once, one B1 or S1 launch a worker gradient (with no plain
   call), no Python fallback, the ring used, and the JAX package's
   objective bands (``tools/dcn.py``);
11. telemetry -- the live UI and the telemetry plane
   (``tools/telemetry.py``): epsilon ASGD ``run()`` at phase 3's settings
   (1,000 updates through B1's compacted form) four times, telemetry off,
   on, on, off; "on" starts the process's telemetry from the conf (the
   profiler on, a flight-dump directory, the sampler at 0.25 s), serves
   the live UI on an ephemeral port (``ui_port=0``) and polls
   ``/api/status``, ``/metrics``, ``/api/timeseries`` and ``/`` every 0.5 s.
   Gates: every GET 200, every ``/metrics`` body parsed strictly, the last
   status's ``accepted`` the result's and its staleness histogram summing
   to the merges, ``asgd_worker_step`` compiled once with compiles plus
   dispatches equal to the B1 launches, ``device_bytes_in_use`` grown by
   at least the 3.2 GB of resident shards since before the dataset was
   made, a flight dump after uninstall, and phase
   3's objective gate in all four runs.  Each ``telemetry`` line carries
   updates/s, the ``queue.depth`` series' maximum and its value at every
   100 accepted updates, and the profiler's zone table
   (``telemetry_cost``: updates/s on and off).  Then rcv1 ASGD on the DCN
   plane as in phase 10 (400 updates, one PS process, two worker
   processes) with ``async.convergence.sample=10`` and
   ``async.metrics.port=0`` in all three: phase 10's gates, one
   ``ell_residual`` launch a convergence sample in each worker process,
   the samples counted where taken one every 10th update of each logical
   worker, every sample in the PS's convergence history, its best sampled loss
   below 0.1x and its last below 0.3x the objective at w = 0, and each
   process's ``/metrics`` answered and parsed (``dcn_telemetry``, with
   updates/s and wire bytes per update beside phase 10's rcv1 ASGD line);
12. shards -- sharded PS groups with epoch fencing and shard failover
   (``tools/dcn.py::shards_phase``): phase 10's machine shape (one PS
   process, two worker processes of 4 logical workers each, loopback, the
   shm ring, the native codecs), the PS process holding the primary shard
   and a ``ShardGroup`` whose shard children run on this card, every shard
   fenced (``async.fence.enabled``).  Arms: (a) epsilon ASGD on 2 shards
   (300 updates); (b) rcv1 ASGD on 3 shards (400, bench.py's recipe at a
   third of its budget; each sparse push split by column range); (c)
   epsilon ASGD on 3 shards (300) with per-shard checkpoints every 75
   updates and shard 1 SIGKILLed at 150 accepted.  Gates: phase 10's (the budget, one B1 or S1 launch a
   worker gradient with no plain call, the objective bands), every pull a
   version vector of the map's length, each shard's pushes counted once,
   every shard under an epoch, no fenced reject in (a) and (b); in (c)
   exactly one restart, resumed from its checkpoint, under an epoch above
   the one it died with, and the objective band held against (a)'s
   objective at w = 0 (the group's trajectory is aligned at the tail, and
   the relaunched shard's shorter snapshot stack cuts its head).  Each ``shards`` line carries updates/s (beside
   phase 10's unsharded line of the deployment), tasks and launches per
   accepted update, wire bytes per update, per-shard merges, staleness,
   fenced rejects and each process's peak device memory;
13. standby_control -- the hot standby with replication and promotion,
   the adaptive controller with the damped apply, and SUBSCRIBE
   (``tools/dcn.py::standby_phase``): phase 12's machine shape, every
   shard fenced and backed by a warm standby child (the primary's too),
   the controller on the primary.  First, on the card: the merge drain
   with 8 slots of random damps in (0, 1] bit-equal (``torch.equal``) to 8
   serial ``make_asgd_apply_damped`` calls, and at damp 1.0 to
   ``make_asgd_apply``.  Arms: (a) epsilon ASGD on 3 shards (600
   updates), shard 1's primary SIGKILLed at 300 accepted, a SUBSCRIBE
   reader on shard 2's standby through the run; (b) rcv1 ASGD on 2 shards
   (1,200, bench.py's recipe), worker process 1 a straggler (150 ms on
   each PUSH).  Gates: phase 12's (the budget, one B1 or S1 launch a
   worker gradient with no plain call, the objective bands -- (a)'s
   against phase 12 (a)'s objective at w = 0, its own trajectory being
   aligned at the tail -- a vector of the map's length every pull, each
   shard's pushes counted once), every
   shard backed, each surviving standby's model read by SUBSCRIBE after
   the run bit-equal to its primary's at the same clock, the controller
   ticking with every actuated value inside its declared bounds; in (a)
   exactly one promotion of shard 1 and no relaunch, under an epoch above
   the one it died with, the promoted member's ledger exact.  Each
   ``standby_control`` line carries updates/s (beside phase 12's matching
   arm), tasks per accepted update, wire bytes per update (the reader's
   and the mirror check's frames left out) and the stream's share, each
   shard's staleness at merge, the standby lag, the reader's reply
   shapes and freshness, promotion seconds, the
   controller's changes, clamps, oscillation trips and the damp factors
   applied, and each process's peak device memory;
14. mesh -- the data-parallel plane: B1's full masked form at a DCN mesh
   rank's block (12,500 x 2,000 f32, b = 0.1) and its ``saga_grad`` form
   at ``MiniBatchSGD``'s rank block (100,000 x 2,000 f32) against their
   plain versions; (a) the DCN worker's mesh steps at 4 ranks of this card
   over an epsilon worker shard (50,000 x 2,000 f32, b = 0.1): the ASGD
   step ``torch.equal`` to 4 B1 launches on the row blocks folded in rank
   order (exactly 4 launches, no plain call), the ASAGA step at 5,408 slots
   with ``diff`` ``torch.equal`` to single-device ``saga_slots_grad`` and
   ``g`` within TOL_REL (``mesh_step`` lines); (b) ``MiniBatchSGD`` at
   epsilon's full width (400,000 x 2,000 f32 generated on the card, least
   squares, the simple updater) on 1-rank and 4-rank meshes at b = 0.1,
   each below 1/10 of the objective at w = 0 with one B1 launch a rank an
   iteration, the 4-rank run's CUDA-graph replays bit-equal to its
   iterations run eagerly, and at b = 1.0 the 1-rank, 4-rank and (dp 2,
   md 2) runs agreeing (``minibatch_sgd``, ``minibatch_graph``,
   ``minibatch_agreement``: iterations/s fenced, launches an iteration);
   (c) the DCN plane in phase 10's shape: epsilon ASGD (300 updates)
   without and with a 4-rank mesh in each worker process (``cuda:0``
   repeated: one card gives no speedup, its ranks share it), then ASAGA
   with it (2,000 updates, phase 10's budget for its band, the serial
   loop), each with phase 10's gates and one B1 launch a rank a gradient
   (``dcn_mesh`` lines);
15. entry -- the port's entry points on the card, one ``entry`` line an
   arm: (a) ``cli.main`` in this process runs ``asgd`` (1,000 updates),
   ``asgd-sync`` (300 rounds), ``asgd-fused`` (5,000) and ``asaga``
   (2,000) on ``synthetic x 2000 400000 8`` at phases 3, 5 and 6's recipes
   and bands, every count set to 0 before each call and read after (B1 on
   the staged route, no plain call; the fused run's launches captured a
   round x rounds), and ``sgd-mllib`` at phase 14's recipe with its host
   data cut to 100,000 rows; (b) ``asgd --sparse`` at rcv1's shape
   (697,641 x 47,236, 80 nonzeros a row from ``make_sparse_regression``,
   gamma 2,361.8 / 80, ``async.drain.batch=16``): phase 7's bands through
   S1; (c) ``python -m asyncframework_tpu_torch.cluster 3 -- asgd ...
   --ui-port 0`` (phase 10's recipe, one PS and two worker processes):
   exit 0, the budget accepted, the band, the dashboard's port in the
   summary; (d) a master and a worker daemon on localhost, then a
   ``--master`` submission of a 3-process app (100,000 rows, 500
   updates): ``FINISHED``, every executor's exit 0; (e) a 2,048 x 2,000
   LibSVM file written from a seed, the C++ parse bit-equal to the line
   parser's, then ``asgd`` (gamma 50, ``async.drain.batch=16``) over it
   through the native load, every launch on the tiled route.  The
   subprocess arms' launches are not counted (their counts live in their
   processes);
16. serving -- the read path (``tools/serve.py``), one ``serving`` line an
   arm: (a) ``serve``: phase 10's epsilon ASGD recipe (one PS process, two
   worker processes, 1,000 updates) trains while two ``serving.cli
   replica`` processes on this card subscribe to the PS behind a frontend
   in this process; four client threads send 16-row f32 batches and a
   fifth cycles 1, 3, 17, 64 and 256 rows; replica 1 is SIGKILLed once
   the PS's clock passes half the budget.  It prints QPS, predict latency
   p50 and p99, lag in versions and ms, failovers, errors, each replica's
   STATUS (predicts, device, refresh shapes) and the PS's SUBSCRIBE
   replies by shape; gates: no client error with a failover counted,
   every bucket hit, the survivor serving the PS's final model on the
   card, its predictions on a fixed 256 x 2,000 batch within rtol 1e-5 of
   ``X @ w_final`` in float64 on the host (relative to each row's
   ``|X| @ |w|``), and phase 10's gates on the training run; (b)
   ``serve_sharded``: phase 12's fenced 2-shard epsilon group (300
   updates) and one replica in this process resolving it
   (``ShardedSubscriber``): its predictions against ``X`` times the
   concatenated final shards, its STATUS naming both ranges, phase 12's
   gates; (c) ``relay``: a PS in this process on the card at rcv1's width
   (d = 47,236) and eight relay nodes with sources (fanout 2, 18 versions
   of decaying size) in three arms, direct SUBSCRIBE, the tree raw and
   the tree compressed: the PS's egress bytes a version and the ratio of
   direct to tree; interior node 1 is then stopped and two more versions
   pushed.  Gates: every node bit-equal to the PS's snapshot with its CRC
   at every version, node 1's children re-homed to the root,
   ``relay_offers`` > 0.  The training arms' B1 launches (in the worker
   processes) join the kernel line's count.  No kernel is new here: the
   predict is ``mm_f32``'s f32 ``gemv`` (TF32 off), as the JAX package's
   is XLA's;
17. ml -- the ML library's core (``tools/ml.py``), one ``ml`` line an
   arm, each arm's data generated on the card at a published shape:
   ``LogisticRegression()`` at epsilon's shape at fractions 1.0 and 0.1
   (one B1 logistic full-form launch an iteration, the loss falling, at
   1.0 ``w`` within 1e-3 of a float64 recomputation), ``LinearSVM`` (one
   ``xt_coeff`` launch an iteration, the float64 gate), ``LBFGS`` (20
   iterations, its objective at most the 100 ``GradientDescent``
   iterations', one B1 launch an evaluation), ``PCA(10)`` (the captured
   variance within 1e-4 of a float64 ``eigh``), ``KMeans(k=10)`` at
   mnist8m's shape in f32 (25.4 GB; the cost within 1e-4 of a float64
   recomputation and below the seeded centres', peak device bytes under
   40 GB) and ``ALS`` at MovieLens-1M's shape (held-out RMSE below half
   the global mean's, a half step within 1e-4 of a float64 solve);
18. ml_breadth -- the ML library's breadth (``tools/ml.py``'s
   ``breadth_phase``), one ``ml_breadth`` line an arm, the data generated
   on the card from a fixed seed at published shapes: (a)
   ``pipeline_cv_epsilon``, a 3-fold ``CrossValidator`` over
   ``Pipeline([StandardScaler(), LogisticRegression(reg_param)])`` at
   epsilon's shape split by ``train_test_split`` (one B1 logistic launch
   an iteration in every fit, ``best_score`` its folds' mean, the scaler
   within 1e-5 of float64, the held-out AUC within 1e-4 of a float64
   recomputation, a saved and loaded ``PipelineModel`` predicting bit
   for bit); (b) ``trees_covtype`` at Covertype's shape, ``DecisionTree``
   twice, ``RandomForest`` and one-against-rest ``GradientBoostedTrees``
   twice (the root histogram equal to numpy's ``bincount``, both refits
   identical, accuracy above the majority class's share, the boosting
   loss falling, the card's predictions the host traversal's); (c)
   ``text_20ng``, ``HashingTF(2^16)`` -> ``IDF`` -> ``NaiveBayes`` at 20
   Newsgroups' shape (the counts' total the token count, naive Bayes
   within 1e-5 of float64, accuracy above 1/20); (d) ``gmm_covtype``,
   ``GaussianMixture(k=7)`` on Covertype's continuous columns (the
   log-likelihood never falling, the returned parameters' within 1e-4 of
   ``torch.distributions``' float64 density).  Arm (a)'s B1 launches join the logistic full form's count;
19. dataset_graph -- the dataset layer and the graph library
   (``tools/dataset_graph.py``), one ``dataset_graph`` line an arm, the
   data generated on the card from a fixed seed at published shapes: (a)
   ``async_reduce_epsilon``, the paper's driver loop on the dataset API
   (``barrier(bucket_predicate)`` -> ``map_partitions`` with one B1
   compacted launch a task -> ``async_reduce``, drained and applied under
   tau with ``make_asgd_apply``) at epsilon's shape with phase 3's gamma
   and budget (phase 3's objective gate, one B1 launch a task, every
   accepted staleness within tau; updates/s beside phase 3's ``run()``);
   (b) ``wordcount_text8``, ``reduce_by_key("sum")`` of text8's 17,005,207
   Zipf tokens on the device plane and the host plane (both equal to
   numpy's ``bincount``, the device plane taken for card tensors); (c)
   ``pagerank_livejournal``, ``pagerank`` and ``connected_components`` on
   an R-MAT graph of soc-LiveJournal1's shape (ranks summing to 1 within
   1e-5 and within 1e-4 in L1 of a float64 power iteration, components
   equal to scipy's); (d) ``svdpp_ml1m``, ``svd_plus_plus`` at rank 8 at
   MovieLens-1M's shape (the loss falling, the RMSE below the global
   mean's, a saved and loaded model predicting bit for bit); (e)
   ``dense_graph_16k``, ``triangle_count``, ``label_propagation`` and SCC
   at n = 2^14 without TF32 (each equal to its host check).  Arm (a)'s B1
   launches join the compacted form's count;
20. the ``total`` line (seconds, and each phase's), the
   ``{"kernels": [...]}`` line, the card line again, and last the
   ``{"ok": true, "device": ...}`` line.

Each run line (``fused``, ``engine_run``) carries updates/s, rounds/s,
elapsed (fenced), accepted, rounds, staleness, the objective at w = 0 and
at the end, the update count and time at bench.py's target (0.001 of the
objective at w = 0), graph replays and kernel launches per accepted update
(on the fused path: launches captured a round x rounds), the peak device
memory and the card.

It needs the package beside it and one CUDA device, and builds the kernels
from ``asyncframework_tpu_torch/csrc`` at first use (nvcc).
"""

import gc
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# an H100 SXM (NVIDIA data sheet, full power limit)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12  # f32 FMA rate outside the tensor cores
BF16_TC_FLOPS = 989e12  # bf16 dense tensor-core rate
L2_FLUSH_BYTES = 128 << 20
TIMED_LAUNCHES = 25
TIMED_ATTENTION = 5  # calls of up to ~0.1 s each at the full-width blocks
SLEEP_CYCLES = 2_000_000  # ~1 ms at the H100's clock: longer than any enqueue

# f32: both sides sum 1e3-1e6 products in f32 in different orders;
# bf16: a one-ulp flip of a row coefficient's bf16 rounding (the f32 dot
# differs in its last bits) moves g by 2^-8 of that row's term
TOL_REL = {"float32": 1e-4, "bfloat16": 2e-2}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


# the kernels' names in csrc/, longest first (one may contain another)
KERNEL_FUNCTIONS = ("masked_grad_staged", "masked_grad_partial",
                    "reduce_partials", "chunk_attn_tc_kernel",
                    "chunk_attn_kernel", "ell_residual_kernel",
                    "segment_bounds_kernel", "segment_sum_kernel",
                    "sparse_task_kernel")


def ptxas_lines(report: str):
    """(kernel function, line) for each register and spill line of an
    ``nvcc -Xptxas -v`` report; the function is its source name, with
    "bf16" for a bfloat16 instance."""
    function = None
    for line in report.splitlines():
        if "Compiling entry function" in line:
            mangled = line.split("'")[1]
            function = next((f for f in KERNEL_FUNCTIONS if f in mangled),
                            mangled)
            if "bfloat16" in mangled:
                function += " bf16"
            if function == "sparse_task_kernel":  # the Pos instance
                function += " wide" if "IyE" in mangled else " narrow"
        elif "registers" in line or "spill" in line:
            yield function, line.strip()


def turns_ms(fns, torch, flush, calls: int = TIMED_LAUNCHES):
    """Median device time of one call of each of ``fns`` over ``calls``
    calls each, taken in turns (so that all see the same card state), each
    call timed alone with CUDA events after the L2 was flushed (the main
    path finds its shard cold: 8 shards of 400 MB do not fit a 50 MB L2).
    A sleep kernel queued ahead of each call keeps the device busy while
    the host enqueues it, so the interval holds device work only, not the
    wrapper's Python time."""
    for fn in fns:
        fn()
    times = [[] for _ in fns]
    for _ in range(calls):
        for k, fn in enumerate(fns):
            flush.zero_()
            torch.cuda._sleep(SLEEP_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times[k].append(start.elapsed_time(end))
    return [sorted(t)[len(t) // 2] for t in times]


def median_ms(fn, torch, flush, calls: int = TIMED_LAUNCHES) -> float:
    """``fn``'s median device ms, timed as :func:`turns_ms` does."""
    return turns_ms([fn], torch, flush, calls)[0]


def routed(mg, fn):
    """``fn()``'s result and the route of its one masked_grad launch."""
    before = mg.masked_grad.launches_staged, mg.masked_grad.launches_tiled
    out = fn()
    staged = mg.masked_grad.launches_staged - before[0]
    tiled = mg.masked_grad.launches_tiled - before[1]
    if staged + tiled != 1:
        raise RuntimeError(f"expected one masked_grad launch, got "
                           f"{staged} staged and {tiled} tiled")
    return out, "staged" if staged else "tiled"


def time_routes(rec, kernel, route, other, torch, mg, flush):
    """The kernel's median ms on its route and, where the other route
    takes the shape too (``other``), that route's (pinned), the two timed
    in turns: on the staged route ``tiled_ms`` is the earlier design's
    time; on the tiled route ``staged_ms`` is what moving would give."""
    if not other:
        rec["ms"] = median_ms(kernel, torch, flush)
        return
    pinned = "tiled" if route == "staged" else "staged"

    def pinned_kernel():
        with mg.pinned_route(pinned):
            return kernel()

    rec["ms"], rec[f"{pinned}_ms"] = turns_ms([kernel, pinned_kernel], torch,
                                              flush)


# the route each phase-2 masked_grad case must take (chosen by shape and
# dtype in ops/masked_grad.py::launch_plan)
B1_ROUTES = {
    "a_epsilon_full": "staged", "b_epsilon_idx": "staged",
    "c_mnist8m_idx": "staged", "c_mnist8m_full": "staged",
    "d_ragged_300x100": "tiled", "d_ragged_17x8": "tiled",
    "d_empty_0x8": "tiled", "d_small_132x2000": "staged",
    "e_epsilon_logistic": "staged",
    "saga_epsilon": "staged", "xt_epsilon": "staged",
    "saga_mnist8m_shard": "staged", "xt_mnist8m_shard": "staged",
    "mesh_rank_block": "staged", "saga_minibatch_rank": "staged",
    "f_file_idx_2048x2000": "tiled", "f_file_idx_4096x500": "tiled",
    "logreg_epsilon_full": "staged", "xt_epsilon_full": "staged",
}


def kernel_case(name, n, d, dtype, torch, mg, flush, gen, b,
                cap=None, loss="least_squares"):
    """One phase-2 shape: masked_grad against its plain version."""
    from asyncframework_tpu_torch.ops.steps import compact_mask

    dev = torch.device("cuda", 0)
    X = torch.randn(n, d, device=dev, generator=gen, dtype=dtype)
    X /= math.sqrt(max(d, 1))
    y = torch.randn(n, device=dev, generator=gen)
    w = torch.randn(d, device=dev, generator=gen)
    sel = torch.rand(n, device=dev, generator=gen) < b
    if cap is None:
        weights, idx = sel.float(), None
        rows = n
    else:
        weights, idx = compact_mask(sel, cap)
        rows = int(torch.unique(idx).numel())  # distinct rows this draw reads
    m = n if idx is None else cap
    es = X.element_size()

    def kernel():
        return mg.masked_grad(X, y, w, weights, idx, loss)

    def plain():
        return mg.masked_grad_reference(X, y, w, weights, idx, loss)

    def library():
        Xs, ys = (X, y) if idx is None else (X[idx], y[idx])
        z = (Xs @ w.to(dtype)).float()
        r = (torch.sigmoid(z) if loss == "logistic" else z) - ys
        return (Xs.T @ (weights * r).to(dtype)).float()

    (g1, route), g2 = routed(mg, kernel), kernel()
    ref = plain()
    torch.cuda.synchronize()
    dt = str(dtype).replace("torch.", "")
    ref_inf = float(ref.abs().max()) if d and n else 0.0
    err = float((g1 - ref).abs().max()) if d and n else 0.0
    tol = TOL_REL[dt] * ref_inf
    ok = bool(torch.isfinite(g1).all()) and err <= tol
    bit_equal = bool(torch.equal(g1, g2))
    bytes_moved = (rows * d * es + rows * 4 + m * 4 + d * 8
                   + (m * 8 if idx is not None else 0))
    flop_s = 4.0 * rows * d / F32_FLOPS
    byte_s = bytes_moved / HBM_BYTES_PER_S
    rec = {
        "phase": "kernel", "kernel": "masked_grad", "case": name,
        "n": n, "d": d, "dtype": dt, "loss": loss,
        "form": "full" if idx is None else f"idx cap={cap}",
        "route": route, "rows_read": rows,
        "max_abs_err": err,
        "max_rel_err": err / ref_inf if ref_inf else 0.0,
        "tol_abs": tol, "tol": f"{TOL_REL[dt]} * max|g_plain|",
        "within_tol": ok, "bit_equal": bit_equal,
    }
    other = route == "staged" or (
        mg.staged_geometry(d, es) is not None
        and X.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0)
    time_routes(rec, kernel, route, other, torch, mg, flush)
    rec.update({
        "plain_ms": median_ms(plain, torch, flush),
        "library_ms": median_ms(library, torch, flush),
        "bound_us": max(byte_s, flop_s) * 1e6,
        "bound_by": "bytes" if byte_s >= flop_s else "operations",
    })
    emit(rec)
    if not ok or not bit_equal:
        raise RuntimeError(f"masked_grad disagrees with its plain version: {rec}")
    if route != B1_ROUTES[name]:
        raise RuntimeError(f"{name} took the {route} route, not "
                           f"{B1_ROUTES[name]}")
    if name == "b_epsilon_idx":  # the fused loop captures this launch
        rec["graph"] = graph_case("b1_graph", kernel, g1, torch)
    return rec


def saga_case(name, n, d, dtype, torch, mg, flush, gen, b):
    """One ASAGA form of masked_grad against its plain version: saga_grad
    (``(g, diff)`` over the full shard) or xt_coeff (``X^T c``)."""
    dev = torch.device("cuda", 0)
    X = torch.randn(n, d, device=dev, generator=gen, dtype=dtype)
    X /= math.sqrt(d)
    y = torch.randn(n, device=dev, generator=gen)
    w = torch.randn(d, device=dev, generator=gen)
    alpha = torch.randn(n, device=dev, generator=gen)
    mask = (torch.rand(n, device=dev, generator=gen) < b).float()
    es = X.element_size()
    dt = str(dtype).replace("torch.", "")
    if name.startswith("saga"):
        def kernel():
            return mg.saga_grad(X, y, w, alpha, mask)

        def plain():
            return mg.saga_grad_reference(X, y, w, alpha, mask)

        def library():
            diff = (X @ w.to(dtype)).float() - y
            return (X.T @ (mask * (diff - alpha)).to(dtype)).float(), diff

        # X once; y, alpha, mask, w in; g and diff out
        bytes_moved = n * d * es + 3 * n * 4 + d * 4 + d * 4 + n * 4
        tol_rel = TOL_REL[dt]
    else:
        c = mask * (torch.randn(n, device=dev, generator=gen) - alpha)

        def kernel():
            return (mg.xt_coeff(X, c),)

        def plain():
            return (mg.xt_coeff_reference(X, c),)

        def library():
            return (X.float().T @ c,) if dtype != torch.float32 else (X.T @ c,)

        def library_pair():
            # an SVM iteration's products (ml/gradient.py): the margin, then
            # X^T c
            return (X @ w.to(dtype)).float(), library()[0]

        bytes_moved = n * d * es + n * 4 + d * 4
        tol_rel = TOL_REL["float32"]  # c is not rounded to bf16
    (got, route), again, ref = routed(mg, kernel), kernel(), plain()
    torch.cuda.synchronize()
    errs = [float((a - r).abs().max()) for a, r in zip(got, ref)]
    scales = [float(r.abs().max()) for r in ref]
    ok = all(bool(torch.isfinite(a).all()) for a in got) and all(
        e <= tol_rel * sc for e, sc in zip(errs, scales)
    )
    bit_equal = all(bool(torch.equal(a, b2)) for a, b2 in zip(got, again))
    flop_s = (4.0 if name.startswith("saga") else 2.0) * n * d / F32_FLOPS
    byte_s = bytes_moved / HBM_BYTES_PER_S
    rec = {
        "phase": "kernel", "kernel": "masked_grad",
        "form": "saga_grad" if name.startswith("saga") else "xt_coeff",
        "case": name, "n": n, "d": d, "dtype": dt, "route": route,
        "max_abs_err": errs[0], "max_rel_err": errs[0] / scales[0],
        "diff_max_abs_err": errs[1] if len(errs) > 1 else None,
        "tol": f"{tol_rel} * max|plain| per output",
        "within_tol": ok, "bit_equal": bit_equal,
    }
    other = route == "staged" or mg.staged_geometry(d, es) is not None
    time_routes(rec, kernel, route, other, torch, mg, flush)
    rec.update({
        "plain_ms": median_ms(plain, torch, flush),
        "library_ms": median_ms(library, torch, flush),
        "bound_us": max(byte_s, flop_s) * 1e6,
        "bound_by": "bytes" if byte_s >= flop_s else "operations",
    })
    if not name.startswith("saga"):
        rec["library_pair_ms"] = median_ms(library_pair, torch, flush)
    emit(rec)
    if not ok or not bit_equal:
        raise RuntimeError(f"{rec['form']} disagrees with its plain version: {rec}")
    if route != B1_ROUTES[name]:
        raise RuntimeError(f"{name} took the {route} route, not "
                           f"{B1_ROUTES[name]}")
    return rec


# chunk_attention against its plain version: both sum D products and Tk
# exponentials in f32, in different orders (the kernel also rescales online)
ATT_TOL = {"o": 1e-4, "m": 1e-5, "l": 1e-5}
# an unmasked block this long is also held against float64 on its first
# heads: there the plain version's own rounding is most of the margin
# (ROADMAP C15; tools/probe_chunk_attention.py)
F64_MIN_TK, F64_HEADS = 4_096, 2


def needed_pairs(mask, tq, tk, torch) -> int:
    """(query, key) pairs the block kernel has to compute for ``mask``:
    those it attends, and every key of a row that attends none (that row's
    l counts them all and its o sums every v).  The kernel skips a tile
    that no row needs, so its bound counts these, not Tq * Tk."""
    if mask is None:
        return tq * tk
    per_row = mask.sum(dim=1)
    return int(torch.where(per_row > 0, per_row,
                           torch.full_like(per_row, tk)).sum())


def attention_case(name, B, tq, tk, H, D, dtype, mask_kind, torch, ca, flush,
                   gen):
    """One chunk_attention shape against its plain version, with
    scaled_dot_product_attention (same boolean mask) as a yardstick: in f32
    (the comparison) and in bf16 (another function: bf16 p; printed only as
    what the card's tensor cores reach here).  It computes o / l only, and
    the port never calls it.  bf16 inputs with D % 16 == 0 must take the
    kernel's tensor-core route; their bound is the function's operations
    at the bf16 tensor-core rate (or its bytes), beside the f32-FMA bound
    of the CUDA-core design and the three-pass design's own floor."""
    F = torch.nn.functional
    dev = torch.device("cuda", 0)
    q, k, v = (torch.randn(B, t, H, D, device=dev, generator=gen).to(dtype)
               for t in (tq, tk, tk))
    if mask_kind == "causal":
        mask = torch.ones(tq, tk, dtype=torch.bool, device=dev).tril(tk - tq)
    elif mask_kind == "ulysses_mid":
        # the Ulysses path's mask for its middle K/V block: the rows before
        # the block attend none of it, the rows after attend all of it
        k_pos = (tq // tk // 2) * tk + torch.arange(tk, device=dev)
        mask = torch.arange(tq, device=dev)[:, None] >= k_pos[None, :]
    elif mask_kind == "random":
        mask = torch.rand(tq, tk, device=dev, generator=gen) > 0.3
        mask[tq // 2] = False  # one row with no unmasked key
    else:
        mask = None

    def kernel():
        return ca.chunk_attention(q, k, v, mask)

    def plain():
        return ca.chunk_attention_reference(q, k, v, mask)

    qf, kf, vf = (x.float().transpose(1, 2) for x in (q, k, v))

    def library():
        return F.scaled_dot_product_attention(qf, kf, vf, attn_mask=mask)

    qb, kb, vb = (x.to(torch.bfloat16).transpose(1, 2) for x in (q, k, v))

    def library_bf16():
        return F.scaled_dot_product_attention(qb, kb, vb, attn_mask=mask)

    tc_before = ca.chunk_attention.launches_tc
    got, again = kernel(), kernel()
    tc_launches = ca.chunk_attention.launches_tc - tc_before
    ref = plain()
    torch.cuda.synchronize()
    tensor_core = dtype == torch.bfloat16 and D % 16 == 0
    rec = {"phase": "kernel", "kernel": "chunk_attention", "case": name,
           "B": B, "Tq": tq, "Tk": tk, "H": H, "D": D,
           "dtype": str(dtype).replace("torch.", ""), "mask": mask_kind,
           "route": "tensor_core" if tc_launches else "f32",
           "tc_launches": tc_launches}
    ok = tc_launches == (2 if tensor_core else 0)
    for key, a, r in zip("oml", got, ref):
        err = (a - r).abs()
        rel = float((err / r.abs().clamp(min=1.0)).max())
        rec[f"{key}_max_abs_err"] = float(err.max())
        rec[f"{key}_max_rel_err"] = rel
        rec[f"{key}_tol_rel"] = ATT_TOL[key]
        ok = ok and rel <= ATT_TOL[key] and bool(torch.isfinite(a).all())
    if mask is None and tk >= F64_MIN_TK:
        from asyncframework_tpu_torch.tools import probe_chunk_attention as pca
        o64 = pca.f64_heads(q, k, v, F64_HEADS)[0]
        for who, trip in (("kernel", got), ("plain", ref)):
            rec[f"o_vs_f64_rel_{who}"] = pca.rel(trip[0][:, :, :F64_HEADS],
                                                 o64)
        rec["o_vs_f64_heads"] = F64_HEADS
        ok = ok and rec["o_vs_f64_rel_kernel"] <= ATT_TOL["o"]
        del o64
    if mask_kind == "random":
        # the TPU kernel's padded-Tk count for a row with no unmasked key
        rec["masked_row_l_ok"] = bool((got[2][:, :, tq // 2]
                                       == -(-tk // 8) * 8).all())
        ok = ok and rec["masked_row_l_ok"]
    del ref
    bit_equal = all(bool(torch.equal(a, b)) for a, b in zip(got, again))
    del got, again
    torch.cuda.empty_cache()
    flops = 4.0 * B * H * D * needed_pairs(mask, tq, tk, torch)
    bytes_moved = (sum(x.numel() * x.element_size() for x in (q, k, v))
                   + (0 if mask is None else mask.numel())
                   + B * tq * H * D * 4 + 2 * B * H * tq * 4)
    fma_s, byte_s = flops / F32_FLOPS, bytes_moved / HBM_BYTES_PER_S
    # bf16 q k^T and p v on the tensor cores (989 TFLOP/s); f32 inputs keep
    # the CUDA-core design and its f32-FMA count
    flop_s = flops / BF16_TC_FLOPS if tensor_core else fma_s
    calls = TIMED_ATTENTION if flops > 1e10 else TIMED_LAUNCHES
    rec.update({
        "within_tol": ok, "bit_equal": bit_equal,
        "ms": median_ms(kernel, torch, flush, calls),
        "plain_ms": median_ms(plain, torch, flush, calls),
        "library_ms": median_ms(library, torch, flush, calls),
        "library": "scaled_dot_product_attention, f32, o/l only (yardstick)",
        "library_bf16_ms": median_ms(library_bf16, torch, flush, calls),
        "library_bf16": "scaled_dot_product_attention, bf16 (bf16 p: another "
                        "function; reference only)",
        "bound_ms": max(flop_s, byte_s) * 1e3,
        "bound_by": "operations" if flop_s >= byte_s else "bytes",
        "bound_f32_fma_ms": max(fma_s, byte_s) * 1e3,
        # the tensor-core route runs four passes (q k^T and three p v)
        # where the function needs two
        "design_floor_ms": (2 * max(flop_s, byte_s) * 1e3 if tensor_core
                            else None),
        "flop": flops,
    })
    rec["tflops"] = flops / (rec["ms"] * 1e-3) / 1e12
    rec["bound_share"] = rec["bound_ms"] / rec["ms"]
    rec["faster_than_sdpa_f32"] = rec["ms"] < rec["library_ms"]
    emit(rec)
    # a time under the least the card could take means a wrong bound
    ok = ok and rec["bound_share"] <= 1.0
    del q, k, v, qf, kf, vf, qb, kb, vb, mask
    torch.cuda.empty_cache()
    if not ok or not bit_equal:
        raise RuntimeError(f"chunk_attention disagrees with its plain version: {rec}")
    return rec


def exact_rows(q, k, v, rows, torch):
    """Causal attention of the query ``rows`` over the whole sequence, in
    plain f32 (the inputs widened exactly from bf16)."""
    D = q.shape[-1]
    qr = q[0, rows].float()                              # (R, H, D)
    s = torch.einsum("rhd,khd->hrk", qr, k[0].float()) / math.sqrt(D)
    k_pos = torch.arange(k.shape[1], device=q.device)
    s = s.masked_fill(k_pos[None, None, :] > rows[None, :, None], float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("hrk,khd->rhd", p, v[0].float())  # (R, H, D)


# the long-context geometry: Llama-2-7B's attention (32 heads x 128, every
# head in K and V) over a 32,768-token sequence, on a 4-rank mesh
LONG_T, LONG_H, LONG_D, LONG_RANKS = 32_768, 32, 128, 4
ULYSSES_BLOCK = 512
EXACT_ROWS = 256


def long_context_phase(torch, ca, card, recs):
    """Ring and Ulysses attention at Llama-2-7B's attention width over a
    32,768-token sequence on a 4-rank mesh of this one card.  Every fold
    must take the kernel's tensor-core route.  Each path's share in the
    kernel is priced at phase 2's medians of its fold shapes (``recs``):
    the ring's diagonal folds at (f) causal and its past folds at (f)
    unmasked, Ulysses' folds at (g)."""
    from asyncframework_tpu_torch.parallel import (
        make_mesh,
        ring_attention,
        ulysses_attention,
    )

    dev = torch.device("cuda", 0)
    B, T, H, D, P, BLK = 1, LONG_T, LONG_H, LONG_D, LONG_RANKS, ULYSSES_BLOCK
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    q, k, v = (torch.randn(B, T, H, D, device=dev, generator=gen)
               .to(torch.bfloat16) for _ in range(3))
    mesh = make_mesh(P, axis_names=("sp",), devices=[dev] * P)
    emit({"phase": "long_context_note",
          "note": f"the {P} ranks of the mesh share one card: the ring's "
                  "K/V rotation and Ulysses' all-to-all are same-device "
                  "no-ops, so no copy between cards is measured"})
    tl = T // P
    # the bound counts the pairs each fold's mask needs: the ring's P
    # diagonal blocks (masked) and P(P-1)/2 past blocks (unmasked); Ulysses'
    # T/BLK K/V blocks per rank, whose rows before the block attend none
    ar = torch.arange(tl, device=dev)
    ring_pairs = (P * needed_pairs(ar[:, None] >= ar[None, :], tl, tl, torch)
                  + P * (P - 1) // 2 * tl * tl)
    q_pos = torch.arange(T, device=dev)
    ulysses_pairs = P * sum(
        needed_pairs(q_pos[:, None] >= (i * BLK + torch.arange(BLK, device=dev)),
                     T, BLK, torch)
        for i in range(T // BLK)
    )
    ring_flop = 4.0 * B * H * D * ring_pairs
    ulysses_flop = 4.0 * B * (H // P) * D * ulysses_pairs
    ring_priced_ms = (P * recs["f_ring_block_causal"]["ms"]
                      + P * (P - 1) // 2 * recs["f_ring_block_nomask"]["ms"])
    ca.chunk_attention.launches = 0
    ca.chunk_attention.launches_tc = 0
    outs, paths = {}, {}
    for name, fn, flop, folds, fold_ms in (
        ("ring", lambda: ring_attention(q, k, v, mesh, causal=True,
                                        block_kernel="cuda"),
         ring_flop, P * (P + 1) // 2, ring_priced_ms / (P * (P + 1) // 2)),
        ("ulysses", lambda: ulysses_attention(q, k, v, mesh, causal=True,
                                              block_kernel="cuda",
                                              pallas_block=BLK),
         ulysses_flop, P * (T // BLK), recs["g_ulysses_block_causal"]["ms"]),
    ):
        before = ca.chunk_attention.launches
        before_tc = ca.chunk_attention.launches_tc
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        outs[name] = fn()
        torch.cuda.synchronize()
        secs = time.monotonic() - t0
        launched = ca.chunk_attention.launches - before
        launched_tc = ca.chunk_attention.launches_tc - before_tc
        bound_s = flop / BF16_TC_FLOPS
        paths[name] = {
            "phase": "long_context", "fn": name, "card": card,
            "B": B, "T": T, "H": H, "D": D, "ranks": P, "dtype": "bfloat16",
            "causal": True, "seconds": secs, "launches": launched,
            "launches_tc": launched_tc, "launches_f32": launched - launched_tc,
            "folds_expected": folds, "flop": flop,
            "tflops": flop / secs / 1e12,
            "bound_s": bound_s,
            "bound_share": bound_s / secs,
            "bound_f32_fma_s": flop / F32_FLOPS,
            # the kernel's share of the call, its folds priced at phase 2
            "kernel_priced_s": launched * fold_ms / 1e3,
            "kernel_share": launched * fold_ms / 1e3 / secs,
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
        }
        if launched < folds or launched_tc != launched:
            emit(paths[name])
            raise RuntimeError(f"{name} made {launched} chunk_attention "
                               f"launches ({launched_tc} on the tensor-core "
                               f"route), not all {folds} folds on that route")
    launches = ca.chunk_attention.launches
    launches_tc = ca.chunk_attention.launches_tc
    # 256 rows against exact f32 attention: the first and last row of each
    # rank's chunk, and the rest from a seeded draw
    edges = [p * tl + e for p in range(P) for e in (0, tl - 1)]
    pick = torch.randperm(T, device=dev, generator=gen).tolist()
    rows = sorted(edges + [r for r in pick if r not in edges]
                  [:EXACT_ROWS - len(edges)])
    rows_t = torch.tensor(rows, device=dev)
    exact = exact_rows(q, k, v, rows_t, torch)
    # each output is rounded to bf16 once (2^-9 relative), over f32 sums:
    # rtol 2^-8, with an absolute floor of 1e-4 * max|exact| for outputs
    # near 0; ring against Ulysses: two roundings, rtol 2^-7
    floor = 1e-4 * float(exact.abs().max())
    ok = True
    for name in ("ring", "ulysses"):
        got = outs[name][0, rows_t].float()
        err = (got - exact).abs()
        bad = int((err > 2 ** -8 * exact.abs() + floor).sum())
        paths[name].update({"rows_checked": len(rows),
                           "max_abs_err_vs_exact": float(err.max()),
                           "rows_tol": "2^-8 * |exact| + 1e-4 * max|exact|",
                           "outside_tol": bad,
                           "finite": bool(torch.isfinite(outs[name]).all())})
        emit(paths[name])
        ok = ok and bad == 0 and paths[name]["finite"]
    a, b = outs["ring"].float(), outs["ulysses"].float()
    cross = (a - b).abs()
    cross_bad = int((cross > 2 ** -7 * b.abs() + 1e-4 * float(b.abs().max())).sum())
    emit({"phase": "long_context_agreement", "max_abs_diff": float(cross.max()),
          "tol": "2^-7 * |ulysses| + 1e-4 * max|ulysses|",
          "outside_tol": cross_bad, "chunk_attention_launches": launches,
          "chunk_attention_launches_tc": launches_tc})
    if not ok or cross_bad:
        raise RuntimeError("long-context attention disagrees with exact "
                           "attention or across the two paths")
    del q, k, v, outs, exact, a, b, cross
    torch.cuda.empty_cache()
    return launches, paths


# kernel S1 (ops/sparse_grad.py) at the rcv1 shapes: (name, shard rows, K,
# live entries a row, d, Bernoulli rate or None for the full shard,
# compacted slots, the columns' law: "uniform", "one" (every update in one
# column) or "zipf" (Zipf(1.0) over column rank, ranks shuffled over the
# column ids: a synthetic stand-in for real rcv1's skew))
S1_CASES = [
    ("s_rcv1_task", 87_205, 80, 75, 47_236, 0.05, 4_752, "uniform"),
    ("s_rcv1_shard", 87_205, 80, 75, 47_236, None, None, "uniform"),
    ("s_no_valid", 87_205, 80, 75, 47_236, 0.0, 4_752, "uniform"),
    ("s_d1", 87_205, 80, 75, 1, 0.05, 4_752, "uniform"),
    ("s_one_column", 87_205, 80, 75, 47_236, 0.05, 4_752, "one"),
    ("s_k8", 87_205, 8, 8, 47_236, 0.05, 4_752, "uniform"),
    ("s_rcv1_skewed", 87_205, 80, 75, 47_236, 0.05, 4_752, "zipf"),
]
# the route kernel S1 must take at each shape (chosen on the card from the
# data: local where every top-digit bucket holds at most 4,096 live
# entries, else global)
S1_ROUTES = {
    "s_rcv1_task": "local", "s_rcv1_shard": "global", "s_no_valid": "local",
    "s_d1": "global", "s_one_column": "global", "s_k8": "local",
    "s_rcv1_skewed": "global",
}
# S1 against the same products summed in f64: f32 sums of a few to 4e5
# products.  Neither index_add_ (atomics in a changing order) nor the
# earlier chain (one serial chain a column) is a reference for a column
# longer than L: at d = 1 (325,000 entries in one column) each strays
# 1.0e-5 to 1.3e-5 of max|g| from the f64 sum, the chunked sum 2.4e-7.
S1_TOL = 1e-5


def s1_columns(rows, K, d, law, torch, gen):
    dev = torch.device("cuda", 0)
    if law == "one":
        return torch.full((rows, K), d // 2, device=dev, dtype=torch.int32)
    if law == "zipf":
        rank = torch.arange(1, d + 1, device=dev, dtype=torch.float32)
        draw = torch.multinomial(1.0 / rank, rows * K, replacement=True,
                                 generator=gen)
        ids = torch.randperm(d, device=dev, generator=gen)
        return ids[draw].reshape(rows, K).to(torch.int32)
    return torch.randint(0, d, (rows, K), device=dev, generator=gen,
                         dtype=torch.int32)


def s1_bound(nbytes, flop):
    byte_s, flop_s = nbytes / HBM_BYTES_PER_S, flop / F32_FLOPS
    return (max(byte_s, flop_s) * 1e3,
            "bytes" if byte_s >= flop_s else "operations")


def s1_route(fn, torch, sg):
    """The route S1's launch in ``fn()`` took ("local" or "global")."""
    blocks = torch.cuda.get_device_properties(0).multi_processor_count
    stamps = torch.zeros(blocks, sg.STAMPS, dtype=torch.int64, device="cuda")
    with sg.record_timeline(stamps):
        fn()
    return "local" if int(stamps[0, sg.ROUTE_STAMP]) else "global"


def s1_case(name, rows, K, nnz, d, rate, cap, law, torch, sg, flush, gen):
    """Kernel S1 at one shape.  The fused design (``compacted_grad``: one
    launch, on the route it picks) bit-equal to its plain version on CPU
    copies and across launches, timed in turns with the earlier chain
    (``ell_residual`` with keys, ``torch.sort``, ``segment_sum``), the
    library chain (a gather-and-sum residual, then ``index_add_``) and,
    where it took the local route, itself pinned to the global route; the
    earlier chain still bit-equal to its own plain version on CPU
    copies."""
    from asyncframework_tpu_torch.ops.steps import compact_mask

    dev = torch.device("cuda", 0)
    cols = s1_columns(rows, K, d, law, torch, gen)
    vals = torch.randn(rows, K, device=dev, generator=gen) / math.sqrt(nnz)
    cols[:, nnz:] = 0
    vals[:, nnz:] = 0.0
    y = torch.randn(rows, device=dev, generator=gen)
    w = torch.randn(d, device=dev, generator=gen)
    if rate is None:
        valid = idx = None
        m, rows_read = rows, rows
    else:
        sel = torch.rand(rows, device=dev, generator=gen) < rate
        valid, idx = compact_mask(sel, cap)
        m, rows_read = cap, int(torch.unique(idx).numel())
    cols_l = cols.long()
    flat_cols = (cols_l if idx is None else cols_l[idx]).reshape(-1)
    rows_sel = vals if idx is None else vals[idx] * valid[:, None]
    y_sel = y if idx is None else y[idx] * valid

    def fused():
        return sg.compacted_grad(cols, vals, y, w, idx, valid, d)

    def chain():
        r, keys = sg.ell_residual(cols, vals, y, w, idx, valid, with_keys=True)
        skeys, perm = sg.sort_keys(keys)
        return sg.segment_sum(skeys, perm, vals, r, d, idx, valid), r

    def library():
        r = (rows_sel * w[flat_cols].reshape(m, K)).sum(1) - y_sel
        contrib = (rows_sel * r[:, None]).reshape(-1)
        return torch.zeros(d, device=dev).index_add_(0, flat_cols, contrib), r

    def plain():
        return sg.compacted_grad_plain(cols, vals, y, w, idx, valid, d)

    def fused_global():
        with sg.pinned_plan(route="global"):
            return fused()

    before = sg.compacted_grad.launches
    (g, r), (g2, r2) = fused(), fused()
    launches = sg.compacted_grad.launches - before
    (g_chain, r_chain), (g_chain2, _) = chain(), chain()
    g_lib, _ = library()
    cpu = [None if t is None else t.cpu() for t in (cols, vals, y, w, idx,
                                                    valid)]
    g_cpu, r_cpu = sg.compacted_grad_plain(*cpu, d)
    r_keys, keys = sg.ell_residual(cols, vals, y, w, idx, valid, True)
    skeys, perm = sg.sort_keys(keys)
    live = int((skeys < d).sum())
    counts = torch.unique_consecutive(skeys[skeys < d], return_counts=True)[1]
    largest = int(counts.max()) if live else 0
    chain_cpu = sg.segment_sum_plain(skeys.cpu(), perm.cpu(), cpu[1],
                                     r_keys.cpu(), d, *cpu[4:])
    torch.cuda.synchronize()
    # the rounded products summed in f64 (atomics: the order matters not)
    g64 = torch.zeros(d, device=dev, dtype=torch.float64).index_add_(
        0, flat_cols, (rows_sel * r[:, None]).reshape(-1).double())
    scale = float(g_cpu.abs().max()) if d else 0.0
    lib_err = float((g - g_lib).abs().max()) if d else 0.0
    chain_err = float((g - g_chain).abs().max()) if d else 0.0
    f64_err = float((g.double() - g64).abs().max()) if d else 0.0
    chain_f64_err = float((g_chain.double() - g64).abs().max()) if d else 0.0
    plan = sg.launch_plan(m, K, d)
    route = s1_route(fused, torch, sg)
    g_global, r_global = fused_global()
    timed = [fused, chain, library] + ([fused_global] if route == "local"
                                       else [])
    times = turns_ms(timed, torch, flush)
    contrib = (rows_sel * r[:, None]).reshape(-1)
    rec = {
        "phase": "kernel", "kernel": "sparse_grad.compacted_grad",
        "case": name, "law": law, "rows": rows, "K": K, "nnz_per_row": nnz,
        "d": d, "slots": m, "rows_read": rows_read, "entries": m * K,
        "live_entries": live, "largest_segment": largest,
        "plan": plan._asdict(), "route": route,
        "launches_per_call": launches / 2,
        "bit_equal_plain_cpu": bool(torch.equal(g.cpu(), g_cpu)
                                    and torch.equal(r.cpu(), r_cpu)),
        "bit_equal": bool(torch.equal(g, g2) and torch.equal(r, r2)),
        "residual_equal_chain": bool(torch.equal(r, r_chain)),
        "bit_equal_chain": bool(torch.equal(g, g_chain)),
        "chain_max_rel_err": chain_err / scale if scale else 0.0,
        "f64_max_rel_err": f64_err / scale if scale else 0.0,
        "chain_f64_max_rel_err": chain_f64_err / scale if scale else 0.0,
        "max_abs_err": float((g.cpu() - g_cpu).abs().max()) if d else 0.0,
        "library_max_rel_err": lib_err / scale if scale else 0.0,
        "tol": f"bit-equal to the plain version on the CPU; "
               f"{S1_TOL} * max|g| against the products summed in "
               f"f64; bit-equal to the earlier chain where no column is "
               f"longer than L (index_add_'s distance recorded, not held)",
        "ms": times[0], "chain_ms": times[1], "library_ms": times[2],
        "global_route_ms": times[3] if route == "local" else times[0],
        "global_route_bit_equal": bool(torch.equal(g, g_global)
                                       and torch.equal(r, r_global)),
        "library": "(vals[idx] * w[cols[idx]]).sum(1) - y[idx], then "
                   "index_add_ of the products (atomics)",
        "plain_ms": median_ms(plain, torch, flush),
        "index_add_ms": median_ms(
            lambda: torch.zeros(d, device=dev).index_add_(0, flat_cols,
                                                          contrib),
            torch, flush),
        "chain_bit_equal_plain_cpu": bool(torch.equal(g_chain.cpu(),
                                                      chain_cpu)),
        "chain_bit_equal": bool(torch.equal(g_chain, g_chain2)),
    }
    # rows of cols and vals once, y (and idx, valid) once, w once; r and g
    # out; a multiply-add an entry for r, a multiply and an add a live
    # entry for g
    nbytes = (rows_read * (K * 8 + 4) + (m * 12 if idx is not None else 0)
              + d * 8 + m * 4)
    rec["bound_ms"], rec["bound_by"] = s1_bound(nbytes, 2.0 * m * K + 2.0 * live)
    rec["bound_share"] = rec["bound_ms"] / rec["ms"]
    emit(rec)
    ok = (rec["bit_equal_plain_cpu"] and rec["bit_equal"] and launches == 2
          and route == S1_ROUTES[name] and rec["global_route_bit_equal"]
          and rec["residual_equal_chain"] and rec["chain_bit_equal_plain_cpu"]
          and rec["chain_bit_equal"]
          and f64_err <= S1_TOL * max(scale, 1e-30)
          and (largest > plan.chunk or rec["bit_equal_chain"])
          and bool(torch.isfinite(g).all()))
    if rate == 0.0:
        ok = ok and not r.any() and not g.any()
    if not ok:
        raise RuntimeError(f"sparse_grad disagrees with its plain version: "
                           f"{rec}")
    out = {"task": rec}
    if rate is None:  # the evaluation's launch: the residual alone
        out["residual"] = s1_residual_case(name, cols, vals, y, w, torch, sg,
                                           flush)
    if name == "s_rcv1_task":  # ASAGA's table delta: the coefficient form
        out["grad_sum"] = s1_grad_sum_case(name, cols[idx], rows_sel, r, d,
                                           torch, sg, flush)
        out["graph"] = graph_case("s1_graph", lambda: fused()[0], g, torch)
    return out


def s1_residual_case(name, cols, vals, y, w, torch, sg, flush):
    """``ell_residual`` over a full shard, without keys (the evaluation)."""
    n, K = cols.shape
    d = w.shape[0]
    cols_l = cols.long()
    r, r2 = sg.ell_residual(cols, vals, y, w), sg.ell_residual(cols, vals, y, w)
    r_ref = sg.ell_residual_plain(cols, vals, y, w)
    rec = {
        "phase": "kernel", "kernel": "sparse_grad.ell_residual", "case": name,
        "rows": n, "K": K, "d": d, "with_keys": False,
        "bit_equal_plain": bool(torch.equal(r, r_ref)),
        "bit_equal": bool(torch.equal(r, r2)),
        "max_abs_err": float((r - r_ref).abs().max()),
        "tol": "bit-equal to the plain version (same order of additions)",
        "ms": median_ms(lambda: sg.ell_residual(cols, vals, y, w), torch,
                        flush),
        "plain_ms": median_ms(lambda: sg.ell_residual_plain(cols, vals, y, w),
                              torch, flush),
        "library_ms": median_ms(lambda: (vals * w[cols_l]).sum(1) - y, torch,
                                flush),
        "library": "(vals * w[cols]).sum(1) - y",
    }
    rec["bound_ms"], rec["bound_by"] = s1_bound(
        n * (K * 8 + 4) + d * 4 + n * 4, 2.0 * n * K)
    rec["bound_share"] = rec["bound_ms"] / rec["ms"]
    emit(rec)
    if not (rec["bit_equal_plain"] and rec["bit_equal"]):
        raise RuntimeError(f"ell_residual disagrees with its plain version: "
                           f"{rec}")
    return rec


def s1_grad_sum_case(name, c_sel, v_sel, coeff, d, torch, sg, flush):
    """``grad_sum`` over gathered rows (ASAGA's table delta)."""
    m, K = c_sel.shape
    flat = c_sel.long().reshape(-1)
    contrib = (v_sel * coeff[:, None]).reshape(-1)

    def fused():
        return sg.grad_sum(c_sel, v_sel, coeff, d)

    g, g2 = fused(), fused()
    g_cpu = sg.grad_sum_plain(c_sel.cpu(), v_sel.cpu(), coeff.cpu(), d)
    times = turns_ms([fused, lambda: torch.zeros(
        d, device=c_sel.device).index_add_(0, flat, contrib)], torch, flush)
    live = int((v_sel != 0).sum())
    rec = {
        "phase": "kernel", "kernel": "sparse_grad.grad_sum", "case": name,
        "slots": m, "K": K, "d": d, "live_entries": live,
        "bit_equal_plain_cpu": bool(torch.equal(g.cpu(), g_cpu)),
        "bit_equal": bool(torch.equal(g, g2)),
        "max_abs_err": float((g.cpu() - g_cpu).abs().max()),
        "tol": "bit-equal to the plain version on the CPU",
        "ms": times[0], "library_ms": times[1],
        "library": "index_add_ of the precomputed products (atomics)",
        "plain_ms": median_ms(lambda: sg.grad_sum_plain(c_sel, v_sel, coeff,
                                                        d), torch, flush),
    }
    # the gathered rows, coeff once; g out
    rec["bound_ms"], rec["bound_by"] = s1_bound(m * K * 8 + m * 4 + d * 4,
                                                2.0 * live)
    rec["bound_share"] = rec["bound_ms"] / rec["ms"]
    emit(rec)
    if not (rec["bit_equal_plain_cpu"] and rec["bit_equal"]):
        raise RuntimeError(f"grad_sum disagrees with its plain version: {rec}")
    return rec


def b1_saga_slots_case(name, n, d, cap, b, torch, mg, flush, gen):
    """B1's per-slot ASAGA form (the DCN ASAGA worker's gradient) against
    its plain version at the worker's shape: the PS's Bernoulli(b) draw of
    a shard's rows, compacted to ``cap`` slots (row 0 in the padding), the
    sampled rows' history scalars by slot."""
    from asyncframework_tpu_torch.ops.steps import compact_mask

    dev = torch.device("cuda", 0)
    X = torch.randn(n, d, device=dev, generator=gen) / math.sqrt(d)
    y = torch.randn(n, device=dev, generator=gen)
    w = torch.randn(d, device=dev, generator=gen)
    valid, idx = compact_mask(torch.rand(n, device=dev, generator=gen) < b,
                              cap)
    alpha = torch.randn(cap, device=dev, generator=gen) * valid
    rows = int(torch.unique(idx).numel())

    def kernel():
        return mg.saga_slots_grad(X, y, w, idx, alpha, valid)

    def plain():
        return mg.saga_slots_grad_reference(X, y, w, idx, alpha, valid)

    def library():
        Xs = X[idx]
        diff = (Xs @ w - y[idx]) * valid
        return Xs.T @ ((diff - alpha) * valid), diff

    before = mg.saga_slots_grad.launches
    (got, route), again, ref = routed(mg, kernel), kernel(), plain()
    launches = mg.saga_slots_grad.launches - before
    torch.cuda.synchronize()
    errs = [float((a - r).abs().max()) for a, r in zip(got, ref)]
    scales = [float(r.abs().max()) for r in ref]
    tol_rel = TOL_REL["float32"]
    ok = (all(bool(torch.isfinite(a).all()) for a in got)
          and all(e <= tol_rel * sc for e, sc in zip(errs, scales))
          and not got[1][int(valid.sum()):].any())
    bit_equal = all(bool(torch.equal(a, b2)) for a, b2 in zip(got, again))
    # the distinct rows read once; per slot its index, y, alpha and weight
    # in and diff out; w in, g out
    bytes_moved = rows * d * 4 + cap * (8 + 4 + 4 + 4 + 4) + d * 8
    flop_s = 4.0 * cap * d / F32_FLOPS
    byte_s = bytes_moved / HBM_BYTES_PER_S
    rec = {
        "phase": "kernel", "kernel": "masked_grad", "form": "saga_slots_grad",
        "case": name, "n": n, "d": d, "dtype": "float32", "slots": cap,
        "n_valid": int(valid.sum()), "rows_read": rows, "route": route,
        "launches_per_call": launches / 2,
        "max_abs_err": errs[0], "max_rel_err": errs[0] / scales[0],
        "diff_max_abs_err": errs[1],
        "tol": f"{tol_rel} * max|plain| per output; diff 0 on padding",
        "within_tol": ok, "bit_equal": bit_equal,
        "library": "X[idx], then (Xs @ w - y[idx]) * valid and "
                   "Xs.T @ ((diff - alpha) * valid)",
    }
    time_routes(rec, kernel, route, True, torch, mg, flush)
    rec.update({
        "plain_ms": median_ms(plain, torch, flush),
        "library_ms": median_ms(library, torch, flush),
        "bound_us": max(byte_s, flop_s) * 1e6,
        "bound_by": "bytes" if byte_s >= flop_s else "operations",
    })
    emit(rec)
    if not ok or not bit_equal or launches != 2:
        raise RuntimeError(f"saga_slots_grad disagrees with its plain "
                           f"version: {rec}")
    if route != "staged":
        raise RuntimeError(f"{name} took the {route} route, not staged")
    return rec


def s1_saga_slots_case(name, rows, K, nnz, d, rate, cap, torch, sg, flush,
                       gen):
    """S1's per-slot ASAGA form (the DCN sparse ASAGA worker's gradient)
    at rcv1's task shape: bit-equal to its plain version on CPU copies,
    across launches, and to ``compacted_grad`` with the scalars placed at
    their rows; timed with its plain version and the library chain."""
    from asyncframework_tpu_torch.ops.steps import compact_mask

    dev = torch.device("cuda", 0)
    cols = s1_columns(rows, K, d, "uniform", torch, gen)
    vals = torch.randn(rows, K, device=dev, generator=gen) / math.sqrt(nnz)
    cols[:, nnz:] = 0
    vals[:, nnz:] = 0.0
    y = torch.randn(rows, device=dev, generator=gen)
    w = torch.randn(d, device=dev, generator=gen)
    valid, idx = compact_mask(torch.rand(rows, device=dev, generator=gen)
                              < rate, cap)
    alpha = torch.randn(cap, device=dev, generator=gen) * valid
    rows_read = int(torch.unique(idx).numel())
    flat_cols = cols.long()[idx].reshape(-1)
    rows_sel = vals[idx] * valid[:, None]
    y_sel = y[idx] * valid

    def fused():
        return sg.saga_slots_grad(cols, vals, y, w, idx, valid, alpha)

    def library():
        r = (rows_sel * w[flat_cols].reshape(cap, K)).sum(1) - y_sel
        contrib = (rows_sel * (r - alpha)[:, None]).reshape(-1)
        return torch.zeros(d, device=dev).index_add_(0, flat_cols, contrib), r

    def plain():
        return sg.compacted_grad_plain(cols, vals, y, w, idx, valid, d, alpha,
                                       alpha_slots=True)

    before = sg.saga_slots_grad.launches
    (g, r), (g2, r2) = fused(), fused()
    launches = sg.saga_slots_grad.launches - before
    cpu = [t.cpu() for t in (cols, vals, y, w, idx, valid)]
    g_cpu, r_cpu = sg.compacted_grad_plain(*cpu, d, alpha.cpu(),
                                           alpha_slots=True)
    full = torch.zeros(rows, device=dev)
    full[idx] = alpha
    g_rows, r_rows = sg.compacted_grad(cols, vals, y, w, idx, valid, d, full)
    g_lib, _ = library()
    torch.cuda.synchronize()
    scale = float(g_cpu.abs().max())
    times = turns_ms([fused, library], torch, flush)
    live = int((rows_sel != 0).sum())
    rec = {
        "phase": "kernel", "kernel": "sparse_grad.saga_slots_grad",
        "case": name, "rows": rows, "K": K, "d": d, "slots": cap,
        "rows_read": rows_read, "live_entries": live,
        "route": s1_route(fused, torch, sg),
        "launches_per_call": launches / 2,
        "bit_equal_plain_cpu": bool(torch.equal(g.cpu(), g_cpu)
                                    and torch.equal(r.cpu(), r_cpu)),
        "bit_equal": bool(torch.equal(g, g2) and torch.equal(r, r2)),
        "bit_equal_row_alpha": bool(torch.equal(g, g_rows)
                                    and torch.equal(r, r_rows)),
        "max_abs_err": float((g.cpu() - g_cpu).abs().max()),
        "library_max_rel_err": float((g - g_lib).abs().max()) / scale,
        "tol": "bit-equal to the plain version on the CPU",
        "ms": times[0], "library_ms": times[1],
        "library": "(vals[idx] * w[cols[idx]]).sum(1) - y[idx], then "
                   "index_add_ of the products with r - alpha (atomics)",
        "plain_ms": median_ms(plain, torch, flush),
    }
    # the rows read once, per slot its index, valid, alpha in and r out;
    # w in, g out
    rec["bound_ms"], rec["bound_by"] = s1_bound(
        rows_read * (K * 8 + 4) + cap * 16 + d * 8, 2.0 * cap * K + 2.0 * live)
    rec["bound_share"] = rec["bound_ms"] / rec["ms"]
    emit(rec)
    if not (rec["bit_equal_plain_cpu"] and rec["bit_equal"]
            and rec["bit_equal_row_alpha"] and launches == 2):
        raise RuntimeError(f"sparse saga_slots_grad disagrees with its plain "
                           f"version: {rec}")
    return rec


def graph_case(phase, fn, ref, torch):
    """Whether ``fn()`` (one kernel launch, a cooperative launch on B1's
    staged route and on S1) is captured by a CUDA graph, and whether the
    replay gives ``ref``'s bits: a record only."""
    rec = {"phase": phase}
    try:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()  # the capture stream's scratch, made outside the capture
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            out = fn()
        graph.replay()
        torch.cuda.synchronize()
        rec.update(captures=True, replay_bit_equal=bool(torch.equal(out, ref)))
    except Exception as e:  # a record of what CUDA refuses to capture
        torch.cuda.synchronize()
        rec.update(captures=False, error=f"{type(e).__name__}: {e}"[:300])
    emit(rec)
    return rec


def sparse_phase(torch, card):
    """The rcv1 deployment through kernel S1 (``tools/rcv1.py``)."""
    from asyncframework_tpu_torch.solvers import ASAGA, ASGD
    from asyncframework_tpu_torch.tools import rcv1

    dev = torch.device("cuda", 0)
    t0 = time.monotonic()
    ds = rcv1.dataset(dev)
    torch.cuda.synchronize()
    emit({"phase": "sparse_data", "card": card,
          "generate_s": time.monotonic() - t0, **rcv1.describe(ds)})
    launches = {"compacted_grad": 0, "grad_sum": 0, "ell_residual": 0,
                "segment_sum": 0}
    records = rcv1.phase(ds, dev)
    for rec in records:
        emit({"phase": "sparse", "card": card, **rec})
        for key in launches:
            launches[key] += rec["launches"][key]
    # the fused loop on the same deployment: a chunk's replay against its
    # eager rounds, then ASGD and ASAGA run_fused() at the same recipes
    for solver_cls, iters, gamma in ((ASGD, rcv1.ASGD_UPDATES, rcv1.ASGD_GAMMA),
                                     (ASAGA, rcv1.SAGA_UPDATES,
                                      rcv1.SAGA_GAMMA)):
        fused_graph("rcv1", solver_cls(ds, None, rcv1.config(iters, gamma),
                                       devices=[dev]), card)
    fused = rcv1.fused_phase(ds, dev)
    for rec in fused:
        emit({"phase": "fused", "config": "rcv1", "card": card,
              **{k: v for k, v in rec.items() if k != "trajectory"}})
        # the task launches on the path: captured a round x rounds
        launches["compacted_grad"] += rec["launches_on_path"]["compacted_grad"]
        for key in ("grad_sum", "ell_residual", "segment_sum"):
            launches[key] += rec["launches"][key]
    del ds
    torch.cuda.empty_cache()
    failed = [f"{r['solver']}.{r['mode']}" for r in records + fused
              if not r["ok"]]
    if failed:
        raise RuntimeError(f"sparse phase gates failed: {failed}")
    return launches


# ASAGA step size: 0.5, the largest of {0.5, 0.2, 0.1, 0.05, 0.02} for which
# the JAX package's ASAGA.run_sync halves the objective, over the 1,500
# rounds run here, on a 16,000 x 2,000 draw of the same generator on the CPU
# (tests/test_torch_asaga.py::test_smoke_step_size_halves_in_jax)
SAGA_GAMMA = 0.5
SAGA_ROUNDS = 1_500
SAGA_UPDATES = 2_000


def asaga_phase(ds, torch, np, mg, card):
    """ASAGA run() and run_sync() on the full-size epsilon deployment."""
    from asyncframework_tpu_torch.solvers import ASAGA, SolverConfig

    dev = torch.device("cuda", 0)
    cfg = dict(num_workers=8, gamma=SAGA_GAMMA, taw=2**31 - 1,
               batch_rate=0.1, bucket_ratio=0.7, printer_freq=100, seed=42)
    mg.masked_grad.launches = 0
    mg.masked_grad.launches_staged = 0
    mg.masked_grad.launches_tiled = 0
    mg.saga_grad.launches = 0
    mg.xt_coeff.launches = 0
    solver = ASAGA(ds, None, SolverConfig(num_iterations=SAGA_UPDATES, **cfg),
                   devices=[dev])
    res = solver.run()
    tasks_async = sum(m.succeeded for m in solver.scheduler.pool.all_metrics())
    sync_solver = ASAGA(ds, None, SolverConfig(num_iterations=SAGA_ROUNDS, **cfg),
                        devices=[dev])
    res_sync = sync_solver.run_sync()
    tasks_sync = sum(m.succeeded
                     for m in sync_solver.scheduler.pool.all_metrics())
    launches = {"masked_grad": mg.masked_grad.launches,
                "saga_grad": mg.saga_grad.launches,
                "xt_coeff": mg.xt_coeff.launches,
                "masked_grad_staged": mg.masked_grad.launches_staged,
                "masked_grad_tiled": mg.masked_grad.launches_tiled}
    for mode, r in (("run", res), ("run_sync", res_sync)):
        obj0, obj1 = r.trajectory[0][1], r.final_objective
        rec = {
            "phase": "asaga", "mode": mode, "n": ds.n, "d": ds.d,
            "workers": 8, "dtype": "float32", "gamma": SAGA_GAMMA,
            "card": card, "accepted": r.accepted, "dropped": r.dropped,
            "rounds": r.rounds, "max_staleness": r.max_staleness,
            "updates_per_sec": r.updates_per_sec, "elapsed_s": r.elapsed_s,
            "objective_at_w0": obj0, "final_objective": obj1,
            "finite": bool(np.isfinite(r.final_w).all()),
        }
        emit(rec)
        if not (rec["finite"] and obj1 < obj0 / 2):
            raise RuntimeError(f"ASAGA {mode} did not halve the objective: {rec}")
    if res.accepted != SAGA_UPDATES or res_sync.rounds != SAGA_ROUNDS:
        raise RuntimeError("ASAGA stopped short of its iteration budget")
    # alpha_bar against the history table's mean, (1/N) sum_s X_s^T alpha_s
    # (after the counts were read: these launches are checks, not the path)
    expected = torch.zeros(ds.d, device=dev)
    for wid, a in res.extras["alpha"].items():
        expected += mg.xt_coeff(ds.shard(wid).X, torch.tensor(a, device=dev))
    expected = (expected / ds.n).cpu().numpy()
    ab = res.extras["alpha_bar"]
    # the JAX test's rtol = 1e-3; the absolute floor is 1e-3 of the
    # largest entry (alpha_bar is ~1e-3 here, so an absolute 1e-4 floor
    # would check next to nothing)
    ab_err = float(np.abs(ab - expected).max())
    ab_ok = bool(np.all(np.abs(ab - expected)
                        <= 1e-3 * np.abs(expected) + 1e-3 * np.abs(expected).max()))
    emit({"phase": "asaga_invariant", "alpha_bar_max_abs_err": ab_err,
          "alpha_bar_max": float(np.abs(expected).max()),
          "tol": "1e-3 * |mean| + 1e-3 * max|mean|", "ok": ab_ok})
    # both forms take the staged route at this shard
    need = {"saga_grad": tasks_async + tasks_sync, "xt_coeff": res.accepted,
            "masked_grad": tasks_async + tasks_sync + res.accepted,
            "masked_grad_staged": tasks_async + tasks_sync + res.accepted}
    emit({"phase": "launches", "path": "asaga", **launches,
          "tasks_run": tasks_async + tasks_sync, "accepted_async": res.accepted})
    if not ab_ok:
        raise RuntimeError("ASAGA alpha_bar is not the history table's mean")
    if any(launches[key] < need[key] for key in need):
        raise RuntimeError(f"ASAGA did not run every task and commit through "
                           f"the masked_grad kernel: {launches} < {need}")
    return launches


# the fused loop at bench.py's recipes (bench.py:94-113, 419-431): 8
# workers, taw 2^31-1, bucket ratio 0.7, a snapshot every 25 updates, seed
# 42; ASAGA (not in bench.py) at phase 5's step size.  A chunk graph holds
# 16 rounds (solvers/base.py::run_fused_plan).
EPS_FUSED_UPDATES, EPS_SAGA_FUSED_UPDATES = 5_000, 2_000
MNIST8M_N, MNIST8M_D, MNIST8M_GAMMA = 8_100_000, 784, 39.2
MNIST8M_FUSED_UPDATES, MNIST8M_RUN_UPDATES = 5_000, 1_000
# alpha_bar against the history table's mean: the JAX package's fused band
# (tests/test_fused.py:139)
FUSED_SAGA_RTOL, FUSED_SAGA_ATOL = 2e-3, 2e-5


def bench_config(SolverConfig, iters, gamma, batch_rate=0.1):
    return SolverConfig(num_workers=8, num_iterations=iters, gamma=gamma,
                        taw=2**31 - 1, batch_rate=batch_rate, bucket_ratio=0.7,
                        printer_freq=25, coeff=0.0, seed=42,
                        calibration_iters=100)


def fused_graph(config, solver, card):
    """One 16-round chunk of ``solver``'s fused loop captured as a CUDA
    graph and replayed, bit-equal to the same chunk run eagerly from the
    same state and generator states (``tools/runs.py::graph_check``); the
    launches the warm-up and the capture counted, by route."""
    from asyncframework_tpu_torch.tools import runs

    rec = {"phase": "fused_graph", "config": config,
           "solver": type(solver).__name__, "card": card,
           **runs.graph_check(solver)}
    emit(rec)
    if not rec["ok"]:
        raise RuntimeError(f"{config} fused chunk: the replay is not the "
                           f"eager rounds: {rec}")
    return rec


def through(rec, *forms) -> bool:
    """Every accepted update of the run was one launch of each of
    ``forms`` (on the fused path: captured once a round, replayed)."""
    return all(rec["launches_on_path"][f] == rec["accepted"] > 0
               for f in forms)


def gated_run(config, solver_cls, mode, ds, cfg, torch, card, gates):
    """One run through ``tools/runs.py::run_one`` (every count set to 0
    just before it, read just after), its line, and its gates (``gates(rec,
    res)``: name -> passed); a gate that fails raises."""
    from asyncframework_tpu_torch.tools import runs

    res, rec = runs.run_one(solver_cls, mode, ds, cfg,
                            torch.device("cuda", 0))
    rec["gates"] = gates(rec, res)
    rec["ok"] = all(rec["gates"].values())
    line = {k: v for k, v in rec.items() if k != "trajectory"}
    emit({"phase": "fused" if mode == "run_fused" else f"engine_{mode}",
          "config": config, "card": card, **line})
    if not rec["ok"]:
        raise RuntimeError(f"{config} {solver_cls.__name__}.{mode} failed "
                           f"its gates: {rec['gates']}")
    return res, rec


def fused_epsilon_phase(ds, torch, np, mg, card):
    """``run_fused`` on the epsilon deployment: a chunk's replay against
    its eager rounds (ASGD and ASAGA), then ASGD (5,000 updates) and ASAGA
    (2,000), each gated: below 1/10 (ASGD) or 1/2 (ASAGA) of the objective
    at w = 0, every task one staged B1 launch, ASAGA's ``alpha_bar`` the
    history table's mean."""
    from asyncframework_tpu_torch.solvers import ASAGA, ASGD, SolverConfig

    dev = torch.device("cuda", 0)
    asgd_cfg = bench_config(SolverConfig, EPS_FUSED_UPDATES, 100.0)
    saga_cfg = bench_config(SolverConfig, EPS_SAGA_FUSED_UPDATES, SAGA_GAMMA)
    fused_graph("epsilon", ASGD(ds, None, asgd_cfg, devices=[dev]), card)
    fused_graph("epsilon", ASAGA(ds, None, saga_cfg, devices=[dev]), card)

    def asgd_gates(rec, res):
        return {"finite": rec["finite"],
                "below_0.1x": rec["final_objective"]
                < rec["objective_at_w0"] / 10,
                "through_b1_staged": through(rec, "masked_grad",
                                             "masked_grad_staged")}

    def saga_gates(rec, res):
        # (1/N) sum_s X_s^T alpha_s (after the counts were read)
        expected = torch.zeros(ds.d, device=dev)
        for wid, a in res.extras["alpha"].items():
            expected += mg.xt_coeff(ds.shard(wid).X,
                                    torch.tensor(a, device=dev))
        expected = (expected / ds.n).cpu().numpy()
        err = np.abs(res.extras["alpha_bar"] - expected)
        rec.update(alpha_bar_max_abs_err=float(err.max()),
                   alpha_bar_max=float(np.abs(expected).max()),
                   invariant_tol=f"{FUSED_SAGA_RTOL} * |mean| + "
                                 f"{FUSED_SAGA_ATOL}")
        return {"finite": rec["finite"],
                "below_0.5x": rec["final_objective"]
                < rec["objective_at_w0"] / 2,
                "alpha_bar_is_table_mean": bool(np.all(
                    err <= FUSED_SAGA_RTOL * np.abs(expected)
                    + FUSED_SAGA_ATOL)),
                "through_b1_staged": through(rec, "saga_grad",
                                             "masked_grad_staged")}

    _, asgd = gated_run("epsilon", ASGD, "run_fused", ds, asgd_cfg, torch,
                        card, asgd_gates)
    _, saga = gated_run("epsilon", ASAGA, "run_fused", ds, saga_cfg, torch,
                        card, saga_gates)
    return asgd, saga


def mnist8m_phase(torch, card):
    """The mnist8m deployment end to end (``bench.py:99-103``: 8,100,000 x
    784 bf16 generated on the card, seed 7, noise 0.01, 8 workers, gamma
    39.2, b = 0.1): a chunk's replay against its eager rounds, then ASGD
    ``run_fused()`` (5,000 updates) and ``run()`` (1,000), each below 1/10
    of the objective at w = 0 and every task one staged B1 launch."""
    from asyncframework_tpu_torch.data.sharded import ShardedDataset
    from asyncframework_tpu_torch.solvers import ASGD, SolverConfig
    from asyncframework_tpu_torch.utils.hbm import dataset_residency_bytes

    dev = torch.device("cuda", 0)
    t0 = time.monotonic()
    ds = ShardedDataset.generate_on_device(
        MNIST8M_N, MNIST8M_D, 8, [dev], seed=7, noise=0.01,
        dtype=torch.bfloat16)
    torch.cuda.synchronize()
    emit({"phase": "mnist8m_data", "card": card, "n": ds.n, "d": ds.d,
          "dtype": "bfloat16", "workers": 8,
          "bytes": sum(dataset_residency_bytes(ds).values()),
          "generate_s": time.monotonic() - t0})
    fused_cfg = bench_config(SolverConfig, MNIST8M_FUSED_UPDATES,
                             MNIST8M_GAMMA)
    run_cfg = bench_config(SolverConfig, MNIST8M_RUN_UPDATES, MNIST8M_GAMMA)
    fused_graph("mnist8m", ASGD(ds, None, fused_cfg, devices=[dev]), card)

    def gates(rec, res):
        return {"finite": rec["finite"],
                "below_0.1x": rec["final_objective"]
                < rec["objective_at_w0"] / 10,
                "budget": res.accepted == rec["budget"],
                "through_b1_staged": rec["launches_on_path"]["masked_grad"]
                >= rec["tasks_run"] > 0
                and rec["launches_on_path"]["masked_grad_staged"]
                == rec["launches_on_path"]["masked_grad"]}

    _, fused = gated_run("mnist8m", ASGD, "run_fused", ds, fused_cfg, torch,
                         card, gates)
    _, engine = gated_run("mnist8m", ASGD, "run", ds, run_cfg, torch, card,
                          gates)
    del ds
    torch.cuda.empty_cache()
    return fused, engine


# the features phase (tools/features.py): epsilon ASGD at phase 3's
# settings with stragglers (worker 0 sleeps FEAT_COEFF x the calibrated
# task time after 100 updates) so the speculation monitor, launching a copy
# of a task past FEAT_SPEC_MIN_MS, has work; rcv1 ASAGA at its step size
FEAT_UPDATES, FEAT_COEFF, FEAT_SPEC_MIN_MS = 1_000, 3.0, 5.0
FEAT_SAGA_UPDATES = 600


def features_phase(torch, card):
    """Every ``run()`` switch on the card: epsilon ASGD off, on, resumed;
    rcv1 ASAGA checkpointed, restored, resumed (``tools/features.py``).
    Returns the kernel launches of all its runs, each counted from 0."""
    import tempfile

    from asyncframework_tpu_torch.data.sharded import ShardedDataset
    from asyncframework_tpu_torch.tools import features, rcv1

    dev = torch.device("cuda", 0)
    launches = {}
    ds = ShardedDataset.generate_on_device(400_000, 2_000, 8, [dev], seed=7,
                                           noise=0.01)
    base = dict(num_workers=8, gamma=100.0, taw=2**31 - 1, batch_rate=0.1,
                bucket_ratio=0.7, printer_freq=25, seed=42,
                calibration_iters=100)
    with tempfile.TemporaryDirectory() as tmp:
        recs = features.asgd_features(ds, dev, base, FEAT_UPDATES, tmp,
                                      FEAT_COEFF, FEAT_SPEC_MIN_MS)
    for rec in recs:
        emit({"phase": "features", "config": "epsilon", "card": card, **rec})
        features.add_launches(launches, rec)
    by = {rec["switches"]: rec for rec in recs}
    emit({"phase": "features_cost", "config": "epsilon", "card": card,
          "updates_per_sec_off": by["off"]["updates_per_sec"],
          "updates_per_sec_on": by["on"]["updates_per_sec"],
          "updates_per_sec_resumed": by["resumed"]["updates_per_sec"],
          "checkpoint_saves": by["on"]["extras"]["checkpoint_saves"],
          "checkpoint_save_ms": by["on"]["extras"]["checkpoint_save_ms"],
          "checkpoint_bytes": by["on"]["checkpoint_bytes"]})
    del ds
    torch.cuda.empty_cache()
    sds = rcv1.dataset(dev)
    sbase = dict(num_workers=rcv1.WORKERS, gamma=rcv1.SAGA_GAMMA,
                 taw=2**31 - 1, batch_rate=rcv1.BATCH_RATE, bucket_ratio=0.7,
                 printer_freq=rcv1.PRINTER_FREQ, seed=42,
                 calibration_iters=100)
    with tempfile.TemporaryDirectory() as tmp:
        srecs = features.asaga_resume(sds, dev, sbase, FEAT_SAGA_UPDATES, tmp)
    for rec in srecs:
        emit({"phase": "features", "config": "rcv1", "card": card, **rec})
        features.add_launches(launches, rec)
    del sds
    torch.cuda.empty_cache()
    failed = [(r.get("switches") or r.get("step"), r["gates"])
              for r in recs + srecs if not r["ok"]]
    if failed:
        raise RuntimeError(f"features phase gates failed: {failed}")
    return launches


# the DCN arms' update budgets here, cut from tools/dcn.py's to make room
# for phase 15 (PERF.md lists each cut).  Undamped ASGD reaches ~1e-4x of
# its objective at w = 0 within 500 updates on either deployment, so its
# arms run 300-400 (phase 10's epsilon 1,000 -> 500 and rcv1 1,200 -> 400,
# its threads arm 1,000 -> 300; phase 11's DCN run 1,200 -> 400; phase
# 12's (a) 1,000 -> 300, (b) 1,200 -> 400, (c) 1,000 -> 300 with its kill
# at 500 -> 150 and checkpoints every 250 -> 75; phase 14's mesh off and
# on arms 1,000 -> 300).  ASAGA's 1/2 band needs its 2,000 updates, and
# phase 13's damped arms theirs: (a) 1,000 -> 600 (kill at 500 -> 300;
# 0.031x at 800 against 0.1x), (b) keeps 1,200 (its best was 0.065x at
# 1,200 against 0.1x).
DCN_RUNS = (("epsilon", "asgd", 500), ("epsilon", "asaga", 2_000),
            ("rcv1", "asgd", 400), ("rcv1", "asaga", 600))
DCN_THREADS_UPDATES = 300
SHARD_ARMS = (("a", "epsilon", 300, 2, None, 0),
              ("b", "rcv1", 400, 3, None, 0),
              ("c", "epsilon", 300, 3, (1, 150), 75))
STANDBY_ARMS = (("a", "epsilon", 600, 3, (1, 300), (0, 0), True),
                ("b", "rcv1", 1_200, 2, None, (0, 150), False))
MESH_DCN_ARMS = (("off", "epsilon", "asgd", 300, 0),
                 ("on", "epsilon", "asgd", 300, 4),
                 ("asaga_on", "epsilon", "asaga", 2_000, 4))


def dcn_phase(torch, card):
    """The DCN parameter-server plane (``tools/dcn.py``): the wire codecs
    built with g++, the merge drain against serial applies on the card,
    then each multi-process run (one PS process, two worker processes) at
    full size and the in-process epsilon ASGD run, each held to its gates;
    returns the worker processes' kernel launches by form."""
    from asyncframework_tpu_torch.ops import steps
    from asyncframework_tpu_torch.tools import dcn

    dev = torch.device("cuda", 0)
    t0 = time.monotonic()
    libs = dcn.build_natives()
    emit({"phase": "dcn_natives", "card": card, "libraries": libs,
          "build_s": time.monotonic() - t0})
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    G = torch.randn(8, 2_000, device=dev, generator=gen)
    w0 = torch.randn(2_000, device=dev, generator=gen)
    mask = torch.ones(8, device=dev)
    one = torch.ones(1, device=dev)
    merge_equal = {}
    for algo, merge, s0 in (
            ("asgd", steps.make_asgd_apply_merge(100.0, 0.1, 400_000, 8),
             torch.tensor(7.0, device=dev)),
            ("asaga", steps.make_saga_apply_merge(0.5, 0.1, 400_000, 8),
             torch.randn(2_000, device=dev, generator=gen) * 1e-3)):
        args = (lambda w, s, g, m: (w, g, m, s)) if algo == "asgd" else (
            lambda w, s, g, m: (w, s, g, m))
        w_m, s_m = merge(*args(w0, s0, G, mask))
        w_s, s_s = w0, s0
        for j in range(8):
            w_s, s_s = merge(*args(w_s, s_s, G[j:j + 1], one))
        merge_equal[algo] = bool(torch.equal(w_m, w_s)
                                 and torch.equal(s_m, s_s))
    emit({"phase": "dcn_merge", "card": card, "slots": 8, "d": 2_000,
          "bit_equal_to_serial": merge_equal})
    if not all(merge_equal.values()):
        raise RuntimeError(f"the merge drain is not m serial applies: "
                           f"{merge_equal}")
    launches = {"masked_grad": 0, "saga_slots_grad": 0, "compacted_grad": 0,
                "sparse_saga_slots_grad": 0, "ell_residual": 0}
    records = dcn.phase(dev, DCN_RUNS, DCN_THREADS_UPDATES)
    for rec in records:
        emit({"phase": "dcn", "card": card, **rec})
        for w in rec["worker_launches"]:
            launches[rec["task_form"]] += w.get(rec["task_form"], 0)
            launches["ell_residual"] += w.get("ell_residual", 0)
    failed = [f"{r['config']}.{r['algo']}.{r['mode']}: "
              f"{[k for k, v in r['gates'].items() if not v]}"
              for r in records if not r["ok"]]
    if failed:
        raise RuntimeError(f"dcn phase gates failed: {failed}")
    torch.cuda.empty_cache()
    return launches, records


# the telemetry phase: phase 3's epsilon recipe and budget; rcv1 ASGD on
# the DCN plane at phase 10's budget (cut 1,200 -> 400 with it), a
# convergence sample every 10th update of each logical worker
TELEMETRY_UPDATES = 1_000
TELEMETRY_DCN_UPDATES = 400
TELEMETRY_CONV_SAMPLE = 10


def telemetry_phase(torch, card, dcn_records):
    """The live UI and the telemetry plane (``tools/telemetry.py``): epsilon
    ASGD ``run()`` with telemetry off, on, on, off, then rcv1 ASGD on the
    DCN plane with convergence samples and an endpoint in every process,
    each held to its gates; returns the kernel launches of its runs."""
    import tempfile

    from asyncframework_tpu_torch.data.sharded import ShardedDataset
    from asyncframework_tpu_torch.tools import telemetry

    dev = torch.device("cuda", 0)
    launches = {"masked_grad": 0, "compacted_grad": 0, "ell_residual": 0}
    # the allocator's reading is process-wide: the shards must show as
    # growth over what the earlier phases left
    gc.collect()
    bytes_before = telemetry.device_bytes_in_use()
    ds = ShardedDataset.generate_on_device(400_000, 2_000, 8, [dev], seed=7,
                                           noise=0.01)
    base = dict(num_workers=8, gamma=100.0, taw=2**31 - 1, batch_rate=0.1,
                bucket_ratio=0.7, printer_freq=25, seed=42)
    with tempfile.TemporaryDirectory() as tmp:
        recs = telemetry.asgd_telemetry(ds, dev, base, TELEMETRY_UPDATES, tmp,
                                        bytes_before)
    for rec in recs:
        launches["masked_grad"] += rec["launches"]["masked_grad"]
        emit({"phase": "telemetry", "config": "epsilon", "card": card,
              **{k: v for k, v in rec.items() if k != "launches"},
              "launches": {k: v for k, v in rec["launches"].items() if v}})
    on = [r["updates_per_sec"] for r in recs if r["telemetry"] == "on"]
    off = [r["updates_per_sec"] for r in recs if r["telemetry"] == "off"]
    emit({"phase": "telemetry_cost", "config": "epsilon", "card": card,
          "updates_per_sec_off": off, "updates_per_sec_on": on,
          "on_over_off": sum(on) / sum(off)})
    del ds
    torch.cuda.empty_cache()
    rec = telemetry.dcn_telemetry("rcv1", "asgd", TELEMETRY_DCN_UPDATES,
                                  TELEMETRY_CONV_SAMPLE)
    plain = next(r for r in dcn_records if r["config"] == "rcv1"
                 and r["algo"] == "asgd" and r["mode"] == "processes")
    for w in rec["worker_launches"]:
        launches["compacted_grad"] += w.get("compacted_grad", 0)
        launches["ell_residual"] += w.get("ell_residual", 0)
    emit({"phase": "dcn_telemetry", "card": card, **rec,
          "updates_per_sec_sampling_off": plain["updates_per_sec"],
          "wire_bytes_per_update_sampling_off":
              plain["wire_bytes_per_update"]})
    failed = [f"epsilon.{r['telemetry']}.{r['order']}: "
              f"{[k for k, v in r['gates'].items() if not v]}"
              for r in recs if not r["ok"]]
    if not rec["ok"]:
        failed.append(f"rcv1.dcn: "
                      f"{[k for k, v in rec['gates'].items() if not v]}")
    if failed:
        raise RuntimeError(f"telemetry phase gates failed: {failed}")
    torch.cuda.empty_cache()
    return launches


def shards_phase(card, dcn_records):
    """Sharded PS groups with fencing and shard failover
    (``tools/dcn.py::shards_phase``): each arm held to its gates; returns
    the worker processes' kernel launches by form and the arms' records."""
    from asyncframework_tpu_torch.tools import dcn

    launches = {"masked_grad": 0, "compacted_grad": 0}
    records = dcn.shards_phase(SHARD_ARMS)
    for rec in records:
        plain = next(r for r in dcn_records if r["config"] == rec["config"]
                     and r["algo"] == "asgd" and r["mode"] == "processes")
        emit({"phase": "shards", "card": card, **rec,
              "updates_per_sec_unsharded": plain["updates_per_sec"],
              "wire_bytes_per_update_unsharded":
                  plain["wire_bytes_per_update"]})
        for w in rec["worker_launches"]:
            launches[rec["task_form"]] += w.get(rec["task_form"], 0)
    failed = [f"{r['arm']}.{r['config']}: "
              f"{[k for k, v in r['gates'].items() if not v]}"
              for r in records if not r["ok"]]
    if failed:
        raise RuntimeError(f"shards phase gates failed: {failed}")
    return launches, records


# phase 13's damped-merge check: slots, and the widths (epsilon, rcv1)
DAMP_SLOTS = 8
DAMP_WIDTHS = (2_000, 47_236)


def damped_merge_check(torch, card):
    """The damped merge drain against serial damped applies on the card:
    ``make_asgd_apply_merge`` with :data:`DAMP_SLOTS` slots of random
    damps in (0, 1] bit-equal to that many ``make_asgd_apply_damped``
    calls, and at damp 1.0 to ``make_asgd_apply``."""
    from asyncframework_tpu_torch.ops import steps

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(13)
    out = []
    for d in DAMP_WIDTHS:
        G = torch.randn(DAMP_SLOTS, d, device=dev, generator=gen)
        w0 = torch.randn(d, device=dev, generator=gen)
        # (0, 1]: 1 - U[0, 1)
        damps = 1.0 - torch.rand(DAMP_SLOTS, device=dev, generator=gen)
        k0 = torch.tensor(37.0, device=dev)
        merge = steps.make_asgd_apply_merge(100.0, 0.1, 400_000, 8)
        damped = steps.make_asgd_apply_damped(100.0, 0.1, 400_000, 8)
        plain = steps.make_asgd_apply(100.0, 0.1, 400_000, 8)
        w_m, k_m = merge(w0, G, damps, k0)
        w_s, k_s = w0, k0
        for j in range(DAMP_SLOTS):
            w_s, k_s = damped(w_s, G[j], k_s, damps[j].item())
        ones = torch.ones(DAMP_SLOTS, device=dev)
        w_1, _ = merge(w0, G, ones, k0)
        w_p, k_p = w0, k0.clone()
        for j in range(DAMP_SLOTS):
            w_p, k_p = plain(w_p, G[j], k_p)
        out.append({
            "d": d, "slots": DAMP_SLOTS,
            "damps": [round(float(x), 6) for x in damps],
            "merge_equal_serial_damped": bool(
                torch.equal(w_m, w_s) and torch.equal(k_m, k_s)),
            "damp_one_equal_apply": bool(torch.equal(w_1, w_p)),
        })
    emit({"phase": "damped_merge", "card": card, "cases": out})
    bad = [c for c in out if not (c["merge_equal_serial_damped"]
                                  and c["damp_one_equal_apply"])]
    if bad:
        raise RuntimeError(f"the damped merge is not serial damped "
                           f"applies: {bad}")


def standby_control_phase(card, shard_records):
    """The hot standby, the adaptive controller and SUBSCRIBE
    (``tools/dcn.py::standby_phase``): each arm held to its gates, beside
    phase 12's matching arm; returns the worker processes' kernel
    launches by form."""
    from asyncframework_tpu_torch.tools import dcn

    launches = {"masked_grad": 0, "compacted_grad": 0}
    # phase 12's arm of the same deployment: (a) beside its killed
    # epsilon arm (3 shards, a relaunch), (b) beside its rcv1 arm (3
    # shards; this arm runs 2)
    match = {"a": "c", "b": "b"}
    # a kill arm's trajectory is aligned at the tail (the promoted
    # range's snapshot stack is shorter): its bands are held against the
    # objective at w = 0 of phase 12's unkilled arm of the deployment
    obj0 = {r["config"]: r["objective_at_w0"] for r in shard_records
            if r["kill"] is None}
    records = dcn.standby_phase(STANDBY_ARMS, obj0=obj0)
    for rec in records:
        twin = next(r for r in shard_records if r["arm"] == match[rec["arm"]])
        ctrl = rec["control"] or {}
        emit({"phase": "standby_control", "card": card, **{
            k: v for k, v in rec.items() if k != "control"},
            "control": {k: v for k, v in ctrl.items() if k != "decisions"},
            "decisions": (ctrl.get("decisions") or [])[:32],
            "updates_per_sec_phase12": twin["updates_per_sec"],
            "phase12_arm": twin["arm"],
            "wire_bytes_per_update_phase12": twin["wire_bytes_per_update"],
            "relaunch_s_phase12": (twin.get("kill") or {}).get("restart_s")})
        for w in rec["worker_launches"]:
            launches[rec["task_form"]] += w.get(rec["task_form"], 0)
    failed = [f"{r['arm']}.{r['config']}: "
              f"{[k for k, v in r['gates'].items() if not v]}"
              for r in records if not r["ok"]]
    if failed:
        raise RuntimeError(f"standby_control phase gates failed: {failed}")
    return launches


# phase 14, the data-parallel plane.  (a) the DCN worker's mesh steps at an
# epsilon worker shard (b = 0.1; sparse_step_capacity(0.1, 50,000) = 5,408
# slots), its rows over MESH_RANKS ranks of this one card
MESH_RANKS = 4
MESH_SHARD = (50_000, 2_000)
MESH_B = 0.1
MESH_SLOTS = 5_408
# (b) MiniBatchSGD at epsilon's full width (bench.py:94-98, generated on
# the card), least squares, the simple updater, learning rate
# MB_GAMMA / sqrt(it + 1) on the mean gradient (rows ~ N(0, I/d): the mean
# loss's curvature is ~1/d, so MB_GAMMA = d/2 halves the error a step)
MB_SHAPE = (400_000, 2_000)
MB_ITERS = 60
MB_GAMMA = 1_000.0
MB_B = 0.1
# two layouts of one run agree elementwise to rtol 1e-4, atol 1e-6 (the
# JAX package's 2-D test's band loosened to its multi-process test's rtol)
MB_RTOL, MB_ATOL = 1e-4, 1e-6


def _plain_calls(counts) -> int:
    return sum(v for k, v in counts.items() if k.endswith("_plain"))


def mesh_steps_check(torch, card, dev):
    """(a) The two mesh worker steps at MESH_RANKS ranks of ``dev``: the
    ASGD step ``torch.equal`` to MESH_RANKS B1 launches on the row blocks
    folded in rank order (the same draw from the same generator state,
    which both advance alike), within TOL_REL of the plain version over
    the whole shard, with exactly MESH_RANKS B1 launches on the staged
    route and no plain call; the ASAGA step's ``diff`` ``torch.equal`` to
    single-device ``saga_slots_grad`` and its ``g`` within TOL_REL."""
    from asyncframework_tpu_torch.ops import masked_grad as mg
    from asyncframework_tpu_torch.ops import steps
    from asyncframework_tpu_torch.ops.sampling import (
        bernoulli_mask,
        worker_generator,
    )
    from asyncframework_tpu_torch.parallel.mesh import (
        make_mesh,
        pad_and_shard,
    )
    from asyncframework_tpu_torch.tools import runs

    n, d = MESH_SHARD
    R = MESH_RANKS
    gen = torch.Generator(device=dev)
    gen.manual_seed(21)
    X = torch.randn(n, d, device=dev, generator=gen) / math.sqrt(d)
    y = torch.randn(n, device=dev, generator=gen)
    w = torch.randn(d, device=dev, generator=gen)
    mesh = make_mesh(R, devices=[dev] * R)
    Xs, ys, vs, _n = pad_and_shard(mesh, X, y)
    nl = n // R
    views = all(Xs[p].data_ptr() == X[p * nl].data_ptr() for p in range(R))
    step = steps.make_mesh_asgd_worker_step(MESH_B, mesh)
    wgen, ref_gen = worker_generator(42, 3, dev), worker_generator(42, 3, dev)
    runs.zero_counts()
    g = step(Xs, ys, vs, w, wgen)
    fence_dev(torch, dev)
    c = runs.counts()
    mask = bernoulli_mask(ref_gen, n, MESH_B).float()
    acc = None
    for p in range(R):
        rows = slice(p * nl, (p + 1) * nl)
        part = mg.masked_grad(X[rows], y[rows], w, mask[rows])
        acc = part if acc is None else acc + part
    ref = mg.masked_grad_reference(X, y, w, mask)
    scale = float(ref.abs().max())
    asgd = {
        "phase": "mesh_step", "step": "asgd", "card": card, "ranks": R,
        "shard": [n, d], "rows_a_rank": nl, "batch_rate": MESH_B,
        "blocks_are_views": views,
        "b1_launches": c["masked_grad"],
        "b1_staged": c["masked_grad_staged"], "plain_calls": _plain_calls(c),
        "equal_to_rank_fold": bool(torch.equal(g, acc)),
        "generator_advanced_as_single_device": bool(
            torch.equal(wgen.get_state(), ref_gen.get_state())),
        "max_abs_err_vs_plain": float((g - ref).abs().max()),
        "tol_abs": TOL_REL["float32"] * scale,
    }
    asgd["ok"] = (asgd["b1_launches"] == R and asgd["b1_staged"] == R
                  and asgd["plain_calls"] == 0 and asgd["equal_to_rank_fold"]
                  and asgd["generator_advanced_as_single_device"]
                  and asgd["max_abs_err_vs_plain"] <= asgd["tol_abs"])
    emit(asgd)
    idx = torch.sort(torch.randperm(n, device=dev, generator=gen)[
        :MESH_SLOTS]).values
    alpha = torch.randn(MESH_SLOTS, device=dev, generator=gen)
    n_valid = MESH_SLOTS - 64  # the last slots are the PS's padding
    sstep = steps.make_mesh_saga_dcn_worker_step(mesh)
    runs.zero_counts()
    gm, dm = sstep(Xs, ys, w, idx, alpha, n_valid)
    fence_dev(torch, dev)
    c = runs.counts()
    g1, d1 = steps.make_saga_dcn_worker_step()(X, y, w, idx, alpha, n_valid)
    scale = float(g1.abs().max())
    saga = {
        "phase": "mesh_step", "step": "asaga", "card": card, "ranks": R,
        "shard": [n, d], "slots": MESH_SLOTS, "n_valid": n_valid,
        "b1_launches": c["saga_slots_grad"], "plain_calls": _plain_calls(c),
        "diff_equal_to_single_device": bool(torch.equal(dm, d1)),
        "g_max_abs_err_vs_single_device": float((gm - g1).abs().max()),
        "tol_abs": TOL_REL["float32"] * scale,
    }
    saga["ok"] = (saga["b1_launches"] == R and saga["plain_calls"] == 0
                  and saga["diff_equal_to_single_device"]
                  and saga["g_max_abs_err_vs_single_device"]
                  <= saga["tol_abs"])
    emit(saga)
    if not (asgd["ok"] and saga["ok"]):
        raise RuntimeError(f"the mesh steps failed: {asgd} {saga}")


def fence_dev(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def minibatch_phase(torch, card, dev, shape=MB_SHAPE, iters=MB_ITERS):
    """(b) ``MiniBatchSGD`` on a ``shape`` deployment generated on ``dev``
    (phase 3's seed), least squares, the simple updater: 1-rank and
    MESH_RANKS-rank meshes at b = MB_B (each below 1/10 of the objective
    at w = 0, one B1 launch a rank an iteration, no plain call), the
    MESH_RANKS run's graph replays bit-equal to the same iterations run
    eagerly, and at b = 1.0 the 1-rank, MESH_RANKS-rank and (dp 2, md 2)
    runs agreeing (MB_RTOL, MB_ATOL).  Returns the B1 launches on the
    path by form."""
    import numpy as np

    from asyncframework_tpu_torch.data.sharded import ShardedDataset
    from asyncframework_tpu_torch.parallel.mesh import make_mesh
    from asyncframework_tpu_torch.solvers import MiniBatchSGD
    from asyncframework_tpu_torch.tools import runs

    n, d = shape
    R = MESH_RANKS
    t0 = time.monotonic()
    ds = ShardedDataset.generate_on_device(n, d, 1, [dev], seed=7,
                                           noise=0.01)
    X, y = ds.shard(0).X, ds.shard(0).y
    obj0 = 0.5 * float(torch.sum(y * y)) / n
    fence_dev(torch, dev)
    emit({"phase": "minibatch_data", "card": card, "shape": [n, d],
          "bytes": X.numel() * X.element_size(), "objective_at_w0": obj0,
          "generate_s": time.monotonic() - t0})
    meshes = {
        "dp1": make_mesh(1, devices=[dev]),
        f"dp{R}": make_mesh(R, devices=[dev] * R),
        "dp2_md2": make_mesh(4, axis_names=("dp", "md"), axis_sizes=(2, 2),
                             devices=[dev] * 4),
    }
    on_path = {"saga_grad": 0, "xt_coeff": 0}
    out = {}

    def one(name, b, graph=None):
        sgd = MiniBatchSGD(gamma=MB_GAMMA, batch_rate=b, num_iterations=iters,
                           seed=3)
        mesh = meshes[name]
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        runs.zero_counts()
        w, losses, _snaps = sgd.run(X, y, mesh=mesh, graph=graph)
        c = runs.counts()
        info = sgd.last_run
        form = "xt_coeff" if "md" in name else "saga_grad"
        per_it = c[form] / max(info["enqueued_iterations"], 1)
        on_path[form] += int(round(per_it * iters))
        rec = {
            "phase": "minibatch_sgd", "card": card, "mesh": name,
            "mesh_shape": mesh.shape, "batch_rate": b, "gamma": MB_GAMMA,
            "iterations": iters, "graph_replays": info["graph_replays"],
            "elapsed_s": info["elapsed_s"],
            "iterations_per_s": iters / info["elapsed_s"],
            "b1_form": form, "b1_launches": c[form],
            "b1_launches_per_iteration": per_it,
            "plain_calls": _plain_calls(c),
            "objective_at_w0": obj0, "loss_first": float(losses[0]),
            "loss_final": float(losses[-1]),
            "finite": bool(np.isfinite(w).all()
                           and np.isfinite(losses).all()),
            "peak_device_bytes": (int(torch.cuda.max_memory_allocated(dev))
                                  if dev.type == "cuda" else None),
        }
        rec["ok"] = (rec["finite"] and per_it == mesh.size
                     and rec["plain_calls"] == 0)
        if b == MB_B:
            rec["loss_below_0.1x"] = rec["loss_final"] < obj0 / 10
            rec["ok"] = rec["ok"] and rec["loss_below_0.1x"]
        out[(name, b, graph)] = (w, losses)
        emit(rec)
        return rec

    recs = [one("dp1", MB_B), one(f"dp{R}", MB_B)]
    eager = one(f"dp{R}", MB_B, graph=False)
    (wg, lg), (we, le) = out[(f"dp{R}", MB_B, None)], out[(f"dp{R}", MB_B,
                                                         False)]
    replay = {"phase": "minibatch_graph", "card": card, "mesh": f"dp{R}",
              "graph_replays": recs[1]["graph_replays"],
              "eager_graph_replays": eager["graph_replays"],
              "w_bit_equal": bool(np.array_equal(wg, we)),
              "losses_bit_equal": bool(np.array_equal(lg, le))}
    replay["ok"] = (replay["graph_replays"] > 0 and replay["w_bit_equal"]
                    and replay["losses_bit_equal"])
    emit(replay)
    full = [one(name, 1.0) for name in ("dp1", f"dp{R}", "dp2_md2")]
    agree = {}
    for a, b in (((f"dp{R}", "dp1")), ("dp2_md2", f"dp{R}")):
        (wa, la), (wb, lb) = out[(a, 1.0, None)], out[(b, 1.0, None)]
        agree[f"{a}_vs_{b}"] = {
            "w_max_abs_diff": float(np.abs(wa - wb).max()),
            "loss_max_abs_diff": float(np.abs(la - lb).max()),
            "agree": bool(np.allclose(wa, wb, rtol=MB_RTOL, atol=MB_ATOL)
                          and np.allclose(la, lb, rtol=MB_RTOL,
                                          atol=MB_ATOL)),
        }
    emit({"phase": "minibatch_agreement", "card": card, "batch_rate": 1.0,
          "rtol": MB_RTOL, "atol": MB_ATOL, **agree})
    failed = ([r["mesh"] for r in recs + [eager] + full if not r["ok"]]
              + ([] if replay["ok"] else ["graph replay"])
              + [k for k, v in agree.items() if not v["agree"]])
    del ds, X, y, out
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    if failed:
        raise RuntimeError(f"minibatch_sgd gates failed: {failed}")
    return on_path


def mesh_phase(torch, card):
    """Phase 14, the data-parallel plane: B1's full masked form at the mesh
    rank block and its ASAGA form at MiniBatchSGD's rank block against
    their plain versions, (a) :func:`mesh_steps_check`, (b)
    :func:`minibatch_phase`, (c) the DCN arms (``tools/dcn.py::
    mesh_phase``: epsilon ASGD without and with a MESH_RANKS-rank mesh on
    this card, then ASAGA with it), each held to phase 10's gates with one
    B1 launch a rank a gradient.  Returns the kernel records and the B1
    launches on the phase's paths by form."""
    from asyncframework_tpu_torch.ops import masked_grad as mg
    from asyncframework_tpu_torch.tools import dcn

    dev = torch.device("cuda", 0)
    flush = torch.empty(L2_FLUSH_BYTES // 4, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(14)
    n, d = MESH_SHARD
    recs = {
        "mesh_rank_block": kernel_case(
            "mesh_rank_block", n // MESH_RANKS, d, torch.float32, torch, mg,
            flush, gen, MESH_B),
        "saga_minibatch_rank": saga_case(
            "saga_minibatch_rank", MB_SHAPE[0] // MESH_RANKS, MB_SHAPE[1],
            torch.float32, torch, mg, flush, gen, MB_B),
    }
    del flush
    torch.cuda.empty_cache()
    mesh_steps_check(torch, card, dev)
    torch.cuda.empty_cache()
    launches = minibatch_phase(torch, card, dev)
    launches.update({"masked_grad": 0, "masked_grad_mesh": 0,
                     "saga_slots_grad": 0})
    records = dcn.mesh_phase(MESH_DCN_ARMS)
    off = next(r for r in records if r["arm"] == "off")
    for rec in records:
        emit({"phase": "dcn_mesh", "card": card, **rec,
              "updates_per_sec_mesh_off": off["updates_per_sec"]})
        key = ("masked_grad_mesh" if rec["mesh"] and rec["algo"] == "asgd"
               else rec["task_form"])
        for w in rec["worker_launches"]:
            launches[key] += w.get(rec["task_form"], 0)
    failed = [f"{r['arm']}.{r['algo']}: "
              f"{[k for k, v in r['gates'].items() if not v]}"
              for r in records if not r["ok"]]
    if failed:
        raise RuntimeError(f"dcn_mesh gates failed: {failed}")
    return recs, launches


# phase 15, the entry points.  (a) phases 3, 5 and 6's recipes through
# the CLI in this process: ASGD run() and run_sync(), run_fused(), ASAGA,
# each with its phase's band; sgd-mllib makes its data on the host, so its
# rows are cut (400,000 to 100,000) at phase 14's MiniBatchSGD recipe
ENTRY_ROWS, ENTRY_WIDTH = 400_000, "2000"
#: (driver, updates (rounds for -sync), gamma, printer freq, band)
ENTRY_DRIVERS = (("asgd", 1_000, 100.0, 25, 0.1),
                 ("asgd-sync", 300, 100.0, 25, 0.1),
                 ("asgd-fused", 5_000, 100.0, 25, 0.1),
                 ("asaga", 2_000, 0.5, 100, 0.5))
ENTRY_MLLIB_ROWS, ENTRY_MLLIB_ITERS = 100_000, 60
# (b) rcv1's published shape through --sparse: int(density * d) = 80
# nonzeros a row, N(0, 1) values, so phase 7's gamma over 80 (the same
# step against E[x x^T] = 80 I / d); the updater drains 16 a wake
ENTRY_RCV1 = (47_236, 697_641, 1_200, 2_361.8 / 80, "0.0016937")
# (c) the local cluster: one PS and two worker processes, phase 10's
# recipe; (d) the standalone deploy: rows cut to 100,000, 500 updates;
# (e) a dense LibSVM file (rows, width, updates, gamma) at epsilon's width,
# ~26-row tasks; the updater drains 16 a wake, as (b) does: with one a wake
# the workers outrun it and results are applied ~250 updates stale (C4),
# which drifts above the objective at w = 0 at gamma 50 on either route
# (``tools/asgd_gate.py --config file``)
ENTRY_CLUSTER_UPDATES = 1_000
ENTRY_DEPLOY_ROWS, ENTRY_DEPLOY_UPDATES = 100_000, 500
ENTRY_LIBSVM = (2_048, 2_000, 1_000, 50.0)


def entry_cli(argv, torch):
    """``cli.main(argv)`` in this process, every kernel count set to 0
    just before it and read just after; returns its exit code, summary,
    trajectory objectives, counts and seconds."""
    import contextlib
    import io

    from asyncframework_tpu_torch import cli
    from asyncframework_tpu_torch.tools import runs

    gc.collect()
    torch.cuda.empty_cache()
    buf = io.StringIO()
    t0 = time.monotonic()
    runs.zero_counts()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(list(argv))
    torch.cuda.synchronize()
    counts = runs.counts()
    seconds = time.monotonic() - t0
    lines = buf.getvalue().strip().splitlines()
    traj = [float(ln.strip("()").split(",")[1]) for ln in lines[:-1]
            if ln.startswith("(")]
    return rc, json.loads(lines[-1]), traj, counts, seconds


def entry_recipe(driver, rows, iters, gamma, pfreq,
                 path=("synthetic", "x"), width=ENTRY_WIDTH, extra=()):
    """A recipe of 8 workers, taw 2^31-1, b = 0.1, bucket ratio 0.7, seed
    42 (phase 3's), at epsilon's width unless given."""
    return [driver, *path, str(width), str(rows), "8", str(iters),
            str(gamma), "2147483647", "0.1", "0.7", str(pfreq), "0", "42",
            *extra]


def _band(traj, summary, band):
    obj0, final = (traj[0] if traj else float("nan"),
                   summary.get("final_objective"))
    return {"finite": final is not None and math.isfinite(final),
            f"final_below_{band}x": final is not None and final < band * obj0}


def entry_drivers(torch, card, on_path):
    """(a) and (b): the in-process drivers, gated; adds their launches to
    ``on_path`` (by form)."""
    from asyncframework_tpu_torch.tools import runs

    for driver, iters, gamma, pfreq, band in ENTRY_DRIVERS:
        rc, s, traj, c, secs = entry_cli(
            entry_recipe(driver, ENTRY_ROWS, iters, gamma, pfreq), torch)
        budget = s["rounds"] if driver.endswith("-sync") else s["accepted"]
        gates = {"exit_0": rc == 0,
                 "budget": (s["accepted"] >= iters if driver.endswith(
                     "-fused") else budget == iters),
                 **_band(traj, s, band),
                 "no_plain_call": _plain_calls(c) == 0}
        if driver == "asaga":
            launched = {"saga_grad": c["saga_grad"],
                        "xt_coeff": c["xt_coeff"]}
            gates["through_b1"] = (c["saga_grad"] >= s["accepted"] > 0
                                   and c["xt_coeff"] >= s["accepted"])
        else:
            launched = ({"masked_grad": c["masked_grad"],
                         "masked_grad_staged": c["masked_grad_staged"]}
                        if not driver.endswith("-fused") else
                        {k: v for k, v in runs._on_path(
                            c, s["rounds"]).items() if k.startswith("mask")})
            gates["through_b1_staged"] = (
                launched["masked_grad"] >= s["accepted"] > 0
                and launched["masked_grad_staged"] == launched["masked_grad"])
        for form in ("masked_grad", "saga_grad", "xt_coeff"):
            on_path[form] += launched.get(form, 0)
        rec = {"phase": "entry", "arm": "a", "driver": driver, "card": card,
               "argv": entry_recipe(driver, ENTRY_ROWS, iters, gamma, pfreq),
               "seconds": secs, "objective_at_w0": traj[0] if traj else None,
               "trajectory_lines": len(traj), "summary": s,
               "launches": launched, "raw_counts": {
                   k: v for k, v in c.items() if v},
               "gates": gates, "ok": all(gates.values())}
        emit(rec)
        if not rec["ok"]:
            raise RuntimeError(f"entry {driver} failed its gates: {gates}")
    # sgd-mllib: its rows made on the host (cut), one rank of the card
    argv = entry_recipe("sgd-mllib", ENTRY_MLLIB_ROWS, ENTRY_MLLIB_ITERS,
                        MB_GAMMA, 25)
    rc, s, traj, c, secs = entry_cli(argv, torch)
    gates = {"exit_0": rc == 0,
             "iterations": s["iterations"] == ENTRY_MLLIB_ITERS,
             "finite": bool(traj) and all(math.isfinite(v) for v in traj),
             "loss_below_0.1x_first": bool(traj) and traj[-1] < traj[0] / 10,
             "through_b1": c["saga_grad"] > 0,
             "no_plain_call": _plain_calls(c) == 0}
    on_path["saga_grad_minibatch"] += c["saga_grad"]
    rec = {"phase": "entry", "arm": "a", "driver": "sgd-mllib", "card": card,
           "argv": argv, "cut": f"rows {ENTRY_MLLIB_ROWS} of 400,000 (host "
           "data)", "seconds": secs, "summary": s,
           "loss_first": traj[0] if traj else None,
           "launches": {"saga_grad": c["saga_grad"]}, "gates": gates,
           "ok": all(gates.values())}
    emit(rec)
    if not rec["ok"]:
        raise RuntimeError(f"entry sgd-mllib failed its gates: {gates}")
    # (b) the sparse driver at rcv1's shape
    d, n, iters, gamma, density = ENTRY_RCV1
    argv = ["asgd", "synthetic", "x", str(d), str(n), "8", str(iters),
            repr(gamma), "2147483647", "0.05", "0.7", "50", "0", "42",
            "--sparse", "--sparse-density", density,
            "--conf", "async.drain.batch=16"]
    rc, s, traj, c, secs = entry_cli(argv, torch)
    obj0 = traj[0] if traj else float("nan")
    gates = {"exit_0": rc == 0, "budget": s["accepted"] == iters,
             "finite": bool(traj) and all(math.isfinite(v) for v in traj),
             "best_below_0.1x": bool(traj) and min(traj) < 0.1 * obj0,
             "final_below_0.3x": bool(traj) and traj[-1] < 0.3 * obj0,
             "through_s1": (c["compacted_grad"] >= s["accepted"] > 0
                            and c["ell_residual"] > 0
                            and c["segment_sum"] == 0
                            and c["masked_grad"] == 0),
             "no_plain_call": _plain_calls(c) == 0}
    on_path["compacted_grad"] += c["compacted_grad"]
    on_path["ell_residual"] += c["ell_residual"]
    rec = {"phase": "entry", "arm": "b", "driver": "asgd --sparse",
           "card": card, "argv": argv, "seconds": secs,
           "objective_at_w0": obj0,
           "best_objective": min(traj) if traj else None, "summary": s,
           "launches": {k: c[k] for k in ("compacted_grad", "ell_residual")},
           "gates": gates, "ok": all(gates.values())}
    emit(rec)
    if not rec["ok"]:
        raise RuntimeError(f"entry asgd --sparse failed its gates: {gates}")


def _last_json(lines):
    for ln in reversed(lines):
        if ln.startswith("{"):
            return json.loads(ln)
    return {}


def entry_cluster(card):
    """(c) ``python -m asyncframework_tpu_torch.cluster 3 -- ...`` on the
    card, its dashboard on an ephemeral port; gated."""
    argv = entry_recipe("asgd", ENTRY_ROWS, ENTRY_CLUSTER_UPDATES, 100.0, 25,
                        extra=("--ui-port", "0"))
    cmd = [sys.executable, "-m", "asyncframework_tpu_torch.cluster", "3",
           "--", *argv]
    t0 = time.monotonic()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                          cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT))
    lines = proc.stdout.strip().splitlines()
    s = _last_json(lines)
    traj = [float(ln.strip("()").split(",")[1]) for ln in lines
            if ln.startswith("(")]
    gates = {"exit_0": proc.returncode == 0, "done": s.get("done") is True,
             "accepted_is_budget": s.get("accepted")
             == ENTRY_CLUSTER_UPDATES,
             **_band(traj, s, 0.1),
             "ui_port": isinstance(s.get("ui_port"), int)
             and s["ui_port"] > 0}
    rec = {"phase": "entry", "arm": "c", "card": card, "command": cmd[1:],
           "seconds": time.monotonic() - t0,
           "objective_at_w0": traj[0] if traj else None,
           "summary": s, "gates": gates, "ok": all(gates.values())}
    if not rec["ok"]:
        rec["stderr_tail"] = proc.stderr[-3000:]
    emit(rec)
    if not rec["ok"]:
        raise RuntimeError(f"entry cluster failed its gates: {gates}")


def _stop(proc, timeout=30):
    import signal

    if proc.poll() is None:
        proc.send_signal(signal.SIGINT)
        try:
            proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    out, err = proc.communicate()
    return out, err


def entry_deploy(torch, card):
    """(d) a master and one worker daemon on localhost, then a ``--master``
    submission of a 3-process app through the CLI; gated.  Both daemons
    are stopped (SIGINT, then killed) whatever happens."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    py = sys.executable
    t0 = time.monotonic()
    master = subprocess.Popen(
        [py, "-m", "asyncframework_tpu_torch.deploy.master", "--port", "0"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT,
        env=env)
    worker = None
    try:
        addr = master.stdout.readline().split()[3]
        worker = subprocess.Popen(
            [py, "-m", "asyncframework_tpu_torch.deploy.worker", addr],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            cwd=ROOT, env=env)
        worker.stdout.readline()  # registered
        argv = ["--master", addr, "--processes", "3", "--wait-timeout",
                "600", "--quiet", *entry_recipe(
                    "asgd", ENTRY_DEPLOY_ROWS, ENTRY_DEPLOY_UPDATES, 100.0,
                    25)]
        rc, s, _traj, _c, secs = entry_cli(argv, torch)
    finally:
        w_out = _stop(worker)[0] if worker is not None else ""
        _stop(master)
    app = _last_json(w_out.strip().splitlines())
    gates = {"exit_0": rc == 0, "finished": s.get("state") == "FINISHED",
             "executors_exit_0": s.get("exits") == {"0": 0, "1": 0, "2": 0},
             "accepted_is_budget": app.get("accepted")
             == ENTRY_DEPLOY_UPDATES}
    rec = {"phase": "entry", "arm": "d", "card": card, "argv": argv,
           "cut": f"rows {ENTRY_DEPLOY_ROWS} of 400,000, "
           f"{ENTRY_DEPLOY_UPDATES} updates",
           "seconds": time.monotonic() - t0, "submit_seconds": secs,
           "final": s, "app_summary": app, "gates": gates,
           "ok": all(gates.values())}
    emit(rec)
    if not rec["ok"]:
        raise RuntimeError(f"entry deploy failed its gates: {gates}")


def entry_libsvm(torch, card, on_path):
    """(e) a dense LibSVM file written from a seed, parsed by the C++
    parser and the line parser (bit-equal), then ``asgd`` over it."""
    import tempfile

    import numpy as np

    from asyncframework_tpu_torch import native_build
    from asyncframework_tpu_torch.data import libsvm
    from asyncframework_tpu_torch.tools import asgd_gate

    n, d, iters, gamma = ENTRY_LIBSVM
    X, y = asgd_gate.file_arrays(n, d)
    fmt = "%.7g " + " ".join(f"{j + 1}:%.7g" for j in range(d)) + "\n"
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "rows.libsvm")
        t0 = time.monotonic()
        with open(path, "w") as f:
            for i in range(n):
                f.write(fmt % (float(y[i]), *X[i].tolist()))
        write_s = time.monotonic() - t0
        native_build.reset_native_totals()
        t0 = time.monotonic()
        Xn, yn = libsvm.load_libsvm(path, d)
        native_s = time.monotonic() - t0
        t0 = time.monotonic()
        Xp, yp = libsvm.load_libsvm(path, d, use_native=False)
        python_s = time.monotonic() - t0
        parsed = native_build.native_totals()
        argv = entry_recipe("asgd", n, iters, gamma, 25,
                            path=(tmp, os.path.basename(path)), width=d,
                            extra=("--conf", "async.drain.batch=16"))
        rc, s, traj, c, secs = entry_cli(argv, torch)
        size = os.path.getsize(path)
    totals = native_build.native_totals()
    gates = {"bit_equal": bool(np.array_equal(Xn, Xp)
                               and np.array_equal(yn, yp)),
             "native_parse": parsed.get("native_calls.libsvm") == 1
             and not parsed.get("python_fallbacks"),
             "cli_native_load": totals.get("native_calls.libsvm") == 2
             and not totals.get("python_fallbacks"),
             "exit_0": rc == 0, "budget": s.get("accepted") == iters,
             **_band(traj, s, 0.1),
             # phase 2's f_file_idx_2048x2000: the tiled route
             "through_b1_tiled": (c["masked_grad"] >= s["accepted"] > 0
                                  and c["masked_grad_tiled"]
                                  == c["masked_grad"]),
             "no_plain_call": _plain_calls(c) == 0}
    on_path["masked_grad_file"] += c["masked_grad"]
    rec = {"phase": "entry", "arm": "e", "card": card,
           "file": {"rows": n, "d": d, "bytes": size, "write_s": write_s},
           "native_parse_s": native_s, "python_parse_s": python_s,
           "argv": argv, "seconds": secs, "summary": s,
           "objective_at_w0": traj[0] if traj else None,
           "launches": {k: c[k] for k in ("masked_grad",
                                          "masked_grad_staged",
                                          "masked_grad_tiled")},
           "gates": gates,
           "ok": all(gates.values())}
    emit(rec)
    if not rec["ok"]:
        raise RuntimeError(f"entry libsvm failed its gates: {gates}")


def entry_phase(torch, card):
    """Phase 15, the entry points (arms (a)-(e)); returns the in-process
    arms' kernel launches by form (the subprocess arms' launches are not
    counted: their counts live in their processes)."""
    on_path = {"masked_grad": 0, "saga_grad": 0, "xt_coeff": 0,
               "saga_grad_minibatch": 0, "compacted_grad": 0,
               "ell_residual": 0, "masked_grad_file": 0}
    entry_drivers(torch, card, on_path)
    gc.collect()
    torch.cuda.empty_cache()
    entry_cluster(card)
    entry_deploy(torch, card)
    entry_libsvm(torch, card, on_path)
    emit({"phase": "entry_launches", "card": card, **on_path})
    return on_path


def serving_phase(card):
    """Phase 16, the read path (``tools/serve.py``): (a) serve, (b)
    serve_sharded, (c) relay, each held to its gates; returns the training
    arms' kernel launches by form (counted in their worker processes)."""
    from asyncframework_tpu_torch.tools import serve

    launches = {"masked_grad": 0}
    failed = []
    for fn in (serve.serve_arm, serve.sharded_arm, serve.relay_arm):
        t0 = time.monotonic()
        rec = fn(device="cuda")
        rec["seconds"] = time.monotonic() - t0
        emit({"phase": "serving", "card": card, **rec})
        for w in rec.get("worker_launches", []):
            launches[rec["task_form"]] += w.get(rec["task_form"], 0)
        if not rec["ok"]:
            failed.append(f"{rec['arm']}: "
                          f"{[k for k, v in rec['gates'].items() if not v]}")
    if failed:
        raise RuntimeError(f"serving phase gates failed: {failed}")
    return launches


def ml_phase(card):
    """Phase 17 (``tools/ml.py``): the ML library's arms on this card;
    returns the B1 launches on the path by form."""
    import torch

    from asyncframework_tpu_torch.tools import ml

    out = ml.phase(torch.device("cuda", 0), card, emit=lambda line: print(
        line, flush=True))
    torch.cuda.empty_cache()
    return out["launches"]


def ml_breadth_phase(card):
    """Phase 18 (``tools/ml.py::breadth_phase``): the library's breadth on
    this card; returns the B1 launches on the path by form."""
    import torch

    from asyncframework_tpu_torch.tools import ml

    out = ml.breadth_phase(torch.device("cuda", 0), card,
                           emit=lambda line: print(line, flush=True))
    torch.cuda.empty_cache()
    return out["launches"]


def dataset_graph_phase(card, run_updates_per_s):
    """Phase 19 (``tools/dataset_graph.py``): the dataset layer and the
    graph library on this card; returns arm (a)'s B1 launches."""
    import torch

    from asyncframework_tpu_torch.tools import dataset_graph

    out = dataset_graph.phase(torch.device("cuda", 0), card,
                              emit=lambda line: print(line, flush=True),
                              run_updates_per_s=run_updates_per_s)
    torch.cuda.empty_cache()
    return out["launches"]


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, "asyncframework_tpu_torch")):
        print("chip_smoke.py: asyncframework_tpu_torch/ is not beside this "
              "script", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 2

    from asyncframework_tpu_torch.data.sharded import ShardedDataset
    from asyncframework_tpu_torch.ops import _build
    from asyncframework_tpu_torch.ops import chunk_attention as ca
    from asyncframework_tpu_torch.ops import masked_grad as mg
    from asyncframework_tpu_torch.ops import sparse_grad as sg
    from asyncframework_tpu_torch.ops.steps import sparse_step_capacity
    from asyncframework_tpu_torch.solvers import ASGD, SolverConfig

    t_start = time.monotonic()
    laps, t_lap = {}, [t_start]

    def lap(name):
        """The seconds since the previous phase ended, by phase."""
        now = time.monotonic()
        laps[name], t_lap[0] = now - t_lap[0], now

    dev = torch.device("cuda", 0)
    # ---------------------------------------------------------- 1. device
    card = card_line()
    print(card, flush=True)
    build_s = _build.build_all()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({
        "phase": "device", "card": card,
        "kind": torch.cuda.get_device_name(0),
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "build_s": build_s,
        "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
        "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
    })
    for name in _build.sources():
        for function, info in ptxas_lines(_build.ptxas_report(name)):
            emit({"phase": "ptxas", "kernel": name, "function": function,
                  "info": info})

    lap("device")

    # ---------------------------------------------------------- 2. kernel
    flush = torch.empty(L2_FLUSH_BYTES // 4, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [
        ("a_epsilon_full", 50_000, 2_000, f32, 0.7, None, "least_squares"),
        ("b_epsilon_idx", 50_000, 2_000, f32, 0.1, 5_408, "least_squares"),
        ("c_mnist8m_idx", 1_012_500, 784, bf16, 0.1, 103_064, "least_squares"),
        ("c_mnist8m_full", 1_012_500, 784, bf16, 0.1, None, "least_squares"),
        ("d_ragged_300x100", 300, 100, f32, 0.5, None, "least_squares"),
        ("d_ragged_17x8", 17, 8, f32, 0.5, None, "least_squares"),
        ("d_empty_0x8", 0, 8, f32, 0.5, None, "least_squares"),
        # just over the staged route's least bytes of X (1 MB of 512 KB)
        ("d_small_132x2000", 132, 2_000, f32, 1.0, None, "least_squares"),
        ("e_epsilon_logistic", 50_000, 2_000, f32, 0.7, None, "logistic"),
        # phase 15 (e)'s task: the compacted form of a file's 8-worker
        # shard at b = 0.1 (under the staged route's 512 KB of X: tiled)
        ("f_file_idx_2048x2000", 256, 2_000, f32, 0.1,
         sparse_step_capacity(0.1, 256), "least_squares"),
        ("f_file_idx_4096x500", 512, 500, f32, 0.1,
         sparse_step_capacity(0.1, 512), "least_squares"),
    ]
    recs = {}
    for name, n, d, dtype, b, cap, loss in cases:
        recs[name] = kernel_case(name, n, d, dtype, torch, mg, flush, gen, b,
                                 cap, loss)
        torch.cuda.empty_cache()
    # ASAGA's forms at the epsilon shard the ASAGA phase runs (b = 0.1)
    for name, dtype in (("saga_epsilon", f32), ("xt_epsilon", f32),
                        ("saga_mnist8m_shard", bf16), ("xt_mnist8m_shard", bf16)):
        n, d = (50_000, 2_000) if "epsilon" in name else (1_012_500, 784)
        recs[name] = saga_case(name, n, d, dtype, torch, mg, flush, gen, 0.1)
        torch.cuda.empty_cache()
    att_cases = [
        ("f_ring_block_causal", 1, 8_192, 8_192, 32, 128, bf16, "causal"),
        ("f_ring_block_nomask", 1, 8_192, 8_192, 32, 128, bf16, "none"),
        ("g_ulysses_block_causal", 1, 32_768, 512, 8, 128, bf16, "ulysses_mid"),
        ("h_ragged_24x18", 2, 24, 18, 3, 20, f32, "random"),
        ("h_tq1", 1, 1, 18, 3, 64, f32, "none"),
        ("h_d64_f32", 1, 300, 257, 4, 64, f32, "causal"),
        # the tensor-core route's edges: ragged Tq and Tk (TMA's zero fill
        # plus the mask), D = 64, a fully masked row, one query row
        ("i_bf16_ragged_300x257", 1, 300, 257, 4, 128, bf16, "causal"),
        ("i_bf16_d64", 2, 200, 130, 4, 64, bf16, "none"),
        ("i_bf16_random", 2, 100, 77, 3, 128, bf16, "random"),
        ("i_bf16_tq1", 1, 1, 18, 3, 128, bf16, "none"),
    ]
    for name, *shape in att_cases:
        recs[name] = attention_case(name, *shape, torch, ca, flush, gen)
    for name, *shape in S1_CASES:
        recs[name] = s1_case(name, *shape, torch, sg, flush, gen)
        torch.cuda.empty_cache()
    # the DCN plane's ASAGA worker forms: epsilon's shard at b = 0.1
    # (sparse_step_capacity(0.1, 50,000) = 5,408 slots), rcv1's task
    recs["saga_slots_epsilon"] = b1_saga_slots_case(
        "saga_slots_epsilon", 50_000, 2_000, 5_408, 0.1, torch, mg, flush,
        gen)
    recs["s_saga_slots_rcv1"] = s1_saga_slots_case(
        "s_saga_slots_rcv1", 87_205, 80, 75, 47_236, 0.05, 4_752, torch, sg,
        flush, gen)
    torch.cuda.empty_cache()
    # phase 17's two B1 forms on the whole epsilon deployment (one rank):
    # LogisticRegression's and LBFGS's logistic full form at fraction 1.0,
    # LinearSVM's xt_coeff; drawn from a generator of their own, so the
    # cases above keep their inputs
    gen_ml = torch.Generator(device=dev)
    gen_ml.manual_seed(17)
    recs["logreg_epsilon_full"] = kernel_case(
        "logreg_epsilon_full", 400_000, 2_000, f32, torch, mg, flush, gen_ml,
        1.0, None, "logistic")
    torch.cuda.empty_cache()
    recs["xt_epsilon_full"] = saga_case("xt_epsilon_full", 400_000, 2_000,
                                        f32, torch, mg, flush, gen_ml, 0.1)
    torch.cuda.empty_cache()
    del flush

    lap("kernel")

    # ------------------------------------------------------- 3. main path
    ds = ShardedDataset.generate_on_device(
        400_000, 2_000, 8, [dev], seed=7, noise=0.01
    )
    cfg = dict(num_workers=8, gamma=100.0, taw=2**31 - 1, batch_rate=0.1,
               bucket_ratio=0.7, printer_freq=25, seed=42)
    mg.masked_grad.launches = 0
    mg.masked_grad.launches_staged = 0
    mg.masked_grad.launches_tiled = 0
    solver = ASGD(ds, None, SolverConfig(num_iterations=1000, **cfg),
                  devices=[dev])
    res = solver.run()
    tasks = sum(m.succeeded for m in solver.scheduler.pool.all_metrics())
    sync_solver = ASGD(ds, None, SolverConfig(num_iterations=300, **cfg),
                       devices=[dev])
    res_sync = sync_solver.run_sync()
    tasks += sum(m.succeeded for m in sync_solver.scheduler.pool.all_metrics())
    launches = mg.masked_grad.launches
    staged = mg.masked_grad.launches_staged
    tiled = mg.masked_grad.launches_tiled
    for mode, r in (("run", res), ("run_sync", res_sync)):
        obj0, obj1 = r.trajectory[0][1], r.final_objective
        rec = {
            "phase": "main_path", "mode": mode, "n": ds.n, "d": ds.d,
            "workers": 8, "dtype": "float32", "card": card,
            "accepted": r.accepted, "dropped": r.dropped, "rounds": r.rounds,
            "max_staleness": r.max_staleness,
            "updates_per_sec": r.updates_per_sec, "elapsed_s": r.elapsed_s,
            "objective_at_w0": obj0, "final_objective": obj1,
            "finite": bool(np.isfinite(r.final_w).all()),
        }
        emit(rec)
        if not (rec["finite"] and obj1 < obj0 / 10):
            raise RuntimeError(f"{mode} did not converge: {rec}")
    if res.accepted != 1000 or res_sync.rounds != 300:
        raise RuntimeError("main path stopped short of its iteration budget")
    emit({"phase": "launches", "masked_grad": launches,
          "masked_grad_staged": staged, "masked_grad_tiled": tiled,
          "tasks_run": tasks})
    if launches < tasks or tasks == 0:
        raise RuntimeError("the main path did not run every task through "
                           "the masked_grad kernel")
    if staged < tasks:
        raise RuntimeError(f"{tasks} ASGD tasks but {staged} launches on "
                           f"masked_grad's staged route")
    del solver, sync_solver
    torch.cuda.empty_cache()

    # small input: the card (kernel) and the CPU (plain path) must agree
    rs = np.random.default_rng(0)
    Xs = rs.normal(size=(4_096, 64)).astype(np.float32)
    ys = (Xs @ rs.normal(size=64).astype(np.float32)).astype(np.float32)
    small = SolverConfig(num_workers=4, num_iterations=20, gamma=0.5,
                         batch_rate=1.0, printer_freq=5)
    w_gpu = ASGD(Xs, ys, small, devices=[dev]).run_sync().final_w
    w_cpu = ASGD(Xs, ys, small, devices=[torch.device("cpu")]).run_sync().final_w
    diff = float(np.abs(w_gpu - w_cpu).max())
    tol = 1e-4 * float(np.abs(w_cpu).max())
    emit({"phase": "small_agreement", "max_abs_diff": diff, "tol": tol,
          "shape": [4_096, 64], "rounds": 20})
    if not diff <= tol:
        raise RuntimeError("run_sync on the card disagrees with the CPU path")

    lap("main_path")

    # ---------------------------------------------------- 4. long context
    att_launches, _ = long_context_phase(torch, ca, card, recs)

    lap("long_context")

    # ------------------------------------------------------------ 5. asaga
    saga_launches = asaga_phase(ds, torch, np, mg, card)

    lap("asaga")

    # ---------------------------------------------------- 6. fused, epsilon
    eps_fused, saga_fused = fused_epsilon_phase(ds, torch, np, mg, card)
    del ds
    torch.cuda.empty_cache()

    lap("fused")

    # ----------------------------------------------------------- 7. sparse
    s1_launches = sparse_phase(torch, card)

    lap("sparse")

    # ---------------------------------------------------------- 8. mnist8m
    mnist_fused, mnist_run = mnist8m_phase(torch, card)

    lap("mnist8m")

    # --------------------------------------------------------- 9. features
    feat = features_phase(torch, card)

    lap("features")

    # -------------------------------------------------------------- 10. dcn
    dcn_launches, dcn_records = dcn_phase(torch, card)

    lap("dcn")

    # -------------------------------------------------------- 11. telemetry
    tel = telemetry_phase(torch, card, dcn_records)

    lap("telemetry")

    # ----------------------------------------------------------- 12. shards
    shard_launches, shard_records = shards_phase(card, dcn_records)

    lap("shards")

    # -------------------------------------------------- 13. standby_control
    damped_merge_check(torch, card)
    standby_launches = standby_control_phase(card, shard_records)

    lap("standby_control")

    # ------------------------------------------------------------- 14. mesh
    mesh_recs, mesh_launches = mesh_phase(torch, card)

    lap("mesh")

    # ------------------------------------------------------------ 15. entry
    entry_launches = entry_phase(torch, card)

    lap("entry")

    # ---------------------------------------------------------- 16. serving
    serving_launches = serving_phase(card)

    lap("serving")

    # --------------------------------------------------------------- 17. ml
    ml_launches = ml_phase(card)

    lap("ml")

    # ------------------------------------------------------ 18. ml_breadth
    breadth_launches = ml_breadth_phase(card)

    lap("ml_breadth")

    # --------------------------------------------------- 19. dataset_graph
    dg_launches = dataset_graph_phase(card, res.updates_per_sec)

    lap("dataset_graph")

    # ------------------------------------------------------ 20. results
    emit({"phase": "total", "seconds": time.monotonic() - t_start,
          "phase_seconds": laps})
    print(card, flush=True)

    def entry(name, source, replaces, count, rec, bound_ms):
        return {
            "name": name, "route": "cuda",
            "source": f"asyncframework_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": count,
            "max_abs_err": rec.get("max_abs_err", rec.get("o_max_abs_err")),
            "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": bound_ms, "bound_by": rec["bound_by"],
            "library_ms": rec["library_ms"],
        }

    b1 = "asyncframework_tpu/ops/pallas_kernels.py:58"
    f_rec = recs["f_ring_block_causal"]  # the ring's diagonal block
    s_task = recs["s_rcv1_task"]
    s_eval = recs["s_rcv1_shard"]["residual"]
    xla = "(XLA, no pallas_call)"
    # launches: each path's count, set to 0 just before it and read just
    # after; on the fused paths the launches captured a round times the
    # rounds replayed (tools/runs.py)
    emit({"kernels": [
        # the main paths' shapes: ASGD's compacted epsilon shard (b = 0.1;
        # phase 19 (a)'s dataset-API tasks too), ASAGA's full epsilon
        # shard, the ring block of the long-context path
        entry("masked_grad", "masked_grad.cu", b1, launches + sum(
            r["launches_on_path"]["masked_grad"]
            for r in (eps_fused, mnist_fused, mnist_run))
              + feat["masked_grad"] + dcn_launches["masked_grad"]
              + tel["masked_grad"] + shard_launches["masked_grad"]
              + standby_launches["masked_grad"]
              + mesh_launches["masked_grad"] + entry_launches["masked_grad"]
              + serving_launches["masked_grad"] + dg_launches["masked_grad"],
              recs["b_epsilon_idx"],
              recs["b_epsilon_idx"]["bound_us"] / 1e3),
        # phase 15 (e): the compacted form at the LibSVM file's task
        entry("masked_grad.file_task", "masked_grad.cu", b1,
              entry_launches["masked_grad_file"],
              recs["f_file_idx_2048x2000"],
              recs["f_file_idx_2048x2000"]["bound_us"] / 1e3),
        entry("masked_grad.saga_grad", "masked_grad.cu", b1,
              saga_launches["saga_grad"]
              + saga_fused["launches_on_path"]["saga_grad"]
              + entry_launches["saga_grad"],
              recs["saga_epsilon"], recs["saga_epsilon"]["bound_us"] / 1e3),
        entry("masked_grad.xt_coeff", "masked_grad.cu", b1,
              saga_launches["xt_coeff"] + mesh_launches["xt_coeff"]
              + entry_launches["xt_coeff"],
              recs["xt_epsilon"], recs["xt_epsilon"]["bound_us"] / 1e3),
        # the DCN ASAGA worker's per-slot form (the worker processes',
        # phase 14's mesh ranks too)
        entry("masked_grad.saga_slots_grad", "masked_grad.cu", b1,
              dcn_launches["saga_slots_grad"]
              + mesh_launches["saga_slots_grad"], recs["saga_slots_epsilon"],
              recs["saga_slots_epsilon"]["bound_us"] / 1e3),
        # phase 14: the full masked form at a DCN mesh rank's block (the
        # mesh workers' launches), saga_grad at MiniBatchSGD's rank block
        # (its 1-D least-squares runs, captured an iteration x iterations)
        entry("masked_grad.mesh_rank", "masked_grad.cu", b1,
              mesh_launches["masked_grad_mesh"], mesh_recs["mesh_rank_block"],
              mesh_recs["mesh_rank_block"]["bound_us"] / 1e3),
        entry("masked_grad.saga_grad.minibatch_rank", "masked_grad.cu", b1,
              mesh_launches["saga_grad"]
              + entry_launches["saga_grad_minibatch"],
              mesh_recs["saga_minibatch_rank"],
              mesh_recs["saga_minibatch_rank"]["bound_us"] / 1e3),
        # phases 17-18: the ML library's gradients on the whole epsilon
        # deployment and on its cross-validation folds (captured an
        # iteration x iterations; LBFGS's eager evaluations one each)
        entry("masked_grad.logistic_full", "masked_grad.cu", b1,
              ml_launches["masked_grad_logistic"]
              + breadth_launches["masked_grad_logistic"],
              recs["logreg_epsilon_full"],
              recs["logreg_epsilon_full"]["bound_us"] / 1e3),
        entry("masked_grad.xt_coeff.svm", "masked_grad.cu", b1,
              ml_launches["xt_coeff"], recs["xt_epsilon_full"],
              recs["xt_epsilon_full"]["bound_us"] / 1e3),
        entry("chunk_attention", "chunk_attention.cu",
              "asyncframework_tpu/ops/pallas_kernels.py:155", att_launches,
              f_rec, f_rec["bound_ms"]),
        # rcv1: no Pallas kernel on this path (XLA).  The task (residual,
        # sort and segment sum in one launch) at the compacted task, its
        # coefficient form at ASAGA's table delta, the residual alone at
        # the evaluation's full shard
        entry("sparse_grad.compacted_grad", "sparse_grad.cu",
              f"asyncframework_tpu/ops/steps.py:519 {xla}",
              s1_launches["compacted_grad"] + feat["compacted_grad"]
              + dcn_launches["compacted_grad"] + tel["compacted_grad"]
              + shard_launches["compacted_grad"]
              + standby_launches["compacted_grad"]
              + entry_launches["compacted_grad"],
              s_task["task"],
              s_task["task"]["bound_ms"]),
        entry("sparse_grad.saga_slots_grad", "sparse_grad.cu",
              f"asyncframework_tpu/ops/steps.py:904 {xla}",
              dcn_launches["sparse_saga_slots_grad"],
              recs["s_saga_slots_rcv1"],
              recs["s_saga_slots_rcv1"]["bound_ms"]),
        entry("sparse_grad.grad_sum", "sparse_grad.cu",
              f"asyncframework_tpu/ops/gradients.py:138 {xla}",
              s1_launches["grad_sum"] + feat["grad_sum"], s_task["grad_sum"],
              s_task["grad_sum"]["bound_ms"]),
        entry("sparse_grad.ell_residual", "sparse_grad.cu",
              f"asyncframework_tpu/ops/gradients.py:131 {xla}",
              s1_launches["ell_residual"] + feat["ell_residual"]
              + dcn_launches["ell_residual"] + tel["ell_residual"]
              + entry_launches["ell_residual"], s_eval,
              s_eval["bound_ms"]),
    ]})
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
