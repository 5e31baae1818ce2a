#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases (each raises on failure, so the script exits non-zero; nothing is
caught and passed over):

1. environment: the card's name and power limit (``nvidia-smi``), torch and
   CUDA versions; no CUDA device -> exit 2 with no result;
2. build: every CUDA source of the port, compiled with ``nvcc`` into
   ``build/``;
3. kernels vs plain: both hier_merge kernels against their plain PyTorch
   versions (and the sort-based oracle) on the card, at every registry job
   and at the main path's shapes, all four semirings, plus the edge cases
   of the merge-path design (one key ~5,000 times in the block, so its run
   crosses many tiles and the look-back carries it; an all-SENTINEL merge,
   nnz 0; all keys distinct, nnz = N; +-inf values under max.plus /
   min.plus; k = 2 with uneven runs; operands of any length, among them the
   depth-2 shape 3072 + 16384 + 131072 that the route rule sends to the
   sort route); keys and nnz exact, values exact for integer inputs and
   within rtol 1e-4 for float inputs (the order of float sums differs); per
   shape, the kernel's host-paced milliseconds, its device microseconds and
   kernels per call (``torch.profiler`` over 20 calls; at most 3 for
   ``merge_multi`` at k = 1, 2 for the pairwise merge), the plain version's
   and the sort route's milliseconds;
4. the main path at the full ``d4m_stream`` geometry: 32 instances, cuts
   (2048, 16384, 131072), block 1024, R-MAT scale 22, fused, lazy layer 0,
   grouped, ``--use-kernel``, 128 blocks in 16 rounds (4,194,304 updates),
   through ``repro_torch.launch.ingest``; then 4096 canon-mode and 32
   scan-mode point lookups per instance against the unflushed hierarchy,
   held against lookups after ``flush``;
5. the same stream with ``use_kernel=False``: every layer, spill, overflow
   and counter equal;
6. the layered oracle (8 instances, 32 blocks, ``--layered --lazy-l0 off
   --use-kernel``), which launches the pairwise kernel: its ``query_all``
   equals the fused run's on the same stream;
7. DCN-v2 serving at full width (``dcn_v2.config()``, ``use_kernel``: 26
   fields, a 94,306,304 x 16 f32 table, 6.04 GB on the card, drawn there
   from a seed): ``serve_scores`` at ``serve_p99`` (batch 512, median of 20
   calls) and ``serve_bulk`` (batch 262,144, examples/s), and
   ``retrieval_topk`` (k = 100 of 1,000,192 candidates); the embedding
   lookups of the kernel route bit-equal to the gather route's, scores
   within rtol 1e-6, top-k values equal to a sort of the same scores, and
   one ``embedding_bag`` launch per kernel-route call;
8. GNN inference at full width: ``graphcast.config()`` (16 layers, d 512,
   227 variables) on its processor graph, the r = 6 multimesh (40,962
   nodes, 327,660 edges), and ``gat_cora.config()`` on the
   ``full_graph_sm`` shape (2,708 nodes, 10,556 edges, 1,433 features):
   exactly 16 and 2 ``segment_sum`` launches per forward, and the kernel
   route within a max relative error of 1e-3 (GraphCast) and 1e-4 (GAT) of
   the ``index_add_`` route, with TF32 off; the aten operators run inside
   the 16 ``ops.segment_sum`` calls of one GraphCast forward hold no copy
   of the messages (no ``cat``, ``index``, ``gather``, ``index_select``);
9. the read-while-ingest service through ``repro_torch.launch.query`` at
   phase 4's geometry and stream (``--rounds 8 --queries 256 --top-k 8
   --use-kernel``): an ingest-only baseline, then the same stream with a
   256-query point-lookup batch and a top-k batch after every round.  Both
   runs end at counter 4,194,304 with overflow 0 and equal states; the
   query batches launched ``merge_multi`` 32 times each (the canon-mode
   layer-0 canonicalization); on the final live fleet, point lookups
   (canon and scan), ``extract_rows`` of the 8 heavy-hitter rows at
   2**22 columns (default width, and width 64 against the entries the
   window drops), ``range_total``, the degree vectors, ``spmv``,
   ``spmv_t``, ``ata_correlation``, ``row_occupancy`` and ``top_k_rows``
   equal, exactly, the same queries on each instance's flushed state or
   the reductions of its ``query_all``;
10. checkpoint, resume, elastic resize and contracts (``fault_phase``):
   phase 4's run with ``--ckpt-dir --ckpt-every 4``, its checkpoints of
   rounds 12 and 16 removed (a crash after round 10), then ``--resume``:
   the run restarts at round 8, launches ``merge_multi`` and ends equal to
   the uninterrupted run, leaf for leaf (the checkpoint's MiB and the wall
   time of ``save`` and ``restore`` printed); the final state saved and
   restored onto the CPU, equal; the fleet shrunk 32 -> 16 and grown
   32 -> 40 by ``runtime.rebalance_instances`` with the exact counter,
   overflow 0 and every key's total kept; a bfloat16 fleet (8 instances,
   32 blocks) whose kernel route launches ``merge_multi`` and equals the
   sort route, with ``top_k_rows`` equal to the float32 ranking of its
   totals; and under ``REPRO_CHECK=1`` a checked kernel-route ingest of 8
   instances that passes, and a checkpoint with a corrupted layer-1 tail
   that ``restore`` refuses, naming the invariant;
11. training at full width (``train_phase``): DCN-v2 (``dcn_v2.config()``,
   the 6.04 GB table, batch 65,536 = ``RECSYS_SHAPES["train_batch"]``)
   through ``launch/train.run_with_state``, dense for 4 steps and then
   ``--hier-embed`` for 4 (median step ms after the first, examples/s,
   peak GiB, host reads of a device flag per step, one step under
   ``device_profile``), then one ``make_train_step_hier`` step called
   directly with lr 0, embed_lr 1 and a drain every step, whose table
   equals the table minus the direct scatter of the embedding gradient
   (rtol 1e-4, atol 1e-5); GraphCast (``graphcast.config()``, remat) on
   phase 8's multimesh, regress task, 3 steps with the drawn processor
   weights scaled by ``GC_LAYER_SCALE`` (at its own init, whose loss and
   gradient norm are recorded first, the norm overflows float32), and its
   gradients with remat on and off at 2 layers, recorded with the default
   scatter-adds and equal within a max relative error of 1e-5 with
   ``torch.use_deterministic_algorithms``; GAT-Cora
   on phase 3's ``full_graph_sm`` graph, 5 steps; one GAT step on a
   ``minibatch_lg`` node flow (1,024 seeds, fanouts 15 and 10: 169,984
   nodes, 168,960 edges, ``seed_count`` 1,024) sampled from an R-MAT graph
   of 232,965 nodes and 114,615,892 edges with 602 features.  Each: finite
   losses and gnorms, a non-zero gradient for every parameter, and
   ``use_kernel=True`` refused with ``NotImplementedError`` (the kernels
   have no backward, as in the reference).  Then the train CLI at smoke
   size (``dcn-v2 --hier-embed``, ``gat-cora``) with ``--ckpt-every 4
   --fail-at-step 6``, each final loss equal to the uninterrupted run's
   within rtol 1e-5; and one step of each family on the card equal to the
   same step on the CPU (losses and gnorms within rtol 1e-4, parameters
   within rtol 1e-4 plus a tenth of one AdamW step);
12. the fleet across ranks (``fleet_phase``): phase 4's fleet and stream
   on P = 1, 2, 4 (and 8 where the process may use 8 cores) gloo ranks
   sharing the card, and on nccl with one rank a card where there are 2
   or more (``launch/mesh.spawn_fleet``).  Each rank draws each round's
   whole stream, keeps its block of instances, and runs
   ``sharded_ingest_fn`` between two barriers; rank 0 times the span, and
   the aggregate rate is 4,194,304 over the summed spans.  Exact checks:
   the ranks' blocks equal phase 4's fleet leaf for leaf; the fleet
   counter is 4,194,304 on every rank; ``global_degree_histogram_fn``
   (2**22 rows, 16 bins) equals the one the parent bins with numpy from
   phase 4's states; ``sharded_query_fn`` (canon, kernel) on 4,096 keys
   (live keys of every layer and instance, then random ones) equals
   ``reduce_axis`` over phase 4's per-instance scan lookups, and its
   per-instance blocks joined equal those lookups; the ranks' ingest
   merges summed equal phase 4's per route, every rank launched
   ``merge_multi``, and each canon call launched it once per instance.
   Then a max.plus and a min.plus fleet (phase 6's size, integer values
   in [1, 100)) on 2 ranks against one process.  Per P: the aggregate
   updates/s, each rank's rate and peak memory, the wall and the card;
   and one more round in every rank under ``torch.profiler``, after the
   checks: the kernel time of a card's ranks summed over the slowest
   rank's wall is that card's busy share (kernels of separate processes
   do not overlap);
13. LM serving through ``launch/serve`` (``serve_phase``), no kernel
   launched: (a) each LM arch's smoke config in float32 (TF32 off), one
   tree drawn on the CPU and copied to the card, prefill of [2, 16]
   prompts and 4 greedy steps on both, the last logits and every cache
   leaf within rtol 1e-4 / atol 1e-5 and the tokens equal; (b)
   ``granite-moe-3b-a800m``'s ``config()`` whole (32 layers, bf16, 6.6 GB
   drawn on the card) through ``serve.run_with_state`` at the CLI's
   defaults (batch 8, prompt 64, gen 32) after an untimed warm-up, then at
   prompt 1024, the decode loop under ``set_sync_debug_mode("error")``
   (and that guard shown to refuse a host read); (c) its decode == the
   teacher-forced ``forward`` in float32 with drop-free routing (capacity
   factor 8, or n_experts / top_k where larger; b 2, S 12), max relative
   error <= 1e-3 (the error at factor 8 alone is recorded, not checked); (d) ``deepseek-v2-236b`` at full width with its depth
   cut 60 -> 4 (33.87 GB in bf16) through ``serve.run_config`` at the
   defaults after an untimed warm-up, and its absorbed MLA decode == the
   naive forward at 1 layer in float32.  Per run: prefill and decode
   tok/s, decode ms a step (the decode is the captured ``serve.decode``:
   its warm-up and capture steps are left out of the timing), the
   weights' bytes over the card's memory rate, peak GiB, and one more
   eager decode step and one more prefill under ``device_profile`` (busy
   share, kernels, the top kernels).

14. LM training through ``launch/train`` (``train_lm_phase``), no kernel
   launched: (a) each LM arch's smoke config in float32 (TF32 off,
   deterministic algorithms), one tree drawn on the CPU and copied to the
   card, two ``make_train_step`` steps with nm 2 on the same batches on
   both: losses, gnorms within rtol 1e-4, params and AdamW moments within
   rtol 1e-4 / atol 1e-5 (lr 1e-4); on the card nm 2 == nm 1 for the
   dense archs and the gradients with remat on == off; (b)
   ``smollm-360m``'s ``config()`` whole (32 layers, bf16, 361,821,120
   params, nm 4, remat) through ``train.run_with_state`` at batch 4 x
   seq 4096 (``LM_SHAPES["train_4k"]``'s sequence, its global batch 256
   cut to 4), 4 steps of the captured ``train.lm_step`` (the eager
   warm-up and the capture untimed, then 2 replays timed), each step
   under the trainer's ``set_sync_debug_mode("error")``; (c) one ``--compress
   int8`` and one ``--compress topk`` step of it at 4 x 1024, then for
   every leaf decompressed + new error == gradient + old error and the
   leaf's wire bytes n + 4 / 8 k; (d) ``granite-moe-3b-a800m``'s
   ``config()`` whole (3,298,793,472 params, nm 8) at 8 x 1024 as (b);
   (e) the train CLI at smoke size for both, plain and int8, with
   ``--ckpt-every 4 --fail-at-step 6`` and cut at step 6 then
   ``--resume``d, under deterministic algorithms, each final loss within
   rtol 1e-5 of the uninterrupted run's.  (b) and (d) print the median
   step ms, tokens/s, peak GiB, a gradient of every leaf non-zero on one
   microbatch, and one more step under ``device_profile`` (busy share,
   kernels, the top kernels).

Phase 3 also holds both merges with float16 and bfloat16 values against
their plain versions under the four semirings (keys and nnz exact,
integer-valued payloads exact, normal ones within rtol 1e-2 for bf16 and
2e-3 for f16) and profiles them at the float32 rows' shapes, with the sort
route timed on the same 16-bit operands.  It also
holds the ``embedding_bag`` and ``segment_agg`` kernels against their
plain versions (and oracles) on their registry jobs, then
times kernel, plain version and the PyTorch library call computing the
same function (``F.embedding_bag``, ``index_add_``; timed only, never on
the path) at the paths' shapes: ``serve_bulk`` on the full table, and
GraphCast's processor graph.  ``segment_sum`` is held bit for bit against
its plain version, reading the unsorted messages through the sort order
and reading them gathered, at GraphCast's graph (D = 512), GAT-Cora's
(D = 64 and 7), a node with 5,000 edges, runs of exactly one chunk, empty
nodes, ids below 0 and at or above N, E = 0, D = 12, D = 640 and unaligned
rows, and against ``index_add_`` within rtol 2e-5 (``segment_checks``);
its row has the kernel's and the whole ``ops.segment_sum``'s milliseconds
and device µs and kernels per call, ``index_add_`` on the unsorted and on
the sorted messages, GAT-Cora's numbers, and under ``prev_shape`` the
kernel on the JAX kernel's staged operands (sorted messages, padded),
which the node-tiled kernel read.

15. the ``stages`` front door (``stages_phase``): (a) ``precompile_fleet``
   at phase 4's geometry with phase 9's query knobs makes every entry of
   ``fleet_jobs``, then a ``launch/ingest`` and a ``launch/query`` run
   with ``--obs`` add no lowering and no compile, and ``obs.jsonl`` holds
   one ``dispatch`` record per dispatch; (b) phase 9's canon batch (32
   instances x 256 lookups, ``use_kernel``) eager (``wrapped.fn``) and
   captured, 7 runs a side interleaved: answers equal exactly, 32
   ``merge_multi`` launches a replay, the bytes copied into the graph's
   inputs; (c) ``granite-moe-3b-a800m``'s ``config()`` whole decoding at
   batch 8, prompt 64, gen 32, 5 runs a side interleaved: tokens equal,
   logits bit-equal under deterministic algorithms; (d) its training step
   at 8 x 1024, nm 8, 6 steps a side each from the seed's state, under
   deterministic algorithms (losses and gnorms within rtol 1e-5) and
   again without (timed; its losses' difference recorded); and the five
   smoke configs' steps in float32 bit for bit; (e) a capture that reads the host refused (in a
   process of its own), every replay under
   ``set_sync_debug_mode("error")``.  Ms, tok/s, kernels a step, busy
   share and peak GiB per arm; the timings leave out the warm-up and
   capture dispatches.
16. the analysis layer (``analysis_phase``): (a) ``python -m
   repro_torch.analysis.palkit --check`` in a process of its
   own — the registry's jobs and the four kernels at phase 3's main-path
   shapes built, launched, held against their plain versions (K005), their
   launch configurations (from the C side) and resources checked (K001,
   K002) against ``analysis/SMEM_BUDGETS.json``; 0 fresh violations;
   (b) in it, the four compute-sanitizer tools (memcheck, initcheck,
   synccheck, racecheck) over those jobs, and where a tool cannot run on
   the machine the checked build (``-DREPRO_KERNEL_CHECKS``: bounds, two
   poisons, warp / barrier / bulk-copy checks; it has no race detector,
   so racecheck's class is then reported as not covered) — each tool's
   error count per kernel printed; (c) ``tracekit.audit_fleet`` at
   ``d4m_stream.config()`` with the kernel route, on the card: 0 fresh
   violations and no host read in ``service.point_query``, each entry's
   ``flops`` / ``bytes_accessed`` / ``peak_bytes`` beside its CPU budget
   at the smoke config, its host reads and launches a call; (d) each
   kernel's row of the kernels line gains ``regs``, ``smem_static``,
   ``smem_dynamic``, ``spill_bytes`` and ``sanitizer`` (one error count
   per tool, and what counted it; null, with the reason, for a tool whose
   class nothing checked).  Rehearse with
   ``tests/test_torch_chip_smoke.py::test_analysis_phase_on_cpu``.
17. the sharding layer (``sharding_phase``): (a) phase 10's checkpoint of
   the 32-instance fleet at round 8 restored with ``ckpt.restore(...,
   shardings=)`` under ``Shard(0)`` of the fleet's ``("data",)``
   ``DeviceMesh`` on P = 2 and 4 gloo ranks sharing the card (each rank
   reads its 32/P instances from disk), grown to 40 by
   ``rebalance_instances(..., sharding=)``, then the 8 remaining rounds
   of the grown fleet's stream through ``sharded_ingest_fn`` on the
   kernel route: the ranks' blocks joined equal one process's restore ->
   resize -> same rounds leaf for leaf, the fleet counter on every rank,
   overflow 0, every rank launched ``merge_multi``; (b) one
   ``transformer.make_train_step`` step under ``use_policy(make_policy
   (mesh))`` — parameters and AdamW moments placed by ``to_shardings
   (lm_param_specs(...))``, the batch by ``batch_sharding`` — of the
   five LM smoke configs (8 x 32; phi3-mini's is the reference's
   ``test_real_execution_on_mesh_matches_single``) and of
   ``smollm-360m`` whole (4 x 1024), float32, TF32 off, on a (2, 2)
   ``("data", "model")`` nccl mesh with 4 or more cards (one a rank),
   else a (1, 1) nccl mesh on the card: the loss within 5e-4 of the same
   step unsharded, every parameter within rtol 1e-4 plus a tenth of one
   lr step, every local shard's shape its spec's arithmetic; (d) on
   the machine's CPU, 4 gloo ranks on a (2, 2) mesh under
   ``make_policy(mesh, "dp")`` (the GNN and recsys cells' layout): two
   ``gnn.make_train_step`` steps of GAT (node loss on 16 seeds), GIN
   (batched molecules), GatedGCN and GraphCast (the r = 2 multimesh)
   smoke configs and one DCN-v2 dense step, each from the same
   parameters unsharded, losses within 5e-4, parameters within rtol
   1e-4 plus a tenth of one lr step, local shards as their specs; DCN-v2's
   ``serve_scores`` and ``retrieval_topk`` (candidates over both axes)
   sharded equal to unsharded (rtol 1e-6, top-k indices exact, no ties);
   (c) ``make_production_mesh`` under a fake process group of 256 and of 512
   ranks, in a child process each: every leaf of the five LM full
   configs, DCN-v2 and GraphCast on ``meta`` placed on it with the local
   shape its spec gives — shapes only, nothing runs.  Rehearse with
   ``tests/test_torch_chip_smoke.py::test_sharding_phase_on_cpu``.
18. the dry-run tooling (``dryrun_phase``): (a) on the card, through
   ``launch/cells.lower_cell``: the D4M ``ingest_small``, ``ingest_wide``
   and ``query`` cells at ``d4m_stream.config()`` on the kernel route
   (the fleet's one-rank mesh; ``merge_multi`` launches) and
   ``smollm-360m``'s train step at 4 x 1024 in float32, GraphCast's train
   step at ``minibatch_lg`` (full width: d 512, 16 layers, remat; a
   seeded graph at the node flow's 169,984 nodes and 168,960 edges) and
   DCN-v2's ``serve_bulk`` on the kernel route (the 6.04 GB table, batch
   262,144; ``embedding_bag`` launches, its scores held within rtol 1e-6
   of the gather route's on the same arguments) on a (1, 1) nccl
   mesh; each cell's recorded call (``cost_analysis``,
   ``memory_analysis``, the collectives of ``as_text``) and the same call
   timed (median of 3 after a warm-up, each ended by a synchronize); the
   roofline bound at the dtype's peak (``roofline/terms.py``) must not
   exceed the measured time; the fraction, its dominant term, the useful
   fraction (every op's flops counted as XLA counts the reference's),
   the recorded peak beside ``max_memory_allocated``; (b) on
   the machine's CPU, one child process a cell, started before (a) and
   run beside it: ``dryrun.run_cell`` on the production meshes under a
   fake group of 256 and 512 ranks for smollm-360m's and granite-moe's
   ``train_4k`` (granite's also on ``multi``), smollm's ``prefill_32k``
   and ``decode_32k``, a ``long_500k`` skip, DCN-v2's ``train_batch`` and
   GraphCast's ``ogb_products`` (the other three archs' ``train_4k``
   cells take minutes each: the dry-run CLI runs them):
   every status ``ok`` or ``skip``, collective bytes above 0,
   ``fits_hbm`` printed.  Rehearse
   with ``tests/test_torch_chip_smoke.py::test_dryrun_phase_on_cpu``.
19. the examples (``examples_phase``, run inside phase 18 after (a),
   while (b)'s children still record on the host): the four modules of
   ``repro_torch.examples`` at the reference's sizes, each in a spawned
   process of its own (``start_example``; quickstart, recsys and
   train_lm side by side, then stream_ingest alone, both of its runs in
   its process), and quickstart also as the plain command ``python -m
   repro_torch.examples.quickstart``:
   quickstart's values on the card equal to the same functions' values
   on the CPU; stream_ingest on the sort route and with ``use_kernel``
   — counter, overflow, nnz per layer and instance, degree histogram and
   tail exponent equal, the resumed counter an uninterrupted 6-round
   run's, no process group left, ``merge_multi`` launched; recsys'
   serving batch on the ``embedding_bag`` route within rtol 1e-6 of the
   gather route, ``embedding_bag`` launched; train_lm's own checks (the
   loss drops; the run with a failure injected at step 30 ends within
   1e-4 of the clean one).  Rehearse with
   ``tests/test_torch_chip_smoke.py::test_examples_phase_on_cpu``.

It prints phase 13's to 19's numbers as one JSON line each
(``{"serve": ...}``, ``{"train_lm": ...}``, ``{"stages": ...}``,
``{"analysis": ...}``, ``{"sharding": ...}``, ``{"dryrun": ...}``,
``{"examples": ...}``), the card line, one JSON
line with every kernel's numbers (the
``merge_multi`` row at the main path's shape 3072 + 16384, and under
``prev_shape`` at 4096 + 28672, the padded shape the main path passed when
the kernel took powers of two only; both merge rows carry their float16
and bfloat16 numbers under those keys), and as its last line
``{"ok": true, "device": {...}}``; the ``merge_multi`` row also
carries ``phase12_launches``, phase 12's launches summed over each
fleet's ranks, ``phase9_query_launches`` (phase 9's query batches: the
warm-up's eager batch, then replays; a captured graph's launches are
counted at each replay), ``phase9_replay_launches`` and
``phase15_launches_per_replay``, ``phase17_launches`` (phase 17
(a)'s, summed over each P's ranks) and ``phase18_launches`` (phase 18
(a)'s D4M cells: recorded, warm-up and timed calls) and
``phase19_launches`` (stream_ingest's ``use_kernel`` run); the
``embedding_bag`` row's ``phase18_launches`` are phase 18 (a)'s
``serve_bulk`` cell's, its ``phase19_launches`` the recsys example's
serving and retrieval.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
try:            # the card's rates live in one place: roofline/terms.py
    from repro_torch.roofline.terms import H100_F32_FLOPS, HW_H100
except ImportError:         # not a checkout: main() says so and exits 2
    H100_F32_FLOPS, HW_H100 = None, dict(hbm_bw=None)
HBM_BYTES_PER_S = HW_H100["hbm_bw"]     # H100 SXM device memory
OPS_PER_S = H100_F32_FLOPS      # H100 SXM float32 rate outside the tensor cores
TOL = 1e-4                     # registry merge rtol
# 16-bit merges: the order of 16-bit adds may differ from the plain
# version's, each add rounding (rtol, atol the same)
TOL16 = {"bfloat16": 1e-2, "float16": 2e-3}
SEMIRINGS = ("plus.times", "max.plus", "min.plus", "max.min")
DENSE_TOL = 2e-5               # registry embedding_bag / segment_agg rtol
SERVE_P99, SERVE_BULK = 512, 262_144          # RECSYS_SHAPES batches
DCN_TRAIN_BATCH = 65_536                      # RECSYS_SHAPES["train_batch"]
N_CANDIDATES = 1_000_192       # retrieval_cand's 1M padded to 256
VOCAB = 40_000_000             # the largest field: every field's ids span it


def phase(name):
    print(f"\n== {name}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warm: int = 3) -> float:
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def compare(got, want, exact_vals: bool, what: str, rtol: float = TOL,
            atol: float = 1e-6) -> float:
    """Keys and nnz exact, values exact or within rtol (TOL unless told);
    returns the largest absolute value difference over finite entries."""
    import torch
    for j, name in ((0, "hi"), (1, "lo"), (3, "nnz")):
        if not torch.equal(got[j], want[j]):
            raise AssertionError(f"{what}: {name} differs")
    g, w = got[2].double(), want[2].double()
    fin = torch.isfinite(w)
    if not torch.equal(torch.isfinite(g), fin) or \
            not torch.equal(g[~fin], w[~fin]):
        raise AssertionError(f"{what}: non-finite values differ")
    err = float((g[fin] - w[fin]).abs().max()) if fin.any() else 0.0
    if exact_vals and err != 0.0:
        raise AssertionError(f"{what}: integer values differ by {err}")
    if not torch.allclose(g[fin], w[fin], rtol=rtol, atol=atol):
        raise AssertionError(f"{what}: values differ by {err}")
    return err


def dense_compare(got, want, rtol: float, what: str) -> float:
    """Same shape and NaN pattern, values within rtol (atol = rtol);
    returns the largest absolute difference."""
    import torch
    if got.shape != want.shape:
        raise AssertionError(f"{what}: shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    g, w = got.double(), want.double()
    if not torch.equal(torch.isnan(g), torch.isnan(w)):
        raise AssertionError(f"{what}: NaN patterns differ")
    ok = ~torch.isnan(w)
    err = float((g[ok] - w[ok]).abs().max()) if bool(ok.any()) else 0.0
    if not torch.allclose(g[ok], w[ok], rtol=rtol, atol=rtol):
        raise AssertionError(f"{what}: values differ by {err}")
    return err


def roofline(nbytes: float, ops: float):
    """(ms, "bytes" | "operations"): the larger of the bytes over the
    card's memory rate and the float32 operations over its rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def merge_bound(sizes, first_sorted: bool, val_bytes: int = 4):
    """Least time for one merge of operands ``sizes`` (entries): each input
    read once and each output written once at the card's memory rate,
    against the operations at its rate: the unsorted block's sorting network
    (about 4 integer operations per compare-exchange) and, per merge of a
    sorted operand, about 8 per entry (compare, scan, count, compact).
    Returns (ms, "bytes" | "operations")."""
    import math
    n = sum(sizes)
    entry = 8 + val_bytes
    nbytes = n * entry + n * entry + 4
    cx, cum = 0, sizes[0]
    if not first_sorted and cum > 1:
        lg = math.ceil(math.log2(cum))
        cx += (1 << lg) // 2 * lg * (lg + 1) // 2
    ops = 4 * cx
    for s in sizes[1:]:
        cum += s
        ops += 8 * cum
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def kernel_phase(torch, registry, hm, assoc, sr_mod):
    """Phase 3; returns per-kernel numbers at the main path's shapes."""
    import numpy as np
    from repro_torch.launch.profile_merge import merge_profile
    SENT = hm.SENTINEL

    def cuda(x):
        return torch.as_tensor(np.ascontiguousarray(x), device="cuda")

    results = {"hier_merge.merge_multi": {}, "hier_merge.merge": {}}
    for job in registry.jobs():
        args = job.make_inputs(0)
        if job.family in ("embedding_bag", "segment_agg"):
            dev_args = tuple(cuda(x) for x in args)
            got = job.fn(*dev_args)
            plain = job.plain(*dev_args)
            err = dense_compare(got, plain, job.rtol, f"{job.name} vs plain")
            dense_compare(got, job.oracle(*dev_args), job.rtol,
                          f"{job.name} vs oracle")
            torch.cuda.synchronize()
            print(f"{job.name}: kernel == plain == oracle within rtol "
                  f"{job.rtol} (bit-equal to plain: "
                  f"{bool(torch.equal(got, plain))}, max_abs_err {err:.3g})",
                  flush=True)
            continue
        if job.counter == "hier_merge.merge_multi":
            bh, bl, bv, runs = args
            dev_args = (cuda(bh), cuda(bl), cuda(bv),
                        [tuple(cuda(x) for x in r) for r in runs])
        else:
            dev_args = tuple(cuda(x) for x in args)
        got = job.fn(*dev_args)
        exact = dev_args[2].dtype == torch.int32
        compare(got, job.plain(*dev_args), exact, f"{job.name} vs plain")
        compare(got, job.oracle(*dev_args), exact, f"{job.name} vs oracle")
        torch.cuda.synchronize()
        print(f"{job.name}: kernel == plain == oracle "
              f"(nnz {int(got[3][0])})", flush=True)

    rng = np.random.default_rng(7)

    def block(n, nkeys, dtype):
        h = rng.integers(0, nkeys, n).astype(np.int32)
        lo = rng.integers(-nkeys, nkeys, n).astype(np.int32)   # negative lo
        v = (rng.integers(1, 4, n) if dtype == np.int32
             else rng.normal(size=n)).astype(dtype)
        return cuda(h), cuda(lo), cuda(v)

    def canon(cap, nkeys, dtype, sr_name):
        maker_sr = "max.plus" if sr_name == "max.min" else sr_name
        return tuple(cuda(x) for x in registry._canonical_segment(
            rng, cap, nkeys, dtype, maker_sr))

    def distinct(n_block, n_run):
        """A block and a full run whose n_block + n_run keys are all
        distinct (negative hi and lo among them): nnz = N."""
        perm = rng.permutation(n_block + n_run)
        hi = (perm // 4096 - 4).astype(np.int32)
        lo = (perm % 4096 - 2048).astype(np.int32)
        val = rng.normal(size=perm.shape[0]).astype(np.float32)
        order = np.lexsort((lo[n_block:], hi[n_block:])) + n_block
        return [(cuda(hi[:n_block]), cuda(lo[:n_block]),
                 cuda(val[:n_block])),
                (cuda(hi[order]), cuda(lo[order]), cuda(val[order]))]

    def with_inf(ops):
        """Every tenth value +inf and every tenth (shifted) -inf."""
        out = []
        for h, lo, v in ops:
            v = v.clone()
            v[::10] = float("inf")
            v[5::10] = -float("inf")
            out.append((h, lo, v))
        return out

    hot = block(6144, 1 << 14, np.float32)
    hot[0][:5000], hot[1][:5000] = 7, -3            # one key 5,000 times
    hot_int = block(6144, 1 << 14, np.int32)
    hot_int[0][:5000], hot_int[1][:5000] = 7, -3
    def sentinels(n, val):
        return (torch.full((n,), SENT, dtype=torch.int32, device="cuda"),
                torch.full((n,), SENT, dtype=torch.int32, device="cuda"),
                val)

    empty = [sentinels(4096, cuda(rng.normal(size=4096).astype(np.float32))),
             sentinels(4096, torch.zeros(4096, device="cuda"))]

    # (kernel, label, operands, first_sorted, semiring, dtype)
    cases = []
    for sr_name in ("plus.times", "max.plus", "min.plus", "max.min"):
        cases.append(("hier_merge.merge_multi", f"k1 4096+28672 {sr_name}",
                      [block(4096, 1 << 14, np.float32),
                       canon(28672, 1 << 14, np.float32, sr_name)],
                      False, sr_name, np.float32))
    cases.append(("hier_merge.merge_multi", "k1 4096+28672 int32",
                  [block(4096, 1 << 14, np.int32),
                   canon(28672, 1 << 14, np.int32, "plus.times")],
                  False, "plus.times", np.int32))
    cases.append(("hier_merge.merge_multi", "k0 4096",
                  [block(4096, 1 << 10, np.float32)], False, "plus.times",
                  np.float32))
    cases.append(("hier_merge.merge", "pair 3072+1024",
                  [canon(3072, 1 << 12, np.float32, "plus.times"),
                   canon(1024, 1 << 12, np.float32, "plus.times")],
                  True, "plus.times", np.float32))
    cases.append(("hier_merge.merge", "pair 19456+13312",
                  [canon(19456, 1 << 14, np.float32, "plus.times"),
                   canon(13312, 1 << 14, np.float32, "plus.times")],
                  True, "plus.times", np.float32))
    # the merge-path design's edge cases and operands of any length
    cases.append(("hier_merge.merge_multi", "k1 3072+16384",
                  [block(3072, 1 << 14, np.float32),
                   canon(16384, 1 << 14, np.float32, "plus.times")],
                  False, "plus.times", np.float32))
    cases.append(("hier_merge.merge_multi", "k1 hot key 6144+16384",
                  [hot, canon(16384, 1 << 14, np.float32, "plus.times")],
                  False, "plus.times", np.float32))
    cases.append(("hier_merge.merge_multi", "k1 hot key 6144+16384 int32",
                  [hot_int, canon(16384, 1 << 14, np.int32, "plus.times")],
                  False, "plus.times", np.int32))
    cases.append(("hier_merge.merge_multi", "k1 all SENTINEL 4096+4096",
                  empty, False, "plus.times", np.float32))
    cases.append(("hier_merge.merge_multi", "k1 distinct 4096+28672",
                  distinct(4096, 28672), False, "plus.times", np.float32))
    for sr_name in ("max.plus", "min.plus"):
        cases.append(("hier_merge.merge_multi", f"k1 +-inf 4096+28672 "
                      f"{sr_name}",
                      with_inf([block(4096, 1 << 10, np.float32),
                                canon(28672, 1 << 10, np.float32,
                                      sr_name)]),
                      False, sr_name, np.float32))
    cases.append(("hier_merge.merge_multi", "k2 1000+3000+12345",
                  [block(1000, 1 << 10, np.float32),
                   canon(3000, 1 << 10, np.float32, "plus.times"),
                   canon(12345, 1 << 10, np.float32, "plus.times")],
                  False, "plus.times", np.float32))
    cases.append(("hier_merge.merge_multi", "k2 3072+16384+131072",
                  [block(3072, 1 << 16, np.float32),
                   canon(16384, 1 << 16, np.float32, "plus.times"),
                   canon(131072, 1 << 16, np.float32, "plus.times")],
                  False, "plus.times", np.float32))
    cases.append(("hier_merge.merge", "pair 19000+13000",
                  [canon(19000, 1 << 14, np.float32, "plus.times"),
                   canon(13000, 1 << 14, np.float32, "plus.times")],
                  True, "plus.times", np.float32))

    for kname, label, ops, first_sorted, sr_name, dtype in cases:
        if first_sorted:
            def kern(ops=ops, sr_name=sr_name):
                return hm.merge_cuda(*ops[0], *ops[1], sr_name=sr_name)

            def plain(ops=ops, sr_name=sr_name):
                return hm.merge_plain(*ops[0], *ops[1], sr_name=sr_name)
        else:
            def kern(ops=ops, sr_name=sr_name):
                return hm.merge_multi_cuda(ops[0], ops[1:], sr_name=sr_name)

            def plain(ops=ops, sr_name=sr_name):
                return hm.merge_multi_plain(ops[0], ops[1:], sr_name=sr_name)
        n = sum(o[0].shape[0] for o in ops)
        sr = sr_mod.get(sr_name)

        def sort_route(ops=ops, sr=sr, n=n):
            return assoc._canonicalize(torch.cat([o[0] for o in ops]),
                                       torch.cat([o[1] for o in ops]),
                                       torch.cat([o[2] for o in ops]), n, sr)

        got = kern()
        err = compare(got, plain(), dtype == np.int32, f"{label} vs plain")
        seg, _ = sort_route()
        compare(got, (seg.hi, seg.lo, seg.val, seg.nnz.reshape(1)),
                dtype == np.int32, f"{label} vs sort route")
        nnz = int(got[3][0])
        if (label.startswith("k1 all SENTINEL") and nnz != 0) or \
                (label.startswith("k1 distinct") and nnz != n):
            raise AssertionError(f"{label}: nnz {nnz}")
        prof = merge_profile(torch, kern)
        names = " ".join(prof["kernels"])
        for old in ("place_kernel", "bitonic_global", "scan_carries"):
            if old in names:
                raise AssertionError(f"{label}: launched {old}")
        limit = 2 if first_sorted else 3 if label.startswith("k1") else None
        if limit is not None and prof["kernels_per_call"] > limit:
            raise AssertionError(f"{label}: {prof['kernels_per_call']} "
                                 f"kernels per call > {limit}: "
                                 f"{prof['kernels']}")
        ms, plain_ms, sort_ms = time_ms(kern), time_ms(plain, 5, 1), \
            time_ms(sort_route)
        bound_ms, bound_by = merge_bound([o[0].shape[0] for o in ops],
                                         first_sorted)
        print(f"{kname} {label}: N={n} nnz {nnz} kernel {ms:.4f} ms, "
              f"device_us {prof['device_us']:.2f}, kernels_per_call "
              f"{prof['kernels_per_call']:g}, plain {plain_ms:.4f} ms, sort "
              f"route {sort_ms:.4f} ms, bound {bound_ms:.6f} ms "
              f"({bound_by}), max_abs_err {err:.3g}; {prof['kernels']}",
              flush=True)
        rec = results[kname]
        rec["max_abs_err"] = max(rec.get("max_abs_err", 0.0), err)
        # the row reported for each kernel: its main-path shape; for
        # merge_multi also the padded shape the main path passed when the
        # kernel took powers of two only, so rows compare across versions
        if label in ("k1 3072+16384", "pair 19456+13312"):
            rec.update(shape=label, N=n, ms=ms, plain_ms=plain_ms,
                       sort_route_ms=sort_ms, bound_ms=bound_ms,
                       bound_by=bound_by, device_us=prof["device_us"],
                       kernels_per_call=prof["kernels_per_call"])
        elif label == "k1 4096+28672 plus.times":
            rec["prev_shape"] = dict(
                shape=label, N=n, ms=ms, plain_ms=plain_ms,
                sort_route_ms=sort_ms, bound_ms=bound_ms,
                device_us=prof["device_us"],
                kernels_per_call=prof["kernels_per_call"])
    merge16_checks(torch, hm, canon, block, compare, results, assoc, sr_mod)
    return results


def merge16_checks(torch, hm, canon, block, compare, results, assoc,
                   sr_mod):
    """Both merges with float16 and bfloat16 values, under the four
    semirings, against their plain versions on the card: keys and nnz
    exact, integer-valued payloads (|v| <= 200, exact in 16 bits) exact,
    normal payloads within TOL16; then each kernel's device µs, kernels
    per call and host-paced ms at the main path's shapes (plus.times,
    normal payloads), beside the float32 row, with the byte bound at
    2-byte values, and the sort route's ms on the same operands (held
    against the kernel within TOL16)."""
    import numpy as np
    from repro_torch.launch.profile_merge import merge_profile

    def as16(ops, tdt, integer):
        out = []
        for h, lo, v in ops:
            if integer:
                v = torch.round(v * 50)      # +-inf stay +-inf
            out.append((h, lo, v.to(tdt)))
        return out

    for dtype, rtol in TOL16.items():
        tdt = getattr(torch, dtype)
        for kname, shape in (("hier_merge.merge_multi", (3072, 16384)),
                             ("hier_merge.merge", (19456, 13312))):
            first_sorted = kname == "hier_merge.merge"
            rec = results[kname].setdefault(dtype, dict(max_abs_err=0.0))
            for sr_name in SEMIRINGS:
                for integer in (True, False):
                    ops = [canon(c, 1 << 14, np.float32, sr_name)
                           if first_sorted or i else
                           block(c, 1 << 14, np.float32)
                           for i, c in enumerate(shape)]
                    ops = as16(ops, tdt, integer)
                    if first_sorted:
                        def kern(ops=ops, sr_name=sr_name):
                            return hm.merge_cuda(*ops[0], *ops[1],
                                                 sr_name=sr_name)

                        def plain(ops=ops, sr_name=sr_name):
                            return hm.merge_plain(*ops[0], *ops[1],
                                                  sr_name=sr_name)
                    else:
                        def kern(ops=ops, sr_name=sr_name):
                            return hm.merge_multi_cuda(ops[0], ops[1:],
                                                       sr_name=sr_name)

                        def plain(ops=ops, sr_name=sr_name):
                            return hm.merge_multi_plain(ops[0], ops[1:],
                                                        sr_name=sr_name)
                    got = kern()
                    label = (f"{kname} {dtype} {sr_name} "
                             f"{'integer' if integer else 'normal'}")
                    if got[2].dtype != tdt:
                        raise AssertionError(f"{label}: values came back "
                                             f"{got[2].dtype}")
                    err = compare(got, plain(), integer, f"{label} vs plain",
                                  rtol=rtol, atol=rtol)
                    rec["max_abs_err"] = max(rec["max_abs_err"], err)
                    if sr_name != "plus.times" or integer:
                        continue
                    n, sr = sum(shape), sr_mod.get(sr_name)

                    def sort_route(ops=ops, sr=sr, n=n):
                        return assoc._canonicalize(
                            torch.cat([o[0] for o in ops]),
                            torch.cat([o[1] for o in ops]),
                            torch.cat([o[2] for o in ops]), n, sr)

                    seg, _ = sort_route()
                    compare(got, (seg.hi, seg.lo, seg.val,
                                  seg.nnz.reshape(1)), False,
                            f"{label} vs sort route", rtol=rtol, atol=rtol)
                    prof = merge_profile(torch, kern)
                    ms, plain_ms = time_ms(kern), time_ms(plain, 5, 1)
                    sort_ms = time_ms(sort_route)
                    bound_ms, bound_by = merge_bound(list(shape),
                                                     first_sorted,
                                                     val_bytes=2)
                    rec.update(shape="+".join(map(str, shape)), ms=ms,
                               plain_ms=plain_ms, sort_route_ms=sort_ms,
                               bound_ms=bound_ms, bound_by=bound_by,
                               device_us=prof["device_us"],
                               kernels_per_call=prof["kernels_per_call"])
                    print(f"{label} {rec['shape']}: nnz {int(got[3][0])} "
                          f"kernel {ms:.4f} ms, device_us "
                          f"{prof['device_us']:.2f}, kernels_per_call "
                          f"{prof['kernels_per_call']:g}, plain "
                          f"{plain_ms:.4f} ms, sort route {sort_ms:.4f} "
                          f"ms, bound {bound_ms:.6f} ms ({bound_by}); "
                          f"{prof['kernels']}", flush=True)
            print(f"{kname} {dtype}: == plain under the four semirings "
                  f"(integer payloads exact, normal within rtol {rtol}; "
                  f"max_abs_err {rec['max_abs_err']:.3g})", flush=True)


def path_kernel_phase(torch, mesh, gat_dst):
    """Phase 3, second part: the embedding_bag and segment_sum kernels at
    their paths' shapes against their plain versions and the library
    calls; returns each kernel's numbers."""
    import torch.nn.functional as F
    from repro_torch.configs import dcn_v2
    from repro_torch.data import synthetic
    from repro_torch.kernels.embedding_bag import embedding_bag as eb
    from repro_torch.launch.profile_merge import merge_profile
    from repro_torch.models import dcn

    def measure(name, shape, kern, plain, library, nbytes, ops):
        got = kern()
        want = plain()
        err = dense_compare(got, want, DENSE_TOL, f"{name} vs plain")
        lib = library()
        dense_compare(got[:lib.shape[0]], lib, DENSE_TOL,
                      f"{name} vs library call")
        exact = bool(torch.equal(got, want))
        ms, plain_ms, lib_ms = time_ms(kern), time_ms(plain, 5, 1), \
            time_ms(library)
        bound_ms, bound_by = roofline(nbytes, ops)
        prof = merge_profile(torch, kern)
        print(f"{name} {shape}: kernel {ms:.4f} ms, plain {plain_ms:.4f} "
              f"ms, library {lib_ms:.4f} ms, bound {bound_ms:.4f} ms "
              f"({bound_by}), bit-equal to plain: {exact}, max_abs_err "
              f"{err:.3g}, device_us {prof['device_us']:.2f}, "
              f"kernels_per_call {prof['kernels_per_call']:g}", flush=True)
        return dict(shape=shape, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                    bound_ms=bound_ms, bound_by=bound_by, max_abs_err=err,
                    sort_route_ms=None, device_us=prof["device_us"],
                    kernels_per_call=prof["kernels_per_call"])

    out = {}
    cfg = dcn_v2.config()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    table = torch.randn((cfg.padded_rows, cfg.embed_dim), generator=gen,
                        device="cuda").mul_(0.01)
    sparse = synthetic.recsys_batch(3, SERVE_BULK, cfg.n_dense, cfg.n_sparse,
                                    VOCAB, cfg.multi_hot,
                                    device="cuda")["sparse"]
    idx = dcn.global_ids(sparse, cfg).reshape(-1, cfg.multi_hot) \
        .contiguous()
    w = torch.ones(idx.shape, dtype=torch.float32, device="cuda")
    idx64 = idx.long()                  # the library call takes int64 ids
    b, l, d = idx.shape[0], idx.shape[1], cfg.embed_dim
    out["embedding_bag.embedding_bag"] = measure(
        "embedding_bag.embedding_bag",
        f"serve_bulk B={b} L={l} D={d} V={cfg.padded_rows}",
        lambda: eb.embedding_bag_cuda(table, idx, w),
        lambda: eb.embedding_bag_plain(table, idx, w),
        lambda: F.embedding_bag(idx64, table, mode="sum",
                                per_sample_weights=w),
        b * l * (4 * d + 8) + 4 * b * d, 2 * b * l * d)
    del table, sparse, idx, w, idx64
    torch.cuda.empty_cache()

    out["segment_agg.segment_sum"] = segment_phase(torch, gen, mesh,
                                                   gat_dst)
    return out


# kernel names of an [E, D] copy: torch.cat, an advanced-index gather,
# index_select
COPY_KERNELS = ("catarray", "gather", "index_elementwise", "indexselect")


def segment_case_list(np, mesh, gat_dst):
    """Phase 3's segment_sum cases: (label, ids [E] int32, N, D, values),
    values "normal" or "dyadic" (multiples of 1/8, whose sums are exact in
    any order)."""
    from repro_torch.kernels.segment_agg.segment_agg import CHUNK
    rng = np.random.default_rng(3)
    hub = rng.integers(0, 1000, 8000).astype(np.int32)
    hub[rng.permutation(8000)[:5000]] = 17          # 5,000 edges to node 17
    gaps = rng.integers(0, 5000, 3000).astype(np.int32)
    gaps[(gaps > 1000) & (gaps < 4000)] = 1000      # nodes 1001..3999 empty
    n_gat = 2708
    return [
        ("graphcast r6", np.asarray(mesh[2]), len(mesh[0]), 512, "normal"),
        ("gat-cora D=64", gat_dst, n_gat, 64, "normal"),
        ("gat-cora D=7", gat_dst, n_gat, 7, "normal"),
        ("hub 5000 of 8000", hub, 1000, 128, "normal"),
        ("hub 5000 of 8000 dyadic", hub, 1000, 128, "dyadic"),
        ("runs of one chunk", np.repeat(np.arange(100, dtype=np.int32),
                                        CHUNK)[rng.permutation(100 * CHUNK)],
         100, 64, "normal"),
        ("empty nodes", gaps, 5000, 32, "normal"),
        ("dropped ids", rng.integers(-50, 1050, 4000).astype(np.int32), 1000,
         64, "normal"),
        ("E=0", np.zeros(0, np.int32), 300, 16, "normal"),
        ("D=12", rng.integers(0, 500, 2000).astype(np.int32), 500, 12,
         "normal"),
        ("D=640 two slices", rng.integers(0, 3000, 20000).astype(np.int32),
         3000, 640, "normal"),
        ("gat-cora D=64 unaligned rows", gat_dst, n_gat, 64, "unaligned"),
    ]


def segment_checks(torch, gen, cases, device="cuda"):
    """Each case through ``segment_sum_cuda`` with ``order`` (the unsorted
    messages read in place) and without (the gathered, sorted messages),
    both equal to ``segment_sum_plain`` and to each other bit for bit;
    ``ops.segment_sum`` (and with ``assume_sorted`` on the sorted ones)
    equal to them; and against ``index_add_`` within rtol 2e-5, exactly
    for dyadic values.  The 5,000-edge hub with normal values is not held
    against ``index_add_``: its 5,000-term sums cancel to near 0 in some
    columns, where two float32 orders of addition differ by more than
    2e-5 (its dyadic twin checks the same edges exactly).  Returns the
    largest difference from ``index_add_``."""
    from repro_torch.kernels.segment_agg import ops as sa_ops
    from repro_torch.kernels.segment_agg import ref as sa_ref
    from repro_torch.kernels.segment_agg import segment_agg as sa
    worst = 0.0
    for label, ids, n, d, values in cases:
        seg = torch.as_tensor(ids, device=device)
        e = seg.shape[0]
        msg = torch.randn((e, d), generator=gen, device=device)
        if values == "dyadic":
            msg = torch.round(msg * 8) / 8
        elif values == "unaligned":
            buf = torch.empty(e * d + 1, device=device)
            buf[1:] = msg.reshape(-1)
            msg = buf[1:].view(e, d)              # rows 4 bytes off 16
        order, s, starts, t = sa_ops.stage(seg, num_segments=n)
        msg_sorted = msg[order.long()]
        got = sa.segment_sum_cuda(msg, s, starts, t, order=order)
        got_sorted = sa.segment_sum_cuda(msg_sorted, s, starts, t)
        for what, x in (
                ("plain with order",
                 sa.segment_sum_plain(msg, s, starts, t, order=order)),
                ("kernel without order", got_sorted),
                ("plain without order",
                 sa.segment_sum_plain(msg_sorted, s, starts, t)),
                ("ops.segment_sum",
                 sa_ops.segment_sum(msg, seg, num_segments=n)),
                ("ops.segment_sum assume_sorted",
                 sa_ops.segment_sum(msg_sorted, s, num_segments=n,
                                    assume_sorted=True))):
            if not torch.equal(got[:x.shape[0]], x):
                raise AssertionError(f"segment_sum {label}: kernel with "
                                     f"order != {what}")
        lib = sa_ref.segment_sum_ref(msg, seg, n)
        if values == "dyadic" and not torch.equal(got[:n], lib):
            raise AssertionError(f"segment_sum {label}: != index_add_")
        if label != "hub 5000 of 8000":
            worst = max(worst, dense_compare(got[:n], lib, DENSE_TOL,
                                             f"segment_sum {label} vs "
                                             f"index_add_"))
        print(f"segment_sum {label}: E={e} D={d} N={n}: kernel with and "
              f"without order == plain == ops.segment_sum, bit for bit",
              flush=True)
    return worst


def segment_phase(torch, gen, mesh, gat_dst):
    """Phase 3, segment_sum: the checks of ``segment_checks``, then at
    GraphCast's processor graph the kernel (messages read through the sort
    order), the whole ``ops.segment_sum``, the plain version, and
    ``index_add_`` on the unsorted messages (the same function as
    ``ops.segment_sum``) and on the sorted ones, with device µs and
    kernels per call; the kernel on the JAX kernel's staged operands
    (sorted messages padded to ceil(E/128)*128 + 128 rows) as
    ``prev_shape``; and GAT-Cora's graph at D = 64."""
    import numpy as np
    from repro_torch.kernels.segment_agg import ops as sa_ops
    from repro_torch.kernels.segment_agg import ref as sa_ref
    from repro_torch.kernels.segment_agg import segment_agg as sa
    from repro_torch.launch.profile_merge import merge_profile

    worst = segment_checks(torch, gen, segment_case_list(np, mesh, gat_dst))

    def measure(n, d, dst):
        seg = torch.as_tensor(dst, device="cuda")
        e = seg.shape[0]
        msg = torch.randn((e, d), generator=gen, device="cuda")
        order, s, starts, t = sa_ops.stage(seg, num_segments=n)
        msg_sorted = msg[order.long()]
        seg64, sorted64 = seg.long(), s.long()

        def kern():
            return sa.segment_sum_cuda(msg, s, starts, t, order=order)

        def ops_call():
            return sa_ops.segment_sum(msg, seg, num_segments=n)

        prof, ops_prof = merge_profile(torch, kern), merge_profile(torch,
                                                                   ops_call)
        copies = [k for k in ops_prof["kernels"]
                  if any(c in k.lower() for c in COPY_KERNELS)]
        if copies:
            raise AssertionError(f"ops.segment_sum copies the messages: "
                                 f"{copies}")
        bound_ms, bound_by = roofline(e * (4 * d + 4) + 4 * n * d, e * d)
        err = float((kern() - sa.segment_sum_plain(msg, s, starts, t,
                                                   order=order))
                    .abs().max())
        rec = dict(
            shape=f"E={e} D={d} N={n}", max_abs_err=err, ms=time_ms(kern),
            ops_ms=time_ms(ops_call),
            plain_ms=time_ms(lambda: sa.segment_sum_plain(
                msg, s, starts, t, order=order), 5, 1),
            library_ms=time_ms(lambda: torch.zeros(
                (n, d), device="cuda").index_add_(0, seg64, msg)),
            library_sorted_ms=time_ms(lambda: torch.zeros(
                (n, d), device="cuda").index_add_(0, sorted64, msg_sorted)),
            bound_ms=bound_ms, bound_by=bound_by,
            device_us=prof["device_us"],
            kernels_per_call=prof["kernels_per_call"],
            ops_device_us=ops_prof["device_us"],
            ops_kernels_per_call=ops_prof["kernels_per_call"],
            ops_kernels=ops_prof["kernels"])
        return rec, (msg, seg, s, starts, t, order)

    n = len(mesh[0])
    gc, (msg, seg, s, starts, t, order) = measure(n, 512, np.asarray(mesh[2]))
    e, d = msg.shape
    # the JAX kernel's staged operands: sorted messages, a spare block
    m_pad, s_pad, st_pad, t_pad = sa_ref.staged_operands(msg, seg, n)
    e_pad = m_pad.shape[0]
    if not torch.equal(sa.segment_sum_cuda(m_pad, s_pad, st_pad, t_pad),
                       sa.segment_sum_cuda(msg, s, starts, t, order=order)):
        raise AssertionError("segment_sum: staged operands != order")
    prev = merge_profile(torch, lambda: sa.segment_sum_cuda(m_pad, s_pad,
                                                            st_pad, t_pad))
    gc["prev_shape"] = dict(
        shape=f"staged (sorted, padded) E_pad={e_pad} D={d}",
        ms=time_ms(lambda: sa.segment_sum_cuda(m_pad, s_pad, st_pad, t_pad)),
        device_us=prev["device_us"], kernels_per_call=prev["kernels_per_call"],
        bound_ms=roofline(e_pad * (4 * d + 4) + 4 * t * sa_ops.TN * d,
                          e * d)[0])
    del m_pad, s_pad, msg
    gat, _ = measure(2708, 64, gat_dst)
    gc.update(shape=f"graphcast r6 {gc['shape']}",
              max_abs_err_vs_index_add=worst, sort_route_ms=None,
              gat_cora={k: gat[k] for k in (
                  "shape", "max_abs_err", "ms", "ops_ms", "plain_ms",
                  "library_ms", "bound_ms", "device_us", "kernels_per_call",
                  "ops_device_us", "ops_kernels_per_call")})
    print("segment_agg.segment_sum: " + json.dumps(gc), flush=True)
    return gc


def device_profile(torch, fn, top: int = 6) -> dict:
    """One call of ``fn`` under ``torch.profiler`` after a synchronize:
    its wall, the summed device time of its kernels, their share of the
    wall, and the ``top`` kernels by device time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = device_events(torch, prof)
    device_us = sum(us for _, us in by_name.values())
    return dict(wall_ms=wall * 1e3, device_ms=device_us / 1e3,
                device_busy_share=device_us / 1e6 / wall,
                kernels=sum(n for n, _ in by_name.values()),
                top=[dict(name=name[:60], calls=n, device_ms=us / 1e3)
                     for name, (n, us) in sorted(
                         by_name.items(), key=lambda kv: -kv[1][1])[:top]])


def device_events(torch, prof) -> dict:
    """{name: (count, device µs)} of the device's events (kernels, copies,
    fills) in a finished profile, read from the trace itself: the
    profiler's ``key_averages`` first builds a Python object per event of
    the host and the device, which for a training step's ~10**5 kernels
    takes longer than the step."""
    out = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        us = (e.end_ns() - e.start_ns()) / 1e3
        if us > 0:
            n, total = out.get(e.name(), (0, 0.0))
            out[e.name()] = (n + 1, total + us)
    return out


def timed(torch, fn, reps: int, warm: int):
    """(last result, median seconds) of ``reps`` calls after ``warm``, each
    ended by a synchronize on the card."""
    sync = torch.cuda.synchronize if torch.cuda.is_available() else \
        (lambda: None)
    for _ in range(warm):
        fn()
    secs = []
    for _ in range(reps):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        secs.append(time.perf_counter() - t0)
    return out, sorted(secs)[len(secs) // 2]


def dcn_phase(torch, cfg, device, *, p99_batch=SERVE_P99,
              bulk_batch=SERVE_BULK, n_candidates=N_CANDIDATES,
              vocab=VOCAB, k=100):
    """Phase 7: DCN-v2 serving through the kernel route, checked against
    the gather route.  Returns the numbers it printed."""
    from repro_torch.data import synthetic
    from repro_torch.kernels import registry
    from repro_torch.models import dcn

    ref_cfg = dataclasses.replace(cfg, use_kernel=False)
    params = dcn.init(0, cfg, device=device)
    p99, bulk, query = (
        synthetic.recsys_batch(seed, b, cfg.n_dense, cfg.n_sparse, vocab,
                               cfg.multi_hot, device=device)
        for seed, b in ((11, p99_batch), (12, bulk_batch), (13, 1)))
    cands = synthetic.retrieval_batch(14, 1, n_candidates, cfg.mlp[-1],
                                      device=device)["candidates"]
    registry.reset_launches()
    scores_p99, p99_s = timed(torch, lambda: dcn.serve_scores(params, p99,
                                                              cfg), 20, 3)
    scores, bulk_s = timed(torch, lambda: dcn.serve_scores(params, bulk, cfg),
                           5, 1)
    emb = dcn.embed_lookup(params.table, bulk["sparse"], cfg)
    (vals, idx), topk_s = timed(
        torch, lambda: dcn.retrieval_topk(params, query, cands, cfg, k=k),
        10, 2)
    calls = 23 + 6 + 1 + 12
    launches = registry.launches()["embedding_bag.embedding_bag"]
    want_launches = calls if torch.device(device).type == "cuda" else 0
    if launches != want_launches:
        raise AssertionError(f"embedding_bag launched {launches} times for "
                             f"{calls} kernel-route calls")

    for x, b in ((scores_p99, p99_batch), (scores, bulk_batch)):
        if x.shape != (b,) or not bool(((x > 0) & (x < 1)).all()):
            raise AssertionError("scores are not probabilities of shape [B]")
    if not torch.equal(emb, dcn.embed_lookup(params.table, bulk["sparse"],
                                             ref_cfg)):
        raise AssertionError("kernel-route embeddings != gather route's")
    ref = dcn.serve_scores(params, bulk, ref_cfg)
    score_err = float((scores - ref).abs().max())
    if not torch.allclose(scores, ref, rtol=1e-6, atol=0.0):
        raise AssertionError(f"kernel-route scores differ by {score_err}")
    all_scores = dcn.query_embedding(params, query, ref_cfg) @ cands.T
    want = torch.sort(all_scores, dim=-1, descending=True).values[:, :k]
    if vals.shape != (1, k) or not torch.allclose(vals, want, rtol=1e-6,
                                                  atol=0.0):
        raise AssertionError("top-k values != a sort of the same scores")
    if not torch.allclose(all_scores[0, idx[0].long()], vals[0], rtol=1e-6,
                          atol=0.0):
        raise AssertionError("top-k indices do not point at their values")
    if registry.launches()["embedding_bag.embedding_bag"] != launches:
        raise AssertionError("the gather route launched the kernel")
    if torch.device(device).type == "cuda":
        for name, batch in (("serve_bulk", bulk), ("serve_p99", p99)):
            print(f"profile {name}: " + json.dumps(device_profile(
                torch, lambda b=batch: dcn.serve_scores(params, b, cfg))),
                flush=True)
    res = dict(serve_p99_ms=p99_s * 1e3, serve_bulk_ms=bulk_s * 1e3,
               serve_bulk_examples_per_s=bulk_batch / bulk_s,
               retrieval_topk_ms=topk_s * 1e3, launches=launches,
               kernel_route_calls=calls, max_score_diff=score_err)
    print(json.dumps(res), flush=True)
    return res


def gnn_forwards(torch, cfg, graph, d_feat, n_out, reps):
    """``reps`` timed kernel-route forwards after one warm-up; returns
    (params, output, median ms, calls)."""
    from repro_torch.models import gnn
    params = gnn.init(0, cfg, d_feat, n_out, device=graph["node_feat"].device)
    out, secs = timed(torch, lambda: gnn.forward(params, cfg, graph), reps, 1)
    if out.shape != (graph["node_feat"].shape[0], n_out) or \
            not bool(torch.isfinite(out).all()):
        raise AssertionError(f"{cfg.name}: output not finite of shape "
                             f"[N, {n_out}]")
    return params, out, secs * 1e3, reps + 1


def gnn_phase(torch, gc_cfg, gc_graph, gat_cfg, gat_graph, n_classes, *,
              reps=2):
    """Phase 8: GraphCast and GAT-Cora forwards through the kernel route,
    checked against the index_add_ route.  Returns the numbers it
    printed."""
    from repro_torch.kernels import registry
    from repro_torch.models import gnn

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmuls are on")
    on_card = gc_graph["node_feat"].device.type == "cuda"
    key = "segment_agg.segment_sum"
    registry.reset_launches()
    gc_params, gc_out, gc_ms, gc_calls = gnn_forwards(
        torch, gc_cfg, gc_graph, gc_cfg.n_vars, gc_cfg.n_vars, reps)
    gc_launches = registry.launches()[key]
    gat_params, gat_out, gat_ms, gat_calls = gnn_forwards(
        torch, gat_cfg, gat_graph, gat_graph["node_feat"].shape[1], n_classes,
        reps)
    launches = registry.launches()[key]
    per_fwd = (gc_launches / gc_calls, (launches - gc_launches) / gat_calls)
    if on_card and per_fwd != (gc_cfg.n_layers, gat_cfg.n_layers):
        raise AssertionError(f"segment_sum launches per forward {per_fwd}, "
                             f"want ({gc_cfg.n_layers}, {gat_cfg.n_layers})")
    res = dict(launches=launches, launches_per_forward=per_fwd,
               graphcast_ms=gc_ms, gat_ms=gat_ms)
    for name, params, cfg, graph, out, bound in (
            ("graphcast", gc_params, gc_cfg, gc_graph, gc_out, 1e-3),
            ("gat", gat_params, gat_cfg, gat_graph, gat_out, 1e-4)):
        ref = gnn.forward(params, dataclasses.replace(cfg, use_kernel=False),
                          graph)
        rel = float((out - ref).abs().max() / ref.abs().max())
        res[f"{name}_max_rel_err"] = rel
        if not rel <= bound:
            raise AssertionError(f"{name}: kernel route vs index_add_ route "
                                 f"max relative error {rel} > {bound}")
    if registry.launches()[key] != launches:
        raise AssertionError("the index_add_ route launched the kernel")
    calls, staging = segment_staging_ops(
        torch, lambda: gnn.forward(gc_params, gc_cfg, gc_graph))
    if calls != gc_cfg.n_layers:
        raise AssertionError(f"{calls} ops.segment_sum calls in a GraphCast "
                             f"forward, want {gc_cfg.n_layers}")
    if on_card and COPY_OPS & set(staging):
        raise AssertionError(f"ops.segment_sum copies the messages: "
                             f"{sorted(COPY_OPS & set(staging))}")
    res["graphcast_segment_sum_ops"] = staging
    for name, params, cfg, graph in (("graphcast", gc_params, gc_cfg,
                                      gc_graph),
                                     ("gat", gat_params, gat_cfg, gat_graph)):
        deg = torch.bincount(graph["edge_dst"].long())
        tiles = torch.bincount(graph["edge_dst"].long() // 128).double()
        res[f"{name}_degree_max_mean"] = (int(deg.max()),
                                          float(deg.double().mean()))
        res[f"{name}_edges_per_tile_max_mean"] = (int(tiles.max()),
                                                  float(tiles.mean()))
        if on_card:
            print(f"profile {name} forward: " + json.dumps(device_profile(
                torch, lambda p=params, c=cfg, g=graph: gnn.forward(p, c, g))),
                flush=True)
    print(json.dumps(res), flush=True)
    return res


# aten operators that copy the messages: none runs inside ops.segment_sum
COPY_OPS = {"aten::cat", "aten::index", "aten::gather", "aten::index_select",
            "aten::take"}


def segment_staging_ops(torch, fn):
    """(calls, {operator: count}): the calls of ``ops.segment_sum`` made
    during ``fn()`` and the aten operators run inside them (the staging and
    the wrapper), under ``torch.profiler`` with each call in a
    ``record_function`` scope for this one run."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.kernels.segment_agg import ops as sa_ops
    scope = "segment_agg.ops.segment_sum"
    inner = sa_ops.segment_sum

    def scoped(*args, **kwargs):
        with record_function(scope):
            return inner(*args, **kwargs)

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    sa_ops.segment_sum = scoped
    try:
        with profile(activities=activities) as prof:
            fn()
    finally:
        sa_ops.segment_sum = inner
    names = {}

    def walk(ev):
        for child in ev.cpu_children:
            names[child.name] = names.get(child.name, 0) + 1
            walk(child)

    # with CUDA activity the scope also shows as a device annotation
    calls = [ev for ev in prof.events() if ev.name == scope
             and ev.device_type == torch.autograd.DeviceType.CPU]
    for ev in calls:
        walk(ev)
    return len(calls), names


def ingest_args(**kw):
    from repro_torch.launch import ingest
    args = ingest.parser().parse_args([])
    knobs = dict(instances=32, blocks=128, rounds=16, block_size=1024,
                 cuts="2048,16384,131072", scale=22, seed=0, use_kernel=True,
                 batch_mode="grouped", device="cuda", lazy_l0="auto",
                 layered=False)
    for k, v in {**knobs, **kw}.items():
        setattr(args, k, v)
    return args


def states_equal(a, b, what: str) -> None:
    import numpy as np
    from repro_torch.core import hier
    na, nb = hier.state_to_numpy(a), hier.state_to_numpy(b)
    for k in na:
        if not np.array_equal(np.asarray(na[k]), np.asarray(nb[k])):
            raise AssertionError(f"{what}: {k} differs")


def service_args(**kw):
    """Phase 9's command line: the ``d4m_stream`` geometry at phase 4's
    stream length with the config's own query knobs."""
    from repro_torch.launch import query
    args = query.parser().parse_args([])
    knobs = dict(instances=32, blocks=128, block_size=1024,
                 cuts="2048,16384,131072", scale=22, rounds=8, queries=256,
                 queries_per_round=1, top_k=8, use_kernel=True, seed=0,
                 device="cuda")
    for k, v in {**knobs, **kw}.items():
        setattr(args, k, v)
    return args


def _exact(got, want, what: str) -> None:
    import torch
    if got.shape != want.shape or not torch.equal(got, want):
        raise AssertionError(f"{what}: live answer != flushed state's")


def _dropped_by_window(torch, h, rows, n_cols: int, width: int):
    """The extract_rows oracle for a window of ``width``: per query row,
    the in-view entries of every sorted layer past the row's first
    ``width`` (layer 0 is scanned whole at this batch size), as a dense
    [Q, n_cols] of their values and their count."""
    dense = torch.zeros((rows.shape[0], n_cols), dtype=h.layers[0].dtype,
                        device=rows.device)
    count = torch.zeros(rows.shape[0], dtype=torch.int32, device=rows.device)
    for layer in h.layers[1:]:
        live = torch.arange(layer.capacity, device=rows.device) < layer.nnz
        view = live & (layer.lo >= 0) & (layer.lo < n_cols)
        for q in range(rows.shape[0]):
            idx = torch.nonzero(view & (layer.hi == rows[q]))[:, 0][width:]
            dense[q].index_put_((layer.lo[idx].long(),), layer.val[idx],
                                accumulate=True)
            count[q] += idx.shape[0]
    return dense, count


def service_phase(torch, args, width: int = 64) -> dict:
    """Phase 9: the read-while-ingest service through ``launch/query.run``
    (an ingest-only baseline, then ingest rounds interleaved with point
    lookup and top-k batches), then every query surface on the final live
    fleet held exactly against each instance's flushed state and the
    reductions of its ``query_all``; ``extract_rows`` also at a window of
    ``width`` entries.  Returns the numbers it printed."""
    import math
    from repro_torch.core import assoc, hier, stream
    from repro_torch.launch import query
    from repro_torch.query import analytics, engine

    dev = torch.device(args.device)
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    stats, base, states = query.run_with_states(args)
    n_inst, n_keys, k = args.instances, 1 << args.scale, args.top_k
    uk, lazy = args.use_kernel, not args.no_lazy_l0
    want_updates = n_inst * args.blocks * args.block_size
    for what, s in (("baseline", base), ("with queries", states)):
        counter, ovf = hier.exact_update_count(s), int(torch.sum(s.overflow))
        if counter != want_updates or ovf != 0:
            raise AssertionError(f"service {what}: counter {counter} != "
                                 f"{want_updates} or overflow {ovf} != 0")
    states_equal(base, states, "service with queries vs without")

    # the query batches' merge_multi launches: one per instance and canon
    # batch (the warm-up's batches — on the card the eager one and the
    # capture's first replay — and one replay per timed round)
    c0 = states.capacities[0]
    canon = args.l0_mode == "canon" or (
        args.l0_mode == "auto"
        and args.queries > engine._L0_SCAN_FACTOR * math.log2(c0 + 1))
    batches = (2 if on_card else 1) + (args.rounds - 1) \
        * args.queries_per_round
    by_queries = {key: stats["launches"][key]
                  - stats["ingest_only_launches"][key]
                  for key in stats["launches"]}
    want = n_inst * batches if on_card and canon and uk else 0
    if by_queries["hier_merge.merge_multi"] != want \
            or by_queries["assoc.sort_route"] != 0:
        raise AssertionError(f"query batches launched {by_queries}, want "
                             f"{want} merge_multi")

    # the final live fleet against each instance's flushed state
    gen = torch.Generator(device=dev)
    gen.manual_seed(9)
    live = [stream.instance(states, i) for i in range(n_inst)]
    flushed = [hier.flush(h, lazy_l0=lazy, use_kernel=uk) for h in live]
    merged = [hier.query_all(h, lazy_l0=lazy, use_kernel=uk) for h in live]

    def keys(h, f):
        rand = torch.randint(0, n_keys, (64,), generator=gen, device=dev,
                             dtype=torch.int32)
        return torch.cat([getattr(h.layers[2], f)[:96],
                          getattr(h.layers[1], f)[:64],
                          getattr(h.layers[0], f)[:32], rand])

    qr = torch.stack([keys(h, "hi") for h in live])
    qc = torch.stack([keys(h, "lo") for h in live])
    for mode, q in (("canon", qr.shape[1]), ("scan", 32)):
        got = engine.point_lookup(states, qr[:, :q], qc[:, :q],
                                  use_kernel=uk, l0_mode=mode)
        for i, f in enumerate(flushed):
            _exact(got[i], engine.point_lookup(f, qr[i, :q], qc[i, :q]),
                   f"instance {i} {mode} point lookups")

    totals, ids = analytics.top_k_rows(states, n_keys, k)
    present = torch.zeros((n_inst, n_keys), dtype=torch.bool, device=dev)
    for i, m in enumerate(merged):
        present[i, m.hi[:int(m.nnz)].long()] = True
        deg = assoc.reduce_rows(m, n_keys)
        score = torch.where(present[i], deg, -float("inf"))
        order = torch.sort(score, descending=True, stable=True).indices[:k]
        _exact(ids[i], order.to(torch.int32), f"instance {i} top_k ids")
        _exact(totals[i], score[order], f"instance {i} top_k totals")

    worst_trunc = 0
    for i, (h, f) in enumerate(zip(live, flushed)):
        dense, trunc = engine.extract_rows(h, ids[i], n_keys, use_kernel=uk)
        want_dense, want_trunc = engine.extract_rows(f, ids[i], n_keys)
        _exact(dense, want_dense, f"instance {i} extract_rows")
        if int(trunc.sum()) or int(want_trunc.sum()):
            raise AssertionError(f"instance {i}: the default width dropped "
                                 f"entries")
        narrow, trunc = engine.extract_rows(h, ids[i], n_keys, width=width,
                                            use_kernel=uk, l0_mode="scan")
        dropped, count = _dropped_by_window(torch, h, ids[i], n_keys, width)
        _exact(trunc, count, f"instance {i} extract_rows width {width} "
               f"truncated")
        _exact(narrow + dropped, dense,
               f"instance {i} extract_rows width {width} + dropped")
        worst_trunc = max(worst_trunc, int(trunc.max()))
        del dense, want_dense, narrow, dropped

    lo = torch.tensor([0, 0, 1 << 10, 0], dtype=torch.int32, device=dev)
    hi = torch.tensor([n_keys, 1 << 10, 1 << 16, 0], dtype=torch.int32,
                      device=dev)
    lo = torch.stack([lo] * n_inst)
    hi = torch.stack([hi] * n_inst)
    lo[:, 3], hi[:, 3] = ids[:, 0], ids[:, 0] + 1
    got = engine.range_total(states, lo, hi, use_kernel=uk)
    for i, f in enumerate(flushed):
        _exact(got[i], engine.range_total(f, lo[i], hi[i]),
               f"instance {i} range_total")
        if int(got[i, 0]) != int(states.n_updates[i]):
            raise AssertionError(f"instance {i}: total {float(got[i, 0])} != "
                                 f"its {int(states.n_updates[i])} updates")

    x_cols = torch.zeros(n_keys, device=dev)
    x_cols[torch.randint(0, n_keys, (4096,), generator=gen, device=dev)] = 1
    x_rows = torch.zeros(n_keys, device=dev)
    x_rows[torch.randint(0, n_keys, (4096,), generator=gen, device=dev)] = 1
    checks = (
        ("out_degrees", analytics.out_degrees(states, n_keys),
         lambda m: assoc.reduce_rows(m, n_keys)),
        ("in_degrees", analytics.in_degrees(states, n_keys),
         lambda m: assoc.reduce_cols(m, n_keys)),
        ("spmv", analytics.spmv(states, x_cols, n_keys),
         lambda m: assoc.spmv(m, x_cols, n_keys)),
        ("spmv_t", analytics.spmv_t(states, x_rows, n_keys),
         lambda m: assoc.spmv_t(m, x_rows, n_keys)),
        ("ata_correlation",
         analytics.ata_correlation(states, x_cols, n_keys, n_keys),
         lambda m: assoc.spmv_t(m, assoc.spmv(m, x_cols, n_keys), n_keys)))
    for name, got, oracle in checks:
        for i, m in enumerate(merged):
            _exact(got[i], oracle(m), f"instance {i} {name}")
        del got
    occ = analytics.row_occupancy(states, n_keys)
    slots = sum(l.nnz.long() for l in states.layers)
    if not torch.equal(occ > 0, present) or \
            not torch.equal(occ.sum(-1), slots):
        raise AssertionError("row_occupancy != the live slots per row")

    from repro_torch.query import service
    query_fn = service.make_point_query_fn(use_kernel=uk,
                                           l0_mode=args.l0_mode)
    comp = query_fn.last
    replay_launches = comp.replays * comp.launches.get(
        "hier_merge.merge_multi", 0) if comp is not None else 0
    profiles = {}
    if on_card:
        # one eager query batch (the entry's function; phase 15 profiles
        # the replay) and one analytics batch under torch.profiler
        top_fn = service.make_analytics_fn(n_keys, k)
        q_rows, q_cols = qr[0], qc[0]
        for name, fn in (("query_batch", lambda: query_fn.fn(
                              states, q_rows, q_cols)),
                         ("analytics_batch", lambda: top_fn(states))):
            profiles[name] = device_profile(torch, fn)
            print(f"profile {name}: " + json.dumps(profiles[name]),
                  flush=True)

    timed = args.rounds - 1
    res = dict(
        updates_per_s=stats["updates_per_s"],
        ingest_only_updates_per_s=stats["ingest_only_updates_per_s"],
        ingest_interference=stats["ingest_interference"],
        queries_per_s=stats["queries_per_s"],
        latency_p50_ms=stats["latency_p50_s"] * 1e3,
        latency_p95_ms=stats["latency_p95_s"] * 1e3,
        latency_p99_ms=stats["latency_p99_s"] * 1e3,
        latency_max_ms=stats["latency_max_s"] * 1e3,
        analytics_ms_per_batch=stats["analytics_wall_s"] / timed * 1e3,
        query_batches=batches, stalled_rounds=stats["stalled_rounds"],
        launches=stats["launches"],
        ingest_only_launches=stats["ingest_only_launches"],
        query_launches=by_queries, query_replay_launches=replay_launches,
        narrow_width=width,
        narrow_max_truncated=worst_trunc, profiles=profiles,
        peak_gib=(torch.cuda.max_memory_allocated() / 2**30
                  if on_card else None))
    print(json.dumps(res), flush=True)
    return res


def _states_close(torch, a, b, rtol: float, what: str) -> None:
    """Two fleets of any value dtype: keys, nnz, spills, overflow and
    counters equal, values within rtol (atol the same) in float32."""
    for i, (la, lb) in enumerate(zip(a.layers, b.layers)):
        for f in ("hi", "lo", "nnz"):
            if not torch.equal(getattr(la, f), getattr(lb, f)):
                raise AssertionError(f"{what}: layer {i} {f} differs")
        va, vb = la.val.float(), lb.val.float()
        fin = torch.isfinite(vb)
        if not torch.equal(torch.isfinite(va), fin) or \
                not torch.equal(va[~fin], vb[~fin]) or \
                not torch.allclose(va[fin], vb[fin], rtol=rtol, atol=rtol):
            raise AssertionError(f"{what}: layer {i} values differ")
    for f in ("spills", "overflow", "n_updates"):
        if not torch.equal(getattr(a, f), getattr(b, f)):
            raise AssertionError(f"{what}: {f} differs")


def _live(seg):
    k = int(seg.nnz)
    return seg.hi[:k], seg.lo[:k], seg.val[:k]


def _check_rebalance(torch, before, after, lazy: bool, what: str) -> None:
    """``after`` (n_new instances) against ``before``: the exact update
    total, overflow 0; a shrunk fleet's instance j holds exactly the
    semiring merge of the old instances i with i % n_new == j (the same
    keys, each key's total unchanged: integer-valued payloads, so exact);
    a grown fleet keeps the old instances leaf for leaf and starts the new
    ones empty."""
    from repro_torch.core import assoc, hier, stream
    n_old, n_new = before.spills.shape[0], after.spills.shape[0]
    if hier.exact_update_count(after) != hier.exact_update_count(before) \
            or int(after.overflow.sum()) != 0:
        raise AssertionError(f"{what}: counter or overflow changed")
    if n_new > n_old:
        states_equal(hier.map_state(lambda x: x[:n_old], after), before,
                     f"{what}: kept instances")
        if any(int(l.nnz[n_old:].sum()) for l in after.layers) or \
                int(after.n_updates[n_old:].sum()):
            raise AssertionError(f"{what}: new instances not empty")
        return
    merged = [hier.query_all(stream.instance(before, i), lazy_l0=lazy)
              for i in range(n_old)]
    for j in range(n_new):
        parts = [_live(merged[i]) for i in range(j, n_old, n_new)]
        n = sum(p[0].shape[0] for p in parts)
        want, _ = assoc._canonicalize(*(torch.cat([p[k] for p in parts])
                                        for k in range(3)), n,
                                      assoc.sr_mod.PLUS_TIMES)
        got = hier.query_all(stream.instance(after, j), lazy_l0=lazy)
        if int(got.nnz) != int(want.nnz) or not all(
                torch.equal(x, y) for x, y in zip(_live(got), _live(want))):
            raise AssertionError(f"{what}: instance {j} is not the merge of "
                                 f"its folded instances")


def _bf16_fleet(torch, args, use_kernel: bool):
    """``launch/ingest.py``'s rounds on a bfloat16 fleet (the CLI builds
    float32 fleets): the same stream, the same knobs."""
    from repro_torch.core import distributed, stream
    from repro_torch.data.powerlaw import instance_streams
    from repro_torch.launch import ingest
    dev = torch.device(args.device)
    sig = ingest.signature(args)
    states = distributed.create_instances(args.instances, sig.cuts,
                                          args.block_size,
                                          dtype=torch.bfloat16, device=dev)
    per = max(args.blocks // args.rounds, 1)
    knobs = dict(ingest.ingest_knobs(sig), use_kernel=use_kernel)
    for rnd in range(args.rounds):
        rows, cols, vals = instance_streams(
            ingest.round_generator(args.seed, rnd, dev), args.instances,
            per, args.block_size, scale=args.scale)
        states, _ = stream.ingest_instances(states, rows, cols, vals,
                                            with_telemetry=False, **knobs)
    return states


def fault_phase(torch, args, small, tmp: str) -> dict:
    """Phase 10: checkpoint, resume, elastic resize and contracts.

    ``args`` is phase 4's command line, ``small`` the 8-instance one; both
    name the device.  (1) Run A checkpoints every ``--ckpt-every`` rounds;
    the checkpoints past half the rounds are removed (a crash), and run B
    ``--resume``s from the latest one left: it restarts at half the
    rounds, launches ``merge_multi`` (on the card) and ends equal to A,
    leaf for leaf.  (2) A's final state, saved, restores onto the CPU
    into an equal state.  (3) A's final fleet shrinks to half and grows by a
    quarter (``_check_rebalance``).  (4) A bfloat16 fleet at ``small``
    takes the kernel route (``merge_multi`` launched on the card) and
    equals the sort route within TOL16; ``top_k_rows`` on it equals the
    float32 ranking of its totals.  (5) Under ``REPRO_CHECK=1`` a fused
    kernel-route ingest at ``small`` passes every check, and a checkpoint
    whose layer-1 tail was corrupted is refused by ``restore``, naming
    the invariant.  Returns the numbers it printed."""
    import argparse
    import os
    import shutil

    import numpy as np
    from repro_torch.analysis import contracts
    from repro_torch.checkpoint import ckpt
    from repro_torch.core import hier
    from repro_torch.kernels import registry
    from repro_torch.launch import ingest
    from repro_torch.query import analytics
    from repro_torch.runtime import rebalance_instances

    on_card = torch.device(args.device).type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    res = {}
    d = os.path.join(tmp, "fleet")
    a_args = argparse.Namespace(**{**vars(args), "ckpt_dir": d})
    out_a, a = ingest.run_with_state(a_args)
    want_updates = args.instances * args.blocks * args.block_size
    steps = sorted(int(n.split("_")[1]) for n in os.listdir(d))
    if steps != list(range(args.ckpt_every, args.rounds + 1,
                           args.ckpt_every)):
        raise AssertionError(f"run A wrote checkpoints {steps}")
    crash = args.rounds // 2
    for step in steps:
        if step > crash:
            shutil.rmtree(os.path.join(d, f"step_{step}"))
    resume_at = ckpt.latest_step(d)
    registry.reset_launches()
    out_b, b = ingest.run_with_state(argparse.Namespace(
        **{**vars(a_args), "resume": True}))
    resumed_launches = registry.launches()
    states_equal(a, b, "resumed run vs uninterrupted run")
    per_round = args.instances * max(args.blocks // args.rounds, 1) \
        * args.block_size
    rounds_run = out_b["total_updates"] // per_round
    if resume_at != crash or rounds_run != args.rounds - crash or \
            out_b["n_updates_counter"] != want_updates or \
            out_a["n_updates_counter"] != want_updates:
        raise AssertionError(f"resume: at {resume_at}, {rounds_run} rounds, "
                             f"counter {out_b['n_updates_counter']}")
    if on_card and resumed_launches["hier_merge.merge_multi"] == 0:
        raise AssertionError("the resumed run never launched merge_multi")

    timed = os.path.join(tmp, "timed")
    sync()
    t0 = time.perf_counter()
    path = ckpt.save(timed, args.rounds, a)
    save_s = time.perf_counter() - t0
    size_mib = sum(os.path.getsize(os.path.join(path, f))
                   for f in os.listdir(path)) / 2**20
    t0 = time.perf_counter()
    r = ckpt.restore(timed, args.rounds, a)
    sync()
    restore_s = time.perf_counter() - t0
    states_equal(r, a, "restore vs saved")
    on_cpu = ckpt.restore(timed, args.rounds, a, device="cpu")
    if on_cpu.device.type != "cpu":
        raise AssertionError("restore(device='cpu') left the CPU")
    states_equal(on_cpu, a, "checkpoint restored on the CPU vs saved")
    res.update(counter=out_b["n_updates_counter"], resumed_at=resume_at,
               rounds_run=rounds_run,
               resumed_merge_multi=resumed_launches["hier_merge.merge_multi"],
               checkpoint_mib=size_mib, save_s=save_s, restore_s=restore_s)
    print(f"resume: run B restarted at round {resume_at}, ran {rounds_run} "
          f"rounds, counter {out_b['n_updates_counter']}, equal to run A; "
          f"launches {resumed_launches}; checkpoint {size_mib:.3f} MiB, "
          f"save {save_s:.4f} s, restore {restore_s:.4f} s; restored on "
          f"the CPU == saved", flush=True)

    lazy = a_args.lazy_l0 != "off"
    for n_new in (args.instances // 2, args.instances + args.instances // 4):
        t0 = time.perf_counter()
        out = rebalance_instances(a, n_new)
        sync()
        res[f"rebalance_{n_new}_s"] = time.perf_counter() - t0
        _check_rebalance(torch, a, out, lazy,
                         f"rebalance {args.instances} -> {n_new}")
        print(f"rebalance {args.instances} -> {n_new}: counter "
              f"{hier.exact_update_count(out)}, overflow 0, every key's "
              f"total kept in "
              f"{res[f'rebalance_{n_new}_s']:.4f} s", flush=True)
        del out

    registry.reset_launches()
    f16 = _bf16_fleet(torch, small, use_kernel=True)
    bf16_launches = registry.launches()
    ref16 = _bf16_fleet(torch, small, use_kernel=False)
    _states_close(torch, f16, ref16, TOL16["bfloat16"],
                  "bf16 kernel route vs sort route")
    if on_card and bf16_launches["hier_merge.merge_multi"] == 0:
        raise AssertionError("the bf16 fleet never launched merge_multi")
    n_keys, k = 1 << small.scale, 8
    totals, ids = analytics.top_k_rows(f16, n_keys, k)
    as32 = hier.map_state(
        lambda x: x.float() if x.dtype == torch.bfloat16 else x, f16)
    t32, i32 = analytics.top_k_rows(as32, n_keys, k)
    if totals.dtype != torch.bfloat16 or not torch.equal(ids, i32) or \
            not torch.equal(totals.float(), t32):
        raise AssertionError("bf16 top_k_rows != the float32 ranking")
    res.update(bf16_launches=bf16_launches,
               bf16_top1=[float(totals[0, 0]), int(ids[0, 0])])
    print(f"bf16 fleet: kernel route == sort route (rtol "
          f"{TOL16['bfloat16']}); launches {bf16_launches}; top_k_rows == "
          f"the float32 ranking (instance 0's top row {int(ids[0, 0])} at "
          f"{float(totals[0, 0])})", flush=True)
    del f16, ref16, as32

    prev = os.environ.get(contracts.ENV_VAR)
    os.environ[contracts.ENV_VAR] = "1"
    try:
        registry.reset_launches()
        out_c, c = ingest.run_with_state(small)
        checked_launches = registry.launches()
        bad = ckpt.save(os.path.join(tmp, "corrupt"), 1, c)
        with open(os.path.join(bad, "manifest.json")) as f:
            leaf = next(l for l in json.load(f)["leaves"]
                        if l["path"] == ".layers/1/.val")
        vals = np.load(os.path.join(bad, leaf["file"]))
        # a tail slot: the last of the least-filled instance's layer 1
        vals[int(torch.argmin(c.layers[1].nnz)), -1] = 123.0
        np.save(os.path.join(bad, leaf["file"]), vals)
        try:
            ckpt.restore(os.path.join(tmp, "corrupt"), 1, c)
        except contracts.ContractViolation as e:
            refused = str(e)
        else:
            raise AssertionError("a corrupted checkpoint restored under "
                                 "REPRO_CHECK=1")
    finally:
        if prev is None:
            os.environ.pop(contracts.ENV_VAR)
        else:
            os.environ[contracts.ENV_VAR] = prev
    if "sentinel-tail violation in restore step_1 layer 1" not in refused:
        raise AssertionError(f"restore refused for another reason: "
                             f"{refused}")
    if on_card and checked_launches["hier_merge.merge_multi"] == 0:
        raise AssertionError("the checked ingest never launched merge_multi")
    res.update(checked_updates_per_s=out_c["updates_per_s"],
               refused=refused)
    print(f"REPRO_CHECK=1: the checked ingest passed (counter "
          f"{out_c['n_updates_counter']}, launches {checked_launches}); "
          f"the corrupted checkpoint was refused: {refused}", flush=True)
    return res


# ------------------------------------------------------------- phase 11 --

TRAIN_RTOL = 1e-5          # resume == uninterrupted; remat on == off
XDEV_RTOL = 1e-4           # one step on the card == the same step on the CPU


def max_rel_err(a, b) -> float:
    """max |a - b| over max |b| (phase 8's measure)."""
    return float((a.double() - b.double()).abs().max()
                 / b.double().abs().max().clamp(min=1e-30))


def grad_coverage(torch, loss_fn, *trees) -> dict:
    """Gradients of ``loss_fn(*trees)`` for every leaf of ``trees``: each
    finite and non-zero somewhere (a dropped gradient would be all
    zeros).  Returns the loss and the number of leaves checked."""
    from repro_torch.models import common
    (loss, _), grads = common.value_and_grad(loss_fn, *trees)
    n = 0
    for g in grads:
        for leaf in common.tree_leaves(g):
            n += 1
            if not bool(torch.isfinite(leaf).all()) or \
                    not bool((leaf != 0).any()):
                raise AssertionError(f"a gradient of shape "
                                     f"{tuple(leaf.shape)} is zero or not "
                                     f"finite")
    del grads
    if not bool(torch.isfinite(loss)):
        raise AssertionError("loss not finite")
    return dict(loss=float(loss), leaves=n)


def refuses_kernel_route(fn, what: str) -> None:
    """``fn()`` must raise NotImplementedError: a kernel route has no
    backward, as in the reference."""
    try:
        fn()
    except NotImplementedError:
        return
    raise AssertionError(f"{what}: the kernel route trained without a "
                         f"backward")


def _sync(torch, device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _peak_reset(torch, device):
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()


def _peak_gib(torch, device):
    if torch.device(device).type == "cuda":
        return torch.cuda.max_memory_allocated() / 2**30
    return None


def _median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2]


def dcn_train_phase(torch, device, *, smoke: bool, batch: int, steps: int,
                    vocab: int):
    """DCN-v2 training through ``launch/train.run_with_state``: the dense
    path, then ``--hier-embed``; per path the median step ms after the
    first step, examples/s, peak GiB, host reads per step, a gradient of
    every leaf non-zero and finite, the kernel route refused, and on the
    card one step under ``device_profile``.  Then the hier path's exact
    mass check, called directly: one step with lr 0, embed_lr 1 and a drain
    every step moves the table by minus the direct scatter of the
    embedding gradient (rtol 1e-4, atol 1e-5)."""
    from repro_torch.configs import registry as cfgs
    from repro_torch.data import synthetic
    from repro_torch.launch import train
    from repro_torch.models import common, dcn
    from repro_torch.obs import trace as obs_trace
    from repro_torch.optim.adamw import AdamWConfig, adamw_init

    cfg = (cfgs.get_smoke_config if smoke else cfgs.get_config)("dcn-v2")
    res = {}
    for mode in ("dense", "hier"):
        _peak_reset(torch, device)
        args = train.make_args(arch="dcn-v2", smoke=smoke, batch=batch,
                               steps=steps, hier_embed=mode == "hier",
                               device=device, log_every=0)
        syncs = obs_trace.host_reads().get("vassoc", 0)
        out, state = train.run_with_state(args)
        syncs = (obs_trace.host_reads().get("vassoc", 0) - syncs) / steps
        if len(out["losses"]) != steps or not all(
                math.isfinite(x) for x in out["losses"] + out["gnorms"]):
            raise AssertionError(f"dcn {mode}: losses or gnorms not finite")
        params = state["params"]
        b = synthetic.recsys_batch(train.step_seed(0, steps), batch,
                                   cfg.n_dense, cfg.n_sparse,
                                   min(cfg.table_sizes), device=device)
        ms = _median(out["step_s"][1:]) * 1e3
        rec = dict(step_ms=ms, examples_per_s=batch / ms * 1e3,
                   peak_gib=_peak_gib(torch, device),
                   host_reads_per_step=syncs, losses=out["losses"],
                   gnorms=out["gnorms"])
        if mode == "dense":
            rec["grads"] = grad_coverage(
                torch, lambda p: (dcn.bce(dcn.forward(p, b, cfg),
                                          b["labels"]), {}), params)
            kcfg = dataclasses.replace(cfg, use_kernel=True)
            refuses_kernel_route(lambda: dcn.make_train_step(
                kcfg, AdamWConfig())(params, state["opt"], b), "dcn dense")
            step = dcn.make_train_step(cfg, AdamWConfig(lr=args.lr))
            run_step = lambda: step(params, state["opt"], b)
        else:
            gids = dcn.global_ids(b["sparse"], cfg)
            with torch.no_grad():
                e = torch.sum(params.table[gids.long()], dim=2).reshape(
                    batch, -1)

            def loss_e(rest, e):
                h = dcn.interact(params, b["dense"], e, cfg)
                return dcn.bce((h @ params.logit_w)[:, 0] + params.logit_b,
                               b["labels"]), {}

            rec["grads"] = grad_coverage(torch, loss_e,
                                         dcn.rest_params(params), e)
            step = dcn.make_train_step_hier(cfg, AdamWConfig(lr=args.lr))
            run_step = lambda: step(params, state["opt"], state["hier"], b)
        if torch.device(device).type == "cuda":
            rec["profile"] = device_profile(torch, run_step)
        print(f"dcn-v2 train {mode}: " + json.dumps(rec), flush=True)
        res[mode] = rec
        del state, params, run_step, step, b

    # the hier path's exact mass, at the same width, called directly
    _peak_reset(torch, device)
    params = dcn.init(3, cfg, device=device)
    table0 = params.table.detach().clone()
    b = synthetic.recsys_batch(21, batch, cfg.n_dense, cfg.n_sparse, vocab,
                               device=device)
    step = dcn.make_train_step_hier(cfg, AdamWConfig(lr=0.0), embed_lr=1.0,
                                    drain_every=1)
    rest = dcn.rest_params(params)
    p2, _, h2, m = step(params, adamw_init(rest),
                        dcn.hier_embed_init(cfg, batch, (1024, 8192, 65536),
                                            device=device), b)
    if not bool(m["drained"]) or int(m["pending_nnz"]) != 0:
        raise AssertionError("hier exact-mass step did not drain")
    gids = dcn.global_ids(b["sparse"], cfg).reshape(-1).long()
    with torch.no_grad():
        e = dcn.embed_lookup(table0, b["sparse"], cfg)

    def loss_e(e):
        h = dcn.interact(params, b["dense"], e, cfg)
        return dcn.bce((h @ params.logit_w)[:, 0] + params.logit_b,
                       b["labels"]), {}

    _, (g_e,) = common.value_and_grad(loss_e, e)
    direct = table0.index_add_(0, gids, -g_e.reshape(-1, cfg.embed_dim))
    step_peak = _peak_gib(torch, device)
    err = 0.0
    for lo in range(0, direct.shape[0], 1 << 23):   # no 6 GB temporaries
        got, want = p2.table[lo:lo + (1 << 23)], direct[lo:lo + (1 << 23)]
        diff = float((got - want).abs().max())
        if not torch.allclose(got, want, rtol=1e-4, atol=1e-5):
            raise AssertionError(f"hier exact mass: table rows from {lo} "
                                 f"differ by {diff}")
        err = max(err, diff)
    res["hier_exact"] = dict(
        unique_rows=int(torch.unique(gids).numel()),
        block_rows=int(gids.numel()), max_abs_err=err, peak_gib=step_peak)
    print("dcn-v2 hier exact mass: " + json.dumps(res["hier_exact"]),
          flush=True)
    return res


def gnn_train_steps(torch, cfg, graph, task, d_feat, n_out, steps,
                    seed_count=0, device="cuda", profile=False,
                    layer_scale=1.0):
    """``steps`` steps of ``gnn.make_train_step``; returns the numbers
    (median step ms after the first, peak GiB, losses, gnorms, gradient
    coverage, the kernel route refused).  ``layer_scale`` multiplies the
    drawn weights of the processor layers (``layers.*``)."""
    from repro_torch.models import gnn
    from repro_torch.optim.adamw import AdamWConfig, adamw_init

    _peak_reset(torch, device)
    params = gnn.init(0, cfg, d_feat, n_out, device=device)
    if layer_scale != 1.0:
        with torch.no_grad():
            for p in params.layers.parameters():
                p.mul_(layer_scale)
    opt = adamw_init(params)
    step = gnn.make_train_step(cfg, AdamWConfig(lr=1e-4), task, seed_count)
    losses, gnorms, secs = [], [], []
    for _ in range(steps):
        _sync(torch, device)
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, graph)
        _sync(torch, device)
        secs.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["gnorm"]))
    if not all(math.isfinite(x) for x in losses + gnorms):
        raise AssertionError(f"{cfg.name}: losses or gnorms not finite")
    rec = dict(step_ms=_median(secs[1:] or secs) * 1e3,
               peak_gib=_peak_gib(torch, device), losses=losses,
               gnorms=gnorms, layer_scale=layer_scale)
    loss_fn = gnn.make_loss_fn(cfg, task, seed_count)
    rec["grads"] = grad_coverage(torch, lambda p: loss_fn(p, graph), params)
    kcfg = dataclasses.replace(cfg, use_kernel=True)
    refuses_kernel_route(lambda: gnn.make_train_step(
        kcfg, AdamWConfig(), task, seed_count)(params, opt, graph),
        f"{cfg.name}")
    if profile and torch.device(device).type == "cuda":
        rec["profile"] = device_profile(
            torch, lambda: step(params, opt, graph))
    return rec


# GraphCast's processor at the reference's init (dense_init, no
# normalisation) grows its activations with depth: at 16 layers the sum of
# squared gradients overflows float32 and gnorm is inf — the reference's
# arithmetic, which the port computes (``init_gnorm`` records it each
# run).  Phase 11 trains it with the drawn processor weights scaled by
# this factor.
GC_LAYER_SCALE = 0.5


def init_gnorm(torch, cfg, graph, n, device):
    """The regress loss and the global gradient norm at ``cfg``'s own
    random init (recorded, not checked)."""
    from repro_torch.models import common, gnn
    from repro_torch.optim.adamw import clip_by_global_norm
    params = gnn.init(0, cfg, n, n, device=device)
    loss_fn = gnn.make_loss_fn(cfg, "regress")
    (loss, _), (g,) = common.value_and_grad(lambda p: loss_fn(p, graph),
                                            params)
    gnorm = clip_by_global_norm(g, 1.0)[1]
    return dict(loss=float(loss), gnorm=float(gnorm))


def remat_check(torch, cfg, graph, task, d_feat, n_out, device):
    """Gradients with remat on and off at ``cfg``'s width, first with
    PyTorch's default (atomic, unordered) scatter-adds on the card, whose
    recomputed forward may round differently from the first, recorded;
    then with ``torch.use_deterministic_algorithms`` (ordered
    scatter-adds), checked: equal within a max relative error of
    TRAIN_RTOL per leaf."""
    from repro_torch.models import common, gnn
    params = gnn.init(1, cfg, d_feat, n_out, device=device)
    out = {}
    for det in (False, True):
        grads, peaks = [], []
        torch.use_deterministic_algorithms(det, warn_only=True)
        try:
            for remat in (True, False):
                c = dataclasses.replace(cfg, remat=remat)
                loss_fn = gnn.make_loss_fn(c, task)
                _peak_reset(torch, device)
                _, (g,) = common.value_and_grad(
                    lambda p: loss_fn(p, graph), params)
                peaks.append(_peak_gib(torch, device))
                grads.append(common.tree_leaves(g))
        finally:
            torch.use_deterministic_algorithms(False)
        errs = [max_rel_err(a, b) for a, b in zip(*grads)]
        key = "deterministic" if det else "default"
        out[key] = dict(max_rel_err=max(errs),
                        worst_leaf=errs.index(max(errs)),
                        peak_gib_on_off=peaks)
    if not out["deterministic"]["max_rel_err"] <= TRAIN_RTOL:
        raise AssertionError(f"remat on vs off: {out}")
    return out


def flow_batch(torch, spec, seed, device):
    """One sampled node flow of ``spec`` (a ``GNN_SHAPES`` sampled entry)
    from an R-MAT graph of its size: the flow's nodes (seeds first) with
    their features and labels, edges child -> parent."""
    from repro_torch.data import graphs
    t0 = time.perf_counter()
    g = graphs.random_graph(seed, spec["n_nodes"], spec["n_edges"],
                            spec["d_feat"], spec["n_classes"], device=device)
    indptr, indices = graphs.to_csr(g["edge_src"], g["edge_dst"],
                                    spec["n_nodes"])
    del g["edge_src"], g["edge_dst"]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    seeds = torch.randint(0, spec["n_nodes"], (spec["batch_nodes"],),
                          generator=gen, device=device, dtype=torch.int32)
    frontiers = graphs.sample_node_flow(gen, indptr, indices, seeds,
                                        spec["fanouts"])
    node_ids, src, dst = graphs.flow_subgraph(frontiers, spec["fanouts"])
    want = graphs.flow_sizes(spec["batch_nodes"], spec["fanouts"])
    if (node_ids.shape[0], src.shape[0]) != want:
        raise AssertionError(f"flow sizes {(node_ids.shape[0], src.shape[0])}"
                             f" != {want}")
    ids = node_ids.long()
    batch = dict(node_feat=g["node_feat"][ids], edge_src=src, edge_dst=dst,
                 labels=g["labels"][ids])
    _sync(torch, device)
    info = dict(graph_nodes=spec["n_nodes"], graph_edges=spec["n_edges"],
                flow_nodes=want[0], flow_edges=want[1],
                build_s=time.perf_counter() - t0)
    return batch, info


def train_resume_checks(torch, device, tmp):
    """The train CLI at smoke size, ``--ckpt-every 4 --fail-at-step 6``:
    each final loss equals the uninterrupted run's within TRAIN_RTOL."""
    from repro_torch.launch import train
    out = {}
    for arch, hier in (("dcn-v2", True), ("gat-cora", False)):
        kw = dict(arch=arch, smoke=True, steps=10, batch=8, hier_embed=hier,
                  device=device, log_every=0)
        base = train.run(train.make_args(**kw))
        failed = train.run(train.make_args(
            ckpt_dir=os.path.join(tmp, arch), ckpt_every=4, fail_at_step=6,
            **kw))
        rel = abs(failed["final_loss"] - base["final_loss"]) / abs(
            base["final_loss"])
        if failed["failures"] != 1 or not rel <= TRAIN_RTOL:
            raise AssertionError(f"{arch}: resumed final loss "
                                 f"{failed['final_loss']} vs "
                                 f"{base['final_loss']}")
        out[arch] = dict(final_loss=base["final_loss"], resumed_rel_err=rel)
    return out


def _xdev_compare(torch, a, b, lr, what):
    """A tree on the card against the same tree on the CPU: rtol XDEV_RTOL
    plus a tenth of one AdamW step (see tests/test_torch_train.py)."""
    from repro_torch.models import common
    worst = 0.0
    for x, y in zip(common.tree_leaves(a), common.tree_leaves(b)):
        x, y = x.detach().cpu(), y.detach().cpu()
        if not torch.allclose(x, y, rtol=XDEV_RTOL, atol=lr / 10):
            raise AssertionError(f"{what}: card vs CPU differ by "
                                 f"{float((x - y).abs().max())}")
        worst = max(worst, max_rel_err(x, y))
    return worst


def cross_device_checks(torch, card="cuda"):
    """One step of each family on the card == the same step on the CPU, at
    smoke size: losses and gnorms within rtol XDEV_RTOL, parameters as
    ``_xdev_compare``.  (``card`` names the device held against the CPU.)"""
    from repro_torch.configs import registry as cfgs
    from repro_torch.data import graphs, synthetic
    from repro_torch.models import dcn, gnn
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    opt_cfg = AdamWConfig(lr=1e-3)
    out = {}
    cfg = cfgs.get_smoke_config("dcn-v2")
    tree = dcn.params_to_numpy(dcn.init(0, cfg, device="cpu"))
    batch = synthetic.recsys_batch(4, 64, cfg.n_dense, cfg.n_sparse, 1000,
                                   device="cpu")
    gcfg = cfgs.get_smoke_config("gat-cora")
    g = graphs.random_graph(4, 300, 1200, 24, 5, device="cpu")
    gtree = gnn.params_to_numpy(gnn.init(0, gcfg, 24, 5, device="cpu"))
    runs = {}
    for dev in ("cpu", card):
        b = {k: v.to(dev) for k, v in batch.items()}
        p = dcn.params_from_numpy(tree, cfg, device=dev)
        p, _, m = dcn.make_train_step(cfg, opt_cfg)(p, adamw_init(p), b)
        hp = dcn.params_from_numpy(tree, cfg, device=dev)
        hp, _, _, hm = dcn.make_train_step_hier(cfg, opt_cfg, drain_every=1)(
            hp, adamw_init(dcn.rest_params(hp)),
            dcn.hier_embed_init(cfg, 64, (64, 128, 256), device=dev), b)
        gp = gnn.params_from_numpy(gtree, gcfg, device=dev)
        gg = {k: v.to(dev) for k, v in g.items()}
        gp, _, gm = gnn.make_train_step(gcfg, opt_cfg, "node")(
            gp, adamw_init(gp), gg)
        runs[dev] = ((p, m), (hp, hm), (gp, gm))
    for name, got, want in zip(("dcn_dense", "dcn_hier", "gat"), runs[card],
                               runs["cpu"]):
        for k in ("loss", "gnorm"):
            a, b = float(got[1][k]), float(want[1][k])
            if not abs(a - b) <= XDEV_RTOL * abs(b):
                raise AssertionError(f"{name} {k}: card {a} vs CPU {b}")
        out[name] = dict(loss=float(got[1]["loss"]),
                         params_max_rel_err=_xdev_compare(
                             torch, got[0], want[0], opt_cfg.lr, name))
    return out


def train_phase(torch, device, tmp, *, dcn_smoke=False,
                dcn_batch=DCN_TRAIN_BATCH, dcn_steps=4, vocab=VOCAB,
                gc_cfg=None, gc_graph=None, gc_steps=3, gat_cfg=None,
                gat_graph=None, gat_classes=7, gat_steps=5, flow_spec=None,
                flow_cfg=None):
    """Phase 11: training at full width (smaller where the rehearsal on the
    CPU passes its own sizes).  Returns the numbers it printed."""
    from repro_torch.obs import trace as obs_trace
    res = dict(dcn=dcn_train_phase(torch, device, smoke=dcn_smoke,
                                   batch=dcn_batch, steps=dcn_steps,
                                   vocab=vocab))
    n = gc_cfg.n_vars
    gen = torch.Generator(device=device)
    gen.manual_seed(8)
    gc_batch = dict(gc_graph, targets=torch.randn(
        (gc_graph["node_feat"].shape[0], n), generator=gen, device=device))
    res["graphcast_init_check"] = init_gnorm(torch, gc_cfg, gc_batch, n,
                                             device)
    print("graphcast at the reference's init: " +
          json.dumps(res["graphcast_init_check"]), flush=True)
    res["graphcast"] = gnn_train_steps(torch, gc_cfg, gc_batch, "regress", n,
                                       n, gc_steps, device=device,
                                       profile=True,
                                       layer_scale=GC_LAYER_SCALE)
    res["graphcast"]["remat_2_layers"] = remat_check(
        torch, dataclasses.replace(gc_cfg, n_layers=2), gc_batch, "regress",
        n, n, device)
    print("graphcast train: " + json.dumps(res["graphcast"]), flush=True)
    del gc_batch
    res["gat_full"] = gnn_train_steps(torch, gat_cfg, gat_graph, "node",
                                      gat_graph["node_feat"].shape[1],
                                      gat_classes, gat_steps,
                                      device=device, profile=True)
    print("gat-cora full_graph_sm train: " + json.dumps(res["gat_full"]),
          flush=True)
    _peak_reset(torch, device)
    batch, info = flow_batch(torch, flow_spec, 9, device)
    info["build_peak_gib"] = _peak_gib(torch, device)
    res["gat_flow"] = gnn_train_steps(
        torch, flow_cfg, batch, "node", flow_spec["d_feat"],
        flow_spec["n_classes"], 2, seed_count=flow_spec["batch_nodes"],
        device=device, profile=True)
    res["gat_flow"].update(info)
    print("gat minibatch_lg node flow train: " + json.dumps(res["gat_flow"]),
          flush=True)
    del batch
    res["resume"] = train_resume_checks(torch, device, tmp)
    print("train CLI resume: " + json.dumps(res["resume"]), flush=True)
    if torch.device(device).type == "cuda":
        res["cross_device"] = cross_device_checks(torch)
        print("card == CPU: " + json.dumps(res["cross_device"]), flush=True)
    res["host_syncs_total"] = obs_trace.host_reads().get("vassoc", 0)
    return res


# ------------------------------------------------------------- phase 12 --

FLEET_AXES = ("data",)
FLEET_BINS = 16
FLEET_QUERIES = 4096


def fleet_round(torch, args, rnd: int, device, tropical: bool):
    """Round ``rnd``'s stream of the whole fleet, drawn as
    ``launch/ingest.py`` draws it; a tropical fleet's values are integers
    in [1, 100) drawn after it from the same generator."""
    from repro_torch.data.powerlaw import instance_streams
    from repro_torch.launch import ingest
    gen = ingest.round_generator(args.seed, rnd, device)
    rows, cols, vals = instance_streams(
        gen, args.instances, args.blocks // args.rounds, args.block_size,
        scale=args.scale)
    if tropical:
        vals = torch.randint(1, 100, vals.shape, generator=gen,
                             device=device).to(torch.float32)
    return rows, cols, vals


def fleet_queries(torch, states, n_queries: int, scale: int, seed: int):
    """One query vector for the whole fleet, as phase 4 draws its own:
    live keys of every layer of every instance (n_queries / 2, / 4 and / 8
    over the instances of layers 2, 1 and 0), then random keys; numpy."""
    n_inst = states.spills.shape[0]
    gen = torch.Generator(device=states.device)
    gen.manual_seed(seed)
    parts = []
    for layer, share in zip(states.layers[::-1], (2, 4, 8)):
        take = max(n_queries // share // n_inst, 1)
        for i in range(n_inst):
            n = min(take, int(layer.nnz[i]))
            parts.append(torch.stack([layer.hi[i, :n], layer.lo[i, :n]]))
    live = torch.cat(parts, dim=1)[:, :n_queries]
    rand = torch.randint(0, 1 << scale, (2, n_queries - live.shape[1]),
                         generator=gen, device=states.device,
                         dtype=torch.int32)
    q = torch.cat([live, rand], dim=1).cpu().numpy()
    return q[0].copy(), q[1].copy()


def fleet_expected(torch, states, sr, queries, num_rows: int) -> dict:
    """The single-process answers phase 12 is held to, on the host: the
    state leaf for leaf, every instance's lookups of ``queries`` (scan
    mode, no kernel, one instance at a time) and their ``sr.add`` over the
    instances, the out-degree histogram binned with numpy (rows whose
    total is above 0, ``floor(log2)`` clipped into 16 bins) and the exact
    counter."""
    import numpy as np
    from repro_torch.core import assoc, hier, stream
    from repro_torch.query import engine
    q_rows, q_cols = (torch.as_tensor(x, device=states.device)
                      for x in queries)
    per, hist = [], np.zeros(FLEET_BINS, np.int64)
    for i in range(states.spills.shape[0]):
        h = stream.instance(states, i)
        per.append(engine.point_lookup(h, q_rows, q_cols, sr=sr,
                                       l0_mode="scan"))
        deg = assoc.reduce_rows(hier.query_all(h, sr), num_rows, sr)
        deg = deg.double().cpu().numpy()
        bins = np.clip(np.floor(np.log2(np.maximum(deg, 1))), 0,
                       FLEET_BINS - 1).astype(np.int64)
        hist += np.bincount(bins[deg > 0], minlength=FLEET_BINS)
    per = torch.stack(per)
    return dict(state=hier.state_to_numpy(states), per=per.cpu().numpy(),
                comb=engine.reduce_axis(sr, per, 0).cpu().numpy(),
                hist=hist, count=hier.exact_update_count(states))


def fleet_rank(mesh, args, sr_name: str, tropical: bool, queries) -> dict:
    """One rank of phase 12 (started by ``launch.mesh.spawn_fleet``): its
    block of the fleet through ``sharded_ingest_fn`` round by round, each
    round drawn whole, cut to the block, then ingested between two
    barriers; then the fleet counter, the degree histogram and the canon
    point lookups (combined, then per instance); on the card, one more
    round under ``device_profile`` (after every check and count).
    Returns numpy results and the rank's launches, times and peak
    memory."""
    import torch
    import torch.distributed as dist
    from repro_torch.core import distributed, hier
    from repro_torch.core import semiring as sr_mod
    from repro_torch.kernels import registry
    from repro_torch.launch import ingest
    dev = mesh.device
    sr = sr_mod.get(sr_name)
    sig = ingest.signature(args)
    states = distributed.shard(mesh, distributed.create_instances(
        args.instances, sig.cuts, args.block_size, sr=sr, device=dev))
    step = distributed.sharded_ingest_fn(mesh, FLEET_AXES, sr=sr,
                                         **ingest.ingest_knobs(sig))
    registry.reset_launches()
    _peak_reset(torch, dev)
    walls, own = [], 0.0
    for rnd in range(args.rounds):
        rows, cols, vals = (distributed.shard(mesh, x) for x in
                            fleet_round(torch, args, rnd, dev, tropical))
        _sync(torch, dev)
        dist.barrier()
        t0 = time.perf_counter()
        states, _ = step(states, rows, cols, vals)
        _sync(torch, dev)
        own += time.perf_counter() - t0
        dist.barrier()
        walls.append(time.perf_counter() - t0)
    launches = dict(ingest=registry.launches())
    count = distributed.aggregate_update_counts_fn(mesh, FLEET_AXES)(states)
    hist = distributed.global_degree_histogram_fn(
        mesh, FLEET_AXES, 1 << args.scale, FLEET_BINS, sr)(states)
    q_rows, q_cols = (torch.as_tensor(x, device=dev) for x in queries)
    out = {}
    for per in (False, True):
        registry.reset_launches()
        out[per] = distributed.sharded_query_fn(
            mesh, FLEET_AXES, sr=sr, use_kernel=True, l0_mode="canon",
            per_instance=per)(states, q_rows, q_cols).cpu().numpy()
        launches["per_instance" if per else "query"] = registry.launches()
    n_local = states.spills.shape[0]
    res = dict(rank=mesh.rank, device=str(dev),
               state=hier.state_to_numpy(states), count=count,
               hist=hist.cpu().numpy(), comb=out[False], per=out[True],
               launches=launches, walls=walls, own_s=own,
               updates=n_local * (args.blocks // args.rounds)
               * args.block_size * args.rounds,
               peak_gib=_peak_gib(torch, dev), profile=None)
    if dev.type == "cuda":
        rows, cols, vals = (distributed.shard(mesh, x) for x in
                            fleet_round(torch, args, args.rounds, dev,
                                        tropical))
        _sync(torch, dev)
        dist.barrier()
        res["profile"] = device_profile(
            torch, lambda: step(states, rows, cols, vals))
        dist.barrier()
    return res


def _check_fleet(np, got: list, want: dict, what: str) -> None:
    """Phase 12's exact checks of one run's ranks against ``want``."""
    for k, v in want["state"].items():
        if k == "cuts":
            continue
        joined = np.concatenate([r["state"][k] for r in got])
        if not np.array_equal(joined, v):
            raise AssertionError(f"{what}: {k} of the ranks' blocks != the "
                                 f"single-process fleet's")
    if not np.array_equal(np.concatenate([r["per"] for r in got]),
                          want["per"]):
        raise AssertionError(f"{what}: per-instance lookups differ")
    for r in got:
        if r["count"] != want["count"]:
            raise AssertionError(f"{what}: rank {r['rank']} counts "
                                 f"{r['count']}, not {want['count']}")
        if not np.array_equal(r["hist"], want["hist"]):
            raise AssertionError(f"{what}: rank {r['rank']} histogram "
                                 f"{r['hist'].tolist()} != "
                                 f"{want['hist'].tolist()}")
        if not np.array_equal(r["comb"], want["comb"]):
            raise AssertionError(f"{what}: rank {r['rank']} combined "
                                 f"lookups differ")


def fleet_run(torch, args, sr_name: str, tropical: bool, want: dict,
              queries, backend: str, ranks: int, device, tmp: str,
              launches: dict, card: str) -> dict:
    """One fleet of ``ranks`` ranks: spawned, held to ``want`` and to the
    single-process ``launches`` (ingest merges summed over the ranks; one
    ``merge_multi`` per instance for each canon query call; every rank
    launched ``merge_multi`` where the single process did).  Returns the
    rates, peaks and launches it printed."""
    import numpy as np
    from repro_torch.launch import mesh as fleet_mesh
    what = f"{sr_name} fleet, {backend}, P={ranks}"
    t0 = time.perf_counter()
    got = fleet_mesh.spawn_fleet(fleet_rank, ranks, backend, device, tmp,
                                 args=(args, sr_name, tropical, queries))
    wall = time.perf_counter() - t0
    _check_fleet(np, got, want, what)
    on_card = torch.device(device).type == "cuda"
    for name in ("hier_merge.merge_multi", "assoc.sort_route"):
        total = sum(r["launches"]["ingest"][name] for r in got)
        if total != launches[name]:
            raise AssertionError(f"{what}: {total} {name} calls by the "
                                 f"ranks, {launches[name]} by one process")
    for kind in ("query", "per_instance"):
        total = sum(r["launches"][kind]["hier_merge.merge_multi"]
                    for r in got)
        if total != (args.instances if on_card else 0):
            raise AssertionError(f"{what}: {kind} canon lookups launched "
                                 f"merge_multi {total} times")
    if on_card and not all(r["launches"]["ingest"]["hier_merge.merge_multi"]
                           for r in got):
        raise AssertionError(f"{what}: a rank never launched merge_multi")
    total_updates = sum(r["updates"] for r in got)
    rank0_wall = sum(got[0]["walls"])
    profiled = None
    if on_card:
        # kernels of different processes do not overlap on a card without
        # MPS, so the device times of the ranks on one card add up
        wall_ms = max(r["profile"]["wall_ms"] for r in got)
        busy = {}
        for r in got:
            busy[r["device"]] = busy.get(r["device"], 0.0) \
                + r["profile"]["device_ms"] / wall_ms
        profiled = dict(wall_ms=wall_ms,
                        device_ms=sum(r["profile"]["device_ms"]
                                      for r in got),
                        card_busy_share=busy,
                        rank_device_ms=[r["profile"]["device_ms"]
                                        for r in got],
                        rank0_top=got[0]["profile"]["top"])
    res = dict(
        backend=backend, ranks=ranks, devices=[r["device"] for r in got],
        updates=total_updates, updates_per_s=total_updates / rank0_wall,
        round_walls_s=got[0]["walls"],
        rank_updates_per_s=[r["updates"] / r["own_s"] for r in got],
        rank_peak_gib=[r["peak_gib"] for r in got], phase_wall_s=wall,
        profiled_round=profiled,
        merge_multi=sum(r["launches"][k]["hier_merge.merge_multi"]
                        for r in got for k in ("ingest", "query",
                                               "per_instance")))
    print(f"{what}: {res['updates_per_s']:.1f} updates/s aggregate "
          f"({total_updates} updates over {rank0_wall:.4f} s of rounds); "
          f"per rank {[round(x, 1) for x in res['rank_updates_per_s']]} "
          f"updates/s; peak GiB {res['rank_peak_gib']}; merge_multi "
          f"{res['merge_multi']} (ingest + 2 x {args.instances} canon "
          f"lookups); wall {wall:.2f} s; every check exact; {card}",
          flush=True)
    if profiled:
        print(f"{what}: one more round under the profiler: wall "
              f"{profiled['wall_ms']:.2f} ms (slowest rank), kernels "
              f"{profiled['device_ms']:.2f} ms summed over the ranks, busy "
              f"share of each card {profiled['card_busy_share']}; {card}",
              flush=True)
    return res


def fleet_phase(torch, main: dict, small, device, tmp: str, runs,
                card: str) -> dict:
    """Phase 12: phase 4's fleet (``main``: its command line, the
    single-process answers, queries and launches) on each ``(backend, P)``
    of ``runs`` (gloo ranks share the card, nccl puts one on each); then
    a max.plus and a min.plus fleet at ``small``'s size on 2 gloo ranks
    against one process."""
    from repro_torch.core import distributed, stream
    from repro_torch.core import semiring as sr_mod
    from repro_torch.kernels import registry
    from repro_torch.launch import ingest
    res = dict(runs=[])
    for backend, ranks in runs:
        res["runs"].append(fleet_run(
            torch, main["args"], "plus.times", False, main["want"],
            main["queries"], backend, ranks, device, tmp,
            main["launches"], card))
    sig = ingest.signature(small)
    for sr_name in ("max.plus", "min.plus"):
        sr = sr_mod.get(sr_name)
        states = distributed.create_instances(
            small.instances, sig.cuts, small.block_size, sr=sr,
            device=device)
        registry.reset_launches()
        for rnd in range(small.rounds):
            states, _ = stream.ingest_instances(
                states, *fleet_round(torch, small, rnd, device, True),
                sr=sr, **ingest.ingest_knobs(sig))
        launches = registry.launches()
        queries = fleet_queries(torch, states, FLEET_QUERIES, small.scale, 12)
        want = fleet_expected(torch, states, sr, queries, 1 << small.scale)
        res[sr_name] = fleet_run(torch, small, sr_name, True, want, queries,
                                 "gloo", 2, device, tmp, launches, card)
    return res


# ------------------------------------------------------------- phase 13 --

LM_ARCHS = ("deepseek-v2-236b", "granite-moe-3b-a800m", "mistral-nemo-12b",
            "phi3-mini-3.8b", "smollm-360m")
LM_RTOL, LM_ATOL = 1e-4, 1e-5   # card == CPU, float32 logits and caches
DECODE_FWD_TOL = 1e-3           # decode == teacher-forced forward (f32)
DEEPSEEK_LAYERS = 4             # deepseek-v2's depth cut: 60 -> 4


def lm_cross_device(torch, card: str) -> dict:
    """(a): each LM arch's smoke config in float32, one tree drawn from a
    seed on the CPU and copied to ``card``; ``serve.generate`` of [2, 16]
    prompts and 4 greedy steps on both: the last logits and every cache
    leaf within rtol 1e-4 / atol 1e-5, the tokens equal."""
    from repro_torch.configs import registry
    from repro_torch.data.synthetic import token_batch
    from repro_torch.launch import serve
    from repro_torch.models import transformer as tf
    res = {}
    for arch in LM_ARCHS:
        cfg = registry.get_smoke_config(arch)
        params = tf.init(0, cfg, device="cpu")
        prompts = token_batch(1, 2, 16, cfg.vocab, device="cpu")["tokens"]
        want = serve.generate(params, prompts, cfg, 4)
        got = serve.generate(
            tf.params_from_numpy(tf.params_to_numpy(params), card),
            prompts.to(card), cfg, 4)
        if not torch.equal(got["tokens"].cpu(), want["tokens"]):
            raise AssertionError(f"{arch}: greedy tokens on {card} differ "
                                 f"from the CPU's")
        errs = {}
        for name, a, b in [("logits", got["logits"], want["logits"])] + [
                (k, got["cache"][k], want["cache"][k]) for k in want["cache"]]:
            a = a.cpu()
            errs[name] = float((a - b).abs().max())
            if not torch.allclose(a, b, rtol=LM_RTOL, atol=LM_ATOL):
                raise AssertionError(f"{arch}: {name} on {card} differs from "
                                     f"the CPU's by {errs[name]}")
        res[arch] = errs
    return res


def decode_vs_forward(torch, cfg, device) -> dict:
    """(c): prefill of S - 2 = 10 tokens (b 2), then 2 decode steps,
    against ``forward``'s last two positions: the max relative error,
    raised above 1e-3.

    Capacity drops differ between a one-token decode batch and the
    forward by design (GShard), so the check routes drop-free: capacity
    factor 8, or n_experts / top_k where that is larger, so that every
    expert has a slot for each of the forward's 24 tokens (each token
    picks an expert at most once).  The error at factor 8 alone is
    recorded too, not checked: at deepseek-v2's width it leaves 8 slots
    for the 24 tokens."""
    import dataclasses
    from repro_torch.data.synthetic import token_batch
    from repro_torch.models import moe
    from repro_torch.models import transformer as tf
    params = tf.init(2, cfg, device=device)
    toks = token_batch(3, 2, 12, cfg.vocab, device=device)["tokens"]

    def err(c):
        _, cache, n = tf.prefill(params, toks[:, :10], c, max_len=12)
        l1, cache = tf.decode_step(params, toks[:, 10:11], cache, n, c)
        l2, _ = tf.decode_step(params, toks[:, 11:12], cache, n + 1, c)
        full, _ = tf.forward(params, toks, c)
        return max(max_rel_err(l1, full[:, -2]), max_rel_err(l2, full[:, -1]))
    if not cfg.moe:
        res = dict(max_rel_err=err(cfg))
    else:
        free = dataclasses.replace(cfg, capacity_factor=max(
            8.0, cfg.n_experts / cfg.top_k))
        if moe._capacity(2 * 12, tf.moe_config(free)) < 2 * 12:
            raise AssertionError(f"{cfg.name}: capacity below 24 slots")
        res = dict(max_rel_err=err(free),
                   max_rel_err_factor_8=err(dataclasses.replace(
                       cfg, capacity_factor=8.0)))
    if not res["max_rel_err"] <= DECODE_FWD_TOL:
        raise AssertionError(f"{cfg.name}: decode differs from forward by "
                             f"{res['max_rel_err']} (max relative)")
    return res


def serve_record(torch, run, device) -> dict:
    """One serve run (``run()`` -> ``serve.run_config``'s result and
    state): its rates, decode ms a step (of the steady steps: on the card
    the decode's warm-up and capture steps are not timed), peak GiB, the
    weights' bytes over
    the card's memory rate (the least a decode step can take: the
    dispatch runs every expert), and on the card one more decode step
    under ``device_profile``."""
    from repro_torch.models import transformer as tf
    _peak_reset(torch, device)
    out, state = run()
    gen = out["generated"][1] - 1
    if not out["finite"] or out["generated"] != (state["prompts"].shape[0],
                                                 gen + 1):
        raise AssertionError(f"serve: {out}")
    nbytes = sum(p.numel() * p.element_size()
                 for p in state["params"].parameters())
    steps = state["decode_steps"]
    rec = dict(out, decode_steps=steps,
               decode_ms_per_step=out["decode_s"] / max(steps, 1) * 1e3,
               peak_gib=_peak_gib(torch, device), weights_gb=nbytes / 1e9,
               weights_bound_ms=nbytes / HBM_BYTES_PER_S * 1e3)
    if torch.device(device).type == "cuda":
        tok = state["tokens"][:, -1:]
        rec["profile"] = device_profile(torch, lambda: tf.decode_step(
            state["params"], tok, state["cache"], state["cache_len"] - 1,
            state["cfg"]), top=8)
        rec["prefill_profile"] = device_profile(torch, lambda: tf.prefill(
            state["params"], state["prompts"], state["cfg"]), top=8)
    return rec


def _serve_line(name: str, r: dict, card: str) -> str:
    prof = r.get("profile")
    busy = "".join(
        f"; one {what} under the profiler: busy "
        f"{p['device_busy_share']:.3f}, {p['kernels']} kernels, device "
        f"{p['device_ms']:.2f} ms of {p['wall_ms']:.2f}"
        for what, p in (("decode step", prof),
                        ("prefill", r.get("prefill_profile"))) if p)
    return (f"{name}: prefill {r['prefill_tok_s']:.1f} tok/s "
            f"({r['prefill_s']:.4f} s), decode {r['decode_tok_s']:.1f} tok/s "
            f"({r['decode_ms_per_step']:.3f} ms a step; weights "
            f"{r['weights_gb']:.3f} GB, bound {r['weights_bound_ms']:.3f} "
            f"ms), generated {r['generated']}, peak {r['peak_gib']} GiB"
            f"{busy}; {card}")


def serve_phase(torch, device, card: str, *, smoke: bool = False) -> dict:
    """Phase 13: LM serving through ``launch/serve``.  (a) card == CPU at
    smoke size, five archs; (b) granite-moe-3b-a800m's ``config()``, whole,
    at the CLI's defaults (batch 8, prompt 64, gen 32) after an untimed
    warm-up, then at prompt 1024; (c) its decode == forward in float32,
    routing drop-free; (d) deepseek-v2-236b at full width with its
    depth cut to 4 layers, served at the defaults after a warm-up, and the
    absorbed MLA
    decode == the naive forward at 1 layer in float32.  ``smoke`` runs
    (b)-(d) on the smoke configs at small sizes (the CPU rehearsal)."""
    import dataclasses
    from repro_torch.configs import registry
    from repro_torch.kernels import registry as kreg
    from repro_torch.launch import serve
    if torch.device(device).type == "cuda":
        if torch.backends.cuda.matmul.allow_tf32:
            raise AssertionError("TF32 is on")
        syncs_refused(torch, serve, device)
    kreg.reset_launches()
    res = dict(cross_device=lm_cross_device(torch, device))
    print(f"(a) card == CPU, smoke configs, float32: max abs errors "
          f"{json.dumps(res['cross_device'])}", flush=True)

    size = dict(batch=2, prompt_len=16, gen=4) if smoke else {}
    long = dict(size, prompt_len=32 if smoke else 1024)
    granite = "granite-moe-3b-a800m"

    def granite_run(**kw):
        return serve.run_with_state(serve.make_args(
            arch=granite, smoke=smoke, device=device, **kw))
    granite_run(**size)                                   # warm-up
    for key, kw in (("granite", size), ("granite_long", long)):
        res[key] = serve_record(torch, lambda: granite_run(**kw), device)
        print("(b) " + _serve_line(f"{granite} {key}", res[key], card),
              flush=True)

    get = registry.get_smoke_config if smoke else registry.get_config
    f32 = dict(dtype="float32")
    _peak_reset(torch, device)
    res["granite_decode_vs_forward"] = decode_vs_forward(
        torch, dataclasses.replace(get(granite), **f32), device)
    print(f"(c) {granite} float32 decode == forward (drop-free routing): "
          f"max relative error {res['granite_decode_vs_forward']}, peak "
          f"{_peak_gib(torch, device)} GiB; {card}", flush=True)

    ds = get("deepseek-v2-236b")
    if not smoke:
        ds = dataclasses.replace(ds, n_layers=DEEPSEEK_LAYERS)
    res["deepseek_params"] = ds.n_params
    ds_args = serve.make_args(device=device, **size)
    serve.run_config(ds, ds_args)                         # warm-up
    res["deepseek"] = serve_record(
        torch, lambda: serve.run_config(ds, ds_args), device)
    print(f"(d) " + _serve_line(f"deepseek-v2-236b {ds.n_layers} layers, "
                                f"{ds.n_params} params", res["deepseek"],
                                card), flush=True)
    _peak_reset(torch, device)
    res["deepseek_decode_vs_forward"] = decode_vs_forward(
        torch, dataclasses.replace(ds, n_layers=1, **f32), device)
    print(f"(d) deepseek-v2-236b 1 layer float32 absorbed MLA decode == "
          f"naive forward (drop-free routing): max relative error "
          f"{res['deepseek_decode_vs_forward']}, peak "
          f"{_peak_gib(torch, device)} GiB; {card}", flush=True)
    res["launches"] = kreg.launches()
    if any(res["launches"].values()):
        raise AssertionError(f"LM serving launched a kernel: "
                             f"{res['launches']}")
    return res


def syncs_refused(torch, serve, device) -> None:
    """Inside ``serve.no_host_sync`` (the decode loop's guard) a host read
    of a device value must raise."""
    try:
        with serve.no_host_sync(torch.device(device)):
            torch.ones(1, device=device).item()
    except RuntimeError:
        return
    raise AssertionError("no_host_sync let a host sync through")


# ------------------------------------------------------------- phase 14 --

LM_TRAIN_LR = 1e-4     # (a): atol 1e-5 is a tenth of one AdamW step
LM_TRAIN_ATOL = 1e-5
NM_RTOL = 1e-5         # nm 2 == nm 1: the reference's total rtol
SMOLLM = "smollm-360m"
GRANITE = "granite-moe-3b-a800m"


def lm_two_steps(cfg, tree, batches, device, **over):
    """Two ``make_train_step`` steps of ``cfg`` (with ``over``) from the
    numpy tree ``tree`` on ``device``: (params, opt state, metrics of each
    step as floats)."""
    from repro_torch.models import transformer as tf
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    cfg = dataclasses.replace(cfg, **over)
    params = tf.params_from_numpy(tree, device)
    opt = adamw_init(params)
    step = tf.make_train_step(cfg, AdamWConfig(lr=LM_TRAIN_LR))
    ms = []
    for b in batches:
        params, opt, m = step(params, opt,
                              {k: v.to(device) for k, v in b.items()})
        ms.append({k: float(v) for k, v in m.items()})
    return params, opt, ms


def _trees_close(torch, got, want, rtol, atol, what) -> float:
    """Every leaf of ``got`` (trees of params, or of moments) within
    rtol / atol of ``want``'s; returns the largest absolute difference."""
    from repro_torch.models import common
    worst = 0.0
    for x, y in zip(common.tree_leaves(got), common.tree_leaves(want)):
        x, y = x.detach().cpu().float(), y.detach().cpu().float()
        if not torch.allclose(x, y, rtol=rtol, atol=atol):
            raise AssertionError(f"{what}: differ by "
                                 f"{float((x - y).abs().max())}")
        worst = max(worst, float((x - y).abs().max()))
    return worst


def _metrics_close(got, want, keys, rtol, what) -> None:
    for g, w in zip(got, want):
        for k in keys:
            if not abs(g[k] - w[k]) <= rtol * abs(w[k]):
                raise AssertionError(f"{what} {k}: {g[k]} vs {w[k]}")


def lm_train_cross_device(torch, card: str) -> dict:
    """(a): each LM arch's smoke config in float32 under deterministic
    algorithms, one tree drawn on the CPU from a seed: two
    ``make_train_step`` steps with nm 2 on the same numpy batches on the
    CPU and on ``card``, losses and gnorms within rtol 1e-4, params and
    AdamW moments within rtol 1e-4 / atol 1e-5.  On ``card`` also: nm 2
    == nm 1 for the dense archs (total rtol 1e-5, params rtol 1e-4 / atol
    1e-5; an MoE's aux loss and capacity depend on the microbatch, as in
    the reference) and the gradients with remat on == off (max relative
    error <= 1e-5)."""
    from repro_torch.configs import registry
    from repro_torch.data.synthetic import token_batch
    from repro_torch.models import common
    from repro_torch.models import transformer as tf
    res = {}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for arch in LM_ARCHS:
            cfg = registry.get_smoke_config(arch)
            tree = tf.params_to_numpy(tf.init(0, cfg, device="cpu"))
            batches = [token_batch(s, 4, 16, cfg.vocab, device="cpu")
                       for s in (1, 2)]
            want = lm_two_steps(cfg, tree, batches, "cpu",
                                num_microbatches=2)
            got = lm_two_steps(cfg, tree, batches, card,
                               num_microbatches=2)
            _metrics_close(got[2], want[2], ("loss", "gnorm", "total"),
                           XDEV_RTOL, f"{arch} card vs CPU")
            rec = dict(
                losses=[m["loss"] for m in got[2]],
                params_max_abs_err=_trees_close(
                    torch, got[0], want[0], XDEV_RTOL, LM_TRAIN_ATOL,
                    f"{arch} params card vs CPU"),
                moments_max_abs_err=_trees_close(
                    torch, [got[1]["m"], got[1]["v"]],
                    [want[1]["m"], want[1]["v"]], XDEV_RTOL, LM_TRAIN_ATOL,
                    f"{arch} moments card vs CPU"))
            if not cfg.moe:
                one = lm_two_steps(cfg, tree, batches, card,
                                   num_microbatches=1)
                _metrics_close(got[2], one[2], ("total",), NM_RTOL,
                               f"{arch} nm 2 vs 1")
                rec["nm2_vs_nm1_params_max_abs_err"] = _trees_close(
                    torch, got[0], one[0], XDEV_RTOL, LM_TRAIN_ATOL,
                    f"{arch} nm 2 vs 1 params")
            grads = {}
            batch = {k: v.to(card) for k, v in batches[0].items()}
            for remat in (True, False):
                c = dataclasses.replace(cfg, remat=remat)
                params = tf.params_from_numpy(tree, card)
                _, (grads[remat],) = common.value_and_grad(
                    lambda p: tf.loss_fn(p, batch, c), params)
            rec["remat_max_rel_err"] = max(
                max_rel_err(a, b) for a, b in zip(
                    common.tree_leaves(grads[True]),
                    common.tree_leaves(grads[False])))
            if not rec["remat_max_rel_err"] <= TRAIN_RTOL:
                raise AssertionError(f"{arch}: remat on vs off "
                                     f"{rec['remat_max_rel_err']}")
            res[arch] = rec
    finally:
        torch.use_deterministic_algorithms(False)
    return res


def lm_train_record(torch, arch, device, *, smoke: bool, batch: int,
                    seq: int, steps: int = 4) -> dict:
    """(b) / (d): ``arch`` trained through ``launch/train.run_with_state``
    for ``steps`` steps (the first two untimed: on the card the eager
    warm-up of ``train.lm_step`` and its capture): the median step ms and
    tokens/s of the others, replays of the captured step, peak GiB,
    finite losses and gnorms;
    then a gradient of every leaf non-zero and finite on one microbatch
    (``grad_coverage``), and on the card one more step under
    ``device_profile``, under the trainer's sync guard."""
    from repro_torch.configs import registry
    from repro_torch.data.synthetic import token_batch
    from repro_torch.launch import serve, train
    from repro_torch.models import transformer as tf
    from repro_torch.optim.adamw import AdamWConfig
    _peak_reset(torch, device)
    args = train.make_args(arch=arch, smoke=smoke, steps=steps, batch=batch,
                           seq=seq, device=device, log_every=0)
    out, state = train.run_with_state(args)
    if not all(math.isfinite(x) for x in out["losses"] + out["gnorms"]):
        raise AssertionError(f"{arch}: {out['losses']} {out['gnorms']}")
    cfg = (registry.get_smoke_config if smoke else registry.get_config)(arch)
    if smoke:
        cfg = dataclasses.replace(cfg, num_microbatches=1)
    step_s = _median(out["step_s"][2:])
    rec = dict(params=cfg.n_params, layers=cfg.n_layers, batch=batch,
               seq=seq, num_microbatches=cfg.num_microbatches,
               losses=out["losses"], gnorms=out["gnorms"],
               step_ms=step_s * 1e3, tokens_per_s=batch * seq / step_s,
               step_ms_all=[s * 1e3 for s in out["step_s"]],
               peak_gib=_peak_gib(torch, device))
    data = token_batch(train.step_seed(args.seed, steps), batch, seq,
                       cfg.vocab, device=device)
    mb = {k: v[:batch // cfg.num_microbatches] for k, v in data.items()}
    rec["grads"] = grad_coverage(
        torch, lambda p: tf.loss_fn(p, mb, cfg), state["params"])
    if torch.device(device).type == "cuda":
        step = tf.make_train_step(cfg, AdamWConfig(lr=args.lr))

        def one_step():
            with serve.no_host_sync(torch.device(device)):
                step(state["params"], state["opt"], data)
        rec["profile"] = device_profile(torch, one_step, top=8)
        # the profiler's own host work stretches the profiled wall: the
        # device time over the unprofiled step is the card's busy share
        rec["device_ms_over_step_ms"] = rec["profile"]["device_ms"] \
            / rec["step_ms"]
    return rec


def lm_compress_checks(torch, device, *, smoke: bool, batch: int,
                       seq: int) -> dict:
    """(c): one ``--compress int8`` and one ``--compress topk`` step of
    smollm through ``launch/train.run_with_state``; then at its params,
    on step 1's batch, with its error tree: for every leaf decompressed +
    new error == gradient + old error within 1e-5 of max |gradient|, and
    the leaf's wire bytes n + 4 (int8) or 8 k (top-k)."""
    from repro_torch.configs import registry
    from repro_torch.data.synthetic import token_batch
    from repro_torch.launch import train
    from repro_torch.models import common
    from repro_torch.models import transformer as tf
    from repro_torch.optim import compression as comp
    cfg = (registry.get_smoke_config if smoke else registry.get_config)(
        SMOLLM)
    res = {}
    for kind in ("int8", "topk"):
        args = train.make_args(arch=SMOLLM, smoke=smoke, steps=1,
                               batch=batch, seq=seq, compress=kind,
                               device=device, log_every=0)
        out, state = train.run_with_state(args)
        if not all(math.isfinite(x) for x in out["losses"] + out["gnorms"]):
            raise AssertionError(f"compress {kind}: {out}")
        data = token_batch(train.step_seed(args.seed, 1), batch, seq,
                           cfg.vocab, device=device)
        _, (g,) = common.value_and_grad(
            lambda p: tf.loss_fn(p, data, cfg), state["params"])
        ccfg = comp.CompressionConfig(kind)
        payloads, new_err = comp.compress_tree(g, state["err"], ccfg)
        deq = comp.decompress_tree(payloads, ccfg)
        worst, wire, dense = 0.0, 0, 0
        for gl, el, dl, nl, pl in zip(
                *(common.tree_leaves(t) for t in (g, state["err"], deq,
                                                   new_err)),
                _payload_leaves(payloads)):
            top = float(gl.float().abs().max())
            diff = float((dl + nl - (gl.float() + el)).abs().max())
            if not diff <= 1e-5 * top:
                raise AssertionError(f"compress {kind}: a leaf of shape "
                                     f"{tuple(gl.shape)} breaks the "
                                     f"error-feedback invariant by {diff}")
            worst = max(worst, diff / max(top, 1e-30))
            n = gl.numel()
            want = n + 4 if kind == "int8" else 8 * max(1, int(n * 0.01))
            got = comp.wire_bytes(pl, ccfg)
            if got != want:
                raise AssertionError(f"compress {kind}: wire bytes {got} "
                                     f"!= {want} for {n} elements")
            wire += got
            dense += 4 * n
        res[kind] = dict(loss=out["losses"][0], step_ms=out["step_s"][0]
                         * 1e3, invariant_max_rel_err=worst,
                         wire_bytes=wire, dense_f32_bytes=dense,
                         ratio=dense / wire)
        del state, g, payloads, new_err, deq
    return res


def _payload_leaves(tree) -> list:
    """The per-leaf payload dicts of a compressed tree, in leaf order."""
    from repro_torch.optim.compression import _is_payload
    if _is_payload(tree):
        return [tree]
    kids = sorted(tree.items()) if isinstance(tree, dict) else \
        enumerate(tree)
    return [p for _, v in kids for p in _payload_leaves(v)]


def lm_resume_checks(torch, device, tmp) -> dict:
    """(e): the train CLI at smoke size for smollm and granite, plain and
    ``--compress int8``: ``--ckpt-every 4 --fail-at-step 6``, and a run
    cut at step 6 then ``--resume``d, both end on the uninterrupted run's
    loss within TRAIN_RTOL."""
    from repro_torch.launch import train
    out = {}
    for arch in (SMOLLM, GRANITE):
        for compress in ("", "int8"):
            name = f"{arch} {compress or 'plain'}"
            kw = dict(arch=arch, smoke=True, steps=10, batch=2, seq=32,
                      compress=compress, device=device, log_every=0)
            base = train.run(train.make_args(**kw))
            failed = train.run(train.make_args(
                ckpt_dir=os.path.join(tmp, name, "a"), ckpt_every=4,
                fail_at_step=6, **kw))
            cut = dict(kw, ckpt_dir=os.path.join(tmp, name, "b"),
                       ckpt_every=4)
            train.run(train.make_args(**dict(cut, steps=6)))
            resumed = train.run(train.make_args(**dict(cut, resume=True)))
            want = base["final_loss"]
            rel = max(abs(r["final_loss"] - want) / abs(want)
                      for r in (failed, resumed))
            if failed["failures"] != 1 or len(resumed["losses"]) != 4 \
                    or not rel <= TRAIN_RTOL:
                raise AssertionError(f"{name}: resumed {failed['final_loss']}"
                                     f" / {resumed['final_loss']} vs {want}")
            out[name] = dict(final_loss=want, resumed_rel_err=rel)
    return out


def train_lm_phase(torch, device, card: str, tmp: str, *,
                   smoke: bool = False) -> dict:
    """Phase 14: LM training.  (a) card == CPU at smoke size, five archs;
    (b) smollm-360m's ``config()`` whole at 4 x 4096; (c) its compression
    at 4 x 1024; (d) granite-moe-3b-a800m's ``config()`` whole at 8 x
    1024; (e) resume == uninterrupted at smoke size.  ``smoke`` runs
    (b)-(d) on the smoke configs at small sizes (the CPU rehearsal)."""
    from repro_torch.kernels import registry as kreg
    from repro_torch.launch import serve
    t0 = time.perf_counter()
    if torch.device(device).type == "cuda":
        if torch.backends.cuda.matmul.allow_tf32:
            raise AssertionError("TF32 is on")
        syncs_refused(torch, serve, device)
    kreg.reset_launches()
    res = dict(cross_device=lm_train_cross_device(torch, device))
    print(f"(a) card == CPU, smoke configs, float32, two steps at nm 2: "
          f"{json.dumps(res['cross_device'])}", flush=True)
    small = dict(batch=4, seq=32) if smoke else {}
    res["smollm"] = lm_train_record(torch, SMOLLM, device, smoke=smoke,
                                    **dict(dict(batch=4, seq=4096), **small))
    print("(b) " + _train_line(SMOLLM, res["smollm"], card), flush=True)
    res["compress"] = lm_compress_checks(
        torch, device, smoke=smoke, **dict(dict(batch=4, seq=1024), **small))
    print(f"(c) {SMOLLM} compression: {json.dumps(res['compress'])}; "
          f"{card}", flush=True)
    res["granite"] = lm_train_record(torch, GRANITE, device, smoke=smoke,
                                     **dict(dict(batch=8, seq=1024), **small))
    print("(d) " + _train_line(GRANITE, res["granite"], card), flush=True)
    res["resume"] = lm_resume_checks(torch, device, tmp)
    print(f"(e) resume == uninterrupted: {json.dumps(res['resume'])}",
          flush=True)
    res["launches"] = kreg.launches()
    if any(res["launches"].values()):
        raise AssertionError(f"LM training launched a kernel: "
                             f"{res['launches']}")
    res["wall_s"] = time.perf_counter() - t0
    return res


def _train_line(arch: str, r: dict, card: str) -> str:
    prof = r.get("profile")
    busy = (f"; one step under the profiler: busy "
            f"{prof['device_busy_share']:.3f}, {prof['kernels']} kernels, "
            f"device {prof['device_ms']:.2f} ms of {prof['wall_ms']:.2f} "
            f"({r['device_ms_over_step_ms']:.3f} of an unprofiled step)"
            if prof else "")
    return (f"{arch} ({r['params']} params, {r['layers']} layers) at "
            f"{r['batch']} x {r['seq']}, nm {r['num_microbatches']}: "
            f"{r['step_ms']:.3f} ms a step (median after the warm-up and "
            f"the capture), "
            f"{r['tokens_per_s']:.1f} tokens/s, peak {r['peak_gib']} GiB, "
            f"losses {r['losses']}, {r['grads']['leaves']} leaves with a "
            f"gradient{busy}; {card}")


# ------------------------------------------------------------- phase 15 --

STAGES_RUNS = 5          # runs a side of each A/B, the arms interleaved
TRAIN_AB_STEPS = 6       # (d): steps a side
MM = "hier_merge.merge_multi"

CAPTURE_REFUSED = """
import sys
import torch
sys.path.insert(0, "src")
from repro_torch import stages
w = stages.wrap(lambda x: x * x.sum().item(), "smoke.host_read",
                stages.signature_of(extra=(("case", "host_read"),)),
                kind="graph")
x = torch.ones(4, device="cuda")
w(x)
try:
    w(x)
except RuntimeError as e:
    print("refused:", str(e).strip().splitlines()[0][:160])
    print("captures", stages.stats()["captures"])
    sys.exit(0)
print("captured a host read")
sys.exit(1)
"""


def front_door_check(torch, device, tmp, small=None):
    """(a): ``precompile_fleet`` at phase 4's geometry with phase 9's query
    knobs (``small``: the CPU rehearsal's) makes every entry of
    ``fleet_jobs``; then a ``launch/ingest`` run (the stream in phase 9's
    rounds) and a ``launch/query`` run, both with ``--obs``, add no
    lowering and no compile, and ``obs.jsonl`` holds one ``dispatch``
    record per dispatch.  Returns (numbers, the query run's live fleet)."""
    from repro_torch import stages
    from repro_torch.launch import ingest, query
    from repro_torch.obs import trace as obs_trace
    obs_dir = os.path.join(tmp, "obs")
    geo = dict(small or {})
    qx = {k: geo.pop(k) for k in ("queries", "top_k") if k in geo}
    q_args = service_args(device=device, obs=True, obs_dir=obs_dir,
                          **geo, **qx)
    i_args = ingest_args(**dict(geo, device=device, rounds=q_args.rounds,
                                obs=True, obs_dir=obs_dir))
    sig = dataclasses.replace(ingest.signature(i_args),
                              l0_mode=q_args.l0_mode)
    job_kw = dict(instances=q_args.instances,
                  blocks=q_args.blocks // q_args.rounds,
                  queries=q_args.queries,
                  analytics_num_rows=1 << q_args.scale,
                  analytics_k=q_args.top_k, device=device)
    stages.clear_memory_cache()
    stages.reset_stats()
    report = stages.precompile_fleet(sig, **job_kw)
    names = [e for e, _, _ in stages.fleet_jobs(sig, **job_kw)]
    if sorted(report) != sorted(names):
        raise AssertionError(f"precompile_fleet {report} != {names}")
    s0 = stages.stats()
    try:
        ingest.run(i_args)
        stats, _, states = query.run_with_states(q_args)
    finally:
        obs_trace.disable()
    s1 = stages.stats()
    delta = {k: s1[k] - s0[k] for k in ("lowerings", "compiles",
                                        "dispatches", "memory_hits",
                                        "captures")}
    if delta["lowerings"] or delta["compiles"]:
        raise AssertionError(f"the runs after precompile_fleet compiled: "
                             f"{delta}")
    with open(os.path.join(obs_dir, "obs.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    disp = [r for r in recs if r["ev"] == "dispatch"]
    kinds = {}
    for r in disp:
        kinds[r["kind"]] = kinds.get(r["kind"], 0) + 1
    if len(disp) != delta["dispatches"]:
        raise AssertionError(f"{len(disp)} dispatch records for "
                             f"{delta['dispatches']} dispatches")
    want_graph = torch.device(device).type == "cuda"
    if bool(kinds.get("graph")) != want_graph:
        raise AssertionError(f"dispatch kinds {kinds}")
    return dict(precompile=report, after_precompile=delta,
                dispatch_records=len(disp), kinds=kinds,
                per_entry={e: v["dispatches"] for e, v in
                           s1["per_entry"].items()},
                queries_per_s=stats["queries_per_s"]), states


def _arm_times(torch, device, arms, runs):
    """``runs`` rounds of every arm in turn, each call timed alone (host
    clock, a synchronize before and after); returns {arm: [ms]} and the
    last output of each arm."""
    times, outs = {a: [] for a in arms}, {}
    for _ in range(runs):
        for name, fn in arms.items():
            _sync(torch, device)
            t0 = time.perf_counter()
            outs[name] = fn()
            _sync(torch, device)
            times[name].append((time.perf_counter() - t0) * 1e3)
    return times, outs


def canon_batch_ab(torch, states, device, *, queries=256, runs=7):
    """(b): phase 9's canon query batch (every instance, ``queries``
    lookups, ``use_kernel``) through ``service.point_query``, eager
    (``wrapped.fn``) and captured, ``runs`` batches a side interleaved
    after the eager warm-up and the capture: answers equal exactly, ms a
    batch, ``merge_multi`` launches a replay (one an instance), bytes
    copied into the graph's inputs for the same fleet (0) and for a fresh
    copy of it, and on the card each arm's device busy share."""
    from repro_torch.core import stream
    from repro_torch.kernels import registry
    from repro_torch.query import service
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    q = service.make_point_query_fn(use_kernel=True, l0_mode="canon")
    gen = torch.Generator(device=dev)
    gen.manual_seed(15)
    half = queries // 2
    l1 = states.layers[1]
    rand = lambda: torch.randint(0, 1 << 20, (queries - half,),  # noqa: E731
                                 generator=gen, device=dev,
                                 dtype=torch.int32)
    qr = torch.cat([l1.hi[0, :half], rand()])
    qc = torch.cat([l1.lo[0, :half], rand()])
    want = q.fn(states, qr, qc).clone()
    got = q.steady(states, qr, qc)
    _exact(got, want, "captured canon batch")
    comp = q.last
    times, outs = _arm_times(torch, dev, dict(
        eager=lambda: q.fn(states, qr, qc),
        graph=lambda: q(states, qr, qc)), runs)
    for name, out in outs.items():
        _exact(out, want, f"{name} canon batch")
    same_bytes = comp.copied_bytes
    before = registry.launches()
    q(states, qr, qc)
    _sync(torch, dev)
    per_replay = registry.launches()[MM] - before[MM]
    want_launches = states.n_updates.shape[0] if on_card else 0
    if per_replay != want_launches:
        raise AssertionError(f"a replay launched merge_multi {per_replay} "
                             f"times, want {want_launches}")
    fresh = stream.clone_state(states)
    _sync(torch, dev)
    t0 = time.perf_counter()
    _exact(q(fresh, qr, qc), want, "canon batch on a fresh fleet")
    fresh_ms = (time.perf_counter() - t0) * 1e3
    res = dict(instances=int(states.n_updates.shape[0]), queries=queries,
               runs=runs, eager_ms=times["eager"], graph_ms=times["graph"],
               eager_median_ms=_median(times["eager"]),
               graph_median_ms=_median(times["graph"]),
               merge_multi_per_replay=per_replay,
               copied_bytes_same_fleet=same_bytes,
               copied_bytes_fresh_fleet=comp.copied_bytes,
               fresh_fleet_ms=fresh_ms, replay_sync_mode=comp.replay_sync_mode)
    if on_card:
        res["eager_profile"] = device_profile(torch, lambda: q.fn(
            states, qr, qc))
        res["graph_profile"] = device_profile(torch, lambda: q(
            states, qr, qc))
        if comp.replay_sync_mode != 2:
            raise AssertionError(f"replay under sync mode "
                                 f"{comp.replay_sync_mode}")
    q.release()
    return res


DECODE_LOGITS_TOL = 2e-2    # bf16 logits of two launch sequences, see below


def decode_ab(torch, device, *, smoke: bool, runs: int, batch: int = 8,
              prompt: int = 64, gen: int = 32) -> dict:
    """(c): ``granite-moe-3b-a800m``'s ``config()`` whole (``smoke``: its
    smoke config) served through ``serve.serve_steps`` at batch 8, prompt
    64, gen 32: the decode loop eager (``decode.fn``) and captured,
    ``runs`` timed runs a side interleaved after one untimed run of each
    (the captured arm's warm-up and capture; later runs replay from the
    first step, which copies the new prefill's cache into the graph's).
    Tokens equal in every run.  Logits bit-equal under deterministic
    algorithms (a fresh capture made under them); otherwise within
    ``DECODE_LOGITS_TOL`` of the largest logit, since a matmul may pick
    another cuBLAS algorithm for the capture stream's workspace.  Ms a
    step, tok/s, and on the card kernels a step, busy share and peak
    GiB."""
    from repro_torch.configs import registry
    from repro_torch.data.synthetic import token_batch
    from repro_torch.launch import serve
    from repro_torch.models import transformer as tf
    from repro_torch.models.attention import as_length
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    get = registry.get_smoke_config if smoke else registry.get_config
    cfg = dataclasses.replace(get(GRANITE), prefill_microbatch=0)
    _peak_reset(torch, dev)
    params = tf.init(0, cfg, device=dev)
    prompts = token_batch(0, batch, prompt - 1, cfg.vocab,
                          device=dev)["tokens"]
    prompts = torch.cat([prompts, torch.zeros((batch, 1), dtype=torch.int32,
                                              device=dev)], dim=1)
    prefill, decode = serve.serve_steps(cfg, prompt + gen, GRANITE, smoke)
    last = {}

    def run(step):
        logits, cache, n = prefill(params, prompts)
        length = as_length(n, dev)
        toks = [torch.argmax(logits, dim=-1).to(torch.int32)]
        _sync(torch, dev)
        t0 = time.perf_counter()
        with serve.no_host_sync(dev):
            for i in range(gen):
                logits, cache = step(params, toks[-1][:, None].clone(),
                                     cache, length + i)
                toks.append(torch.argmax(logits, dim=-1).to(torch.int32))
        _sync(torch, dev)
        last.update(cache=cache, tok=toks[-1][:, None], length=length)
        return (torch.stack(toks, dim=1), logits.float().clone(),
                time.perf_counter() - t0)

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        te, le, _ = run(decode.fn)
        tg, lg, _ = run(decode)
    finally:
        torch.use_deterministic_algorithms(False)
    decode.release()
    if not (torch.equal(te, tg) and torch.equal(le, lg)):
        raise AssertionError("decode under deterministic algorithms: the "
                             "captured logits differ from the eager ones "
                             f"by {float((le - lg).abs().max())}")
    run(decode.fn)
    run(decode)                                   # warm-up and capture
    res = dict(batch=batch, prompt=prompt, gen=gen, runs=runs,
               params=cfg.n_params, eager_ms_per_step=[],
               graph_ms_per_step=[], logits_max_abs_err=0.0)
    for _ in range(runs):
        te, le, de = run(decode.fn)
        tg, lg, dg = run(decode)
        if not torch.equal(te, tg):
            raise AssertionError("decode: captured tokens != eager tokens")
        err = float((le - lg).abs().max())
        if not err <= DECODE_LOGITS_TOL * float(le.abs().max()):
            raise AssertionError(f"decode logits differ by {err}")
        res["logits_max_abs_err"] = max(res["logits_max_abs_err"], err)
        res["eager_ms_per_step"].append(de / gen * 1e3)
        res["graph_ms_per_step"].append(dg / gen * 1e3)
    for arm in ("eager", "graph"):
        ms = _median(res[f"{arm}_ms_per_step"])
        res[f"{arm}_median_ms_per_step"] = ms
        res[f"{arm}_tok_s"] = batch / ms * 1e3
    comp = decode.last
    res.update(graph_copied_bytes_steady=comp.copied_bytes,
               replays=comp.replays, logits_bit_equal_deterministic=True,
               peak_gib=_peak_gib(torch, dev))
    if on_card:
        args = (params, last["tok"], last["cache"], last["length"])
        res["eager_profile"] = device_profile(
            torch, lambda: decode.fn(*args), top=4)
        res["graph_profile"] = device_profile(
            torch, lambda: decode(*args), top=4)
        if comp.replay_sync_mode != 2:
            raise AssertionError(f"replay under sync mode "
                                 f"{comp.replay_sync_mode}")
    decode.release()
    return res


def train_ab(torch, device, *, smoke: bool, batch: int, seq: int,
             steps: int = TRAIN_AB_STEPS) -> dict:
    """(d): ``granite-moe-3b-a800m``'s ``config()`` whole (nm 8) through
    ``train._lm_setup``'s ``train.lm_step``, four arms of ``steps`` steps,
    each from a state initialised anew from the seed: eager
    (``wrapped.fn``) and through the front door (the first step the eager
    warm-up, the second the capture and its first replay), first under
    deterministic algorithms, then without; each step under the trainer's
    sync guard and ended by reading its loss.  The gate is the
    deterministic pair: losses and gnorms within rtol 1e-5 (the MoE
    backward's atomic adds part even two eager runs without them; that
    pair's difference is recorded, not checked).  Per arm the median step
    ms of steps 2-6 (and of 3-6, the replays alone), tokens/s and peak
    GiB; on the card one more step of each default-mode arm under
    ``device_profile``."""
    from repro_torch.configs import registry
    from repro_torch.launch import serve, train
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    cfg = (registry.get_smoke_config if smoke else registry.get_config)(
        GRANITE)
    args = train.make_args(arch=GRANITE, smoke=smoke, batch=batch, seq=seq,
                           device=device, log_every=0)

    def arm(graph: bool, profile: bool) -> dict:
        _peak_reset(torch, dev)
        state, step, data = train._lm_setup(cfg, args, dev)
        fn = step if graph else step.fn
        out = dict(losses=[], gnorms=[], step_ms=[])
        for s in range(steps):
            b = data(s)
            _sync(torch, dev)
            t0 = time.perf_counter()
            with serve.no_host_sync(dev):
                state, m = fn(state, b)
            out["losses"].append(float(m["loss"]))
            out["step_ms"].append((time.perf_counter() - t0) * 1e3)
            out["gnorms"].append(float(m["gnorm"]))
        out["peak_gib"] = _peak_gib(torch, dev)
        if on_card and profile:
            b = data(steps)

            def one():
                with serve.no_host_sync(dev):
                    fn(state, b)
            out["profile"] = device_profile(torch, one, top=4)
        if graph:
            out["copied_bytes"] = step.last.copied_bytes
            out["replay_sync_mode"] = step.last.replay_sync_mode
        step.release()
        del state, m
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        for k, xs in (("2_6", out["step_ms"][1:]),
                      ("3_6", out["step_ms"][2:])):
            out[f"median_ms_steps_{k}"] = _median(xs)
        out["tokens_per_s"] = batch * seq / out["median_ms_steps_2_6"] * 1e3
        return out

    def rel(a, b, key):
        return max(abs(x - y) / abs(y) for x, y in zip(a[key], b[key]))

    res = dict(params=cfg.n_params, batch=batch, seq=seq,
               num_microbatches=cfg.num_microbatches, steps=steps)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        res["eager_det"] = arm(False, False)
        res["graph_det"] = arm(True, False)
    finally:
        torch.use_deterministic_algorithms(False)
    for key in ("losses", "gnorms"):
        err = rel(res["graph_det"], res["eager_det"], key)
        if not err <= TRAIN_RTOL:
            raise AssertionError(f"captured {key} {res['graph_det'][key]} "
                                 f"vs eager {res['eager_det'][key]}: {err}")
        res["graph_det"][f"{key}_max_rel_err"] = err
    res["eager"] = arm(False, True)
    res["graph"] = arm(True, True)
    for key in ("losses", "gnorms"):
        res["graph"][f"{key}_max_rel_err"] = rel(res["graph"], res["eager"],
                                                 key)
    for name in ("graph_det", "graph"):
        if on_card and res[name]["replay_sync_mode"] != 2:
            raise AssertionError("a train replay ran outside the sync guard")
    return res


def train_smoke_bits(torch, device) -> dict:
    """(d): each LM arch's smoke config in float32, nm 2, under
    deterministic algorithms: two ``train.lm_step`` steps eagerly and two
    through the front door (on the card the second a replay), each from
    the same seed's state: every parameter and moment bit for bit."""
    from repro_torch.configs import registry
    from repro_torch.launch import serve, train
    from repro_torch.models import common
    dev = torch.device(device)
    res = {}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for arch in LM_ARCHS:
            cfg = dataclasses.replace(registry.get_smoke_config(arch),
                                      dtype="float32", num_microbatches=2)
            args = train.make_args(arch=arch, smoke=True, batch=4, seq=32,
                                   lr=LM_TRAIN_LR, device=device,
                                   log_every=0)
            ends = []
            for graph in (False, True):
                state, step, data = train._lm_setup(cfg, args, dev)
                fn = step if graph else step.fn
                for s in range(2):
                    with serve.no_host_sync(dev):
                        state, _ = fn(state, data(s))
                ends.append([x.clone() for x in common.tree_leaves(
                    state["params"]) + common.tree_leaves(state["opt"])])
                step.release()
            same = all(torch.equal(a, b) for a, b in zip(*ends))
            if not same:
                raise AssertionError(f"{arch}: captured params or moments "
                                     f"differ from the eager ones")
            res[arch] = dict(leaves=len(ends[0]), bit_equal=same)
    finally:
        torch.use_deterministic_algorithms(False)
    return res


def capture_refused(torch) -> dict:
    """(e): a ``"graph"`` entry whose function reads the host is refused at
    its capture — the dispatch raises, no graph is kept and nothing falls
    back to eager; run in a process of its own, since a failed capture
    may leave its CUDA context unusable."""
    out = subprocess.run([sys.executable, "-c", CAPTURE_REFUSED], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    if out.returncode != 0 or "captures 0" not in out.stdout:
        raise AssertionError(f"a host read was captured: rc "
                             f"{out.returncode}\n{out.stdout}\n"
                             f"{out.stderr[-2000:]}")
    return dict(refused=out.stdout.strip().splitlines()[0])


def stages_phase(torch, device, card: str, tmp: str, *,
                 smoke: bool = False) -> dict:
    """Phase 15: the ``stages`` front door.  (a) ``front_door_check``;
    (b) ``canon_batch_ab``; (c) ``decode_ab``; (d) ``train_ab`` and
    ``train_smoke_bits``; (e) on the card, ``capture_refused``, and every
    replay of (b)-(d) under ``set_sync_debug_mode("error")``.  The eager
    arm of each A/B calls the entry's ``wrapped.fn``; timings leave out
    the warm-up and capture dispatches.  ``smoke`` runs at small sizes
    (the CPU rehearsal, where every entry is eager)."""
    from repro_torch import stages
    t0 = time.perf_counter()
    small = dict(instances=3, blocks=16, block_size=32, cuts="64,256,1024",
                 scale=10, rounds=4, queries=64, top_k=4) if smoke else None
    res = {}
    res["front_door"], states = front_door_check(torch, device, tmp, small)
    print(f"(a) precompile_fleet {json.dumps(res['front_door'])}; {card}",
          flush=True)
    res["canon_batch"] = canon_batch_ab(
        torch, states, device, queries=64 if smoke else 256)
    del states
    r = res["canon_batch"]
    print(f"(b) canon query batch {r['instances']} x {r['queries']}: eager "
          f"{r['eager_median_ms']:.3f} ms, captured "
          f"{r['graph_median_ms']:.3f} ms (median of {r['runs']} each, "
          f"interleaved), answers equal; {r['merge_multi_per_replay']} "
          f"merge_multi a replay; copied {r['copied_bytes_same_fleet']} B "
          f"(same fleet) / {r['copied_bytes_fresh_fleet']} B (fresh fleet, "
          f"{r['fresh_fleet_ms']:.3f} ms); {card}", flush=True)
    res["decode"] = decode_ab(torch, device, smoke=smoke, runs=STAGES_RUNS,
                              **(dict(batch=2, prompt=16, gen=4) if smoke
                                 else {}))
    r = res["decode"]
    print(f"(c) {GRANITE} decode b{r['batch']} p{r['prompt']} g{r['gen']}: "
          f"eager {r['eager_median_ms_per_step']:.3f} ms a step "
          f"({r['eager_tok_s']:.1f} tok/s), captured "
          f"{r['graph_median_ms_per_step']:.3f} ms ({r['graph_tok_s']:.1f} "
          f"tok/s), median of {r['runs']} runs each; tokens equal, logits "
          f"max abs err {r['logits_max_abs_err']} (bit-equal under "
          f"deterministic algorithms); peak {r['peak_gib']} GiB; {card}",
          flush=True)
    res["train_smoke_bits"] = train_smoke_bits(torch, device)
    print(f"(d) smoke configs, float32, nm 2, deterministic: captured == "
          f"eager bit for bit {json.dumps(res['train_smoke_bits'])}",
          flush=True)
    res["train"] = train_ab(torch, device, smoke=smoke,
                            **(dict(batch=4, seq=32) if smoke
                               else dict(batch=8, seq=1024)))
    r = res["train"]
    for mode, e, g in (("deterministic", "eager_det", "graph_det"),
                       ("default", "eager", "graph")):
        print(f"(d) {GRANITE} train {r['batch']} x {r['seq']} nm "
              f"{r['num_microbatches']}, {mode} algorithms: eager "
              f"{r[e]['median_ms_steps_2_6']:.2f} ms a step, captured "
              f"{r[g]['median_ms_steps_2_6']:.2f} ms (steps 3-6: "
              f"{r[g]['median_ms_steps_3_6']:.2f}); losses within "
              f"{r[g]['losses_max_rel_err']}, peak {r[e]['peak_gib']} / "
              f"{r[g]['peak_gib']} GiB; {card}", flush=True)
    if torch.device(device).type == "cuda":
        res["capture_refused"] = capture_refused(torch)
        print(f"(e) {res['capture_refused']['refused']}; every replay under "
              f"sync debug mode error", flush=True)
    res["stats"] = {k: v for k, v in stages.stats().items()
                    if k != "per_entry"}
    stages.clear_memory_cache()
    res["wall_s"] = time.perf_counter() - t0
    return res


# ------------------------------------------------------------- phase 16 --

# the kernels line's rows and the main-path job of each (palkit)
ANALYSIS_JOBS = {
    "hier_merge.merge_multi": "hier_merge.merge_multi_cuda/main.3072+16384",
    "hier_merge.merge": "hier_merge.merge_cuda/main.19456+13312",
    "embedding_bag.embedding_bag":
        "embedding_bag.embedding_bag_cuda/main.serve_bulk",
    "segment_agg.segment_sum":
        "segment_agg.segment_sum_cuda/main.graphcast_r6",
}


def palkit_check(tmp: str) -> dict:
    """(a) + (b): ``python -m repro_torch.analysis.palkit --check`` in a
    process of its own: every registry job and the
    kernels at the main path's shapes built, launched, held against their
    plain versions and their SMEM_BUDGETS.json rows, and run under each
    compute-sanitizer tool (or, where a tool cannot run on the machine,
    the checked build).  Without a card it must exit 2.  Returns its JSON
    report (None on the CPU)."""
    import torch
    path = os.path.join(tmp, "palkit.json")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.analysis.palkit",
                          "--check", "--json", path],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=900)
    if not torch.cuda.is_available():
        if out.returncode != 2 or "no CUDA device" not in out.stderr:
            raise AssertionError(f"palkit without a card: rc "
                                 f"{out.returncode}, {out.stderr[-500:]}")
        return None
    print("\n".join(l for l in out.stdout.splitlines()
                    if not l.startswith(" ")), flush=True)
    if out.returncode != 0:
        raise AssertionError(f"palkit --check failed: rc {out.returncode}\n"
                             f"{out.stdout[-3000:]}\n{out.stderr[-3000:]}")
    with open(path, encoding="utf-8") as fh:
        return json.load(fh)


def kernel_checks(report: dict, job: str) -> dict:
    """(d): a kernels-line row's resources (the largest over its main-path
    job's launches) and one error count per sanitizer tool: the tool's own
    where it ran, else the checked build's count for the tool's class;
    None, with the reason under ``not_covered``, where the checked build
    has no check of that class (racecheck's shared-memory races)."""
    from repro_torch.analysis import palkit
    j = report["jobs"][job]
    ls = j["launches"]
    san = report["sanitizer"]
    counts, by, why, uncovered = {}, {}, set(), {}
    for tool, c in palkit.STANDS_IN.items():
        if j["tools"].get(tool) is not None:
            counts[tool], by[tool] = j["tools"][tool], "compute-sanitizer"
            continue
        why.add(san[tool]["message"])
        if c is None:
            counts[tool] = None
            uncovered[tool] = (f"compute-sanitizer {tool} did not run; "
                               f"{palkit.RACE_NOT_COVERED}")
        else:
            counts[tool], by[tool] = j["checked"][c], f"checked build ({c})"
    if len({v.split(" (")[0] for v in by.values()}) == 1:
        by = next(iter(by.values())).split(" (")[0]
    return dict(regs=max(l["regs"] for l in ls),
                smem_static=max(l["smem_static"] for l in ls),
                smem_dynamic=max(l["smem_dynamic"] for l in ls),
                spill_bytes=max(l["spill_bytes"] for l in ls),
                sanitizer=dict(counts, counted_by=by,
                               not_covered=uncovered,
                               compute_sanitizer="; ".join(sorted(why))
                               or "ran"))


def tracekit_check(torch, device, *, smoke: bool = False) -> dict:
    """(c): tracekit over the fleet entries at ``d4m_stream.config()``'s
    geometry (smoke: the smoke config) on ``device``, the kernel route
    on: the gate is the rules (0 fresh violations, no host read in the
    graph entry ``service.point_query``), not the budgets, which are the
    CPU's at the smoke config and are printed beside each entry's numbers
    here.  Returns the rows and the launches of the recorded calls."""
    from repro_torch.analysis import tracekit
    from repro_torch.configs import d4m_stream
    from repro_torch.kernels import registry
    cfg = d4m_stream.smoke_config() if smoke else d4m_stream.config()
    cfg = dataclasses.replace(cfg, use_kernel=True)
    registry.reset_launches()
    res = tracekit.audit_fleet(cfg, device=device)
    launches = registry.launches()
    if res["fresh"]:
        raise AssertionError("tracekit: fresh violations\n" + "\n".join(
            v.render() for v in res["fresh"]))
    graph_reads = [v.render() for v in res["violations"]
                   if v.rule == "J004" and v.entry == "service.point_query"]
    if graph_reads:
        raise AssertionError(f"host read in the graph entry: {graph_reads}")
    budgets = {row["entry"]: row for row in tracekit.load_budgets(
        tracekit.DEFAULT_BUDGETS)["entries"].values()}
    rows = {}
    for key, m in sorted(res["measured"].items()):
        cpu = budgets.get(m["entry"], {})
        rows[m["entry"]] = dict(
            {k: m[k] for k in ("flops", "bytes_accessed", "peak_bytes",
                               "calls", "host_reads_per_call",
                               "launches_per_call")},
            cpu_smoke_budget={k: cpu.get(k) for k in
                              ("flops", "bytes_accessed", "peak_bytes")})
        print(f"  {m['entry']}: flops {m['flops']:g}, bytes_accessed "
              f"{m['bytes_accessed']:.6g} (CPU smoke budget "
              f"{cpu.get('bytes_accessed')}), peak_bytes {m['peak_bytes']} "
              f"({cpu.get('peak_bytes')}), host reads a call "
              f"{m['host_reads_per_call']:g}, launches a call "
              f"{m['launches_per_call']:g}", flush=True)
    return dict(entries=rows, launches=launches,
                violations=len(res["violations"]),
                allowed=len(res["suppressed"]), fresh=0)


def analysis_phase(torch, device, card: str, tmp: str, *,
                   smoke: bool = False) -> dict:
    """Phase 16: the analysis layer on the card — (a) + (b)
    ``palkit_check``, (c) ``tracekit_check``; the kernels line's (d)
    comes from (a)'s report.  ``smoke`` (the CPU rehearsal): palkit must
    exit 2, tracekit runs the smoke config."""
    t0 = time.perf_counter()
    report = palkit_check(tmp)
    res = dict(palkit=None if report is None else dict(
        sanitizer={t: {k: v for k, v in r.items() if k != "per_kernel"}
                   for t, r in report["sanitizer"].items()},
        violations=len(report["violations"]), fresh=len(report["fresh"]),
        measured=report["measured"]))
    print(f"(a, b) palkit: {res['palkit'] and res['palkit']['fresh']} fresh "
          f"violations; {card}", flush=True)
    res["tracekit"] = tracekit_check(torch, device, smoke=smoke)
    print(f"(c) tracekit: {res['tracekit']['violations']} violation(s), "
          f"{res['tracekit']['allowed']} allowed, 0 new; launches of the "
          f"recorded calls {res['tracekit']['launches']}; {card}",
          flush=True)
    res["report"] = report
    res["wall_s"] = time.perf_counter() - t0
    return res


# ------------------------------------------------------------- phase 17 --

SHARD_RANKS = (2, 4)            # gloo ranks sharing the card, (a)
SHARD_GROW = 40                 # phase 10's 32-instance fleet grown to 40
MESH_LR = 1e-3                  # the reference's test_real_execution lr
MESH_LOSS_TOL = 5e-4            # ... and its loss bound
MESH_PARAM_RTOL = 1e-4          # params: rtol plus a tenth of one lr step
MESH_AXES = ("data", "model")
# the five smoke configs (phi3-mini's is the reference's test), then
# smollm-360m whole
MESH_JOBS = tuple((arch, True, 8, 32) for arch in (
    "phi3-mini-3.8b", "deepseek-v2-236b", "granite-moe-3b-a800m",
    "mistral-nemo-12b", "smollm-360m")) + (("smollm-360m", False, 4, 1024),)


GRAPHCAST_D_FEAT = 100          # GNN_SHAPES["ogb_products"]["d_feat"]
# (d) on the machine's CPU, a (2, 2) gloo mesh under make_policy(mesh,
# "dp"): (arch, seed_count) at smoke widths — GAT's node loss on 16 seeds,
# GIN's graph task on batched molecules, GatedGCN's node task, GraphCast's
# regression on the r = 2 multimesh (162 nodes: the nodes stay whole, the
# edges are cut), DCN-v2's dense step, serving and retrieval
MODEL_MESH_JOBS = (("gat-cora", 16), ("gin-tu", 0), ("gatedgcn", 0),
                   ("graphcast", 0), ("dcn-v2", 0))
MODEL_MESH_LR = dict(gnn=1e-2, recsys=1e-3)
MODEL_MESH_STEPS = dict(gnn=2, recsys=1)
SCORE_RTOL = 1e-6               # sharded serving == unsharded
MESH_TOPK = 8


def shard_fleet_rank(mesh, args, ckpt_dir: str, step: int, n_new: int
                     ) -> dict:
    """One rank of phase 17 (a) (``spawn_fleet``): checkpoint ``step`` of
    ``args``' fleet restored under ``Shard(0)`` of the fleet's
    ``("data",)`` ``DeviceMesh`` (the rank reads its block from disk),
    resized to ``n_new`` instances under the same sharding, then the
    remaining rounds of the grown fleet's stream through
    ``sharded_ingest_fn``.  Returns the rank's block (numpy), its
    restored block's shape, the fleet counter, launches, times and peak
    memory."""
    import argparse

    import torch
    from repro_torch.checkpoint import ckpt
    from repro_torch.core import distributed, hier
    from repro_torch.distribution import sharding as sh
    from repro_torch.kernels import registry
    from repro_torch.launch import ingest
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.runtime import rebalance_instances
    dev = mesh.device
    dmesh = mesh_mod.fleet_device_mesh(mesh)
    sharding = sh.to_shardings(sh.Spec("data"), dmesh)
    sig = ingest.signature(args)
    template = distributed.create_instances(args.instances, sig.cuts,
                                            args.block_size, device="meta")
    torch.zeros(1, device=dev)          # the rank's context, not timed
    _sync(torch, dev)
    _peak_reset(torch, dev)
    t0 = time.perf_counter()
    restored = ckpt.restore(ckpt_dir, step, template, shardings=sharding)
    restored_block = tuple(restored.spills.to_local().shape)
    restore_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    grown = rebalance_instances(restored, n_new, sharding=sharding)
    _sync(torch, dev)
    rebalance_s = time.perf_counter() - t0
    states = hier.map_state(lambda x: x.to_local(), grown)
    grown_args = argparse.Namespace(**{**vars(args), "instances": n_new})
    ingest_fn = distributed.sharded_ingest_fn(mesh, FLEET_AXES,
                                              **ingest.ingest_knobs(sig))
    registry.reset_launches()
    t0 = time.perf_counter()
    for rnd in range(step, args.rounds):
        rows, cols, vals = (distributed.shard(mesh, x) for x in
                            fleet_round(torch, grown_args, rnd, dev, False))
        states, _ = ingest_fn(states, rows, cols, vals)
    _sync(torch, dev)
    ingest_s = time.perf_counter() - t0
    launches = registry.launches()
    count = distributed.aggregate_update_counts_fn(mesh, FLEET_AXES)(states)
    return dict(rank=mesh.rank, device=str(dev), restored_block=restored_block,
                block=tuple(states.spills.shape),
                state=hier.state_to_numpy(states), count=count,
                launches=launches, restore_s=restore_s,
                rebalance_s=rebalance_s, ingest_s=ingest_s,
                peak_gib=_peak_gib(torch, dev))


def shard_fleet_check(torch, args, ckpt_dir: str, step: int, n_new: int,
                      device, tmp: str, card: str) -> dict:
    """Phase 17 (a): the single-process restore -> resize -> remaining
    rounds, then the same on each P of ``SHARD_RANKS`` gloo ranks; the
    ranks' blocks joined equal to it leaf for leaf, each restored block
    ``1/P`` of the checkpoint's fleet, the fleet counter on every rank,
    overflow 0, and every rank launched ``merge_multi`` on the card."""
    import argparse

    import numpy as np
    from repro_torch.checkpoint import ckpt
    from repro_torch.core import distributed, hier, stream
    from repro_torch.kernels import registry
    from repro_torch.launch import ingest
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.runtime import rebalance_instances
    sig = ingest.signature(args)
    template = distributed.create_instances(args.instances, sig.cuts,
                                            args.block_size, device=device)
    one = rebalance_instances(ckpt.restore(ckpt_dir, step, template), n_new)
    grown_args = argparse.Namespace(**{**vars(args), "instances": n_new})
    registry.reset_launches()
    for rnd in range(step, args.rounds):
        one, _ = stream.ingest_instances(
            one, *fleet_round(torch, grown_args, rnd, device, False),
            **ingest.ingest_knobs(sig))
    single_launches = registry.launches()[MM]
    want = dict(state=hier.state_to_numpy(one),
                count=hier.exact_update_count(one))
    del one, template
    on_card = torch.device(device).type == "cuda"
    runs = []
    for ranks in SHARD_RANKS:
        what = f"sharded restore + rebalance, gloo P={ranks}"
        t0 = time.perf_counter()
        got = mesh_mod.spawn_fleet(shard_fleet_rank, ranks, "gloo", device,
                                   tmp, args=(args, ckpt_dir, step, n_new))
        wall = time.perf_counter() - t0
        for k, v in want["state"].items():
            if k == "cuts":
                continue
            joined = np.concatenate([r["state"][k] for r in got])
            if not np.array_equal(joined, v):
                raise AssertionError(f"{what}: {k} of the ranks' blocks != "
                                     f"the single-process fleet's")
        for r in got:
            if r["restored_block"][0] != args.instances // ranks or \
                    r["block"][0] != n_new // ranks:
                raise AssertionError(f"{what}: rank {r['rank']} held "
                                     f"{r['restored_block']} then "
                                     f"{r['block']} instances")
            if r["count"] != want["count"]:
                raise AssertionError(f"{what}: rank {r['rank']} counts "
                                     f"{r['count']}, not {want['count']}")
            if on_card and r["launches"][MM] == 0:
                raise AssertionError(f"{what}: rank {r['rank']} never "
                                     f"launched merge_multi")
        if int(np.sum(want["state"]["overflow"])) != 0:
            raise AssertionError(f"{what}: the fleet overflowed")
        launches = sum(r["launches"][MM] for r in got)
        res = dict(ranks=ranks, devices=[r["device"] for r in got],
                   wall_s=wall, restore_s=[r["restore_s"] for r in got],
                   rebalance_s=[r["rebalance_s"] for r in got],
                   ingest_s=[r["ingest_s"] for r in got],
                   peak_gib=[r["peak_gib"] for r in got],
                   merge_multi=launches,
                   rank_merge_multi=[r["launches"][MM] for r in got])
        runs.append(res)
        print(f"{what}: {args.instances} -> {n_new} instances from step "
              f"{step}, {args.rounds - step} more rounds; blocks joined == "
              f"one process (counter {want['count']}, overflow 0); "
              f"merge_multi per rank {res['rank_merge_multi']} (one "
              f"process: {single_launches}); restore s "
              f"{[round(x, 4) for x in res['restore_s']]}, rebalance s "
              f"{[round(x, 4) for x in res['rebalance_s']]}, ingest s "
              f"{[round(x, 4) for x in res['ingest_s']]}; peak GiB "
              f"{res['peak_gib']}; wall {wall:.2f} s; {card}", flush=True)
    return dict(counter=want["count"], single_merge_multi=single_launches,
                runs=runs)


def _timed_steps(torch, dev, fn):
    """([ms], result) of one call of ``fn``, the device synchronized
    around it."""
    _sync(torch, dev)
    t0 = time.perf_counter()
    out = fn()
    _sync(torch, dev)
    return [(time.perf_counter() - t0) * 1e3], out


def lm_mesh_rank(fleet, shape, jobs, lr: float) -> list:
    """One rank of phase 17 (b) (``spawn_fleet``): for each job (arch,
    smoke, batch, seq) in float32 with TF32 off, one
    ``transformer.make_train_step`` step unsharded, then one on the
    ``shape`` ``("data", "model")`` mesh under ``make_policy(mesh)`` —
    parameters placed by ``to_shardings(lm_param_specs(...))``, AdamW
    moments under the same placements, the batch under
    ``batch_sharding``; every local shard's shape held to its spec's
    arithmetic.  Returns each job's losses, worst parameter excess over
    ``rtol * |p| + lr / 10``, peak memory, and the times of the checked
    first step and of a second step from its state (both arms)."""
    import dataclasses

    import torch
    from repro_torch.configs import registry as arch_registry
    from repro_torch.data import pipeline
    from repro_torch.data.synthetic import token_batch
    from repro_torch.distribution import sharding as sh
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models import common
    from repro_torch.models import transformer as tf
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = fleet.device
    mesh = mesh_mod.make_test_mesh(shape, MESH_AXES, dev)
    coord = dict(zip(MESH_AXES, mesh.get_coordinate()))
    sizes = dict(zip(MESH_AXES, mesh.shape))
    policy = sh.make_policy(mesh)
    out = []
    for arch, smoke, b, s in jobs:
        get = arch_registry.get_smoke_config if smoke \
            else arch_registry.get_config
        cfg = dataclasses.replace(get(arch), dtype="float32")
        step = tf.make_train_step(cfg, AdamWConfig(lr=lr))
        batch = token_batch(0, b, s, cfg.vocab, device=dev)
        params = tf.init(0, cfg, device=dev)
        plain_ms, (params, opt, m0) = _timed_steps(
            torch, dev, lambda: step(params, adamw_init(params), batch))
        want = {p: x.clone() for p, x in sh.leaves_with_paths(params)}
        loss0 = float(m0["total"])
        plain_ms.append(_timed_steps(
            torch, dev, lambda: step(params, opt, batch))[0][0])
        del params, opt, m0
        params = tf.init(0, cfg, device=dev)
        specs = sh.lm_param_specs(params, cfg, policy)
        placed = common.with_leaves(params, common.tree_map(
            sh.place, params, sh.to_shardings(specs, mesh)))
        del params
        bsh = pipeline.batch_sharding(mesh, policy.batch_axes)
        sbatch = {k: sh.place(v, bsh) for k, v in batch.items()}
        _peak_reset(torch, dev)
        with sh.use_policy(policy):
            step_ms, (placed, opt, m1) = _timed_steps(
                torch, dev, lambda: step(placed, adamw_init(placed), sbatch))
        loss1 = float(m1["total"].full_tensor())
        worst = -math.inf
        spec_of = dict(sh.leaves_with_paths(specs))
        leaves = sh.leaves_with_paths(placed)
        for path, p in leaves:
            local = tuple(p.to_local().shape)
            spec_local = sh.local_shape(tuple(p.shape), spec_of[path],
                                        sizes, coord)
            if local != spec_local:
                raise AssertionError(f"{arch} {path}: local shard {local}, "
                                     f"its spec {spec_of[path]} gives "
                                     f"{spec_local}")
            err = (p.full_tensor() - want[path]).abs() \
                - MESH_PARAM_RTOL * want[path].abs()
            worst = max(worst, float(err.max()))
        with sh.use_policy(policy):
            step_ms.append(_timed_steps(
                torch, dev, lambda: step(placed, opt, sbatch))[0][0])
        out.append(dict(arch=arch, smoke=smoke, batch=b, seq=s,
                        device=str(dev), loss=loss1, unsharded_loss=loss0,
                        param_excess=worst, step_ms=step_ms,
                        unsharded_step_ms=plain_ms,
                        peak_gib=_peak_gib(torch, dev),
                        leaves=len(leaves)))
        del placed, opt, m1, want
    return out




def model_mesh_inputs(torch, arch: str, seed_count: int):
    """(config, parameters, batch, train step, steps, lr) of one phase 17
    (d) job, on the CPU from fixed seeds: each call gives the same
    numbers."""
    from repro_torch.configs import registry as arch_registry
    from repro_torch.data import graphs, synthetic
    from repro_torch.models import dcn, gnn
    from repro_torch.optim.adamw import AdamWConfig
    cfg = arch_registry.get_smoke_config(arch)
    fam = cfg.family
    lr = MODEL_MESH_LR[fam]
    if fam == "recsys":
        batch = synthetic.recsys_batch(3, 16, cfg.n_dense, cfg.n_sparse,
                                       vocab_per_field=1000, device="cpu")
        return (cfg, dcn.init(0, cfg, device="cpu"), batch,
                dcn.make_train_step(cfg, AdamWConfig(lr=lr)),
                MODEL_MESH_STEPS[fam], lr)
    if arch == "graphcast":
        _, src, dst = graphs.icosahedral_multimesh(2)
        gen = torch.Generator().manual_seed(11)
        batch = dict(node_feat=torch.randn((162, 8), generator=gen),
                     edge_src=torch.as_tensor(src),
                     edge_dst=torch.as_tensor(dst),
                     targets=torch.randn((162, 6), generator=gen))
        task, d_feat, n_out = "regress", 8, 6
    elif arch == "gin-tu":
        batch = graphs.batched_molecules(2, 8, 10, 20, 7, 3, device="cpu")
        task, d_feat, n_out = "graph", 7, 3
    else:
        batch = graphs.random_graph(1, 96, 400, 12, 5, device="cpu")
        task, d_feat, n_out = "node", 12, 5
    return (cfg, gnn.init(3, cfg, d_feat, n_out, device="cpu"), batch,
            gnn.make_train_step(cfg, AdamWConfig(lr=lr), task, seed_count),
            MODEL_MESH_STEPS[fam], lr)


def _full(x):
    return x.full_tensor() if hasattr(x, "full_tensor") else x


def model_mesh_rank(fleet, jobs) -> list:
    """One rank of phase 17 (d) (``spawn_fleet``, gloo on the CPU): for each
    (arch, seed_count) of ``jobs``, the train steps unsharded, then from the
    same parameters on a (2, 2) ``("data", "model")`` mesh under
    ``make_policy(mesh, "dp")`` — the parameters placed by
    ``gnn_param_specs`` / ``recsys_param_specs``, the batch by the cells'
    ``_bsh``; every local shard's shape held to its spec's arithmetic.
    DCN-v2 also serves the batch and ranks candidates sharded over every
    axis for one whole query, against the same calls unsharded.  Returns
    each job's losses, worst parameter excess over ``rtol * |p| + lr /
    10``, the sharded leaves and the serving errors."""
    import torch
    from repro_torch.distribution import sharding as sh
    from repro_torch.launch import cells
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models import common, dcn
    from repro_torch.optim.adamw import adamw_init
    torch.set_num_threads(1)
    mesh = mesh_mod.make_test_mesh((2, 2), MESH_AXES, "cpu")
    coord = dict(zip(MESH_AXES, mesh.get_coordinate()))
    sizes = dict(zip(MESH_AXES, mesh.shape))
    policy = sh.make_policy(mesh, "dp")
    whole = sh.Sharding(mesh, (sh.Replicate(),) * 2)
    out = []
    for arch, seed_count in jobs:
        t0 = time.perf_counter()
        cfg, params, batch, step, steps, lr = model_mesh_inputs(
            torch, arch, seed_count)
        rec = dict(arch=arch, seed_count=seed_count, steps=steps, lr=lr)
        specs_of = sh.recsys_param_specs if cfg.family == "recsys" \
            else sh.gnn_param_specs
        specs = specs_of(params, cfg, policy)
        placed = common.with_leaves(params, common.tree_map(
            sh.place, params, sh.to_shardings(specs, mesh)))
        sbatch = {k: sh.place(v, cells._bsh(mesh, policy.batch_axes, v))
                  for k, v in batch.items()}
        if cfg.family == "recsys":
            cands = torch.randn((64, cfg.mlp[-1]),
                                generator=torch.Generator().manual_seed(2))
            query = {k: batch[k][:1] for k in ("dense", "sparse")}
            scores = dcn.serve_scores(params, batch, cfg)
            values, indices = dcn.retrieval_topk(params, query, cands, cfg,
                                                 k=MESH_TOPK)
            ranked = (dcn.query_embedding(params, query, cfg)
                      @ cands.T)[0].sort().values
            with sh.use_policy(policy):
                got = dcn.serve_scores(placed, sbatch, cfg).full_tensor()
                v1, i1 = dcn.retrieval_topk(
                    placed, {k: sh.place(v, whole) for k, v in query.items()},
                    sh.place(cands, sh.to_shardings(sh.Spec(MESH_AXES, None),
                                                    mesh)), cfg, k=MESH_TOPK)
            rec.update(
                score_err=float(((got - scores).abs()
                                 / scores.abs()).max()),
                topk_value_err=float(((v1.full_tensor() - values).abs()
                                      / values.abs()).max()),
                topk_equal=bool(torch.equal(i1.full_tensor(), indices)),
                ties=bool((ranked[1:] == ranked[:-1]).any()))
        opt, losses0 = adamw_init(params), []
        for _ in range(steps):
            params, opt, m = step(params, opt, batch)
            losses0.append(float(m["loss"]))
        want = {p: x.clone() for p, x in sh.leaves_with_paths(params)}
        opt, losses1 = adamw_init(placed), []
        with sh.use_policy(policy):
            for _ in range(steps):
                placed, opt, m = step(placed, opt, sbatch)
                losses1.append(float(_full(m["loss"])))
        worst, sharded = -math.inf, 0
        spec_of = dict(sh.leaves_with_paths(specs))
        for path, p in sh.leaves_with_paths(placed):
            local = tuple(p.to_local().shape)
            spec_local = sh.local_shape(tuple(p.shape), spec_of[path],
                                        sizes, coord)
            if local != spec_local:
                raise AssertionError(f"{arch} {path}: local shard {local}, "
                                     f"its spec {spec_of[path]} gives "
                                     f"{spec_local}")
            sharded += local != tuple(p.shape)
            err = (p.full_tensor() - want[path]).abs() \
                - MESH_PARAM_RTOL * want[path].abs()
            worst = max(worst, float(err.max()))
        rec.update(losses=losses1, unsharded_losses=losses0,
                   param_excess=worst, leaves=len(want),
                   sharded_leaves=sharded,
                   batch_local={k: list(v.to_local().shape)
                                for k, v in sbatch.items()},
                   seconds=time.perf_counter() - t0)
        out.append(rec)
    return out


def model_mesh_check(torch, tmp: str, card: str,
                     jobs=MODEL_MESH_JOBS) -> list:
    """Phase 17 (d): ``model_mesh_rank`` on 4 gloo ranks of the CPU, each
    job's sharded losses within ``MESH_LOSS_TOL`` of the unsharded steps',
    its parameters within ``MESH_PARAM_RTOL`` plus a tenth of one lr step
    on every rank; DCN-v2's sharded scores and top-k values within
    ``SCORE_RTOL``, its top-k indices equal (no ties among the scores).
    Returns one record a job."""
    from repro_torch.launch import mesh as mesh_mod
    t0 = time.perf_counter()
    got = mesh_mod.spawn_fleet(model_mesh_rank, 4, "gloo", "cpu", tmp,
                               args=(jobs,))
    wall = time.perf_counter() - t0
    out = []
    for i, (arch, seed_count) in enumerate(jobs):
        rows = [r[i] for r in got]
        r0 = rows[0]
        what = f"{arch} smoke on a (2, 2) gloo CPU mesh"
        for r in rows:
            off = max(abs(a - b) for a, b in zip(r["losses"],
                                                  r["unsharded_losses"]))
            if off > MESH_LOSS_TOL:
                raise AssertionError(f"{what}: sharded losses {r['losses']} "
                                     f"vs unsharded {r['unsharded_losses']}")
            if r["param_excess"] > r["lr"] / 10:
                raise AssertionError(f"{what}: a parameter is off by "
                                     f"{r['param_excess']} beyond rtol "
                                     f"{MESH_PARAM_RTOL}")
            if "score_err" in r and (
                    r["ties"] or not r["topk_equal"]
                    or max(r["score_err"], r["topk_value_err"]) > SCORE_RTOL):
                raise AssertionError(f"{what}: sharded serving differs {r}")
        rec = dict(r0, wall_s=wall,
                   param_excess=max(r["param_excess"] for r in rows))
        out.append(rec)
        serving = (f"; serve_scores rel err {rec['score_err']:.3g}, top-"
                   f"{MESH_TOPK} indices equal, values rel err "
                   f"{rec['topk_value_err']:.3g}"
                   if "score_err" in rec else "")
        print(f"(d) {what}: {rec['steps']} step(s), losses "
              f"{[round(x, 6) for x in rec['losses']]} == unsharded "
              f"{[round(x, 6) for x in rec['unsharded_losses']]} (tol "
              f"{MESH_LOSS_TOL}); params within rtol {MESH_PARAM_RTOL} + "
              f"lr/10 (worst excess {rec['param_excess']:.3g}); "
              f"{rec['sharded_leaves']} of {rec['leaves']} leaves sharded, "
              f"batch local {rec['batch_local']}{serving}; {card}",
              flush=True)
    return out


def production_shapes_check(torch, mesh) -> int:
    """Every leaf of the five LM full configs (layout ``"2d"``), DCN-v2's
    and GraphCast's (``"dp"``, as the reference's cells lay them out),
    drawn on ``meta`` and placed on the production ``mesh``: its local
    shard's shape under ``sharding.place`` and under DTensor's own
    ``distribute_tensor`` equals its spec's arithmetic at this rank's
    coordinate.  Shapes only: nothing runs.  Returns the leaves
    checked."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.configs import registry as arch_registry
    from repro_torch.distribution import sharding as sh
    from repro_torch.models import dcn, gnn
    from repro_torch.models import transformer as tf
    names = tuple(mesh.mesh_dim_names)
    sizes = dict(zip(names, mesh.shape))
    coord = dict(zip(names, mesh.get_coordinate()))
    trees = [(arch, "lm", tf.init(0, arch_registry.get_config(arch),
                                  device="meta")) for arch in LM_ARCHS]
    trees.append(("dcn-v2", "dp", dcn.init(
        0, arch_registry.get_config("dcn-v2"), device="meta")))
    gc_cfg = arch_registry.get_config("graphcast")
    trees.append(("graphcast", "dp", gnn.init(
        0, gc_cfg, GRAPHCAST_D_FEAT, gc_cfg.n_vars, device="meta")))
    checked = 0
    for arch, kind, params in trees:
        cfg = arch_registry.get_config(arch)
        if kind == "lm":
            specs = sh.lm_param_specs(params, cfg, sh.make_policy(mesh, "2d"))
        elif arch == "dcn-v2":
            specs = sh.recsys_param_specs(params, cfg,
                                          sh.make_policy(mesh, "dp"))
        else:
            specs = sh.gnn_param_specs(params, cfg,
                                       sh.make_policy(mesh, "dp"))
        spec_of = dict(sh.leaves_with_paths(specs))
        for path, leaf in sh.leaves_with_paths(params):
            sharding = sh.to_shardings(spec_of[path], mesh)
            want = sh.local_shape(tuple(leaf.shape), spec_of[path], sizes,
                                  coord)
            got = [tuple(t.to_local().shape) for t in (
                sh.place(leaf, sharding),
                distribute_tensor(leaf, mesh, sharding.placements))]
            if got != [want, want]:
                raise AssertionError(
                    f"{arch} {path} on {tuple(mesh.shape)}: local shards "
                    f"{got} (place, distribute_tensor), spec "
                    f"{spec_of[path]} gives {want}")
            checked += 1
    return checked


def production_child(world: int, multi_pod: bool, device: str,
                     out_path: str) -> None:
    """Phase 17 (c)'s child process: a fake process group (``FakeStore``,
    backend ``"fake"``) of ``world`` ranks, ``make_production_mesh`` over
    it, ``production_shapes_check``; the result as JSON in
    ``out_path``."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.launch import mesh as mesh_mod
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    t0 = time.perf_counter()
    mesh = mesh_mod.make_production_mesh(multi_pod=multi_pod, device=device)
    leaves = production_shapes_check(torch, mesh)
    dist.destroy_process_group()
    with open(out_path, "w") as f:
        json.dump(dict(world=world, mesh=list(mesh.shape),
                       axes=list(mesh.mesh_dim_names),
                       device_type=mesh.device_type, leaves=leaves,
                       seconds=time.perf_counter() - t0), f)


def production_meshes(device: str, tmp: str) -> list:
    """Phase 17 (c): ``production_child`` at world size 256 and at 512
    (the multi-pod mesh), each in a spawned process, since the fake group
    is process-global."""
    import multiprocessing
    ctx = multiprocessing.get_context("spawn")
    out = []
    for world, multi_pod in ((256, False), (512, True)):
        path = os.path.join(tmp, f"production_{world}.json")
        proc = ctx.Process(target=production_child,
                           args=(world, multi_pod, device, path))
        proc.start()
        proc.join()
        if proc.exitcode != 0:
            raise AssertionError(f"the production mesh child at world "
                                 f"{world} exited {proc.exitcode}")
        with open(path) as f:
            out.append(json.load(f))
    return out


def lm_mesh_check(torch, backend: str, shape, jobs, device, tmp: str,
                  card: str) -> list:
    """Phase 17 (b) on one ``(backend, shape)`` mesh (a (2, 2) nccl mesh
    needs one card a rank): ``lm_mesh_rank`` on every rank, each job's
    sharded loss within ``MESH_LOSS_TOL`` of the unsharded step's and its
    parameters within ``MESH_PARAM_RTOL`` plus a tenth of one lr step on
    every rank.  Returns one record a job."""
    from repro_torch.launch import mesh as mesh_mod
    ranks = math.prod(shape)
    t0 = time.perf_counter()
    got = mesh_mod.spawn_fleet(lm_mesh_rank, ranks, backend, device, tmp,
                               args=(shape, jobs, MESH_LR))
    wall = time.perf_counter() - t0
    out = []
    for i, (arch, smoke, b, s) in enumerate(jobs):
        rows = [r[i] for r in got]
        r0 = rows[0]
        what = (f"{arch}{' smoke' if smoke else ''} {b} x {s} on a "
                f"{shape} {backend} mesh")
        if any(abs(r["loss"] - r["unsharded_loss"]) > MESH_LOSS_TOL
               for r in rows):
            raise AssertionError(f"{what}: sharded loss "
                                 f"{[r['loss'] for r in rows]} vs "
                                 f"unsharded "
                                 f"{[r['unsharded_loss'] for r in rows]}")
        excess = max(r["param_excess"] for r in rows)
        if excess > MESH_LR / 10:
            raise AssertionError(f"{what}: a parameter is off by {excess} "
                                 f"beyond rtol {MESH_PARAM_RTOL}")
        rec = dict(arch=arch, smoke=smoke, batch=b, seq=s, backend=backend,
                   mesh=list(shape), ranks=ranks,
                   cards=torch.cuda.device_count()
                   if torch.cuda.is_available() else 0,
                   devices=[r["device"] for r in rows], loss=r0["loss"],
                   unsharded_loss=r0["unsharded_loss"], param_excess=excess,
                   # the second step (the first, checked, one is its cold
                   # start)
                   step_ms=[r["step_ms"][1] for r in rows],
                   unsharded_step_ms=[r["unsharded_step_ms"][1]
                                      for r in rows],
                   first_step_ms=[r["step_ms"][0] for r in rows],
                   unsharded_first_step_ms=[r["unsharded_step_ms"][0]
                                            for r in rows],
                   peak_gib=[r["peak_gib"] for r in rows],
                   leaves=r0["leaves"], wall_s=wall)
        out.append(rec)
        print(f"(b) {what}: loss {rec['loss']:.6f} == unsharded "
              f"{rec['unsharded_loss']:.6f} (tol {MESH_LOSS_TOL}); params "
              f"within rtol {MESH_PARAM_RTOL} + lr/10 (worst excess "
              f"{excess:.3g}); every local shard as its spec; second step "
              f"ms {rec['step_ms']} (unsharded {rec['unsharded_step_ms']}; "
              f"first steps {rec['first_step_ms']}, unsharded "
              f"{rec['unsharded_first_step_ms']}); peak GiB "
              f"{rec['peak_gib']}; {card}", flush=True)
    return out


def sharding_phase(torch, args, ckpt_dir: str, step: int, device, card: str,
                   tmp: str, *, mesh_runs, jobs=None,
                   n_new: int = SHARD_GROW) -> dict:
    """Phase 17: (a) ``shard_fleet_check``; (b) ``lm_mesh_check`` of
    ``jobs`` (default: ``MESH_JOBS``) on each ``(backend, shape)``
    of ``mesh_runs``; (d) ``model_mesh_check``; (c)
    ``production_meshes``.  Returns the ``{"sharding": ...}`` record."""
    t0 = time.perf_counter()
    res = dict(fleet=shard_fleet_check(torch, args, ckpt_dir, step, n_new,
                                       device, tmp, card))
    res["lm"] = [rec for backend, shape in mesh_runs
                 for rec in lm_mesh_check(torch, backend, shape,
                                          jobs or MESH_JOBS, device,
                                          tmp, card)]
    res["models"] = model_mesh_check(torch, tmp, card)
    res["production"] = production_meshes(
        "cuda" if torch.device(device).type == "cuda" else "cpu", tmp)
    for p in res["production"]:
        print(f"(c) production mesh {tuple(p['mesh'])} over {p['axes']} "
              f"under a fake group of {p['world']}: shapes only, "
              f"{p['leaves']} leaves of five LM configs, DCN-v2 and "
              f"GraphCast each as its spec gives", flush=True)
    res["wall_s"] = time.perf_counter() - t0
    return res


# ------------------------------------------------------------- phase 18 --

# (a) on the card: (arch, shape, variant); the LM cell cut to phase 17's
# 4 x 1024 (``DRYRUN_LM_CUT``)
DRYRUN_CARD_CELLS = (("d4m-stream", "ingest_small", "use_kernel=1"),
                     ("d4m-stream", "ingest_wide", "use_kernel=1"),
                     ("d4m-stream", "query", "use_kernel=1"),
                     ("smollm-360m", "train_4k", "dtype=float32"),
                     ("graphcast", "minibatch_lg", "baseline"),
                     ("dcn-v2", "serve_bulk", "use_kernel=1"))
DRYRUN_LM_CUT = dict(batch=4, seq=1024)
DRYRUN_REPS = 3                 # timed calls a cell, after one warm-up
# (b) on the machine's CPU, the production meshes under a fake group:
# (mesh, arch, shape, variant).  Cut to smollm-360m and granite-moe: a
# full-size train_4k cell records in one to four minutes of one core, so
# phi3-mini's, mistral-nemo's and deepseek-v2's train_4k stay with the
# dry-run CLI (PERF.md); DCN-v2's train_batch and GraphCast's
# ogb_products record in seconds
DRYRUN_HOST_CELLS = (
    ("single", "smollm-360m", "train_4k", "baseline"),
    ("single", "granite-moe-3b-a800m", "train_4k", "baseline"),
    ("multi", "granite-moe-3b-a800m", "train_4k", "baseline"),
    ("single", "smollm-360m", "prefill_32k", "baseline"),
    ("single", "smollm-360m", "decode_32k", "baseline"),
    ("single", "smollm-360m", "long_500k", "baseline"),
    ("single", "dcn-v2", "train_batch", "baseline"),
    ("single", "graphcast", "ogb_products", "baseline"))
DRYRUN_HOST_TIMEOUT = 900       # seconds a host cell may take


def dryrun_host_child(cells_, outdir: str, path: str) -> None:
    """Phase 18 (b)'s child process: ``dryrun.run_cell`` for each (mesh,
    arch, shape, variant) of ``cells_`` (one mesh kind: the fake group is
    process-global), its records as JSON in ``path``."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist
    from repro_torch.launch import dryrun
    torch.set_num_threads(1)
    recs = [dryrun.run_cell(arch, shape, kind, variant, outdir,
                            verbose=False)
            for kind, arch, shape, variant in cells_]
    dist.destroy_process_group()
    with open(path, "w") as f:
        json.dump(recs, f)


def start_host_cells(cells_, tmp: str) -> list:
    """Phase 18 (b): one spawned child a cell, all started at once."""
    import multiprocessing
    ctx = multiprocessing.get_context("spawn")
    outdir = os.path.join(tmp, "dryrun")
    procs = []
    for i, cell in enumerate(cells_):
        path = os.path.join(tmp, f"dryrun_host_{i}.json")
        proc = ctx.Process(target=dryrun_host_child,
                           args=((cell,), outdir, path))
        proc.start()
        procs.append((cell, proc, path))
    return procs


def join_host_cells(procs, timeout: float) -> list:
    """Phase 18 (b)'s records, each printed as it is joined; a child that
    fails or outlives ``timeout`` (seconds from now, for them all), or a
    cell not ``ok`` or ``skip``, or one with no collective bytes, fails
    the phase once every child is joined."""
    deadline = time.monotonic() + timeout
    out, bad = [], []
    for cell, proc, path in procs:
        proc.join(max(deadline - time.monotonic(), 1.0))
        if proc.is_alive():
            proc.terminate()
            bad.append(f"{cell}: still running after {timeout:.0f} s")
            continue
        if proc.exitcode != 0:
            bad.append(f"{cell}: its process exited {proc.exitcode}")
            continue
        with open(path) as f:
            (rec,) = json.load(f)
        out.append(rec)
        print(host_line(rec), flush=True)
        if rec["status"] not in ("ok", "skip"):
            bad.append(f"{cell}: {rec['status']} {rec.get('error')}\n"
                       f"{rec.get('traceback', '')}")
        elif rec["status"] == "ok" and \
                not rec["collective_bytes_per_device"] > 0:
            bad.append(f"{cell}: no collective bytes on a "
                       f"{rec['n_devices']}-rank mesh")
    if bad:
        raise AssertionError("phase 18 (b): " + "\n".join(bad))
    return out


def host_line(r: dict) -> str:
    line = f"(b) [{r['mesh']}] {r['arch']} {r['shape']}: {r['status']}"
    if r["status"] == "ok":
        rf = r["roofline"]
        line += (f", fits_hbm {r['fits_hbm']}, coll/dev "
                 f"{r['collective_bytes_per_device']:.4g} B, compute "
                 f"{rf['compute_s']:.4g} s memory {rf['memory_s']:.4g} s "
                 f"collective {rf['collective_s']:.4g} s "
                 f"({rf['dominant']}), useful "
                 f"{r['useful_fraction']:.3f}")
    elif r["status"] == "skip":
        line += f" ({r['reason']})"
    else:
        line += f" ({r.get('error')})"
    return line + (f"; lower {r.get('lower_s')} s, recorded in "
                   f"{r.get('compile_s')} s, total {r.get('total_s')} s")


def plain_route_err(torch, arch: str, variant: str, args, out,
                    mesh) -> float:
    """The largest relative difference of a kernel-route serve cell's
    scores ``out`` from the gather route's on the same arguments, under
    the cell's policy (the plain route launches no kernel)."""
    from repro_torch.configs import registry as arch_registry
    from repro_torch.distribution import sharding as sh
    from repro_torch.launch import cells
    from repro_torch.models import dcn
    cfg = dataclasses.replace(cells.apply_variant(
        arch_registry.get_config(arch), variant), use_kernel=False)
    with sh.use_policy(sh.make_policy(mesh, "dp")):
        want = dcn.serve_scores(*args, cfg)
    got, want = out.full_tensor(), want.full_tensor()
    return float(((got - want).abs() / want.abs()).max())


def dryrun_card(torch, device, cells_, lm_cut: dict, reps: int, tmp: str,
                card: str) -> list:
    """Phase 18 (a): each cell through ``cells.lower_cell`` on the card — a
    D4M cell on the fleet's one-rank mesh, an LM, GNN or recsys cell on a
    (1, 1) mesh of the same one-rank group (nccl on the card, gloo on the
    CPU) — its recorded call's cost, memory and collectives, and the same
    call timed (median of ``reps`` after a warm-up, each on fresh clones
    of the lowered arguments, ended by a synchronize) against the roofline
    bound at the dtype's peak (``dryrun.hw_for``).  A bound above the
    measured time fails: the count would overstate the work.  A recsys
    serve cell on the kernel route (``use_kernel``) has its last timed
    call's scores held within ``SCORE_RTOL`` of the gather route's."""
    import copy

    import torch.distributed as dist
    from repro_torch.configs import registry as arch_registry
    from repro_torch.kernels import registry
    from repro_torch.launch import cells, dryrun
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.roofline.hlo import collective_bytes_by_type
    from repro_torch.roofline.terms import roofline_terms, useful_fraction
    cuda = torch.device(device).type == "cuda"
    backend = "nccl" if cuda else "gloo"
    dist.init_process_group(backend, init_method=f"file://{tmp}/dryrun_pg",
                            rank=0, world_size=1)
    out = []
    try:
        fleet = mesh_mod.make_fleet_mesh(backend, device)
        dmesh = mesh_mod.make_test_mesh((1, 1), MESH_AXES, device)
        for arch, shape, variant in cells_:
            fam = arch_registry.family(arch)
            low, meta = cells.lower_cell(
                arch, shape, fleet if fam == "d4m" else dmesh, variant,
                device=device, **(lm_cut if fam == "lm" else {}))
            comp = low.compile()
            _peak_reset(torch, device)
            before = registry.launches()
            t0 = time.perf_counter()
            cost = comp.cost_analysis()                 # the recorded call
            record_s = time.perf_counter() - t0
            after = registry.launches()
            mem = comp.memory_analysis()
            coll, by_type = collective_bytes_by_type(comp.as_text())
            terms = roofline_terms(cost["flops"], cost["bytes accessed"],
                                   coll, hw=dryrun.hw_for(meta["dtype"]))
            times = []
            _peak_reset(torch, device)
            for i in range(reps + 1):
                args = copy.deepcopy(low.args)
                _sync(torch, device)
                t0 = time.perf_counter()
                result = comp(*args)
                _sync(torch, device)
                if i:
                    times.append(time.perf_counter() - t0)
                del args
            ms, bound_ms = _median(times) * 1e3, terms.bound_s * 1e3
            rec = dict(
                arch=arch, shape=shape, variant=variant,
                kind=meta["kind"], dtype=meta["dtype"],
                tokens=meta["tokens"], flops=cost["flops"],
                bytes=cost["bytes accessed"], coll=coll,
                collectives=by_type, bound_ms=bound_ms,
                dominant=terms.dominant, ms=ms,
                ms_all=[t * 1e3 for t in times],
                fraction=bound_ms / ms,
                useful_fraction=useful_fraction(meta["model_flops"],
                                                cost["flops"]),
                recorded_peak_bytes=mem.temp_size_in_bytes,
                argument_bytes=mem.argument_size_in_bytes,
                max_memory_allocated=(torch.cuda.max_memory_allocated()
                                      if cuda else None),
                record_s=record_s,
                recorded_launches={k: after[k] - before[k] for k in after
                                   if after[k] != before[k]})
            if fam == "recsys" and meta["kind"] == "serve" and \
                    cells.apply_variant(arch_registry.get_config(arch),
                                        variant).use_kernel:
                rec["plain_route_rel_err"] = plain_route_err(
                    torch, arch, variant, low.args, result, dmesh)
                if not rec["plain_route_rel_err"] <= SCORE_RTOL:
                    raise AssertionError(
                        f"{arch} {shape}: the kernel route's scores differ "
                        f"from the gather route's by "
                        f"{rec['plain_route_rel_err']} (rtol {SCORE_RTOL})")
                print(f"(a) {arch} {shape}: kernel route == gather route, "
                      f"scores rel err {rec['plain_route_rel_err']:.3g}",
                      flush=True)
            del result
            if bound_ms > ms:
                raise AssertionError(
                    f"{arch} {shape}: roofline bound {bound_ms:.4f} ms > "
                    f"measured {ms:.4f} ms — the count overstates the work "
                    f"({rec})")
            print(f"(a) {arch} {shape} [{variant}]: {ms:.3f} ms (median of "
                  f"{reps}), bound {bound_ms:.4f} ms ({terms.dominant}), "
                  f"fraction {rec['fraction']:.4f}, useful "
                  f"{rec['useful_fraction']:.3f}, "
                  f"flops {cost['flops']:.4g}"
                  f" bytes {cost['bytes accessed']:.4g} coll {coll}; "
                  f"recorded peak {mem.temp_size_in_bytes / 2**30:.3f} GiB,"
                  f" max_memory_allocated "
                  + (f"{rec['max_memory_allocated'] / 2**30:.3f} GiB"
                     if cuda else "n/a") + f"; {card}", flush=True)
            out.append(rec)
            del low, comp
            gc.collect()
    finally:
        dist.destroy_process_group()
    return out


def dryrun_phase(torch, device, card: str, tmp: str, *,
                 card_cells=DRYRUN_CARD_CELLS, host_cells=DRYRUN_HOST_CELLS,
                 lm_cut=DRYRUN_LM_CUT, reps: int = DRYRUN_REPS,
                 host_timeout: float = DRYRUN_HOST_TIMEOUT,
                 then=None) -> dict:
    """Phase 18: (b)'s children started first (they run on the host's
    CPU while (a) runs on the card), then ``dryrun_card`` (a), then
    ``then()`` where given (``main`` runs phase 19 there, on the card
    while (b) still records), then (b)'s records joined: every cell
    ``ok`` or ``skip``, collective bytes above 0.  Returns the
    ``{"dryrun": ...}`` record, ``then()``'s result under ``then`` and its
    seconds left out of ``wall_s``; ``merge_multi`` and
    ``embedding_bag`` hold (a)'s launches."""
    from repro_torch.kernels import registry
    t0 = time.perf_counter()
    procs = start_host_cells(host_cells, tmp)
    then_s, then_out = 0.0, None
    try:
        registry.reset_launches()
        card_recs = dryrun_card(torch, device, card_cells, lm_cut, reps,
                                tmp, card)
        launches = registry.launches()
        if then is not None:
            t1 = time.perf_counter()
            then_out = then()
            then_s = time.perf_counter() - t1
    except BaseException:
        for _, p, _ in procs:
            p.terminate()
        raise
    host = join_host_cells(procs, host_timeout)
    keep = ("arch", "shape", "mesh", "status", "fits_hbm", "roofline",
            "collective_bytes_per_device", "collectives", "raw",
            "useful_fraction", "memory_analysis", "compile_s", "total_s",
            "reason")
    return dict(card=card_recs,
                host=[{k: r[k] for k in keep if k in r} for r in host],
                merge_multi=launches["hier_merge.merge_multi"],
                embedding_bag=launches["embedding_bag.embedding_bag"],
                then=then_out, wall_s=time.perf_counter() - t0 - then_s)


EXAMPLE_TIMEOUT = 600       # seconds a child process may take
EXAMPLE_SCORE_RTOL = 1e-6   # recsys serving: kernel route == gather route


def _ingest_run(mod, device: str, kw: dict) -> dict:
    """One stream_ingest run for ``_example_run``: its main, its
    launches, whether it left a process group, and the counter of an
    uninterrupted run to the resumed round count."""
    import torch.distributed as dist

    from repro_torch.kernels import registry
    from repro_torch.launch import ingest
    registry.reset_launches()
    t0 = time.perf_counter()
    out = mod.main(device, **kw)
    out["wall_s"] = time.perf_counter() - t0
    out["launches"] = registry.launches()
    out["group_left"] = dist.is_initialized()
    a = mod.ingest_args(device=device, verbose=False, **{
        k: v for k, v in kw.items()
        if hasattr(mod.Args, k) or k == "use_kernel"})
    rounds = kw.get("resume_rounds", 6)
    a.blocks = max(a.blocks // a.rounds, 1) * rounds
    a.rounds = rounds
    out["uninterrupted_counter"] = ingest.run(a)["n_updates_counter"]
    return out


def _example_run(name: str, device: str, kw: dict) -> dict:
    """One example's run for ``example_child``, with what its gates read:
    quickstart's main on ``device`` and on the CPU; stream_ingest on the
    sort route, then with ``use_kernel`` (``_ingest_run`` each); recsys'
    main and its serving batch scored on the gather route too; train_lm's
    main."""
    import importlib

    import torch

    from repro_torch.kernels import registry
    mod = importlib.import_module(f"repro_torch.examples.{name}")
    if name == "stream_ingest":
        return {route: _ingest_run(mod, device, dict(kw, use_kernel=uk))
                for route, uk in (("sort", False), ("kernel", True))}
    registry.reset_launches()
    t0 = time.perf_counter()
    if name == "quickstart":
        out = dict(card=mod.main(device, **kw))
        out["wall_s"] = time.perf_counter() - t0
        out["cpu"] = mod.main("cpu", **kw)
        return out
    if name == "recsys_hier_embeddings":
        from repro_torch.models import dcn
        out, (params, batch, cfg) = mod.run_with_state(device, **kw)
        out["launches"] = registry.launches()
        gather = dcn.serve_scores(params, batch, dataclasses.replace(
            cfg, use_kernel=False)).cpu()
        scores = torch.tensor(out.pop("scores"))
        out["scores_max_rel_err"] = float(
            ((scores - gather).abs() / gather.abs()).max())
    else:
        out = mod.main(device, **kw)
        out["launches"] = registry.launches()
    out["wall_s"] = time.perf_counter() - t0
    return out


def example_child(name: str, device: str, kw: dict, path: str) -> None:
    """Phase 19's child process: ``_example_run``'s record as JSON in
    ``path``."""
    sys.path.insert(0, str(ROOT / "src"))
    out = _example_run(name, device, kw)
    with open(path, "w") as f:
        json.dump(out, f)


def start_example(name: str, device: str, kw: dict, tmp: str):
    """``example_child`` started in a spawned process of its own."""
    import multiprocessing
    ctx = multiprocessing.get_context("spawn")
    fd, path = tempfile.mkstemp(prefix=f"{name}-", suffix=".json", dir=tmp)
    os.close(fd)
    proc = ctx.Process(target=example_child, args=(name, device, kw, path))
    proc.start()
    return name, proc, path, time.perf_counter()


def join_examples(started) -> dict:
    """The records of ``start_example``'s processes, each with its
    process's wall seconds; a process that fails or outlives
    ``EXAMPLE_TIMEOUT`` fails the phase once every one is joined or
    stopped."""
    out, bad = {}, []
    try:
        for name, proc, path, t0 in started:
            proc.join(max(t0 + EXAMPLE_TIMEOUT - time.perf_counter(), 1.0))
            if proc.is_alive():
                bad.append(f"{name} still running after {EXAMPLE_TIMEOUT} s")
            elif proc.exitcode != 0:
                bad.append(f"{name} exited {proc.exitcode}")
            else:
                with open(path) as f:
                    out[name] = json.load(f)
                out[name]["process_s"] = time.perf_counter() - t0
    finally:
        for _, proc, _, _ in started:
            if proc.is_alive():
                proc.terminate()
                proc.join()
    if bad:
        raise AssertionError("phase 19: " + "; ".join(bad))
    return out


def quickstart_command(device: str) -> dict:
    """``python -m repro_torch.examples.quickstart`` as a user types it
    (``--device`` only off the card); its exit code 0 and its last line."""
    cmd = [sys.executable, "-m", "repro_torch.examples.quickstart"]
    if device != "cuda":
        cmd += ["--device", device]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                         timeout=EXAMPLE_TIMEOUT,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    if res.returncode != 0 or "monitor saw" not in res.stdout:
        raise AssertionError(f"the quickstart command exited "
                             f"{res.returncode}\n{res.stdout[-2000:]}\n"
                             f"{res.stderr[-2000:]}")
    return dict(process_s=time.perf_counter() - t0,
                last_line=res.stdout.strip().splitlines()[-1])


def examples_phase(torch, device, card: str, tmp: str, *,
                   sizes=None) -> dict:
    """Phase 19: the four examples (``repro_torch.examples``), each in a
    fresh process at the reference's sizes (``sizes``: each example's
    ``main`` keywords, for a rehearsal), and their gates.  Quickstart
    (also as its plain command), recsys and train_lm run side by side;
    then stream_ingest alone on the card (its rates are host-paced), the
    sort route then ``use_kernel`` in one process.  The gates:
    quickstart's values on ``device`` equal to the CPU's; stream_ingest's
    two runs' counter, overflow, nnz per layer, histogram and tail
    exponent equal, each resumed counter an uninterrupted run's, no
    process group left, ``merge_multi`` launched (on the card); recsys'
    serving batch on the ``embedding_bag`` route within rtol 1e-6 of the
    gather route's, ``embedding_bag`` launched (on the card); train_lm's
    own two checks.  Returns the ``{"examples": ...}`` record."""
    sizes = sizes or {}
    card_run = torch.device(device).type == "cuda"
    t0 = time.perf_counter()
    started = [start_example(name, device, dict(sizes.get(name, {}), **kw),
                             tmp)
               for name, kw in (("quickstart", {}),
                                ("recsys_hier_embeddings",
                                 dict(use_kernel=True)),
                                ("train_lm", {}))]
    try:
        res = dict(quickstart_command=quickstart_command(str(device)))
    finally:
        got = join_examples(started)
    qs, rx, lm = (got[name] for name in ("quickstart",
                                         "recsys_hier_embeddings",
                                         "train_lm"))

    card_vals = {k: v for k, v in qs["card"].items() if k != "device"}
    cpu_vals = {k: v for k, v in qs["cpu"].items() if k != "device"}
    diff = sorted(k for k in card_vals if card_vals[k] != cpu_vals.get(k))
    if diff:
        raise AssertionError(f"phase 19: quickstart on {device} != on the "
                             f"CPU in {diff}")
    res["quickstart"] = dict(
        wall_s=qs["wall_s"], process_s=qs["process_s"],
        equal_to_cpu=sorted(card_vals),
        **{k: card_vals[k] for k in ("nnz", "nnz_per_layer", "spills",
                                     "unique_edges", "top_rows",
                                     "active_rows", "monitor_records")})
    print(f"quickstart: {device} == cpu in {len(card_vals)} values, "
          f"{qs['wall_s']:.1f} s", flush=True)

    if not rx["scores_max_rel_err"] <= EXAMPLE_SCORE_RTOL:
        raise AssertionError(f"phase 19: recsys kernel-route scores differ "
                             f"from the gather route's by "
                             f"{rx['scores_max_rel_err']:.3g}")
    embedding_bag = rx["launches"]["embedding_bag.embedding_bag"]
    if card_run and embedding_bag == 0:
        raise AssertionError("phase 19: recsys serving launched no "
                             "embedding_bag")
    res["recsys_hier_embeddings"] = {k: rx[k] for k in (
        "use_kernel", "dense_loss", "hier_loss", "drains", "pending_nnz", "spills",
        "best_score", "scores_max_rel_err", "dense_s", "hier_s", "wall_s",
        "process_s")}
    print(f"recsys: dense {rx['dense_loss']:.4f}, hier "
          f"{rx['hier_loss']:.4f}, scores kernel vs gather "
          f"{rx['scores_max_rel_err']:.3g}, {rx['wall_s']:.1f} s",
          flush=True)

    if not (lm["final_loss"] < lm["first_loss"]
            and lm["final_loss_diff"] < 1e-4 and lm["failures"] == 1):
        raise AssertionError(f"phase 19: train_lm's checks: {lm}")
    res["train_lm"] = {k: lm[k] for k in lm if k not in ("launches",
                                                         "device")}
    print(f"train_lm: loss {lm['first_loss']:.4f} -> "
          f"{lm['final_loss']:.4f}, recovered {lm['faulty_final_loss']:.4f} "
          f"(|diff| {lm['final_loss_diff']:.3g}), {lm['wall_s']:.1f} s",
          flush=True)

    runs = join_examples([start_example(
        "stream_ingest", device, sizes.get("stream_ingest", {}), tmp)])
    runs = runs["stream_ingest"]
    process_s = runs.pop("process_s")
    for route, r in runs.items():
        if r["group_left"]:
            raise AssertionError("phase 19: stream_ingest left a process "
                                 "group initialized")
        if r["resumed_counter"] != r["uninterrupted_counter"]:
            raise AssertionError(
                f"phase 19: resumed counter {r['resumed_counter']} != an "
                f"uninterrupted run's {r['uninterrupted_counter']}")
        print(f"stream_ingest ({route} route): {r['updates_per_s']:.1f} "
              f"updates/s, counter {r['counter']}, resumed "
              f"{r['resumed_counter']}, {r['wall_s']:.1f} s", flush=True)
    keys = ("counter", "overflow", "resumed_counter", "nnz_per_layer",
            "histogram", "tail_exponent")
    diff = [k for k in keys if runs["sort"][k] != runs["kernel"][k]]
    if diff:
        raise AssertionError(f"phase 19: stream_ingest kernel route != "
                             f"sort route in {diff}")
    merge_multi = runs["kernel"]["launches"][MM]
    if card_run and merge_multi == 0:
        raise AssertionError("phase 19: stream_ingest with use_kernel "
                             "launched no merge_multi")
    res["stream_ingest"] = {
        route: {k: r[k] for k in keys + (
            "updates_per_s", "resumed_updates_per_s", "frac_blocks_layer0",
            "uninterrupted_counter", "wall_s")}
        for route, r in runs.items()}
    res["stream_ingest"]["process_s"] = process_s
    res.update(merge_multi=merge_multi, embedding_bag=embedding_bag,
               wall_s=time.perf_counter() - t0)
    return res


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    t_start = time.perf_counter()

    from repro_torch.configs import dcn_v2, gat_cora, graphcast
    from repro_torch.configs.base import GNN_SHAPES
    from repro_torch.core import assoc, hier, stream
    from repro_torch.core import semiring as sr_mod
    from repro_torch.data import graphs
    from repro_torch.kernels import build, registry
    from repro_torch.kernels.hier_merge import hier_merge as hm
    from repro_torch.kernels.hier_merge import ops as hm_ops
    from repro_torch.launch import ingest
    from repro_torch.query import engine

    phase("1 environment")
    card = card_line()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}, "
          f"count {torch.cuda.device_count()}", flush=True)
    print(card, flush=True)

    phase("2 build")
    secs = build.build_all()
    print(f"built {list(registry.AUDITED_FILES)} in {secs:.1f} s", flush=True)
    for src, log in build.LOG.items():
        usage = dict.fromkeys(line.split(":", 1)[-1].strip()
                              for line in log.splitlines()
                              if "registers" in line or "spill" in line)
        for line in usage:
            print(f"  {src}: {line}")

    phase("3 kernels vs plain on the card")
    numbers = kernel_phase(torch, registry, hm, assoc, sr_mod)
    t0 = time.perf_counter()
    mesh = graphs.icosahedral_multimesh(6)
    print(f"multimesh r=6: {len(mesh[0])} nodes, {len(mesh[1])} edges "
          f"in {time.perf_counter() - t0:.2f} s", flush=True)
    cora = GNN_SHAPES["full_graph_sm"]
    gat_graph = graphs.random_graph(6, cora["n_nodes"], cora["n_edges"],
                                    cora["d_feat"], cora["n_classes"],
                                    device="cuda")
    numbers.update(path_kernel_phase(torch, mesh,
                                     gat_graph["edge_dst"]))

    phase("4 main path: d4m_stream geometry, fused, lazy layer 0, grouped, "
          "kernel")
    registry.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    out, states = ingest.run_with_state(ingest_args())
    main_launches = registry.launches()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    spills = states.spills.sum(0).tolist()
    n_steps = 32 * 128
    hist = {"depth0": n_steps - spills[0], "depth1": spills[0] - spills[1],
            "depth2": spills[1]}
    print(json.dumps({k: out[k] for k in out}), flush=True)
    print(f"updates_per_s on the card: {out['updates_per_s']:.1f}; spill "
          f"depth histogram over {n_steps} instance-blocks: {hist}; "
          f"spills per layer {spills}; launches {main_launches}; layer nnz "
          f"{[int(l.nnz.sum()) for l in states.layers]}; peak device "
          f"memory {peak_gib:.3f} GiB", flush=True)
    if out["n_updates_counter"] != 4194304 or out["total_updates"] != 4194304:
        raise AssertionError(f"update counter {out['n_updates_counter']} "
                             f"!= 4194304")
    if out["overflow"] != 0:
        raise AssertionError(f"overflow {out['overflow']} != 0")
    # a depth-d merge takes the kernel iff its padded width fits the ceiling
    # (on d4m_stream: depth 1 -> 32768 does, depth 2 -> 262144 does not)
    caps = states.capacities
    by_route = {"hier_merge.merge_multi": 0, "assoc.sort_route": 0}
    for d in (1, 2):
        width = hm_ops.multi_padded_capacity(1024 + caps[0], caps[1:d + 1])
        by_route["hier_merge.merge_multi"
                 if width <= hm_ops.MAX_KERNEL_CAPACITY
                 else "assoc.sort_route"] += hist[f"depth{d}"]
    for route, want in by_route.items():
        if main_launches[route] != want:
            raise AssertionError(f"{route}: {main_launches[route]} calls, "
                                 f"{want} merges planned for it")
    if main_launches["hier_merge.merge_multi"] == 0:
        raise AssertionError("the main path never launched merge_multi")

    registry.reset_launches()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    n_inst = states.spills.shape[0]
    live = []
    for i in range(n_inst):
        h = stream.instance(states, i)
        # queries: live keys of every layer plus random keys
        n0 = int(h.layers[0].nnz)
        rand = [torch.randint(0, 1 << 22, (4096,), generator=gen,
                              device="cuda", dtype=torch.int32)
                for _ in range(2)]
        qr = torch.cat([h.layers[2].hi[:2048], h.layers[1].hi[:1024],
                        h.layers[0].hi[:min(n0, 512)], rand[0]])[:4096]
        qc = torch.cat([h.layers[2].lo[:2048], h.layers[1].lo[:1024],
                        h.layers[0].lo[:min(n0, 512)], rand[1]])[:4096]
        canon = engine.point_lookup(h, qr, qc, use_kernel=True,
                                    l0_mode="canon")
        scan = engine.point_lookup(h, qr[-32:], qc[-32:], use_kernel=True,
                                   l0_mode="scan")
        live.append((qr, qc, canon, scan))
    query_launches = registry.launches()
    if query_launches["hier_merge.merge_multi"] != n_inst:
        raise AssertionError("canon-mode queries did not launch merge_multi "
                             "once each")
    for i, (qr, qc, canon, scan) in enumerate(live):
        flushed = hier.flush(stream.instance(states, i), lazy_l0=True,
                             use_kernel=True)
        want = engine.point_lookup(flushed, qr, qc, l0_mode="scan")
        if not torch.equal(canon, want) or not torch.equal(scan, want[-32:]):
            raise AssertionError(f"instance {i}: live lookups != lookups "
                                 f"after flush")
    print(f"point lookups: {n_inst} x (4096 canon + 32 scan) == after flush; "
          f"launches of the lookups {query_launches}", flush=True)
    # phase 12's single-process answers, kept on the host
    queries = fleet_queries(torch, states, FLEET_QUERIES, 22, 11)
    fleet_main = dict(args=ingest_args(), queries=queries,
                      launches=main_launches,
                      want=fleet_expected(torch, states, sr_mod.PLUS_TIMES,
                                          queries, 1 << 22))
    phase("5 kernel route == sort route, end to end")
    out_sort, states_sort = ingest.run_with_state(
        ingest_args(use_kernel=False))
    states_equal(states, states_sort, "kernel vs sort route")
    print(f"all layers, spills, overflow and counters equal; sort route "
          f"updates_per_s {out_sort['updates_per_s']:.1f}", flush=True)

    phase("6 layered oracle (pairwise kernel) == fused")
    small = dict(instances=8, blocks=32, rounds=4)
    registry.reset_launches()
    out_lay, states_lay = ingest.run_with_state(
        ingest_args(layered=True, lazy_l0="off", **small))
    layered_launches = registry.launches()
    _, states_fused = ingest.run_with_state(ingest_args(**small))
    for i in range(8):
        a = hier.query_all(stream.instance(states_lay, i))
        b = hier.query_all(stream.instance(states_fused, i))
        if not all(torch.equal(x, y) for x, y in
                   ((a.hi, b.hi), (a.lo, b.lo), (a.val, b.val),
                    (a.nnz, b.nnz))):
            raise AssertionError(f"instance {i}: layered != fused")
    print(f"layered == fused on 8 instances; layered updates_per_s "
          f"{out_lay['updates_per_s']:.1f}; launches {layered_launches}",
          flush=True)
    if layered_launches["hier_merge.merge"] == 0:
        raise AssertionError("the layered path did not launch merge")

    phase("7 DCN-v2 serving at full width: serve_p99, serve_bulk, "
          "retrieval_cand, embedding_bag kernel")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    dcn_res = dcn_phase(torch, dataclasses.replace(dcn_v2.config(),
                                                   use_kernel=True), "cuda")
    print(f"serve_p99 {dcn_res['serve_p99_ms']:.3f} ms (median of 20), "
          f"serve_bulk {dcn_res['serve_bulk_examples_per_s']:.1f} "
          f"examples/s, retrieval_topk {dcn_res['retrieval_topk_ms']:.3f} "
          f"ms; embedding_bag launches {dcn_res['launches']}; peak device "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB",
          flush=True)

    phase("8 GNN inference at full width: GraphCast on the r=6 multimesh, "
          "GAT-Cora, segment_sum kernel")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    gc_cfg = dataclasses.replace(graphcast.config(), use_kernel=True)
    gc_graph = dict(
        node_feat=torch.randn((len(mesh[0]), gc_cfg.n_vars), generator=gen,
                              device="cuda"),
        edge_src=torch.as_tensor(mesh[1], device="cuda"),
        edge_dst=torch.as_tensor(mesh[2], device="cuda"))
    gnn_res = gnn_phase(torch, gc_cfg, gc_graph,
                        dataclasses.replace(gat_cora.config(),
                                            use_kernel=True),
                        gat_graph, cora["n_classes"])
    print(f"graphcast {gnn_res['graphcast_ms']:.2f} ms per forward, "
          f"gat-cora {gnn_res['gat_ms']:.3f} ms per forward; segment_sum "
          f"launches {gnn_res['launches']}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB", flush=True)

    phase("9 read-while-ingest service: d4m_stream geometry, 32 instances, "
          "point lookups and top-k against the live fleet")
    torch.cuda.empty_cache()
    svc = service_phase(torch, service_args())
    print(f"service: updates_per_s {svc['updates_per_s']:.1f} with queries, "
          f"{svc['ingest_only_updates_per_s']:.1f} without (interference "
          f"{svc['ingest_interference']:+.4f}); queries_per_s "
          f"{svc['queries_per_s']:.1f}; batch latency p50/p95/p99/max "
          f"{svc['latency_p50_ms']:.3f}/{svc['latency_p95_ms']:.3f}/"
          f"{svc['latency_p99_ms']:.3f}/{svc['latency_max_ms']:.3f} ms; "
          f"analytics {svc['analytics_ms_per_batch']:.3f} ms per batch; "
          f"merge_multi launched {svc['query_launches']['hier_merge.merge_multi']}"
          f" times by {svc['query_batches']} query batches; peak device "
          f"memory {svc['peak_gib']:.3f} GiB; {card}", flush=True)

    phase("10 checkpoint, resume, elastic resize, contracts: d4m_stream "
          "geometry, 32 instances")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    fault_tmp = tempfile.TemporaryDirectory()     # phase 17 restores from it
    fault_args = ingest_args(ckpt_every=4)
    fault = fault_phase(torch, fault_args,
                        ingest_args(instances=8, blocks=32, rounds=4),
                        fault_tmp.name)
    print(json.dumps(fault), flush=True)
    print(f"phase 10 wall {time.perf_counter() - t0:.1f} s; {card}",
          flush=True)

    phase("11 training at full width: DCN-v2 dense and --hier-embed through "
          "launch/train, GraphCast on the r=6 multimesh (remat), GAT-Cora "
          "full graph, a minibatch_lg node flow")
    del states, states_sort, states_lay, states_fused, live
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        tr = train_phase(
            torch, "cuda", tmp, gc_cfg=graphcast.config(),
            gc_graph=gc_graph, gat_cfg=gat_cora.config(),
            gat_graph=gat_graph, gat_classes=cora["n_classes"],
            flow_spec=GNN_SHAPES["minibatch_lg"], flow_cfg=gat_cora.config())
    for mode in ("dense", "hier"):
        r = tr["dcn"][mode]
        print(f"dcn-v2 {mode} train: {r['step_ms']:.3f} ms per step "
              f"(median after the first), {r['examples_per_s']:.1f} "
              f"examples/s, peak {r['peak_gib']:.3f} GiB, busy "
              f"{r['profile']['device_busy_share']:.3f}, "
              f"{r['host_reads_per_step']:g} host reads per step; {card}",
              flush=True)
    for name in ("graphcast", "gat_full", "gat_flow"):
        r = tr[name]
        print(f"{name} train: {r['step_ms']:.3f} ms per step, peak "
              f"{r['peak_gib']:.3f} GiB, busy "
              f"{r['profile']['device_busy_share']:.3f}; {card}", flush=True)
    print(f"phase 11 wall {time.perf_counter() - t0:.1f} s; {card}",
          flush=True)

    phase("12 the fleet across ranks: phase 4's fleet on P gloo ranks "
          "sharing the card (nccl: one rank a card), fleet counter, degree "
          "histogram, point lookups; max.plus and min.plus fleets")
    del tr
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cores = len(os.sched_getaffinity(0))
    runs = [("gloo", p) for p in (1, 2, 4, 8) if p <= 4 or cores >= 8]
    n_cards = torch.cuda.device_count()
    if n_cards >= 2:
        runs.append(("nccl", min(n_cards, 4)))
    print(f"{cores} cores for this process: gloo P in "
          f"{[p for b, p in runs if b == 'gloo']}; "
          + (f"nccl P={min(n_cards, 4)}" if n_cards >= 2 else
             f"nccl not run: {n_cards} card, it needs 2 or more"),
          flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        fleet = fleet_phase(
            torch, fleet_main,
            ingest_args(instances=8, blocks=32, rounds=4, lazy_l0="off"),
            "cuda", tmp, runs, card)
    print(json.dumps(fleet), flush=True)
    print(f"phase 12 wall {time.perf_counter() - t0:.1f} s; {card}",
          flush=True)

    phase("13 LM serving through launch/serve: card == CPU for five archs, "
          "granite-moe-3b-a800m whole, decode == forward, deepseek-v2-236b "
          f"at {DEEPSEEK_LAYERS} layers")
    del gc_graph, gat_graph, fleet_main
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    served = serve_phase(torch, "cuda", card)
    served["wall_s"] = time.perf_counter() - t0
    print(f"phase 13 wall {served['wall_s']:.1f} s; {card}", flush=True)

    phase("14 LM training through launch/train: card == CPU for five archs, "
          "smollm-360m whole at 4 x 4096, compression, granite-moe-3b-a800m "
          "whole at 8 x 1024, resume")
    gc.collect()
    torch.cuda.empty_cache()
    print(f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB held by earlier "
          f"phases", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        trained = train_lm_phase(torch, "cuda", card, tmp)
    print(f"phase 14 wall {trained['wall_s']:.1f} s; {card}", flush=True)

    phase("15 the stages front door: precompile_fleet, captured CUDA graphs "
          "for the canon query batch, granite-moe-3b-a800m decode and its "
          "training step, against their eager arms")
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        staged = stages_phase(torch, "cuda", card, tmp)
    print(f"phase 15 wall {staged['wall_s']:.1f} s; {card}", flush=True)

    phase("16 the analysis layer on the card: palkit (registry and main-path "
          "jobs, compute-sanitizer or the checked build), tracekit at the "
          "production config")
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        analysed = analysis_phase(torch, "cuda", card, tmp)
    if analysed["tracekit"]["launches"][MM] == 0:
        raise AssertionError("tracekit's recorded calls launched no "
                             "merge_multi: the kernel route was not audited")
    print(f"phase 16 wall {analysed['wall_s']:.1f} s; {card}", flush=True)

    phase("17 the sharding layer: the fleet restored and resized under "
          "Shard(0) on gloo ranks sharing the card, an FSDP x TP LM step on "
          "a DeviceMesh, the GNN and DCN-v2 steps on a (2, 2) gloo CPU "
          "mesh, the production meshes (shapes only)")
    gc.collect()
    torch.cuda.empty_cache()
    mesh_runs = [("nccl", (2, 2) if n_cards >= 4 else (1, 1))]
    print(f"{n_cards} card(s): the LM step on a {mesh_runs[0][1]} nccl mesh"
          + ("" if n_cards >= 4 else " (a (2, 2) nccl mesh needs 4 cards, "
             "one a rank)"), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        sharded = sharding_phase(
            torch, fault_args, os.path.join(fault_tmp.name, "fleet"),
            fault["resumed_at"], "cuda", card, tmp, mesh_runs=mesh_runs)
    fault_tmp.cleanup()
    print(f"phase 17 wall {sharded['wall_s']:.1f} s; {card}", flush=True)

    phase("18 the dry-run tooling: D4M cells, smollm-360m's train step, "
          "GraphCast's minibatch_lg step and DCN-v2's serve_bulk on the "
          "kernel route recorded on the card against their roofline bound; "
          "the production meshes' LM, DCN-v2 and GraphCast cells recorded "
          "on the host under a fake group")
    gc.collect()
    torch.cuda.empty_cache()

    def examples_on_the_card():
        phase("19 the examples: quickstart (card == CPU, and as a "
              "command), stream_ingest on the sort and kernel routes, "
              "recsys serving on the embedding_bag route, train_lm with an "
              "injected failure; phase 18 (b) records beside it")
        gc.collect()
        torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory() as tmp:
            out = examples_phase(torch, "cuda", card, tmp)
        print(f"phase 19 wall {out['wall_s']:.1f} s; {card}", flush=True)
        return out

    with tempfile.TemporaryDirectory() as tmp:
        dried = dryrun_phase(torch, "cuda", card, tmp,
                             then=examples_on_the_card)
    examples = dried.pop("then")
    if dried["merge_multi"] == 0:
        raise AssertionError("phase 18's D4M cells launched no merge_multi")
    if dried["embedding_bag"] == 0:
        raise AssertionError("phase 18's DCN-v2 serve_bulk cell launched no "
                             "embedding_bag")
    print(f"phase 18 wall {dried['wall_s']:.1f} s (phase 19 left out); "
          f"{card}", flush=True)
    fleet_launches = {f"{r['backend']} P={r['ranks']}": r["merge_multi"]
                      for r in fleet["runs"]}
    fleet_launches.update({f"{s} gloo P=2": fleet[s]["merge_multi"]
                           for s in ("max.plus", "min.plus")})

    kernels = []
    for name, source, replaces, launches in (
            ("hier_merge.merge_multi", "hier_merge/csrc/hier_merge.cu",
             "hier_merge/hier_merge.py:236",
             main_launches["hier_merge.merge_multi"]),
            ("hier_merge.merge", "hier_merge/csrc/hier_merge.cu",
             "hier_merge/hier_merge.py:212",
             layered_launches["hier_merge.merge"]),
            ("embedding_bag.embedding_bag",
             "embedding_bag/csrc/embedding_bag.cu",
             "embedding_bag/embedding_bag.py:45", dcn_res["launches"]),
            ("segment_agg.segment_sum", "segment_agg/csrc/segment_agg.cu",
             "segment_agg/segment_agg.py:90", gnn_res["launches"])):
        rec = numbers[name]
        kernels.append(dict(
            name=name, route="cuda",
            source=f"src/repro_torch/kernels/{source}",
            replaces=f"src/repro/kernels/{replaces}", launches=launches,
            max_abs_err=rec["max_abs_err"], ms=rec["ms"],
            plain_ms=rec["plain_ms"], bound_ms=rec["bound_ms"],
            bound_by=rec["bound_by"], library_ms=rec.get("library_ms"),
            sort_route_ms=rec["sort_route_ms"], shape=rec["shape"],
            device_us=rec.get("device_us"),
            kernels_per_call=rec.get("kernels_per_call")))
        kernels[-1].update({k: v for k, v in rec.items()
                            if k not in kernels[-1] and k != "ops_kernels"})
        kernels[-1].update(kernel_checks(analysed["report"],
                                         ANALYSIS_JOBS[name]))
    # phase 12's launches, summed over each fleet's ranks; phase 9's query
    # batches' (the warm-up's eager batch, then replays) and phase 15's
    kernels[0]["phase12_launches"] = fleet_launches
    kernels[0]["phase9_query_launches"] = svc["query_launches"][MM]
    kernels[0]["phase9_replay_launches"] = svc["query_replay_launches"]
    kernels[0]["phase15_launches_per_replay"] = \
        staged["canon_batch"]["merge_multi_per_replay"]
    kernels[0]["phase16_tracekit_launches"] = \
        analysed["tracekit"]["launches"][MM]
    kernels[0]["phase17_launches"] = {
        f"gloo P={r['ranks']}": r["merge_multi"]
        for r in sharded["fleet"]["runs"]}
    kernels[0]["phase18_launches"] = dried["merge_multi"]
    kernels[2]["phase18_launches"] = dried["embedding_bag"]
    kernels[0]["phase19_launches"] = examples["merge_multi"]
    kernels[2]["phase19_launches"] = examples["embedding_bag"]
    print(f"\nchip_smoke wall {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"serve": served, "card": card}))
    print(json.dumps({"train_lm": trained, "card": card}))
    print(json.dumps({"stages": staged, "card": card}))
    print(json.dumps({"analysis": {k: v for k, v in analysed.items()
                                   if k != "report"}, "card": card}))
    print(json.dumps({"sharding": sharded, "card": card}))
    print(json.dumps({"dryrun": dried, "card": card}))
    print(json.dumps({"examples": examples, "card": card}))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
