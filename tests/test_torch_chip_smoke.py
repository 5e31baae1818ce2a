"""``chip_smoke.py``'s model phases (7: DCN-v2 serving, 8: GNN inference,
13: LM serving), phase 9 (the read-while-ingest service), phase 15 (the
``stages`` front door, every entry eager here) and phase 3's
segment_sum checks rehearsed on the CPU at small sizes: the
same calls and checks as on the card, with the kernel wrappers running
their plain versions (so no launch is counted).  The DCN-v2 kernel route
equals the reference route exactly; the GNN kernel route adds a run that
crosses a chunk of sorted edges in another order than ``index_add_``, so it
agrees to float32 rounding."""
import dataclasses
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.data import graphs  # noqa: E402


def test_dcn_phase_on_cpu():
    cfg = dataclasses.replace(registry.get_smoke_config("dcn-v2"),
                              use_kernel=True)
    res = chip_smoke.dcn_phase(torch, cfg, "cpu", p99_batch=16,
                               bulk_batch=64, n_candidates=500, vocab=5000,
                               k=10)
    assert res["launches"] == 0 and res["kernel_route_calls"] == 42
    assert res["max_score_diff"] == 0.0
    assert res["serve_bulk_examples_per_s"] > 0


def test_gnn_phase_on_cpu():
    _, src, dst = graphs.icosahedral_multimesh(2)
    gc = dataclasses.replace(registry.get_smoke_config("graphcast"),
                             use_kernel=True)
    gen = torch.Generator().manual_seed(5)
    gc_graph = dict(node_feat=torch.randn((162, gc.n_vars), generator=gen),
                    edge_src=torch.as_tensor(src),
                    edge_dst=torch.as_tensor(dst))
    gat = dataclasses.replace(registry.get_config("gat-cora"),
                              use_kernel=True)
    gat_graph = graphs.random_graph(6, 300, 1200, 50, 7, device="cpu")
    res = chip_smoke.gnn_phase(torch, gc, gc_graph, gat, gat_graph, 7)
    assert res["launches"] == 0
    assert res["graphcast_max_rel_err"] <= 1e-6
    assert res["gat_max_rel_err"] <= 1e-6
    assert res["graphcast_segment_sum_ops"]["aten::sort"] == gc.n_layers
    assert res["graphcast_degree_max_mean"][0] >= 5


def test_profile_merge_needs_a_card():
    """The merge profiler measures on the card only: without one it exits
    with 2 and prints no result."""
    from repro_torch.launch import profile_merge
    want = 0 if torch.cuda.is_available() else 2
    assert profile_merge.main() == want


def test_segment_checks_on_cpu():
    """Phase 3's segment_sum cases (the 5,000-edge hub, runs of one chunk,
    empty nodes, dropped ids, E = 0, D = 12, D = 640, unaligned rows) with
    GraphCast's r = 2 multimesh for the r = 6 one."""
    import numpy as np
    mesh = graphs.icosahedral_multimesh(2)
    gat_dst = graphs.random_graph(6, 2708, 10556, 8, 7,
                                  device="cpu")["edge_dst"]
    cases = chip_smoke.segment_case_list(np, mesh, gat_dst)
    assert len(cases) == 12
    worst = chip_smoke.segment_checks(torch, torch.Generator().manual_seed(4),
                                      cases, device="cpu")
    assert worst <= 1e-4


def test_profile_segment_needs_a_card():
    """The segment profiler measures on the card only: without one it
    exits with 2 and prints no result."""
    from repro_torch.launch import profile_segment
    want = 0 if torch.cuda.is_available() else 2
    assert profile_segment.main() == want


def test_service_phase_on_cpu():
    """Phase 9 at smoke size: the service through ``launch/query.run``
    with and without queries (equal states, exact counter), then every
    query surface on the live fleet exactly equal to the flushed states'
    answers; the plain versions launch nothing."""
    args = chip_smoke.service_args(instances=3, blocks=16, block_size=32,
                                   cuts="64,256,1024", scale=10, rounds=4,
                                   queries=64, top_k=4, device="cpu")
    res = chip_smoke.service_phase(torch, args, width=2)
    assert res["query_batches"] == 4
    assert res["query_launches"]["hier_merge.merge_multi"] == 0
    assert res["updates_per_s"] > 0 and res["queries_per_s"] > 0
    assert res["narrow_max_truncated"] > 0
    assert res["latency_p50_ms"] <= res["latency_max_ms"]


def test_fault_phase_on_cpu(tmp_path):
    """Phase 10 at smoke size: run A checkpoints every 2 of 8 rounds, the
    checkpoints of rounds 6 and 8 go, run B resumes at round 4 and ends
    equal to A; A's state restores on the CPU; 4 instances shrink to 2
    and grow to 5 keeping every key's total; a bf16 fleet's kernel route
    equals its sort route and ranks as float32; the checked ingest passes
    and the corrupted checkpoint is refused by name."""
    kw = dict(block_size=32, cuts="64,256,1024", scale=10, device="cpu")
    big = chip_smoke.ingest_args(instances=4, blocks=32, rounds=8,
                                 ckpt_every=2, **kw)
    small = chip_smoke.ingest_args(instances=2, blocks=8, rounds=4, **kw)
    res = chip_smoke.fault_phase(torch, big, small, str(tmp_path))
    assert res["resumed_at"] == 4 and res["rounds_run"] == 4
    assert res["counter"] == 4 * 32 * 32
    assert res["resumed_merge_multi"] == 0       # plain versions on the CPU
    assert res["checkpoint_mib"] > 0
    assert "sentinel-tail violation in restore step_1 layer 1" \
        in res["refused"]


def test_train_phase_on_cpu(tmp_path):
    """Phase 11 at smoke size: DCN-v2 dense and ``--hier-embed`` through
    ``launch/train.run_with_state`` (finite losses and gnorms, a non-zero
    gradient for every leaf, the kernel route refused), the hier path's
    exact mass, GraphCast (remat on == off at 2 layers), GAT full graph, a
    sampled node flow with ``seed_count``, and the train CLI's resume."""
    _, src, dst = graphs.icosahedral_multimesh(2)
    gc = registry.get_smoke_config("graphcast")
    gen = torch.Generator().manual_seed(5)
    gc_graph = dict(node_feat=torch.randn((162, gc.n_vars), generator=gen),
                    edge_src=torch.as_tensor(src),
                    edge_dst=torch.as_tensor(dst))
    gat = registry.get_smoke_config("gat-cora")
    gat_graph = graphs.random_graph(6, 300, 1200, 50, 7, device="cpu")
    flow = dict(kind="sampled", n_nodes=500, n_edges=4000, batch_nodes=16,
                fanouts=(3, 2), d_feat=12, n_classes=5)
    res = chip_smoke.train_phase(
        torch, "cpu", str(tmp_path), dcn_smoke=True, dcn_batch=16,
        dcn_steps=3, vocab=5000, gc_cfg=gc, gc_graph=gc_graph, gc_steps=2,
        gat_cfg=gat, gat_graph=gat_graph, gat_classes=7, gat_steps=2,
        flow_spec=flow, flow_cfg=gat)
    for mode in ("dense", "hier"):
        r = res["dcn"][mode]
        assert len(r["losses"]) == 3 and r["examples_per_s"] > 0
        assert r["grads"]["leaves"] == (11 if mode == "dense" else 11)
    assert res["dcn"]["hier"]["host_reads_per_step"] == 3   # 2 spills, drain
    assert res["dcn"]["hier_exact"]["max_abs_err"] <= 1e-5
    remat = res["graphcast"]["remat_2_layers"]
    assert remat["deterministic"]["max_rel_err"] <= 1e-5
    assert remat["default"]["max_rel_err"] <= 1e-5       # ordered on a CPU
    assert res["gat_flow"]["flow_nodes"] == 16 + 48 + 96
    assert res["gat_flow"]["flow_edges"] == 48 + 96
    for arch in ("dcn-v2", "gat-cora"):
        assert res["resume"][arch]["resumed_rel_err"] <= 1e-5
    assert "cross_device" not in res                  # the card only
    # the card-vs-CPU comparison's own code, with the CPU standing in
    xdev = chip_smoke.cross_device_checks(torch, card="cpu")
    assert all(v["params_max_rel_err"] == 0.0 for v in xdev.values())


def test_fleet_phase_on_cpu(tmp_path):
    """Phase 12 at smoke size on gloo ranks on the CPU: phase 4's fleet
    (here 4 instances, cuts 64,256,1024, block 32, 16 blocks in 4 rounds)
    on P = 1, 2 and 4 ranks, each rank's block equal to the single-process
    fleet leaf for leaf, the fleet counter, the degree histogram, the
    combined and per-instance canon lookups exact, the ranks' merges
    summed equal to one process's (the plain versions count none); then
    the max.plus and min.plus fleets on 2 ranks."""
    from repro_torch.core import semiring as sr_mod
    from repro_torch.kernels import registry
    from repro_torch.launch import ingest
    kw = dict(block_size=32, cuts="64,256,1024", scale=10, device="cpu")
    args = chip_smoke.ingest_args(instances=4, blocks=16, rounds=4, **kw)
    registry.reset_launches()
    out, states = ingest.run_with_state(args)
    queries = chip_smoke.fleet_queries(torch, states, 256, 10, 11)
    assert (queries[0] < 1 << 10).all() and queries[0].shape == (256,)
    main = dict(args=args, queries=queries, launches=registry.launches(),
                want=chip_smoke.fleet_expected(torch, states,
                                               sr_mod.PLUS_TIMES, queries,
                                               1 << 10))
    assert main["want"]["count"] == out["n_updates_counter"] == 4 * 16 * 32
    assert main["want"]["hist"].sum() > 0
    small = chip_smoke.ingest_args(instances=4, blocks=8, rounds=2,
                                   lazy_l0="off", **kw)
    res = chip_smoke.fleet_phase(
        torch, main, small, "cpu", str(tmp_path),
        [("gloo", 1), ("gloo", 2), ("gloo", 4)], "cpu")
    assert [r["ranks"] for r in res["runs"]] == [1, 2, 4]
    for r in res["runs"]:
        assert r["updates"] == 4 * 16 * 32 and r["updates_per_s"] > 0
        assert len(r["rank_updates_per_s"]) == r["ranks"]
        assert r["rank_peak_gib"] == [None] * r["ranks"]   # the card only
        assert r["merge_multi"] == 0                 # plain versions
    for sr_name in ("max.plus", "min.plus"):
        assert res[sr_name]["ranks"] == 2
        assert res[sr_name]["updates"] == 4 * 8 * 32


def test_serve_phase_on_cpu():
    """Phase 13 at smoke size: (a) the card-vs-CPU comparison's own code
    with the CPU standing in, five archs; (b) granite's smoke config served
    through ``launch/serve.run_with_state`` at two prompt lengths; (c) its
    decode == forward in float32; (d) deepseek's smoke config through
    ``serve.run_config`` and its absorbed MLA decode == the naive forward
    at one layer; no kernel launched."""
    res = chip_smoke.serve_phase(torch, "cpu", "cpu", smoke=True)
    assert sorted(res["cross_device"]) == list(chip_smoke.LM_ARCHS)
    assert all(v == 0.0 for errs in res["cross_device"].values()
               for v in errs.values())
    for key in ("granite", "granite_long", "deepseek"):
        r = res[key]
        assert r["finite"] and r["decode_tok_s"] > 0
        assert r["generated"] == (2, 5) and r["peak_gib"] is None
        assert "profile" not in r                     # the card only
    assert res["granite_long"]["prefill_s"] > 0
    for key in ("granite_decode_vs_forward", "deepseek_decode_vs_forward"):
        assert res[key]["max_rel_err"] <= 1e-5
        assert res[key]["max_rel_err_factor_8"] <= 1e-5   # no drop here
    assert res["deepseek_params"] == registry.get_smoke_config(
        "deepseek-v2-236b").n_params
    assert not any(res["launches"].values())


def test_train_lm_phase_on_cpu(tmp_path):
    """Phase 14 at smoke size: (a) the card-vs-CPU comparison's own code
    with the CPU standing in, five archs (nm 2 == nm 1 for the dense ones,
    remat on == off); (b) smollm and (d) granite-moe trained through
    ``launch/train.run_with_state`` (finite losses, a gradient for every
    leaf); (c) compression's error-feedback invariant and wire bytes;
    (e) resume == uninterrupted, plain and int8; no kernel launched."""
    res = chip_smoke.train_lm_phase(torch, "cpu", "the CPU, no card line",
                                    str(tmp_path), smoke=True)
    xdev = res["cross_device"]
    assert sorted(xdev) == list(chip_smoke.LM_ARCHS)
    for arch, r in xdev.items():
        assert r["params_max_abs_err"] == r["moments_max_abs_err"] == 0.0
        assert r["remat_max_rel_err"] <= 1e-5
        moe = registry.get_smoke_config(arch).moe
        assert ("nm2_vs_nm1_params_max_abs_err" in r) != moe
    for key, arch in (("smollm", "smollm-360m"),
                      ("granite", "granite-moe-3b-a800m")):
        r = res[key]
        assert r["params"] == registry.get_smoke_config(arch).n_params
        assert len(r["losses"]) == 4 and r["tokens_per_s"] > 0
        assert r["grads"]["leaves"] == (12 if key == "granite" else 11)
        assert r["peak_gib"] is None and "profile" not in r  # the card only
    for kind, r in res["compress"].items():
        assert r["invariant_max_rel_err"] <= 1e-5
        assert r["wire_bytes"] < r["dense_f32_bytes"]
    assert res["compress"]["int8"]["ratio"] > 3.9
    assert sorted(res["resume"]) == [
        "granite-moe-3b-a800m int8", "granite-moe-3b-a800m plain",
        "smollm-360m int8", "smollm-360m plain"]
    assert all(r["resumed_rel_err"] <= 1e-5 for r in res["resume"].values())
    assert not any(res["launches"].values())


def test_stages_phase_on_cpu(tmp_path):
    """Phase 15 at smoke size, where every entry is eager: (a)
    ``precompile_fleet`` then the ingest and query CLIs with 0 lowerings
    and 0 compiles and one ``dispatch`` record per dispatch; (b) the canon
    batch's two arms equal; (c) granite's smoke decode, tokens equal and
    logits bit-equal; (d) granite's smoke training, losses within rtol
    1e-5 under deterministic algorithms and equal without (every arm is
    eager here), and the five smoke configs bit for bit."""
    res = chip_smoke.stages_phase(torch, "cpu", "the CPU, no card line",
                                  str(tmp_path), smoke=True)
    a = res["front_door"]
    assert a["after_precompile"]["compiles"] == 0
    assert a["after_precompile"]["lowerings"] == 0
    assert a["dispatch_records"] == a["after_precompile"]["dispatches"] > 0
    assert set(a["precompile"].values()) == {"compiled"}
    assert a["kinds"] == {"eager": a["dispatch_records"]}
    b = res["canon_batch"]
    assert b["merge_multi_per_replay"] == 0 and len(b["graph_ms"]) == 7
    assert b["copied_bytes_same_fleet"] == b["copied_bytes_fresh_fleet"] == 0
    c = res["decode"]
    assert c["logits_max_abs_err"] == 0.0 and c["replays"] == 0
    assert len(c["graph_ms_per_step"]) == chip_smoke.STAGES_RUNS
    d = res["train"]
    assert d["graph_det"]["losses_max_rel_err"] <= 1e-5
    assert d["graph"]["losses_max_rel_err"] == 0.0        # eager here
    assert len(d["eager"]["losses"]) == chip_smoke.TRAIN_AB_STEPS
    assert sorted(res["train_smoke_bits"]) == list(chip_smoke.LM_ARCHS)
    assert all(r["bit_equal"] for r in res["train_smoke_bits"].values())
    assert "capture_refused" not in res                   # the card only
    assert res["stats"]["captures"] == 0


def test_analysis_phase_on_cpu(tmp_path):
    """Phase 16 rehearsed on the CPU: palkit exits 2 without a card (no
    rule skipped, nothing run), tracekit over the smoke config's fleet
    entries with the kernel route is clean and the graph entry reads no
    host."""
    res = chip_smoke.analysis_phase(torch, "cpu", "cpu", str(tmp_path),
                                    smoke=True)
    assert res["palkit"] is None and res["report"] is None
    tk = res["tracekit"]
    assert tk["fresh"] == 0 and tk["allowed"] == tk["violations"] > 0
    assert tk["entries"]["service.point_query"]["host_reads_per_call"] == 0
    assert tk["entries"]["service.ingest"]["host_reads_per_call"] > 0
    assert set(tk["entries"]) >= {"stream.ingest_instances",
                                  "service.ingest", "service.point_query",
                                  "hier.update", "hier.flush"}


def test_sharding_phase_on_cpu(tmp_path):
    """Phase 17 at smoke size on gloo ranks on the CPU (the plain kernel
    versions): (a) a fleet of 8 instances checkpointed at round 4 of 8,
    restored under ``Shard(0)`` on P = 2 and 4 ranks, grown to 16, the 4
    remaining rounds ingested: the blocks joined equal one process's
    restore -> resize -> rounds; (b) phi3-mini's smoke step on a (2, 2)
    CPU mesh equal to the unsharded step; (d) the four GNN kinds' and
    DCN-v2's smoke steps on a (2, 2) gloo mesh equal to the unsharded
    steps, DCN-v2's serving and retrieval too; (c) both production meshes
    under a fake group, shapes only."""
    import os
    from repro_torch.launch import ingest
    kw = dict(block_size=32, cuts="64,256,1024", scale=10, device="cpu")
    args = chip_smoke.ingest_args(instances=8, blocks=32, rounds=8,
                                  ckpt_every=4, **kw)
    args.ckpt_dir = str(tmp_path / "fleet")
    ingest.run_with_state(args)
    assert sorted(os.listdir(args.ckpt_dir)) == ["step_4", "step_8"]
    res = chip_smoke.sharding_phase(
        torch, args, args.ckpt_dir, 4, "cpu", "cpu", str(tmp_path),
        mesh_runs=[("gloo", (2, 2))], jobs=(chip_smoke.MESH_JOBS[0],),
        n_new=16)
    # 4 blocks of 32 a round: 4 rounds of 8 instances, then 4 of 16
    assert res["fleet"]["counter"] == (8 + 16) * 4 * 4 * 32
    assert [r["ranks"] for r in res["fleet"]["runs"]] == [2, 4]
    for r in res["fleet"]["runs"]:
        assert r["merge_multi"] == 0                # plain versions
        assert r["peak_gib"] == [None] * r["ranks"]  # the card only
    (lm,) = res["lm"]
    assert lm["mesh"] == [2, 2] and lm["backend"] == "gloo"
    assert abs(lm["loss"] - lm["unsharded_loss"]) < chip_smoke.MESH_LOSS_TOL
    assert lm["param_excess"] <= chip_smoke.MESH_LR / 10
    models = {r["arch"]: r for r in res["models"]}
    assert sorted(models) == sorted(a for a, _ in chip_smoke.MODEL_MESH_JOBS)
    for r in res["models"]:
        assert len(r["losses"]) == r["steps"] > 0
        for a, b in zip(r["losses"], r["unsharded_losses"]):
            assert abs(a - b) < chip_smoke.MESH_LOSS_TOL
        assert r["param_excess"] <= r["lr"] / 10
    dcn = models["dcn-v2"]
    assert dcn["topk_equal"] and not dcn["ties"]
    assert dcn["score_err"] <= chip_smoke.SCORE_RTOL
    assert dcn["sharded_leaves"] >= 1                  # the table's rows
    assert models["gat-cora"]["batch_local"]["edge_src"] == [100]
    assert [p["mesh"] for p in res["production"]] == [[16, 16], [2, 16, 16]]
    assert all(p["leaves"] > 100 for p in res["production"])


def test_dryrun_phase_on_cpu(tmp_path):
    """Phase 18 at smoke size on the CPU: (a) through ``cells.lower_cell``
    on a one-rank gloo group, the D4M ``ingest_small`` and ``query`` cells
    at ``d4m_stream.config()`` (the plain kernel versions) and smollm's
    train step at its smoke widths, 4 x 32, GraphCast's train step and
    DCN-v2's ``serve_bulk`` on the kernel route (the plain version here;
    its scores held against the gather route's) at smoke widths, each
    recorded and timed — the roofline bound at the H100's rates held under
    the CPU's measured time; (b) ``dryrun.run_cell`` in child processes
    on both production meshes under a fake group: decode cells, DCN-v2's
    ``train_batch`` and GraphCast's ``ogb_products`` at smoke widths and a
    ``long_500k`` skip."""
    import torch_parity as tp
    lm = tp.smoke_variant("smollm-360m")
    dcn = tp.smoke_variant("dcn-v2")
    gc = tp.smoke_variant("graphcast")
    res = chip_smoke.dryrun_phase(
        torch, "cpu", "cpu", str(tmp_path),
        card_cells=(("d4m-stream", "ingest_small", "baseline"),
                    ("d4m-stream", "query", "baseline"),
                    ("smollm-360m", "train_4k", lm),
                    ("graphcast", "full_graph_sm", gc),
                    ("dcn-v2", "serve_bulk", dcn + ",use_kernel=1")),
        host_cells=(("single", "smollm-360m", "decode_32k", lm),
                    ("multi", "granite-moe-3b-a800m", "decode_32k",
                     tp.smoke_variant("granite-moe-3b-a800m")),
                    ("single", "smollm-360m", "long_500k", "baseline"),
                    ("single", "dcn-v2", "train_batch", dcn),
                    ("single", "graphcast", "ogb_products", gc)),
        lm_cut=dict(batch=4, seq=32), reps=1, host_timeout=300)
    ingest, query, train, graphcast, serve = res["card"]
    for r in res["card"]:
        assert 0 < r["bound_ms"] <= r["ms"] and r["fraction"] <= 1
        assert r["recorded_peak_bytes"] > 0 and r["argument_bytes"] > 0
    assert ingest["dominant"] == "memory" and ingest["coll"] == 0
    # the histogram's one all_reduce, recorded on a one-rank group too
    assert query["collectives"] == {"all-reduce": 32 * 4}
    assert train["flops"] > 0 and train["tokens"] == 4 * 32
    assert train["useful_fraction"] > 0
    # ingest's sorts, compares and bit ops count: a useful fraction
    assert ingest["flops"] > 0 and ingest["useful_fraction"] > 0
    assert res["merge_multi"] == res["embedding_bag"] == 0  # plain versions
    # the padded Cora graph at smoke widths, on a one-rank mesh
    assert graphcast["kind"] == "full" and graphcast["tokens"] == 4096
    assert graphcast["flops"] > 0 and graphcast["useful_fraction"] > 0
    assert serve["kind"] == "serve" and serve["tokens"] == 262_144
    assert serve["plain_route_rel_err"] <= chip_smoke.SCORE_RTOL
    decode, granite, skip, dcn_train, gc_products = res["host"]
    for r in (dcn_train, gc_products):
        assert r["status"] == "ok" and r["fits_hbm"] is True
        assert r["collective_bytes_per_device"] > 0
    assert decode["status"] == granite["status"] == "ok"
    assert decode["collective_bytes_per_device"] > 0
    assert granite["mesh"] == "multi" and granite["fits_hbm"] is True
    assert skip["status"] == "skip"


EXAMPLE_SIZES = dict(
    stream_ingest=dict(instances=2, blocks=8, block_size=64, rounds=4,
                       cuts="64,512,4096", scale=10, hist_instances=2,
                       hist_blocks=4, hist_block=64, hist_scale=10,
                       hist_cuts=(64, 512), num_rows=1 << 10),
    recsys_hier_embeddings=dict(batch=32, steps=4, drain_every=2,
                                cuts=(64, 128, 256), n_candidates=1000),
    train_lm=dict(steps=12, batch=2, seq=32, ckpt_every=2, fail_at_step=6,
                  log_every=0))


def test_examples_phase_on_cpu(tmp_path):
    """Phase 19 rehearsed on the CPU at the examples' test sizes: each
    example in a fresh process (quickstart also as its plain command),
    quickstart's values equal to the CPU's, stream_ingest's sort and
    ``use_kernel`` runs equal (the kernel route's plain version here) and
    resumed == uninterrupted with no process group left, recsys' serving
    batch on both routes, train_lm's own checks.  No kernel runs here:
    the launch gates are the card's."""
    res = chip_smoke.examples_phase(torch, "cpu", "cpu", str(tmp_path),
                                    sizes=EXAMPLE_SIZES)
    assert res["merge_multi"] == res["embedding_bag"] == 0
    # obs_start, the sample's dispatch, the fleet sample and its span
    assert "monitor saw 4 records" in res["quickstart_command"]["last_line"]
    assert res["quickstart"]["monitor_records"] == 4
    for route in ("sort", "kernel"):
        run = res["stream_ingest"][route]
        assert run["counter"] == 2 * 8 * 64
        assert run["resumed_counter"] == run["uninterrupted_counter"]
    assert res["recsys_hier_embeddings"]["drains"] == 2
    assert res["recsys_hier_embeddings"]["use_kernel"] is True
    assert res["train_lm"]["failures"] == 1
