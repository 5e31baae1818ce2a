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
