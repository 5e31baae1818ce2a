"""Quickstart: D4M associative arrays, the Fig 1 query, and the hierarchy
— the port of ``examples/quickstart.py``.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

Walks the paper's core objects, one function a section:
  1. ``fig1``: build an associative array from (row, col, val) triples;
  2. ``neighbors``: the paper's Fig 1 operation — nearest neighbors of a
     vertex — as a semiring matrix-vector product and as a row extract;
  3. ``stream``: stream updates through a hierarchical array and watch the
     spill cascade keep most traffic in the fast layer;
  4. ``live_reads``: query and analyze the LIVE hierarchy with the
     streaming engine — batched point lookups, row extraction, degrees and
     heavy hitters, all without flushing or merging the layers;
  5. ``max_plus``: swap the semiring (max.plus) to reuse the same
     machinery for "latest-timestamp" semantics;
  6. ``observe``: one device-side metrics snapshot + the obs event stream
     that ``launch/monitor`` aggregates across processes.

Runs on the card unless ``--device cpu``.  The streamed keys are drawn
from a seeded ``torch.Generator`` on the CPU and moved to the device, so
every device sees the same stream.
"""
from __future__ import annotations

import argparse
import tempfile

import torch

from repro_torch import obs, resolve_device
from repro_torch.core import assoc, hier, semiring
from repro_torch.launch import monitor
from repro_torch.query import analytics, engine

# network traffic (Fig 1): vertices are IPs hashed to ints, A[src, dst] =
# #packets; (0, 1) is sent twice
SRC = (0, 0, 1, 2, 2, 3, 0)
DST = (1, 2, 2, 3, 1, 0, 1)


def traffic(device) -> tuple:
    """The 7 packets as int32 ``(src, dst)`` and unit float32 values."""
    src = torch.tensor(SRC, dtype=torch.int32, device=device)
    dst = torch.tensor(DST, dtype=torch.int32, device=device)
    return src, dst, torch.ones(len(SRC), device=device)


def fig1(src, dst, val, capacity: int = 16) -> tuple:
    """Section 1: the associative array (duplicates combined) and its
    overflow."""
    return assoc.from_coo(src, dst, val, capacity=capacity)


def neighbors(A, vertex: int = 0, n: int = 4) -> dict:
    """Section 2: Fig 1's neighbors of ``vertex``: ``A @ e_vertex`` over
    +.x, and the row extract's live (col, val) pairs."""
    e = torch.zeros(n, device=A.val.device)
    e[vertex] = 1.0
    cols, vals, mask = assoc.extract_row(A, vertex)
    return dict(spmv=assoc.spmv(A, e, num_rows=n),
                row=[(int(c), float(v)) for c, v, m in
                     zip(cols.tolist(), vals.tolist(), mask.tolist()) if m])


def stream_blocks(seed: int, n_blocks: int, block: int, n_keys: int,
                  device) -> list:
    """``n_blocks`` blocks of ``block`` (row, col) keys in
    ``[0, n_keys)``, drawn on the CPU from ``seed`` and moved to
    ``device``."""
    gen = torch.Generator().manual_seed(seed)
    return [tuple(torch.randint(0, n_keys, (block,), generator=gen,
                                dtype=torch.int32).to(device)
                  for _ in range(2)) for _ in range(n_blocks)]


def stream(blocks, cuts=(64, 256, 1024), device=None):
    """Section 3: every block through ``hier.update`` (the fused spill
    cascade, one canonicalization a block) with unit values; returns the
    hierarchy."""
    block = blocks[0][0].shape[0]
    h = hier.create(cuts, block_size=block, device=device)
    for r, c in blocks:
        h = hier.update(h, r, c, torch.ones(block, device=r.device))
    return h


def live_reads(h, q_rows, q_cols, row: int = 3, num_rows: int = 512,
               k: int = 3) -> dict:
    """Section 4: batched point lookups, one row's dense extract, the
    heavy hitters and the weighted out-degree vector of the live
    hierarchy."""
    dense, truncated = engine.extract_rows(
        h, torch.tensor([row], dtype=torch.int32, device=h.device),
        num_cols=num_rows)
    totals, hot = analytics.top_k_rows(h, num_rows=num_rows, k=k)
    return dict(lookups=hier.lookup(h, q_rows, q_cols), row=dense,
                truncated=truncated, top_totals=totals, top_rows=hot,
                degrees=analytics.out_degrees(h, num_rows=num_rows))


def max_plus(src, dst, capacity: int = 16, n: int = 4):
    """Section 5: the same packets with their timestamps under max.plus:
    the dense view of the latest time each edge was seen."""
    ts = torch.arange(len(src), dtype=torch.float32, device=src.device)
    latest, _ = assoc.from_coo(src, dst, ts, capacity=capacity,
                               sr=semiring.MAX_PLUS)
    return assoc.to_dense(latest, n, n, sr=semiring.MAX_PLUS)


def observe(h, obs_dir: str) -> tuple:
    """Section 6: one ``fleet`` sample of the hierarchy into
    ``<obs_dir>/obs.jsonl`` (``metrics_snapshot``: nnz, occupancy, spills,
    depth and the exact 64-bit update counter in one dispatch), then the
    monitor's summary of the directory.  Returns ``(sample, summary)``."""
    obs.enable(obs_dir)
    try:
        sample = obs.metrics.fleet_sample(h)
        obs.emit("fleet", **sample)
    finally:
        obs.disable()
    return sample, monitor.main(["--once", "--obs-dir", obs_dir])


def main(device="cuda", *, seed: int = 0, n_blocks: int = 32,
         block: int = 32, n_keys: int = 512,
         cuts=(64, 256, 1024)) -> dict:
    """The six sections at the reference's sizes; returns what they
    print, as plain Python values."""
    dev = resolve_device(device)
    src, dst, val = traffic(dev)

    A, overflow = fig1(src, dst, val)
    print(f"A: nnz={int(A.nnz)} (duplicates combined), "
          f"overflow={int(overflow)}")
    dense = assoc.to_dense(A, 4, 4)
    print("dense view:\n", dense)

    nb = neighbors(A)
    print("out-degree-weighted neighbors of v0:", nb["spmv"])
    print("row-extract neighbors of v0:", nb["row"])

    blocks = stream_blocks(seed, n_blocks, block, n_keys, dev)
    h = stream(blocks, cuts, dev)
    nnz, spills = h.nnz_per_layer().tolist(), h.spills.tolist()
    print(f"\nafter {n_blocks * block} streamed updates: nnz/layer={nnz}, "
          f"spills/layer={spills}  (most merges stayed in layer 0)")
    merged = hier.query_all(h)
    total = float(assoc.total(merged))
    print(f"query_all: {int(merged.nnz)} unique edges, total weight "
          f"{total:.0f}")

    # keys from the last streamed block: the engine answers the whole
    # vector of lookups by per-layer binary search, no merge
    r, c = blocks[-1]
    live = live_reads(h, r[:3], c[:3], num_rows=n_keys)
    print("\nbatched live lookups:", live["lookups"])
    live_cols = int((live["row"] != 0).sum())
    print(f"row 3 extract: {live_cols} live cols "
          f"(truncated={int(live['truncated'][0])})")
    hot = [(int(i), float(t)) for i, t in
           zip(live["top_rows"].tolist(), live["top_totals"].tolist())]
    print("heavy hitters (top-3 rows by weight):", hot)
    deg = live["degrees"]
    print(f"degree vector: {int((deg > 0).sum())} active rows, "
          f"max weighted out-degree {float(deg.max()):.0f}")

    latest = max_plus(src, dst)
    print("\nlatest-timestamp array (max.plus):\n", latest)

    with tempfile.TemporaryDirectory(prefix="obs-quickstart-") as d:
        sample, summary = observe(h, d)
    print(f"\nfleet sample: {sample['updates']} exact updates, "
          f"nnz/layer={sample['nnz']}, occupancy="
          f"{[f'{o:.0%}' for o in sample['occupancy']]}")
    print(f"monitor saw {summary['records']} records from "
          f"{summary['sources']} source(s)")
    return dict(
        device=str(dev), nnz=int(A.nnz), overflow=int(overflow),
        dense=dense.tolist(), spmv=nb["spmv"].tolist(), row=nb["row"],
        nnz_per_layer=nnz, spills=spills, unique_edges=int(merged.nnz),
        total_weight=total, lookups=live["lookups"].tolist(),
        row3_live_cols=live_cols, truncated=int(live["truncated"][0]),
        top_rows=hot, degrees=deg.tolist(), active_rows=int((deg > 0).sum()),
        max_plus=latest.tolist(), sample=sample,
        monitor_records=summary["records"],
        monitor_sources=summary["sources"])


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; the run fails when it "
                    "is absent)")
    main(ap.parse_args().device)
