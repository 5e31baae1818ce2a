"""Config dataclasses and input-shape tables of the families the port runs.

A copy of the GNN, RecSys and D4M parts of ``repro/configs/base.py``: the same
field names, defaults and derived properties, so ``dataclasses.asdict`` of
a port config equals the reference's.  Pure data, no torch.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

# ------------------------------------------------------------------ GNN -----


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    name: str
    kind: str                           # "gat" | "gin" | "gatedgcn" | "graphcast"
    n_layers: int
    d_hidden: int
    n_heads: int = 1                    # GAT
    aggregator: str = "sum"
    learnable_eps: bool = True          # GIN
    mesh_refinement: int = 6            # GraphCast
    n_vars: int = 227                   # GraphCast input channels
    d_in: int = 0                       # 0 = taken from the shape's d_feat
    n_classes: int = 16
    dtype: str = "float32"
    use_kernel: bool = False            # segment_agg CUDA kernel path
    remat: bool = True                  # checkpoint each layer (backward)

    family: str = dataclasses.field(default="gnn", init=False)


GNN_SHAPES = {
    "full_graph_sm": dict(kind="full", n_nodes=2708, n_edges=10556,
                          d_feat=1433, n_classes=7),          # Cora
    "minibatch_lg":  dict(kind="sampled", n_nodes=232_965,
                          n_edges=114_615_892, batch_nodes=1024,
                          fanouts=(15, 10), d_feat=602, n_classes=41),  # Reddit
    "ogb_products":  dict(kind="full", n_nodes=2_449_029,
                          n_edges=61_859_140, d_feat=100, n_classes=47),
    "molecule":      dict(kind="batched", n_nodes=30, n_edges=64, batch=128,
                          d_feat=16, n_classes=2),            # TU binary
}


# ---------------------------------------------------------------- RecSys ----


@dataclasses.dataclass(frozen=True)
class RecsysConfig:
    name: str
    n_dense: int = 13
    n_sparse: int = 26
    embed_dim: int = 16
    n_cross_layers: int = 3
    mlp: Tuple[int, ...] = (1024, 1024, 512)
    # Criteo-style per-field vocab sizes (sum ~ 96M rows, one stacked table).
    table_sizes: Tuple[int, ...] = (
        40_000_000, 20_000_000, 10_000_000, 8_000_000, 4_000_000,
        2_000_000, 2_000_000, 1_000_000, 1_000_000, 1_000_000,
        1_000_000, 1_000_000, 1_000_000, 512_000, 512_000,
        512_000, 256_000, 256_000, 128_000, 64_000,
        32_000, 16_000, 8_000, 4_000, 2_000, 1_000)
    multi_hot: int = 1
    interaction: str = "cross"
    dtype: str = "float32"
    use_kernel: bool = False            # embedding_bag CUDA kernel path
    # paper technique: hierarchical sparse-grad accumulation for the tables
    hier_embed_grads: bool = False

    family: str = dataclasses.field(default="recsys", init=False)

    @property
    def total_rows(self) -> int:
        return sum(self.table_sizes)

    @property
    def padded_rows(self) -> int:
        """Stacked-table rows padded to a multiple of 4096 (the reference
        pads so the row dimension shards evenly over any mesh)."""
        return -(-self.total_rows // 4096) * 4096

    @property
    def d_interact(self) -> int:
        return self.n_dense + self.n_sparse * self.embed_dim


RECSYS_SHAPES = {
    "train_batch":    dict(kind="train", batch=65_536),
    "serve_p99":      dict(kind="serve", batch=512),
    "serve_bulk":     dict(kind="serve", batch=262_144),
    "retrieval_cand": dict(kind="retrieval", batch=1,
                           n_candidates=1_000_000),
}


# ------------------------------------------------------------------ D4M -----


@dataclasses.dataclass(frozen=True)
class D4MConfig:
    """The paper's own workload: hierarchical assoc-array streaming ingest."""
    name: str
    cuts: Tuple[int, ...] = (2048, 16384, 131072)
    block_size: int = 1024
    blocks_per_step: int = 8            # stream blocks per device step
    instances_per_device: int = 4       # 34k/1.1k node analogue
    rmat_scale: int = 22                # 2^22 vertices
    dtype: str = "float32"
    use_kernel: bool = False
    lazy_l0: bool = False               # append-buffer layer 0
    fused: bool = True                  # single-sort fused spill cascade
    chunk: int = 1                      # stream blocks pre-combined per update
    # instance-batched execution strategy (stream.ingest_instances):
    # "grouped" (per depth cohort), "bucketed", "branchfree" or "switch"
    batch_mode: str = "grouped"
    # --- read path (query: engine + service) ---
    query_batch: int = 256              # Q-vector width per engine call
    # layer-0 strategy for queries: "auto" picks raw scan vs one
    # canonicalization of just the layer-0 buffer by Q (engine.py)
    query_l0_mode: str = "auto"
    queries_per_round: int = 1          # service loop: query batches/round

    family: str = dataclasses.field(default="d4m", init=False)

    def effective_chunk(self, blocks: int) -> int:
        """chunk>1 needs the fused planner (layered layer 0 has no headroom
        for a wider block) and a stream length it divides — else 1."""
        c = max(self.chunk, 1)
        return c if self.fused and blocks % c == 0 else 1
