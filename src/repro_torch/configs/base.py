"""Config dataclasses and input-shape tables of the families the port runs.

A copy of ``repro/configs/base.py``: the same field names, defaults and
derived properties, so ``dataclasses.asdict`` of a port config equals the
reference's, and the same shape tables.  Pure data, no torch.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

# ------------------------------------------------------------------ LM ------


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    vocab: int
    d_model: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    attn: str = "gqa"                  # "gqa" | "mla"
    # --- MLA (DeepSeek-V2) ---
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    # --- MoE ---
    moe: bool = False
    n_experts: int = 0
    top_k: int = 0
    n_shared: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25
    moe_shard: str = "ep"              # "ep" (experts over model) | "tp"
    # --- misc ---
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    remat: bool = True
    attn_chunk: int = 512
    num_microbatches: int = 1          # grad-accumulation inside train_step
    grad_accum_dtype: str = "float32"  # bf16 halves the accumulator (±3 bits)
    prefill_microbatch: int = 0        # 0 = whole batch in one pass
    scan_layers: bool = True           # False: unrolled (dry-run flop probes)
    layout: str = "2d"                 # "2d" = FSDP x TP | "dp" = pure DP

    family: str = dataclasses.field(default="lm", init=False)

    @property
    def n_params(self) -> int:
        """Total parameter count (exact, matches init)."""
        d, v = self.d_model, self.vocab
        emb = v * d * (1 if self.tie_embeddings else 2)
        if self.attn == "mla":
            h = self.n_heads
            qk = (self.q_lora_rank and
                  d * self.q_lora_rank
                  + self.q_lora_rank * h * (self.qk_nope_dim + self.qk_rope_dim)
                  ) or d * h * (self.qk_nope_dim + self.qk_rope_dim)
            attn = (qk + d * (self.kv_lora_rank + self.qk_rope_dim)
                    + self.kv_lora_rank * h * (self.qk_nope_dim + self.v_head_dim)
                    + h * self.v_head_dim * d)
        else:
            attn = d * self.n_heads * self.d_head \
                + 2 * d * self.n_kv_heads * self.d_head \
                + self.n_heads * self.d_head * d
        if self.moe:
            ffn = (d * self.n_experts                       # router
                   + 3 * self.n_experts * d * self.d_ff_expert
                   + 3 * self.n_shared * d * self.d_ff_expert)
        else:
            ffn = 3 * d * self.d_ff
        per_layer = attn + ffn + 2 * d                       # + 2 norms
        return emb + self.n_layers * per_layer + d           # + final norm

    @property
    def n_active_params(self) -> int:
        """Params touched per token (MoE: routed top-k + shared only)."""
        if not self.moe:
            return self.n_params
        d = self.d_model
        routed_all = 3 * self.n_experts * d * self.d_ff_expert
        routed_act = 3 * self.top_k * d * self.d_ff_expert
        return self.n_params - self.n_layers * (routed_all - routed_act)


# LM shapes: seq_len x global_batch.  decode_* / long_* lower serve_step.
LM_SHAPES = {
    "train_4k":    dict(kind="train",   seq=4096,    batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768,   batch=32),
    "decode_32k":  dict(kind="decode",  seq=32768,   batch=128),
    # long_500k needs sub-quadratic attention; every LM arch here is
    # full softmax attention (GQA/MLA), so this cell is a documented skip.
    "long_500k":   dict(kind="decode",  seq=524288,  batch=1,
                        requires_subquadratic=True),
}


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


D4M_SHAPES = {
    # one device-step of the paper's experiment at three block regimes
    "ingest_small":  dict(kind="ingest", block_size=1024, blocks=8),
    "ingest_paper":  dict(kind="ingest", block_size=100_000, blocks=10),
    "ingest_wide":   dict(kind="ingest", block_size=8192, blocks=64),
    "query":         dict(kind="query"),
}


SHAPES_BY_FAMILY = {
    "lm": LM_SHAPES,
    "gnn": GNN_SHAPES,
    "recsys": RECSYS_SHAPES,
    "d4m": D4M_SHAPES,
}
