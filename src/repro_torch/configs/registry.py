"""Arch registry: arch id -> config module, for every arch of the reference.

Every architecture is a module exposing ``config()`` (the full-size config)
and ``smoke_config()`` (a reduced same-family config for CPU tests), as in
``repro/configs/registry.py``.
"""
from __future__ import annotations

import importlib
from typing import List

ARCHS = {
    # LM family (5)
    "deepseek-v2-236b":     ("lm", "repro_torch.configs.deepseek_v2_236b"),
    "granite-moe-3b-a800m": ("lm", "repro_torch.configs.granite_moe_3b_a800m"),
    "mistral-nemo-12b":     ("lm", "repro_torch.configs.mistral_nemo_12b"),
    "phi3-mini-3.8b":       ("lm", "repro_torch.configs.phi3_mini_3_8b"),
    "smollm-360m":          ("lm", "repro_torch.configs.smollm_360m"),
    # GNN family (4)
    "gat-cora":             ("gnn", "repro_torch.configs.gat_cora"),
    "gin-tu":               ("gnn", "repro_torch.configs.gin_tu"),
    "graphcast":            ("gnn", "repro_torch.configs.graphcast"),
    "gatedgcn":             ("gnn", "repro_torch.configs.gatedgcn"),
    # RecSys (1)
    "dcn-v2":               ("recsys", "repro_torch.configs.dcn_v2"),
    # the paper's own workload
    "d4m-stream":           ("d4m", "repro_torch.configs.d4m_stream"),
}


def _entry(arch: str):
    try:
        return ARCHS[arch]
    except KeyError:
        raise ValueError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}")


def family(arch: str) -> str:
    return _entry(arch)[0]


def get_config(arch: str):
    return importlib.import_module(_entry(arch)[1]).config()


def get_smoke_config(arch: str):
    return importlib.import_module(_entry(arch)[1]).smoke_config()


def list_archs(fam: str | None = None) -> List[str]:
    return [a for a, (f, _) in ARCHS.items() if fam is None or f == fam]
