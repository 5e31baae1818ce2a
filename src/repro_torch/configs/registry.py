"""Arch registry: arch id -> config module, for the families the port runs.

Every ported architecture is a module exposing ``config()`` (the full-size
config) and ``smoke_config()`` (a reduced same-family config for CPU
tests).  The reference's other archs are known by name and refused with a
``ValueError`` saying they are not ported yet.
"""
from __future__ import annotations

import importlib
from typing import List

ARCHS = {
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

# archs of the reference whose family the port does not run yet
NOT_PORTED = {
    "deepseek-v2-236b": "lm",
    "granite-moe-3b-a800m": "lm",
    "mistral-nemo-12b": "lm",
    "phi3-mini-3.8b": "lm",
    "smollm-360m": "lm",
}


def _entry(arch: str):
    if arch in NOT_PORTED:
        raise ValueError(f"arch {arch!r} ({NOT_PORTED[arch]} family) is not "
                         f"ported yet; ported: {sorted(ARCHS)}")
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
