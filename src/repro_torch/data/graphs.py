"""Graph builders for the GNN architectures — the port of
``repro/data/graphs.py``'s ``random_graph``, ``batched_molecules`` and
``icosahedral_multimesh``.

Message passing uses edge lists + segment reductions.  The random builders
draw on the device from a ``torch.Generator`` seeded with ``seed`` (the
bits differ from JAX's; the formulas are the same); the multimesh is
built with numpy on the host and equals the reference's arrays.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import generator, resolve_device
from repro_torch.data.powerlaw import rmat_edges


def random_graph(seed: int, n_nodes: int, n_edges: int, d_feat: int,
                 n_classes: int = 16, symmetric: bool = True, *,
                 device=None):
    """Power-law (R-MAT) graph with node features and labels, on
    ``device`` (default: the CUDA device)."""
    dev = resolve_device(device)
    gen = generator(seed, dev)
    scale = max(1, (int(n_nodes) - 1).bit_length())
    src, dst = rmat_edges(gen, n_edges, scale)
    src, dst = src % n_nodes, dst % n_nodes
    if symmetric:  # undirected message passing: half fwd, half reversed
        half = n_edges // 2
        src, dst = (torch.cat([src[:half], dst[half:]]),
                    torch.cat([dst[:half], src[half:]]))
    feat = torch.randn((n_nodes, d_feat), generator=gen, device=dev)
    labels = torch.randint(0, n_classes, (n_nodes,), generator=gen,
                           device=dev)
    return dict(node_feat=feat, edge_src=src.to(torch.int32),
                edge_dst=dst.to(torch.int32), labels=labels.to(torch.int32))


def batched_molecules(seed: int, n_graphs: int, n_nodes: int, n_edges: int,
                      d_feat: int, n_classes: int = 2, *, device=None):
    """Batch of small graphs packed into one edge list with id offsets."""
    dev = resolve_device(device)
    gen = generator(seed, dev)
    feat = torch.randn((n_graphs * n_nodes, d_feat), generator=gen,
                       device=dev)
    src = torch.randint(0, n_nodes, (n_graphs, n_edges), generator=gen,
                        device=dev)
    dst = torch.randint(0, n_nodes, (n_graphs, n_edges), generator=gen,
                        device=dev)
    offset = (torch.arange(n_graphs, device=dev) * n_nodes)[:, None]
    graph_ids = torch.repeat_interleave(
        torch.arange(n_graphs, dtype=torch.int32, device=dev), n_nodes)
    labels = torch.randint(0, n_classes, (n_graphs,), generator=gen,
                           device=dev)
    return dict(node_feat=feat,
                edge_src=(src + offset).reshape(-1).to(torch.int32),
                edge_dst=(dst + offset).reshape(-1).to(torch.int32),
                graph_ids=graph_ids, labels=labels.to(torch.int32))


def icosahedral_multimesh(refinement: int):
    """GraphCast multi-mesh: icosahedron refined ``refinement`` times, with
    the union of ALL refinement levels' edges (bidirectional).

    Returns (vertices [N, 3] float32 on the unit sphere, edge_src,
    edge_dst) as numpy arrays, N = 10 * 4^r + 2 (40,962 at r=6).  The same
    arrays as the reference, which grows the vertex array by one
    ``np.vstack`` per midpoint (quadratic); here it is allocated once.
    """
    phi = (1 + 5 ** 0.5) / 2
    n_final = 10 * 4 ** refinement + 2
    verts = np.empty((n_final, 3), np.float64)
    verts[:12] = np.array(
        [(-1, phi, 0), (1, phi, 0), (-1, -phi, 0), (1, -phi, 0),
         (0, -1, phi), (0, 1, phi), (0, -1, -phi), (0, 1, -phi),
         (phi, 0, -1), (phi, 0, 1), (-phi, 0, -1), (-phi, 0, 1)],
        np.float64)
    verts[:12] /= np.linalg.norm(verts[:12], axis=1, keepdims=True)
    n_verts = 12
    faces = np.array(
        [(0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
         (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
         (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
         (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1)],
        np.int64)

    all_edges = set()

    def add_face_edges(fs):
        for a, b, c in fs:
            for u, v in ((a, b), (b, c), (c, a)):
                all_edges.add((min(u, v), max(u, v)))

    add_face_edges(faces)
    for _ in range(refinement):
        mid_cache = {}
        new_faces = []

        def midpoint(u, v):
            nonlocal n_verts
            k = (min(u, v), max(u, v))
            if k not in mid_cache:
                m = verts[u] + verts[v]
                m /= np.linalg.norm(m)
                mid_cache[k] = n_verts
                verts[n_verts] = m
                n_verts += 1
            return mid_cache[k]

        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [(a, ab, ca), (b, bc, ab), (c, ca, bc),
                          (ab, bc, ca)]
        faces = np.array(new_faces, np.int64)
        add_face_edges(faces)           # multi-mesh: keep every level

    assert n_verts == n_final, (n_verts, n_final)
    e = np.array(sorted(all_edges), np.int32)
    src = np.concatenate([e[:, 0], e[:, 1]])
    dst = np.concatenate([e[:, 1], e[:, 0]])
    return verts.astype(np.float32), src, dst
