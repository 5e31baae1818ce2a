"""Embedding-bag kernel — ``out[b] = sum_l w[b,l] * table[idx[b,l]]`` on Hopper.

``embedding_bag_cuda`` launches the hand-written CUDA C++ kernel of
``csrc/embedding_bag.cu`` (``sm_90a``), which replaces the Pallas kernel
``repro/kernels/embedding_bag/embedding_bag.py::embedding_bag_pallas``.
One thread per (bag, 16-byte piece of the row): each walks l = 0 .. L-1 and
accumulates ``w * row`` from 0.0f with separately rounded multiply and add,
in the TPU kernel's order.

``embedding_bag_plain`` is its plain PyTorch version: a loop over l of
``index_select`` and a multiply-add into zeros, the same order and the same
roundings, so kernel and plain version agree bit for bit.  A wrapper runs
the plain version for tensors on the CPU and launches the kernel for
tensors on the card; it never falls back from one to the other.  Each
launch adds one to ``registry.LAUNCHES["embedding_bag.embedding_bag"]``.

Indices arrive clamped to [0, V) (``ops.embedding_bag``); neither version
clamps again or skips a zero weight, so ``0 * inf`` stays NaN.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, registry

SOURCE = "embedding_bag/csrc/embedding_bag.cu"
COUNTER = "embedding_bag.embedding_bag"


def embedding_bag_plain(table, indices, weights):
    """Plain version: table [V, D]; indices int32 / weights f32 [B, L]
    -> [B, D] f32, accumulated from zero in order l = 0 .. L-1."""
    n_bags, bag = indices.shape
    out = torch.zeros((n_bags, table.shape[1]), dtype=torch.float32,
                      device=table.device)
    for l in range(bag):
        rows = table.index_select(0, indices[:, l]).float()
        out += weights[:, l:l + 1].float() * rows
    return out


_BOUND = {}


def _lib():
    if "lib" not in _BOUND:
        lib = build.load(SOURCE)
        lib.eb_embedding_bag.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p]
        lib.eb_embedding_bag.restype = ctypes.c_int
        lib.eb_error_string.argtypes = [ctypes.c_int]
        lib.eb_error_string.restype = ctypes.c_char_p
        lib.eb_launch_config.argtypes = [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int), ctypes.c_int]
        lib.eb_launch_config.restype = ctypes.c_int
        _BOUND["lib"] = lib
    return _BOUND["lib"]


def _check(table, indices, weights):
    dev = table.device
    ok = (table.dtype == torch.float32 and table.dim() == 2
          and indices.dtype == torch.int32 and indices.dim() == 2
          and weights.dtype == torch.float32
          and weights.shape == indices.shape
          and indices.device == dev and weights.device == dev
          and all(x.is_contiguous() for x in (table, indices, weights)))
    if not ok:
        raise ValueError(
            "embedding_bag_cuda: needs a contiguous float32 table [V, D], "
            "int32 indices [B, L] and float32 weights [B, L] on one device; "
            f"got {table.dtype}{tuple(table.shape)}, "
            f"{indices.dtype}{tuple(indices.shape)}, "
            f"{weights.dtype}{tuple(weights.shape)}")


def vector_path(table) -> int:
    """1 when the kernel reads rows as float4: D % 4 == 0 and the table
    16-byte aligned (so is every row start)."""
    return int(table.shape[1] % 4 == 0 and table.data_ptr() % 16 == 0)


def embedding_bag_launch_config(table, indices, weights) -> list:
    """``embedding_bag_cuda``'s launch for these operands, as the C side
    decides it (``eb_launch_config``)."""
    _check(table, indices, weights)
    lib = _lib()
    rows = (ctypes.c_int * (4 * build.MAX_LAUNCHES))()
    n = lib.eb_launch_config(indices.shape[0], indices.shape[1],
                             table.shape[1], vector_path(table), rows,
                             build.MAX_LAUNCHES)
    return build.launch_rows("eb", n, rows)


def embedding_bag_cuda(table, indices, weights):
    """table [V, D] f32; indices [B, L] int32 in [0, V); weights [B, L] f32
    -> [B, D] f32.  CPU tensors run ``embedding_bag_plain``; CUDA tensors
    launch the kernel."""
    dev = table.device.type
    if dev == "cpu":
        return embedding_bag_plain(table, indices, weights)
    if dev != "cuda":
        raise ValueError(f"embedding_bag: unsupported device {dev}")
    _check(table, indices, weights)
    n_bags, bag = indices.shape
    d = table.shape[1]
    out = torch.empty((n_bags, d), dtype=torch.float32, device=table.device)
    if n_bags == 0 or d == 0:
        return out
    # one float4 per thread when every row starts on a 16-byte boundary
    vec = vector_path(table)
    lib = _lib()
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        err = lib.eb_embedding_bag(table.data_ptr(), indices.data_ptr(),
                                   weights.data_ptr(), out.data_ptr(),
                                   n_bags, bag, d, vec, stream)
    if err != 0:
        raise RuntimeError(f"embedding_bag_cuda: CUDA launch failed with "
                           f"error {err} ({lib.eb_error_string(err).decode()})")
    # a row and its index and weight per (bag, item), a row out per bag
    registry.count(COUNTER, n_bags * bag * (4 * d + 8) + 4 * n_bags * d)
    return out
