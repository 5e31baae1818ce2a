"""Sharding policy: parameter specs and activation constraints over a
``DeviceMesh`` — the port of ``repro/distribution/sharding.py``.

  mesh axes            (pod, data, model)  |  (data, model)
  batch / tokens       sharded over (pod, data)      — DP across pods
  params + opt states  sharded over  data            — FSDP within a pod
  heads / ffn / vocab  sharded over  model           — TP
  MoE experts          sharded over  model           — EP (or expert-TP when
                                                       n_experts % tp != 0)

A spec (``Spec``) is the counterpart of a ``PartitionSpec``: one entry per
tensor dim, each a mesh-axis name, a tuple of names or ``None``
(replicated).  ``to_placements`` turns it into DTensor placements, one per
mesh dim: ``Shard(d)`` where dim d names that mesh axis, ``Replicate()``
elsewhere.  A dim over two axes (``("pod", "data")``) is ``Shard(d)`` on
both, which splits it pod-major as the ``PartitionSpec`` does; the names
must come in the mesh's order.  ``sharding`` and ``to_shardings`` give
``Sharding(mesh, placements)`` pairs, and ``place`` puts a tensor under
one.

Models call ``constrain(x, *logical)`` with *logical* axis names; the
active policy (a contextvar set by the caller, ``use_policy``) maps them
to mesh axes and redistributes the DTensor ``x`` to them.  With no active
policy it returns ``x`` itself, so model code runs unmodified on one
device.  Under a policy ``x`` must be a DTensor: a plain tensor there
raises ``TypeError`` rather than stay unsharded.

Logical axis vocabulary:
  "batch"   -> (pod, data)     "fsdp"  -> data
  "tp"      -> model           "ep"    -> model (expert dim)
  "all"     -> every mesh axis None    -> replicated

Executing the LM step on DTensors.  GSPMD propagates a sharding through
every op; DTensor does so through the ops it has a rule for, and raises
for the others.  Before each op of the port's models with no rule (or a
rule that does not take the placements the step gives it) the model calls
``replicate(x)``, which redistributes a DTensor to ``Replicate()`` on
every mesh dim (the identity without a policy), or builds its plain
operand with ``like(t, x)`` as a replicated DTensor on ``x``'s mesh
(DTensor refuses an op that mixes it with a plain tensor):

  * ``transformer._embed``: ``index_select`` of the vocab- and
    FSDP-sharded table (``replicate``: no rule for a sharded source), and
    the token ids;
  * ``common.cross_entropy``: the logits before the ``gather`` of the
    gold logit (no rule for an index along a sharded dim), and the
    labels (``replicate``);
  * ``moe.route``: the router's logits gathered whole (``replicate``),
    so every rank routes all tokens; the slot assignment (the one-hot
    count and the ``scatter_`` of token ids have no rule) runs on each
    rank's local copy of the expert ids (``to_local``) and comes back as
    replicated DTensors (``like``); the tokens and the expert outputs
    gathered before the dispatch's and the combine's ``index_select``;
    the aux loss's routed counts (``index_add_``: no rule in torch 2.11)
    counted on the local expert ids; the gates gathered from the
    probabilities at the ranking's indices (the sort's backward mixes a
    plain zeros tensor into DTensors in torch 2.11);
  * ``attention._heads_whole`` / ``_batch_only``: the q / k / v
    projections' outputs (GQA and MLA) constrained to the batch sharding
    alone, their heads gathered over the model axis, and every reshape
    of the attention put between two such constraints (its two einsums
    are one grouped ``bmm`` each): DTensor refuses to split a sharded dim
    into heads the axis does not divide (smollm's) or to merge batch and
    heads when both are sharded, and it picks such placements for
    gradients on the card (the constraint's backward puts the gradient
    back);
  * ``grad_as_forward``: the per-layer views of the stacked parameters
    (``transformer._layers``), whose gradients are reduced to each
    view's own placements before the unbind's backward stacks them, and
    the output head (``transformer._logits``), whose gradient a tied
    table adds to the embedding's (torch 2.11 cannot add a (Partial,
    Shard(0)) gradient to a (Shard(1), Replicate()) one);
  * ``replicate_grad``: the MoE dispatch's and combine's
    ``index_select`` outputs, whose gradient DTensor may shard over the
    selected rows while the index is whole (torch 2.11 then fails the
    backward's ``index_add_``);
  * ``like``: the positions (``transformer.forward``), ``apply_rope``'s
    frequencies, ``chunked_attention``'s running max, denominator,
    accumulator and causal mask, the dense layers' zero aux loss,
    DCN-v2's field sizes and offsets (``dcn.global_ids``) and ``bce``'s
    zero, and the GNN regression's zero accuracy — tensors built by
    ``arange`` / ``full`` / ``zeros`` / ``tensor`` that meet a DTensor;
  * ``gather_rows``: the GNN layers' ``h[src]`` / ``h[dst]`` and the edge
    softmax's reads of per-node maxima and sums — node-sharded features
    read by edge-sharded ids (the features gathered whole once a layer,
    the rows read locally, the backward a reduce-scatter of a partial
    sum);
  * ``scatter_rows``: ``gnn._scatter_sum`` (the ``index_add_`` and the
    ``segment_agg`` kernel route), ``segment_max`` and ``graph_readout``
    — each rank reduces its own edges (or nodes) into a whole-size
    buffer, and the partial results are reduce-scattered to the nodes'
    (or graphs') sharding: ``[N, D]`` moves, never the ``[E, D]``
    messages;
  * ``lookup_rows``: ``dcn.embed_lookup``, vocab-parallel — the ids
    gathered whole, each rank's rows of its own block of the table
    (sharded over every mesh axis) looked up by the gather or by the
    ``embedding_bag`` kernel on the local block (ids relative to the
    block's start, clamped into it, weight 0 outside it), the partial
    rows reduce-scattered to the batch; the table's gradient is added
    into its block.  The table is never gathered;
  * ``full_rows``: the GNN edge state built beside the edge ids
    (GatedGCN's zeros, GraphCast's ones), sharded as the edges;
  * ``under_current_policy``: a remat layer (``transformer.forward``,
    ``gnn._layer``) re-enters the caller's policy when the backward
    recomputes it;
  * ``optim.adamw``: the update is elementwise, so it runs on each rank's
    local shard (``to_local``) of parameter, gradient and moments, the
    gradient first redistributed to its parameter's placements; the
    global norm is the one collective (``full_tensor``).

The five LM archs' steps, the four GNN kinds' train steps and DCN-v2's
dense train step, ``serve_scores`` and ``retrieval_topk`` execute under
a policy.  DCN-v2's hier step (``make_train_step_hier``) is not run
sharded: the reference's cell for it cannot be built (its ``"hier"``
variant is refused by ``apply_variant``).

DTensor returns its operand unchanged for ``<<``, ``>>`` and ``&`` with
an int (torch 2.13): code that may meet a DTensor multiplies instead
(``checkpoint/ckpt.py``'s counter words).
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
from typing import Any, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch import resolve_device

_POLICY: contextvars.ContextVar = contextvars.ContextVar(
    "sharding_policy", default=None)


class Spec(tuple):
    """Per-dim mesh axes of a tensor: ``Spec("model", None)``,
    ``Spec(("pod", "data"), None)``; the ``PartitionSpec`` of the port,
    which like it names a one-axis tuple by the axis alone."""

    def __new__(cls, *entries):
        return super().__new__(cls, (
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self):
        return f"Spec{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A mesh and one DTensor placement per mesh dim: the port's
    ``NamedSharding`` (a leaf of a tree, not a sequence)."""
    mesh: Any
    placements: Tuple


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def _mesh_shape(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def to_placements(spec, mesh) -> tuple:
    """DTensor placements for ``spec`` on ``mesh``: one per mesh dim."""
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        axes = _axes(entry)
        at = [names.index(a) for a in axes]
        if at != sorted(at):
            raise ValueError(f"spec {spec}: axes {axes} are not in the "
                             f"mesh's order {names}")
        for i in at:
            if out[i] != Replicate():
                raise ValueError(f"spec {spec}: mesh axis {names[i]!r} "
                                 f"shards two dims")
            out[i] = Shard(d)
    return tuple(out)


def _split(size: int, parts: int, at: int) -> Tuple[int, int]:
    """Part ``at`` of ``size`` cut in ``parts`` as ``torch.chunk`` cuts
    it (DTensor's rule): [start, stop)."""
    chunk = -(-size // parts)
    start = min(at * chunk, size)
    return start, min(start + chunk, size)


def local_shape(shape, spec, mesh_shape: dict, coordinate=None) -> tuple:
    """The spec's arithmetic: the shape of one rank's shard of a
    ``shape`` tensor under ``spec``, each dim cut over its axes in turn
    (``mesh_shape``: axis name -> size; ``coordinate``: axis name -> the
    rank's position, default 0 on every axis, the largest shard)."""
    coordinate = coordinate or {}
    out = list(shape)
    for d, entry in enumerate(spec):
        for a in _axes(entry):
            start, stop = _split(out[d], mesh_shape[a], coordinate.get(a, 0))
            out[d] = stop - start
    return tuple(out)


def local_slices(shape, sharding: Sharding) -> tuple:
    """This rank's block of a ``shape`` tensor under ``sharding``: one
    slice per dim."""
    coord = sharding.mesh.get_coordinate()
    bounds = [(0, n) for n in shape]
    for i, pl in enumerate(sharding.placements):
        if isinstance(pl, Shard):
            lo, hi = bounds[pl.dim]
            start, stop = _split(hi - lo, sharding.mesh.size(i), coord[i])
            bounds[pl.dim] = (lo + start, lo + stop)
    return tuple(slice(a, b) for a, b in bounds)


def mesh_device(mesh) -> torch.device:
    """The device this rank's shards live on: the current CUDA device for
    a CUDA mesh (ranks sharing a card all name it; raises without a
    card), else the mesh's device type."""
    dev = resolve_device(mesh.device_type)
    if dev.type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def from_shard(local: torch.Tensor, sharding: Sharding, shape):
    """This rank's shard ``local`` of a ``shape`` tensor as a DTensor
    under ``sharding``; no collective is made."""
    shape = torch.Size(shape)
    stride = [1] * len(shape)
    for d in range(len(shape) - 2, -1, -1):
        stride[d] = stride[d + 1] * shape[d + 1]
    return DTensor.from_local(local, sharding.mesh, sharding.placements,
                              run_check=False, shape=shape,
                              stride=tuple(stride))


@dataclasses.dataclass(frozen=True)
class ShardingPolicy:
    mesh: Any                            # torch DeviceMesh
    batch_axes: Tuple[str, ...]          # ("pod","data") or ("data",)
    fsdp_axis: Optional[str] = "data"
    tp_axis: Optional[str] = "model"

    def resolve(self, logical: Optional[str]):
        if logical is None:
            return None
        if logical == "batch":
            return self.batch_axes
        if logical == "fsdp":
            return self.fsdp_axis
        if logical in ("tp", "ep"):
            return self.tp_axis
        if logical == "all":                 # every mesh axis (flat shard)
            return tuple(self.mesh.mesh_dim_names)
        raise ValueError(f"unknown logical axis {logical!r}")

    def spec(self, *logical) -> Spec:
        return Spec(*(self.resolve(l) for l in logical))

    def sharding(self, *logical) -> Sharding:
        return to_shardings(self.spec(*logical), self.mesh)

    def axis_size(self, logical: str) -> int:
        sizes = _mesh_shape(self.mesh)
        return math.prod(sizes[a] for a in _axes(self.resolve(logical)))


def current_policy() -> Optional[ShardingPolicy]:
    return _POLICY.get()


@contextlib.contextmanager
def use_policy(policy: Optional[ShardingPolicy]):
    token = _POLICY.set(policy)
    try:
        yield policy
    finally:
        _POLICY.reset(token)


def constrain(x, *logical, divisible_dims: bool = True):
    """Redistribute the DTensor ``x`` to ``logical``'s placements under
    the active policy; ``x`` itself without one.

    A logical axis that does not evenly divide its dim is dropped (the
    dim is replicated), as the reference drops it.  Under a policy a
    plain tensor raises ``TypeError``: it would stay unsharded where the
    reference shards it.  The redistribution is recorded even when the
    placements already match, so that the gradient is put back under the
    same placements in the backward, as ``with_sharding_constraint``
    constrains the cotangent (DTensor chooses a gradient's placements
    freely, and a view's backward may refuse them).
    """
    pol = current_policy()
    if pol is None:
        return x
    if not isinstance(x, DTensor):
        raise TypeError("constrain under a sharding policy takes a DTensor, "
                        f"got a plain {type(x).__name__} of shape "
                        f"{tuple(x.shape)}")
    return x.redistribute(pol.mesh, _constrained(pol, x.shape, logical,
                                                 divisible_dims))


def _constrained(pol: ShardingPolicy, shape, logical,
                 divisible_dims: bool = True) -> tuple:
    """The placements ``constrain`` gives a ``shape`` tensor."""
    sizes = _mesh_shape(pol.mesh)
    specs = []
    for dim, logical_ax in zip(shape, logical):
        ax = pol.resolve(logical_ax)
        if ax is not None and divisible_dims and \
                dim % math.prod(sizes[a] for a in _axes(ax)) != 0:
            ax = None
        specs.append(ax)
    return to_placements(Spec(*specs), pol.mesh)


def replicate(x):
    """``x`` redistributed to ``Replicate()`` on every mesh dim when it is
    a DTensor under a policy (before an op DTensor has no rule for);
    ``x`` itself otherwise."""
    if current_policy() is None or not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh,
                          (Replicate(),) * x.device_mesh.ndim)


class _GradTo(torch.autograd.Function):
    """The identity, whose backward redistributes the gradient to the
    given placements."""

    @staticmethod
    def forward(ctx, x, placements):
        ctx.placements = tuple(placements)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if isinstance(g, DTensor) and tuple(g.placements) != ctx.placements:
            g = g.redistribute(g.device_mesh, ctx.placements)
        return g, None


def replicate_grad(x):
    """``x`` itself in the forward; under a policy its gradient is made
    whole (``Replicate()``) in the backward, before the op that made
    ``x`` takes it.  An ``index_select`` of a whole source by a whole index
    needs this: DTensor may hand its backward a gradient sharded over the
    selected rows, which the whole index does not fit (torch 2.11's
    ``index_add_`` size error)."""
    if current_policy() is None or not isinstance(x, DTensor):
        return x
    return _GradTo.apply(x, (Replicate(),) * x.device_mesh.ndim)


def grad_as_forward(x):
    """``x`` itself in the forward; under a policy its gradient is put
    under ``x``'s own placements in the backward.  The layer views of a
    stacked ``[L, ...]`` parameter take it, so that each layer's gradient
    is reduced to its parameter's sharding before the views' gradients
    are stacked: DTensor otherwise picks the stacked gradient's
    intermediate placements by whether the mesh axis divides L (a
    collective that grows by L's parity, not by L)."""
    if current_policy() is None or not isinstance(x, DTensor):
        return x
    return _GradTo.apply(x, x.placements)


def index_copy_(x, dim: int, at: torch.Tensor, src):
    """``x.index_copy_(dim, at, src)`` for one position ``at`` (a 1-element
    index).  For a DTensor ``x`` each rank writes the position into its own
    block of ``x``, in place: DTensor's rule for ``index_copy_`` would
    replicate a sharded ``dim`` and leave the local shard as it was (a
    DTensor whose placements no longer describe its shard)."""
    if not isinstance(x, DTensor):
        return x.index_copy_(dim, at, src)
    mesh = x.device_mesh
    keep = tuple(Replicate() if isinstance(p, Shard) and p.dim == dim else p
                 for p in x.placements)
    src = like(src, x).redistribute(mesh, keep).to_local()
    block = local_slices(x.shape, Sharding(mesh, tuple(x.placements)))[dim]
    n = block.stop - block.start
    local = x.to_local()
    rel = to_local(at) - block.start
    inside = (rel >= 0) & (rel < n)
    rel = torch.clamp(rel, 0, max(n - 1, 0))
    local.index_copy_(dim, rel, torch.where(inside, src,
                                            local.index_select(dim, rel)))
    return x


def to_local(x):
    """This rank's local tensor of a DTensor; ``x`` itself otherwise."""
    return x.to_local() if isinstance(x, DTensor) else x


def like(t: torch.Tensor, ref):
    """A plain tensor ``t`` that meets the DTensor ``ref`` in an op, as a
    DTensor replicated over ``ref``'s mesh (every rank holds all of
    ``t``); ``t`` itself when ``ref`` is a plain tensor.  ``t`` needs no
    gradient: a ``from_local`` in the backward graph let the ranks run
    their collectives in different orders (a deadlock, seen when the MoE
    routing's probabilities came through it)."""
    if not isinstance(ref, DTensor) or isinstance(t, DTensor):
        return t
    return DTensor.from_local(t, ref.device_mesh,
                              (Replicate(),) * ref.device_mesh.ndim,
                              run_check=False)


def under_current_policy(fn):
    """``fn`` run under the policy active now, wherever it is called
    later: ``torch.utils.checkpoint`` recomputes a layer inside the
    backward, which for CUDA tensors runs on autograd's device thread,
    where the caller's contextvar is not set (the recompute would then
    constrain nothing and differ from the forward)."""
    pol = current_policy()

    def run(*args, **kwargs):
        with use_policy(pol):
            return fn(*args, **kwargs)
    return run


# ------------------------------------------ row gathers, scatters, lookups ---

def _whole(mesh) -> tuple:
    return (Replicate(),) * mesh.ndim


def _partial_over(placements, reduce_op: str = "sum") -> tuple:
    """A partial result's placements: ``Partial`` on every mesh dim where
    ``placements`` shard the rows it was made from (each rank holds a part),
    ``Replicate()`` where they do not (the ranks hold the same part)."""
    return tuple(Partial(reduce_op) if isinstance(p, Shard) else Replicate()
                 for p in placements)


def _row_placements(ids) -> tuple:
    placements = tuple(ids.placements)
    if any(not isinstance(p, (Shard, Replicate)) or
           (isinstance(p, Shard) and p.dim != 0) for p in placements):
        raise ValueError(f"rows must be sharded on dim 0 or replicated, "
                         f"not {placements}")
    return placements


class _GatherRows(torch.autograd.Function):
    """``table[ids]`` for each of ``ids``: one all-gather of the table, the
    rows of each rank's block of the ids looked up locally, each result
    sharded as its ids.  The backward adds the rows' gradients into a
    whole-size buffer on each rank (a partial sum) and reduce-scatters it
    to the table's placements."""

    @staticmethod
    def forward(ctx, table, placements, *ids):
        mesh = table.device_mesh
        whole = table.redistribute(mesh, _whole(mesh)).to_local()
        local = [i.to_local().long() for i in ids]
        ctx.save_for_backward(*local)
        ctx.mesh, ctx.shape = mesh, table.shape
        ctx.placements, ctx.ids_placements = tuple(table.placements), \
            placements
        tail = tuple(table.shape[1:])
        return tuple(from_shard(whole[l], Sharding(mesh, placements),
                                (i.shape[0],) + tail)
                     for l, i in zip(local, ids))

    @staticmethod
    def backward(ctx, *grads):
        mesh, part = ctx.mesh, None
        for g, l in zip(grads, ctx.saved_tensors):
            if g is None:
                continue
            if tuple(g.placements) != ctx.ids_placements:
                g = g.redistribute(mesh, ctx.ids_placements)
            g = g.to_local()
            if part is None:
                part = g.new_zeros(ctx.shape)
            part.index_add_(0, l, g)
        if part is None:
            return (None,) * (2 + len(grads))
        grad = from_shard(part, Sharding(mesh, _partial_over(
            ctx.ids_placements)), ctx.shape)
        return (grad.redistribute(mesh, ctx.placements), None) \
            + (None,) * len(grads)


def gather_rows(table, *ids):
    """``tuple(table[i] for i in ids)``.  Under a policy, for a DTensor
    ``table`` (node features sharded over the nodes) and row ids sharded
    over their dim 0 (edge ids sharded over the edges, all alike): the
    table is gathered whole once for all the ids, and each result is
    sharded as its ids (``_GatherRows``; DTensor has no rule for an index
    of a sharded source by a sharded index)."""
    if current_policy() is None or not isinstance(table, DTensor):
        return tuple(table[i.long()] for i in ids)
    ids = [like(i, table) for i in ids]
    placements = _row_placements(ids[0])
    if any(tuple(i.placements) != placements for i in ids):
        raise ValueError("gather_rows: the ids are sharded unlike each other")
    return _GatherRows.apply(table, placements, *ids)


class _ScatterRows(torch.autograd.Function):
    """``local_fn`` of each rank's block of ``x`` and ``ids`` into a
    whole-size ``[n, ...]`` buffer (a partial result), reduced to
    ``out_placements`` (a reduce-scatter).  The backward of the sum gathers
    the result's gradient whole and reads each rank's rows of it (ids
    outside ``[0, n)`` get 0)."""

    @staticmethod
    def forward(ctx, x, ids, n, local_fn, reduce_op, out_placements):
        mesh = x.device_mesh
        local = ids.to_local()
        part = local_fn(x.to_local(), local, n)
        ctx.save_for_backward(local)
        ctx.mesh, ctx.n, ctx.shape = mesh, n, x.shape
        ctx.placements = tuple(x.placements)
        out = from_shard(part, Sharding(mesh, _partial_over(
            x.placements, reduce_op)), (n,) + tuple(x.shape[1:]))
        return out.redistribute(mesh, out_placements)

    @staticmethod
    def backward(ctx, g):
        (local,) = ctx.saved_tensors
        whole = g.redistribute(ctx.mesh, _whole(ctx.mesh)).to_local()
        whole = torch.cat([whole, whole.new_zeros((1,) + whole.shape[1:])])
        local = local.long()
        valid = (local >= 0) & (local < ctx.n)
        gx = whole[torch.where(valid, local, ctx.n)]
        return (from_shard(gx, Sharding(ctx.mesh, ctx.placements),
                           ctx.shape), None, None, None, None, None)


def scatter_rows(x, ids, n: int, local_fn, reduce_op: str = "sum"):
    """``local_fn(x, ids, n)``: rows of ``x`` reduced by ``ids`` into
    ``[n, ...]`` (a segment sum or max; ids outside ``[0, n)`` dropped).

    Under a policy, for DTensors (edge messages and ids sharded over the
    edges): each rank reduces its own edges into a whole-size buffer with
    ``local_fn`` on plain tensors (a kernel wrapper may be one), and the
    partial results are reduced to the ``"batch"`` sharding of the rows, as
    ``constrain(out, "batch", None, ...)`` places them — a reduce-scatter
    of ``[n, ...]``, not an all-gather of the ``[E, ...]`` messages
    (``_ScatterRows``).  ``reduce_op="max"`` takes no gradient: its one use,
    the shift of ``gnn.segment_softmax``, cancels in the softmax, so its
    gradient is zero in exact arithmetic."""
    pol = current_policy()
    if pol is None or not isinstance(x, DTensor):
        return local_fn(x, ids, n)
    ids = like(ids, x)
    placements = _row_placements(ids)
    if reduce_op != "sum":
        x = x.detach()
    if tuple(x.placements) != placements:
        x = x.redistribute(x.device_mesh, placements)
    shape = (n,) + tuple(x.shape[1:])
    out = _constrained(pol, shape, ("batch",) + (None,) * (len(shape) - 1))
    return _ScatterRows.apply(x, ids, n, local_fn, reduce_op, out)


class _BlockLookup(torch.autograd.Function):
    """The vocab-parallel lookup: the ids gathered whole, each rank's rows
    of its own block of the table looked up by ``local_fn(block, rel,
    weights)`` with the ids taken relative to the block's start, clamped
    into it, and weighted 0 outside it; the partial results reduced to
    ``out_placements``.  The backward gathers the result's gradient whole
    and adds each rank's rows into its block (``index_add_``): the table's
    gradient stays row-sharded."""

    @staticmethod
    def forward(ctx, table, ids, local_fn, out_placements):
        mesh = table.device_mesh
        whole = ids.redistribute(mesh, _whole(mesh)).to_local()
        block = local_slices(table.shape, Sharding(
            mesh, tuple(table.placements)))[0]
        n = block.stop - block.start
        rel = whole.long() - block.start
        weights = ((rel >= 0) & (rel < n)).to(torch.float32)
        rel = torch.clamp(rel, 0, max(n - 1, 0))
        part = local_fn(table.to_local(), rel, weights)
        ctx.save_for_backward(rel, weights)
        ctx.mesh, ctx.shape, ctx.n = mesh, table.shape, n
        ctx.placements = tuple(table.placements)
        out = from_shard(part, Sharding(mesh, _partial_over(
            table.placements)), tuple(part.shape))
        return out.redistribute(mesh, out_placements)

    @staticmethod
    def backward(ctx, g):
        rel, weights = ctx.saved_tensors
        whole = g.redistribute(ctx.mesh, _whole(ctx.mesh)).to_local()
        d = ctx.shape[-1]
        rows = whole.unsqueeze(-2) * weights.unsqueeze(-1).to(whole.dtype)
        grad = whole.new_zeros((ctx.n, d)).index_add_(
            0, rel.reshape(-1), rows.reshape(-1, d))
        return (from_shard(grad, Sharding(ctx.mesh, ctx.placements),
                           ctx.shape), None, None, None)


def lookup_rows(table, ids, local_fn, *logical):
    """``local_fn(table, ids, None)`` (no weights): the rows
    of ``table`` at ``ids`` ``[..., H]`` combined over the last dim into
    ``[..., D]``.

    Under a policy, for a DTensor ``table`` whose rows are sharded (over
    every mesh axis: ``recsys_param_specs``' table) and DTensor ``ids``,
    the table is never gathered: the ids are (``_BlockLookup``), each rank
    looks up the rows of its block, and the partial results are reduced
    to ``logical``'s placements (``constrain``'s rule).  ``local_fn`` takes
    plain tensors (a kernel wrapper may be one) and must give rows of
    weight 0 nothing."""
    pol = current_policy()
    if pol is None or not isinstance(table, DTensor):
        return local_fn(table, ids, None)
    _row_placements(table)
    ids = like(ids, table)
    shape = tuple(ids.shape[:-1]) + (table.shape[-1],)
    return _BlockLookup.apply(table, ids, local_fn,
                              _constrained(pol, shape, logical))


def full_rows(ref, tail, fill, dtype):
    """A ``(len(ref),) + tail`` tensor of ``fill`` on ``ref``'s device,
    its rows sharded as the 1-D ``ref``'s (edge state built beside the edge
    ids: no collective, no whole copy on a rank); a plain tensor when
    ``ref`` is one."""
    shape = (ref.shape[0],) + tuple(tail)
    if not isinstance(ref, DTensor):
        return torch.full(shape, fill, dtype=dtype, device=ref.device)
    local = ref.to_local()
    block = torch.full((local.shape[0],) + tuple(tail), fill, dtype=dtype,
                       device=local.device)
    return from_shard(block, Sharding(ref.device_mesh,
                                      _row_placements(ref)), shape)


def make_policy(mesh, layout: str = "2d") -> ShardingPolicy:
    """Policy for a production mesh (``launch/mesh.py`` shapes).

    layout "2d": batch over (pod, data); FSDP on data; TP on model.
    layout "dp": batch over EVERY axis (model folds into data parallelism);
                 FSDP on data; no TP.  The right call for models whose head
                 counts don't divide the model axis (e.g. smollm's 15 heads)
                 — replicated-TP compute is worse than pure DP.
    """
    names = tuple(mesh.mesh_dim_names)
    pod = ("pod",) if "pod" in names else ()
    if layout == "dp":
        return ShardingPolicy(mesh, batch_axes=pod + ("data", "model"),
                              fsdp_axis="data", tp_axis=None)
    if layout != "2d":
        raise ValueError(f"unknown layout {layout!r}")
    return ShardingPolicy(mesh, batch_axes=pod + ("data",),
                          fsdp_axis="data", tp_axis="model")


# ------------------------------------------------------- param spec rules ---

def _divides(n: int, k: int) -> bool:
    return k > 0 and n % k == 0


def lm_param_specs(params, cfg, policy: ShardingPolicy):
    """Specs for transformer LM params (FSDP x TP), as nested dicts of
    ``params``' nesting.

    Rules keyed on path leaf names; every matmul weight is sharded on one
    dim by ``fsdp`` and (where divisible) the other by ``tp``.
    """
    tp = policy.axis_size("tp")
    fs = policy.axis_size("fsdp")
    TPA = policy.tp_axis                   # None under the "dp" layout
    FSA = policy.fsdp_axis

    def spec_for(path: str, leaf) -> Spec:
        shape = leaf.shape
        ndim = len(shape)
        name = path.split("/")[-1]

        def ok(dim_i, k):
            return _divides(shape[dim_i], k)

        # stacked layer params carry a leading L dim -> shift rules right
        off = 1 if path.startswith("layers/") and ndim >= 2 else 0

        if name in ("embed", "lm_head"):
            # [V, D]: vocab over tp (sharded logits), D over fsdp
            return Spec(TPA if ok(0, tp) else None,
                        FSA if ok(1, fs) else None)
        if ndim - off == 1:                         # norms / biases
            return Spec(*([None] * ndim))
        if name in ("w_gate", "w_up", "wq", "wk", "wv", "wq_a", "wq_b",
                    "wkv_a", "wkv_b", "router", "shared_gate", "shared_up"):
            if ndim - off == 3:                     # MoE experts [E, D, F]
                if cfg.moe_shard == "ep" and ok(off, tp):
                    return Spec(*([None] * off), TPA,
                                FSA if ok(off + 1, fs) else None, None)
                return Spec(*([None] * off), None,  # expert-TP: shard D, F
                            FSA if ok(off + 1, fs) else None,
                            TPA if ok(off + 2, tp) else None)
            return Spec(*([None] * off),
                        FSA if ok(off, fs) else None,
                        TPA if ok(off + 1, tp) else None)
        if name in ("w_down", "wo", "shared_down"):
            if ndim - off == 3:                     # [E, F, D]
                if cfg.moe_shard == "ep" and ok(off, tp):
                    return Spec(*([None] * off), TPA, None,
                                FSA if ok(off + 2, fs) else None)
                return Spec(*([None] * off), None,  # expert-TP: shard F, D
                            TPA if ok(off + 1, tp) else None,
                            FSA if ok(off + 2, fs) else None)
            return Spec(*([None] * off),
                        TPA if ok(off, tp) else None,
                        FSA if ok(off + 1, fs) else None)
        # fallback: fsdp on the largest divisible dim
        for i in range(ndim - 1, -1, -1):
            if ok(i, fs):
                return Spec(*([None] * i), FSA, *([None] * (ndim - i - 1)))
        return Spec(*([None] * ndim))

    return tree_map_with_path(spec_for, params)


def gnn_param_specs(params, cfg, policy: ShardingPolicy):
    """GNN params are small: replicate 1-D, fsdp-shard big matrices."""
    fs = policy.axis_size("fsdp")
    FSA = policy.fsdp_axis

    def spec_for(path, leaf):
        ndim = len(leaf.shape)
        if ndim >= 2 and fs > 1 and leaf.shape[-1] % fs == 0 \
                and math.prod(leaf.shape) > 1 << 16:
            return Spec(*([None] * (ndim - 1)), FSA)
        return Spec(*([None] * ndim))

    return tree_map_with_path(spec_for, params)


def recsys_param_specs(params, cfg, policy: ShardingPolicy):
    """Embedding table rows shard over the WHOLE mesh; MLPs fsdp x tp."""
    tp = policy.axis_size("tp")
    fs = policy.axis_size("fsdp")
    TPA, FSA = policy.tp_axis, policy.fsdp_axis
    every = tuple(policy.mesh.mesh_dim_names)

    def spec_for(path, leaf):
        name = path.split("/")[-1]
        ndim = len(leaf.shape)
        if name == "table":                       # [rows, dim]
            return Spec(every, None)
        if ndim == 2:
            return Spec(FSA if fs > 1 and _divides(leaf.shape[0], fs)
                        else None,
                        TPA if tp > 1 and _divides(leaf.shape[1], tp)
                        else None)
        return Spec(*([None] * ndim))

    return tree_map_with_path(spec_for, params)


def _children(node):
    """(key, child) pairs of a tree node — a ``ParamTree`` or another
    ``nn.Module``, a dict, a list — or None for a leaf."""
    from torch import nn
    if isinstance(node, (nn.ModuleList, list)):
        return list(enumerate(node))
    if isinstance(node, nn.Module):
        items = dict(node.named_parameters(recurse=False))
        items.update(node.named_children())
        return list(items.items())
    if isinstance(node, dict):
        return list(node.items())
    return None


def tree_map_with_path(fn, tree, path: str = ""):
    """``fn("a/b/0/c", leaf)`` over a tree's leaves, as nested dicts and
    lists of its nesting; the paths are the JAX pytree's."""
    kids = _children(tree)
    if kids is None:
        return fn(path, tree)
    out = {k: tree_map_with_path(fn, c, f"{path}/{k}" if path else str(k))
           for k, c in kids}
    if isinstance(tree, (list, torch.nn.ModuleList)):
        return [out[i] for i in range(len(kids))]
    return out


def leaves_with_paths(tree) -> list:
    """``(path, leaf)`` of every leaf of a tree (a ``ParamTree``, nested
    dicts and lists, a tree of ``Spec``s), paths as
    ``tree_map_with_path``'s."""
    out = []
    tree_map_with_path(lambda path, leaf: out.append((path, leaf)), tree)
    return out


def to_shardings(specs, mesh):
    """A tree of ``Spec``s (or one ``Spec``) -> the same nesting of
    ``Sharding``s."""
    if isinstance(specs, Spec):
        return Sharding(mesh, to_placements(specs, mesh))
    if isinstance(specs, dict):
        return {k: to_shardings(v, mesh) for k, v in specs.items()}
    return [to_shardings(v, mesh) for v in specs]


def place(x: torch.Tensor, sharding: Sharding):
    """The whole tensor ``x`` (every rank holds the same values) as a
    DTensor under ``sharding``: each rank keeps a copy of its block, on
    the mesh's device (a ``meta`` tensor stays on ``meta``).  No
    collective is made."""
    local = x[local_slices(x.shape, sharding)].clone(
        memory_format=torch.contiguous_format)
    if not x.is_meta:
        local = local.to(mesh_device(sharding.mesh))
    return from_shard(local, sharding, x.shape)
