"""The production mesh as DTensors on the meta device: where the dry-run
(``launch/dryrun.py``) places a step's arguments and counts the
collectives that placing them costs.

The reference compiles each step for 256 or 512 placeholder devices and
reads the collectives out of XLA's SPMD program. Here :func:`fake_mesh`
brings up a process group of the mesh's size over PyTorch's fake backend
(``torch.testing._internal.distributed.fake_pg.FakeStore``, imported here
and nowhere else: not public API; a torch without it makes the dry-run
raise) with this process as rank 0, and a ``DeviceMesh`` of the mesh's
shape and axis names whose local tensors live on ``meta``. No rank but 0
exists: a collective over the fake group returns at once, touching no
data, and on meta nothing is allocated. :func:`distribute` makes each
argument a ``DTensor`` of the ``Partitioner``'s spec, and DTensor's
sharding propagation places every op of the step: where an op's
operands do not fit its rule, it redistributes them, issuing the
functional collectives that :func:`collective_kind` names under the
reference's five kinds. Where DTensor's own choice would differ from
XLA's placement of the reference's program, the rules below decide
(the dry-run's step counter applies them: ``launch/dryrun.py``).

The mesh's device type is ``meta``, so that a shard moving between dims
is DTensor's all-to-all (on a ``cpu`` mesh DTensor all-gathers in its
place, as gloo has no all-to-all). DTensor's cost model asks how many
devices a host holds, which a meta mesh cannot answer: while the mesh is
up it reads :data:`HOST_DEVICES`, the eight H100s of an HGX board.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

# H100s on one host (an HGX H100 board), for DTensor's cost model
HOST_DEVICES = 8

# functional collective -> the reference's kind (``launch/roofline.py``)
KINDS = {
    "all_reduce": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
}
REFERENCE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                   "all-to-all", "collective-permute")
_NAMESPACES = ("_c10d_functional", "_dtensor")


class Strided(RuntimeError):
    """An output DTensor on a mesh of three axes would place a dim as a
    strided split (``_StridedShard``: a flattened dim whose inner part is
    the split one), whose redistributions DTensor plans by a search that
    takes minutes there: the op is placed again from gathered operands
    (:func:`reshard_and_retry`)."""


# what DTensor raises for an op it cannot place as its operands lie
UNPLACEABLE = (RuntimeError, NotImplementedError, AssertionError, IndexError)


def check_plain(out):
    """Raise :class:`Strided` if an output of ``out`` on a mesh of three
    axes or more is split strided (on two axes DTensor plans them in no
    time)."""
    for o in out if isinstance(out, (tuple, list)) else (out,):
        if is_sharded(o) and o.device_mesh.ndim > 2 and any(
                type(p).__name__ == "_StridedShard" for p in o.placements):
            raise Strided(f"strided split {o.placements}")


_KIND_OF: dict = {}


def collective_kind(func) -> str | None:
    """The reference's kind of a collective op, or None for any other op
    (``wait_tensor`` and ``_wrap_tensor_autograd`` move nothing)."""
    try:
        return _KIND_OF[func]
    except KeyError:
        kind = KINDS.get(func.overloadpacket.__name__) \
            if func.namespace in _NAMESPACES else None
        _KIND_OF[func] = kind
        return kind


def is_sharded(x) -> bool:
    return isinstance(x, DTensor)


@contextlib.contextmanager
def fake_mesh(mesh):
    """A ``DeviceMesh`` on ``meta`` of ``mesh``'s shape and axis names
    (``launch/mesh.py:ShapeMesh``), over a fake process group of its size
    with this process as rank 0. The group is destroyed on leaving, and
    the host size lent to DTensor's cost model taken back."""
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as err:
        raise RuntimeError(
            f"the dry-run places its steps over torch's fake process group "
            f"(torch.testing._internal.distributed.fake_pg), which torch "
            f"{torch.__version__} lacks") from err
    from torch.distributed.device_mesh import _mesh_resources, init_device_mesh

    if dist.is_initialized():
        raise RuntimeError("fake_mesh: a process group is already up")
    sizes = tuple(mesh.shape.values())
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=math.prod(sizes))
    _mesh_resources.num_devices_per_host = lambda device_type: HOST_DEVICES
    try:
        yield init_device_mesh("meta", sizes,
                               mesh_dim_names=tuple(mesh.axis_names))
    finally:
        del _mesh_resources.num_devices_per_host
        dist.destroy_process_group()


def placements(spec, ndim: int, axis_names) -> list:
    """One placement per mesh dim: ``Shard(i)`` where dim ``i`` of the spec
    names that axis, else ``Replicate()``. A dim split over two axes
    (``("data", "model")``) is ``Shard(i)`` on both, the first axis the
    outer split, as the spec orders them."""
    out = []
    for axis in axis_names:
        placement = Replicate()
        for i in range(ndim):
            part = spec[i] if i < len(spec) else None
            names = () if part is None else \
                (part,) if isinstance(part, str) else part
            if axis in names:
                placement = Shard(i)
        out.append(placement)
    return out


def distribute(t: torch.Tensor, sharding, dmesh) -> DTensor:
    """A meta tensor as a DTensor of ``sharding``'s spec on ``dmesh``:
    rank 0's shard, empty on meta."""
    shape = tuple(t.shape)
    local = torch.empty(sharding.shard_shape(shape), dtype=t.dtype,
                        device="meta")
    return DTensor.from_local(
        local, dmesh, placements(sharding.spec, t.ndim,
                                 dmesh.mesh_dim_names),
        run_check=False, shape=t.shape, stride=t.stride())


# Nesting depth of redistributions the dry-run's step counter must not
# count as the step's own ops: their collectives count, their local copies
# (chunks, concatenations) do not.
QUIET = 0


@contextlib.contextmanager
def quiet():
    global QUIET
    QUIET += 1
    try:
        yield
    finally:
        QUIET -= 1


# The per-device share of a plain tensor's bytes, for the dry-run's memory
# term: a region that moves nothing (:func:`local`, :func:`on_shards`)
# runs its plain ops at the operands' global shapes, where each device
# holds only its share, the local share of the region's largest operand.
# ``SCALE`` is the share of the region whose forward runs (:func:`region`;
# None outside one), ``BACKWARD`` that of the region whose backward runs:
# set where its gradients enter (``_Placed.backward``) and put back to 1
# where they leave (``_Whole.backward``). Autograd runs the nodes of a
# step in the reverse of the order it made them, so a region's backward
# runs from the one to the other with no other node between. Outside
# regions every plain op runs on local tensors, at 1 (:func:`share`).
SCALE: float | None = None
BACKWARD = 1.0
# Nesting depth of the global stand-ins of a region's boundary (a
# DTensor's global view, its gradient's): aliases of local data, which
# hold no memory of their own
ALIAS = 0


@contextlib.contextmanager
def region(part: float):
    global SCALE
    outer, SCALE = SCALE, part
    try:
        yield
    finally:
        SCALE = outer


def share() -> float:
    """The per-device share of what a plain op makes here: its region's in
    a forward, its region's in a backward (grad mode off), 1 outside
    regions. A checkpoint's recomputation runs with grad mode on, as the
    forward it repeats."""
    if SCALE is not None:
        return SCALE
    return 1.0 if torch.is_grad_enabled() else BACKWARD


@contextlib.contextmanager
def alias():
    global ALIAS
    ALIAS += 1
    try:
        yield
    finally:
        ALIAS -= 1


class _Constrain(torch.autograd.Function):
    """``x.redistribute`` to ``target`` as a sharding constraint. Its
    backward constrains the gradient to the same placements, as JAX
    transposes ``with_sharding_constraint``. Both directions run under
    :func:`quiet`."""

    @staticmethod
    def forward(ctx, x, target):
        ctx.target = target
        with quiet():
            return x.redistribute(x.device_mesh, target)

    @staticmethod
    def backward(ctx, grad):
        with quiet():
            return grad.redistribute(grad.device_mesh, ctx.target), None


def place(x: DTensor, target) -> DTensor:
    """``x`` redistributed to the placements ``target``."""
    if tuple(target) == tuple(x.placements):
        return x
    return _Constrain.apply(x, tuple(target))


def constrain(x: DTensor, spec) -> DTensor:
    """``x`` redistributed to ``spec``'s placements, the counterpart of
    ``jax.lax.with_sharding_constraint``."""
    return place(x, placements(spec, x.ndim, x.device_mesh.mesh_dim_names))


def _shard_shape(shape, mesh, target) -> tuple[int, ...]:
    """Rank 0's block of a tensor of ``shape`` placed as ``target``."""
    out = list(shape)
    for size, p in zip(mesh.shape, target):
        if p.is_shard():
            out[p.dim] = -(-out[p.dim] // size)
    return tuple(out)


class _Whole(torch.autograd.Function):
    """A DTensor as a plain meta tensor of its global shape, entering a
    region split on the mesh dims marked in ``split``. The gradient comes
    back as a DTensor of the input's placements, but a partial sum on each
    of those dims where the input is a replica: each device forms its part
    from its own shards, as ``shard_map``'s transpose sums the cotangent of
    an input it does not split. The region's backward ends here."""

    @staticmethod
    def forward(ctx, x, split):
        ctx.mesh = x.device_mesh
        ctx.target = tuple(Partial() if s and p.is_replicate() else p
                           for s, p in zip(split, x.placements))
        with quiet(), alias():
            return torch.empty_strided(x.shape, x.stride(), dtype=x.dtype,
                                       device="meta")

    @staticmethod
    def backward(ctx, grad):
        global BACKWARD
        BACKWARD = 1.0
        return _placed(grad, ctx.mesh, ctx.target), None


class _Placed(torch.autograd.Function):
    """A plain meta tensor of a region whose per-device share is ``scale``
    as a DTensor of ``target`` on ``mesh``. The gradient is redistributed
    to the placements the region's backward reads (``target``'s, a replica
    where ``target`` is a partial sum; the collectives counted) and comes
    back as a plain tensor of the global shape. The region's backward
    starts here."""

    @staticmethod
    def forward(ctx, t, mesh, target, scale):
        ctx.scale = scale
        ctx.want = tuple(Replicate() if p.is_partial() else p
                         for p in target)
        return _placed(t, mesh, target)

    @staticmethod
    def backward(ctx, grad):
        global BACKWARD
        if is_sharded(grad) and tuple(grad.placements) != ctx.want:
            with quiet():
                grad = grad.redistribute(grad.device_mesh, ctx.want)
        BACKWARD = ctx.scale
        with quiet(), alias():
            return torch.empty_strided(grad.shape, grad.stride(),
                                       dtype=grad.dtype,
                                       device="meta"), None, None, None


def _placed(t, mesh, target) -> DTensor:
    with quiet():
        local = torch.empty(_shard_shape(t.shape, mesh, target),
                            dtype=t.dtype, device="meta")
        return DTensor.from_local(local, mesh, target, run_check=False,
                                  shape=t.shape, stride=t.stride())


def local(fn, in_specs, out_spec):
    """``fn`` as a region that moves nothing between devices, as
    ``shard_map`` declares one: each DTensor argument is constrained to
    its spec of ``in_specs`` (None: left as it is), ``fn`` runs on plain
    meta tensors of the arguments' global shapes (so that the dry-run's
    step counter counts its ops as on one device), and its output is a
    DTensor of ``out_spec`` on the arguments' mesh (for a dict output, a
    dict of specs by key; its values that are not tensors pass as they
    are). Gradients cross the boundary the other way: an output's
    redistributed to the placements the region read it in (a replica
    where the output is a partial sum), an argument's in the placements it
    entered in, but a partial sum on each mesh dim the region splits where
    the argument is a replica."""

    def run(*args):
        sharded = [a for a in args if is_sharded(a)]
        if not sharded:
            return fn(*args)
        mesh = sharded[0].device_mesh
        placed = [constrain(a, spec) if is_sharded(a) and spec is not None
                  else a for a, spec in zip(args, in_specs)]
        scale, split = _largest_share(placed), _split(placed)
        with region(scale):
            out = fn(*[_Whole.apply(a, split) if is_sharded(a) else a
                       for a in placed])

        def placed(t, spec):
            if not isinstance(t, torch.Tensor):
                return t
            target = tuple(placements(spec, t.ndim, mesh.mesh_dim_names))
            return _Placed.apply(t, mesh, target, scale)

        if isinstance(out, dict):
            return {k: placed(v, out_spec.get(k)) for k, v in out.items()}
        return placed(out, out_spec)

    return run


def on_shards(fn, args, labels, out_labels, shardable: str):
    """``fn(*args)`` under a sharding rule given by dim labels, as a
    region that moves nothing once its operands are placed (:func:`local`):
    the rule of a kernel's plain version, and of the decode step's plain
    attention. ``labels`` names each argument's dims (None: not a tensor),
    one letter a dim, the same letter for dims that split together (batch
    ``b``; heads ``h``, query and kv heads alike; the keys ``t``);
    ``out_labels`` names the outputs' dims (one string, or a tuple for a
    tuple of outputs, None for an output that is None). On each mesh dim
    the operands may stay split on one label of ``shardable``: of the
    labels they are split on there, the one most of their elements lie
    split by whose dims all divide; every operand with that label split
    on it, every other one whole. Any other placement is redistributed to
    that (a collective, counted), and with no such label, to replicas. An
    output is split where its label is, and a partial sum where it lacks
    the label (a gradient summed over the batch; attention over split
    keys)."""
    mesh = next(a for a in args if is_sharded(a)).device_mesh
    tensors = [(i, a) for i, a in enumerate(args) if is_sharded(a)]
    chosen = []
    for j in range(mesh.ndim):
        # the shardable labels split on this mesh dim, by the bytes that
        # already lie so; the heaviest whose dims all divide is kept
        weight: dict = {}
        for i, a in tensors:
            p = a.placements[j]
            if p.is_shard() and labels[i][p.dim] in shardable:
                lab = labels[i][p.dim]
                weight[lab] = weight.get(lab, 0) + a.numel()
        fits = [lab for lab in sorted(weight, key=weight.get, reverse=True)
                if not any(lab in labels[i] and a.shape[labels[i].index(lab)]
                           % mesh.size(j) for i, a in tensors)]
        chosen.append(fits[0] if fits else None)
    placed = list(args)
    for i, a in tensors:
        target = [Shard(labels[i].index(lab))
                  if lab is not None and lab in labels[i] else Replicate()
                  for lab in chosen]
        placed[i] = place(a, target)
    scale, split = _largest_share(placed), _split(placed)
    with region(scale):
        out = fn(*[_Whole.apply(a, split) if is_sharded(a) else a
                   for a in placed])

    def wrap(t, labs):
        if t is None:
            return None
        target = tuple(Replicate() if lab is None else
                       Shard(labs.index(lab)) if lab in labs else Partial()
                       for lab in chosen)
        return _Placed.apply(t, mesh, target, scale)

    if isinstance(out_labels, str):
        return wrap(out, out_labels)
    return tuple(wrap(t, labs) for t, labs in zip(out, out_labels))


def _largest_share(args) -> float:
    """The part of the largest DTensor among ``args`` that one device
    holds."""
    x = max((a for a in args if is_sharded(a)), key=DTensor.numel)
    return x._local_tensor.numel() / max(x.numel(), 1)


def _split(args) -> tuple[bool, ...]:
    """For each mesh dim, whether a DTensor among ``args`` is split on
    it."""
    sharded = [a for a in args if is_sharded(a)]
    return tuple(any(a.placements[j].is_shard() for a in sharded)
                 for j in range(sharded[0].device_mesh.ndim))


def restride(func, args, kwargs, out):
    """A view's output with the strides the same view of a plain meta
    tensor has: DTensor's rule may give a unit dim another (equally
    valid) stride, and the step's composite ops (``matmul``'s folding,
    ``reshape``'s copy) decide by strides, so the placed step would run
    other ops than the plain one counted. Only outputs with a unit dim
    are looked at."""
    if not func.is_view or not args or not is_sharded(args[0]) or not any(
            o.ndim and 1 in o.shape
            for o in (out if isinstance(out, (tuple, list)) else (out,))):
        return out
    src = args[0]
    plain = func(torch.empty_strided(src.shape, src.stride(),
                                     dtype=src.dtype, device="meta"),
                 *args[1:], **kwargs)

    def fix(o, p):
        if not is_sharded(o) or o.stride() == p.stride():
            return o
        return DTensor.from_local(o._local_tensor, o.device_mesh,
                                  o.placements, run_check=False,
                                  shape=o.shape, stride=p.stride())

    with torch.no_grad():
        if isinstance(out, (tuple, list)):
            return type(out)(fix(o, p) for o, p in zip(out, plain))
        return fix(out, plain)


def on_replicas(func, args, kwargs):
    """``func`` on DTensor operands that are all replicas (plain tensors
    beside them are replicas too), run on their local tensors (each the
    whole tensor) and its tensor outputs made replicas: what DTensor's
    rules give such a call, without their search (a replica's placement
    needs none), and with the strides the op gives a plain tensor. None
    when an operand is split or a partial sum."""
    if func._schema.is_mutable and not (args and is_sharded(args[0])):
        return None
    flat = torch.utils._pytree.tree_leaves((args, kwargs))
    mesh = None
    for a in flat:
        if is_sharded(a):
            if any(not p.is_replicate() for p in a.placements):
                return None
            mesh = a.device_mesh
    local = torch.utils._pytree.tree_map(
        lambda a: a._local_tensor if is_sharded(a) else a, (args, kwargs))
    out = func(*local[0], **local[1])
    if func._schema.is_mutable and out is local[0][0]:
        return args[0]
    with torch.no_grad():
        return torch.utils._pytree.tree_map(
            lambda t: DTensor.from_local(
                t, mesh, [Replicate()] * mesh.ndim, run_check=False,
                shape=t.shape, stride=t.stride())
            if isinstance(t, torch.Tensor) else t, out)


def on_same_shards(func, args, kwargs):
    """A pointwise op whose DTensor operands all have one shape, one
    contiguous layout and one placement (no partial sum; any other
    operand a number or a 0-dim tensor), run on their local tensors, the
    output (contiguous, as the op makes it from such operands) placed as
    they are: DTensor's pointwise rule, without its search. None
    otherwise."""
    if torch.Tag.pointwise not in func.tags and \
            func is not _aten._to_copy.default:
        return None
    first = None
    for a in torch.utils._pytree.tree_leaves((args, kwargs)):
        if is_sharded(a):
            if first is None:
                first = a
                if any(p.is_partial() for p in a.placements) or \
                        not a.is_contiguous():
                    return None
            elif a.shape != first.shape or a.stride() != first.stride() \
                    or a.placements != first.placements:
                return None
        elif isinstance(a, torch.Tensor) and a.ndim:
            return None
    local = torch.utils._pytree.tree_map(
        lambda a: a._local_tensor if is_sharded(a) else a, (args, kwargs))
    out = func(*local[0], **local[1])
    if func._schema.is_mutable and out is local[0][0]:
        return args[0]
    if not isinstance(out, torch.Tensor):
        return None
    with torch.no_grad():
        return DTensor.from_local(out, first.device_mesh, first.placements,
                                  run_check=False, shape=first.shape,
                                  stride=first.stride())


# In-place writes by index (a decode step's cache rows): left undone, as
# XLA's dynamic-update-slice of a cache split on batch, heads or sequence
# moves nothing; on meta they write nothing (DTensor's search over their
# placements took seconds a call, and found none)
WRITES_BY_INDEX = (torch.ops.aten.index_put_.default,
                   torch.ops.aten._index_put_impl_.default)


# Reductions along a dim that DTensor places only by gathering the dim
# whole: traced through their decompositions (max, exp, sum), which DTensor
# reduces across the shards as partial results, as XLA partitions them.
_aten = torch.ops.aten
DECOMPOSED = (_aten.logsumexp.default, _aten._softmax.default,
              _aten._log_softmax.default,
              _aten._softmax_backward_data.default,
              _aten._log_softmax_backward_data.default)


def decomposition(func):
    """The decomposition :data:`DECOMPOSED` traces ``func`` through, or
    None."""
    if func not in DECOMPOSED:
        return None
    from torch._decomp import decomposition_table
    return decomposition_table[func]


def lookup(func, args, call):
    """A row lookup ``table[ids]`` into a table sharded on its rows (the
    vocab-parallel embedding) made as ``embedding(table, ids)``, which
    DTensor places as each shard's masked lookup, and its partial sum
    reduced at once, as XLA partitions the reference's gather (DTensor
    would move the whole table to shards of its columns). ``call(func,
    args)`` makes the call. Returns the output, or None for any other
    op."""
    if func is not _aten.index.Tensor or len(args) != 2:
        return None
    table, ids = args
    if not (is_sharded(table) and table.ndim == 2 and len(ids) == 1
            and ids[0] is not None and not ids[0].dtype.is_floating_point
            and ids[0].dtype != torch.bool
            and any(p.is_shard(0) for p in table.placements)):
        return None
    out = call(_aten.embedding.default, (table, ids[0]))
    reduced = [Replicate() if p.is_partial() else p for p in out.placements]
    with torch.no_grad(), quiet():
        return out.redistribute(out.device_mesh, reduced)


# Binary ops that add two tensors of one shape (the residual stream and a
# block's output; two gradients of one tensor)
_SUMS = (_aten.add.Tensor, _aten.sub.Tensor)


def align_sum(func, args):
    """An add of two same-shaped DTensors placed differently: one operand
    is redistributed to the other's placements first, a partial sum onto
    the operand that is not one (an all-reduce onto a replica, a
    reduce-scatter onto a shard), else the second operand onto the first
    (the residual stream's layout), as XLA reduces the reference's
    row-parallel products where they meet the residual. DTensor would
    otherwise pick a third layout for both by its cost model (the
    residual scattered over another dim), which the next ops undo. Other
    calls pass as they are."""
    if func not in _SUMS or len(args) < 2 or not all(
            is_sharded(a) for a in args[:2]):
        return args
    a, b = args[:2]
    if a.shape != b.shape or tuple(a.placements) == tuple(b.placements):
        return args
    partial_a = any(p.is_partial() for p in a.placements)
    partial_b = any(p.is_partial() for p in b.placements)
    if partial_a and not partial_b:
        a = place(a, b.placements)
    else:
        b = place(b, a.placements)
    return (a, b) + tuple(args[2:])


def reshard_and_retry(call, func, args, kwargs, err):
    """An op whose operands DTensor's sharding propagation cannot place as
    they are. Returns ``(out, how)``, ``how`` naming the route taken:

    - an in-place op (a pointwise update of a backward's temporary whose
      operands lie differently) is left undone: on meta it writes
      nothing, and its output keeps its placement;
    - an op DTensor has no rule for runs on the local shards: where every
      operand has the same placements, none a partial sum and none
      splitting a last dim (the dim such ops work along), the op is
      batch-parallel and its output takes those placements; else the
      operands are gathered to replicas first;
    - any other op (a view splitting a dim sharded unevenly for the split,
      a strided split on three axes) has its operands made replicas over
      the last mesh axis, then the last two, and so on, until
      ``call(args, kwargs)`` goes through, as XLA gathers an operand it
      cannot partition.

    The gathers are counted; ``err`` is re-raised when nothing works."""
    if func._schema.is_mutable and args and \
            isinstance(args[0], torch.Tensor):
        return args[0], "in place, left undone"
    operands = [a for a in _leaves((args, kwargs)) if is_sharded(a)]
    mesh = operands[0].device_mesh
    if isinstance(err, NotImplementedError):
        first = tuple(operands[0].placements)
        batch = all(tuple(a.placements) == first for a in operands) and \
            not any(p.is_partial() or (p.is_shard() and
                                        p.dim in (-1, a.ndim - 1))
                    for a in operands for p in a.placements)
        if batch:
            return _on_shards(func, args, kwargs, mesh, first), \
                "run on the shards"
        args, kwargs = _replicate(args, kwargs, range(mesh.ndim))
        return _on_shards(func, args, kwargs, mesh,
                          [Replicate()] * mesh.ndim), "run on replicas"
    for k in range(1, mesh.ndim + 1):
        rep = range(mesh.ndim - k, mesh.ndim)
        a2, k2 = _replicate(args, kwargs, rep)
        try:
            return call(a2, k2), f"mesh dims {list(rep)} gathered"
        except UNPLACEABLE:
            continue
    raise err


def _replicate(args, kwargs, mesh_dims):
    """Every DTensor of ``(args, kwargs)`` made a replica over
    ``mesh_dims`` (a redistribution, its collectives counted)."""
    def fix(a):
        if not is_sharded(a):
            return a
        target = [Replicate() if j in mesh_dims else p
                  for j, p in enumerate(a.placements)]
        with torch.no_grad(), quiet():
            return a.redistribute(a.device_mesh, target)

    return torch.utils._pytree.tree_map(fix, (args, kwargs))


def _on_shards(func, args, kwargs, mesh, placements):
    """``func`` on the DTensor operands' local tensors, each tensor output
    a DTensor of ``placements``."""
    local = torch.utils._pytree.tree_map(
        lambda a: a._local_tensor if is_sharded(a) else a, (args, kwargs))
    out = func(*local[0], **local[1])
    with torch.no_grad():
        return torch.utils._pytree.tree_map(
            lambda t: DTensor.from_local(t, mesh, placements,
                                         run_check=False)
            if isinstance(t, torch.Tensor) else t, out)


def _leaves(tree):
    return torch.utils._pytree.tree_leaves(tree)
