"""Sharding rules: logical activation axes and path-based parameter specs.
Counterpart of ``repro/distribution/sharding.py``.

The model code annotates activations with *logical* axis names through
``constrain`` (``layers.hint``).  ``use_mesh`` binds a mesh plus the
logical -> mesh-axis rules; parameter shardings are derived from the
parameter's path with ``param_specs`` (MaxText-style rules, computed rather
than declared per layer), exactly as the reference derives them.

Modes:
  * tp     : tensor parallel over ``model`` only; params replicated over data
  * fsdp   : tp + params and optimizer state sharded over ``("pod", "data")``
             too (ZeRO-3 style)

A spec is a PartitionSpec-like tuple: per tensor dim, ``None``, a mesh axis
name, or a tuple of names, so that it compares entry by entry with the
reference's ``PartitionSpec``.  The rule functions read only the mesh's axis
names and sizes: they take a ``torch.distributed.device_mesh.DeviceMesh``,
a ``MeshShape`` or any object with ``axis_names`` and a ``shape`` mapping,
so the production meshes are checked with no process group.

A mesh is a ``DeviceMesh`` whose dimensions carry the reference's axis
names.  ``distribute`` turns a tree of tensors into ``DTensor``s with the
placements a tree of specs gives: an entry ``("pod", "data")`` on tensor
dim d is ``Shard(d)`` on both mesh dims, in mesh order, which is JAX's
block layout.  ``constrain`` redistributes a DTensor to the placements the
rules give; on a plain tensor, or outside ``use_mesh``, it is a no-op.  A
mesh whose every dim has size 1 leaves tensors plain (``is_trivial``).

The reference's ``_shardmap.py`` has no counterpart: it papers over two
``jax.shard_map`` signatures, and the port's per-rank regions are
``torch.distributed.tensor.experimental.local_map``.
"""
from __future__ import annotations

import contextlib
import math
import sys
import threading
from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import torch

__all__ = [
    "DEFAULT_RULES", "MeshShape", "use_mesh", "current", "constrain", "mesh_axes",
    "param_specs", "opt_state_specs", "batch_specs", "cache_specs", "placements",
    "distribute", "is_trivial", "is_dtensor", "data_axes", "splits_heads", "logical_spec",
    "merge_heads", "distribute_cache", "gather_fsdp", "local_layout", "per_rank",
]

_STATE = threading.local()

#: logical activation axis -> mesh axes (None = replicated)
DEFAULT_RULES: Dict[str, Any] = {
    "batch": ("pod", "data"),
    "seq": None,  # flipped to 'model' when sequence parallelism is on
    "heads": "model",
    "kv_heads": "model",
    "mlp": "model",
    "vocab": "model",
    "experts": "model",
}


class MeshShape(NamedTuple):
    """A mesh's axis names and sizes, with no devices behind it."""

    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))


def mesh_axes(mesh) -> Dict[str, int]:
    """{axis name: size} in mesh order, for a DeviceMesh or a mesh-like."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    shape = mesh.shape
    if isinstance(shape, dict):
        return {a: int(shape[a]) for a in mesh.axis_names}
    return dict(zip(mesh.axis_names, tuple(shape)))


def _axes_in(mesh, want) -> Optional[Any]:
    if want is None:
        return None
    names = mesh_axes(mesh)
    if isinstance(want, str):
        return want if want in names else None
    present = tuple(a for a in want if a in names)
    return present if present else None


def data_axes(mesh) -> Tuple[str, ...]:
    """The data-like axes ``("pod", "data")`` present in ``mesh``."""
    names = mesh_axes(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def _size(mesh, axes) -> int:
    names = mesh_axes(mesh)
    return int(math.prod(names[a] for a in axes))


@contextlib.contextmanager
def use_mesh(mesh, rules: Optional[Dict[str, Any]] = None, *,
             sequence_parallel: bool = False, fsdp: bool = True):
    r = dict(DEFAULT_RULES)
    if rules:
        r.update(rules)
    if sequence_parallel:
        r["seq"] = "model"
    prev = getattr(_STATE, "ctx", None)
    _STATE.ctx = {"mesh": mesh, "rules": r, "fsdp": fsdp}
    try:
        yield
    finally:
        _STATE.ctx = prev


def current() -> Optional[dict]:
    return getattr(_STATE, "ctx", None)


def logical_spec(shape: Sequence[int], logical_axes: Sequence[Optional[str]], mesh,
                 rules: Dict[str, Any]) -> Tuple[Any, ...]:
    """The reference's ``constrain`` spec for ``shape``: a mesh axis appears
    once per spec (the first logical axis wins) and a dim is sharded only
    when the mesh axes' total size divides it."""
    sizes = mesh_axes(mesh)
    spec = []
    used: set = set()
    for i, ax in enumerate(logical_axes):
        m = _axes_in(mesh, rules.get(ax)) if ax else None
        if m is not None:
            flat = (m,) if isinstance(m, str) else tuple(m)
            flat = tuple(a for a in flat if a not in used)
            used.update(flat)
            m = None if not flat else (flat[0] if len(flat) == 1 else flat)
        if m is not None:
            flat = (m,) if isinstance(m, str) else tuple(m)
            total = math.prod(sizes[a] for a in flat)
            if shape[i] % total != 0:
                used.difference_update(flat)
                m = None
        spec.append(m)
    return tuple(spec)


def constrain(x, logical_axes: Sequence[Optional[str]]):
    """Redistribute the DTensor ``x`` to the placements the rules give its
    logical axes, and its gradient to the same placements on the way back,
    as ``with_sharding_constraint`` constrains the cotangent too (DTensor
    would otherwise carry a gradient's partial sums on through linear ops
    and gather the next weights to multiply them whole on every rank); a
    plain tensor, a rank mismatch or no mesh leave it as is."""
    ctx = current()
    if ctx is None or not is_dtensor(x):
        return x
    if x.ndim != len(logical_axes):
        return x  # the caller's annotation does not apply here
    spec = logical_spec(tuple(x.shape), logical_axes, ctx["mesh"], ctx["rules"])
    want = placements(spec, ctx["mesh"])
    if tuple(x.placements) != want:
        x = x.redistribute(x.device_mesh, want)
    return _GradInPlacements.apply(x) if x.requires_grad else x


# ---------------------------------------------------------------------------
# parameter specs by path
# ---------------------------------------------------------------------------
_COL_SHARDED = ("wq", "wk", "wv", "w_gate", "w_up", "w_in", "wq_b", "wkv_b")
_ROW_SHARDED = ("wo", "w_out")
_REPLICATED = ("scale", "bias", "q_norm", "kv_norm", "a_log", "dt_bias", "router")


def _spec_for(path: Tuple[str, ...], shape: Tuple[int, ...], mesh, fsdp: bool):
    """One parameter's spec from its path leaf and shape.

    Stacked layer params carry a leading L dim, so the tensor-parallel rules
    address the trailing dims (row = -2, col = -1) and the expert rule finds
    the expert-count dim among the leading dims."""
    leaf = path[-1]
    nd = len(shape)
    parts: list = [None] * nd
    sizes = mesh_axes(mesh)
    model_ok = "model" in sizes
    msize = sizes.get("model", 1)

    def fits(dim: int) -> bool:
        return shape[dim] % msize == 0 and shape[dim] >= msize

    is_expert = any("expert" in p for p in path)
    if is_expert and nd >= 3:
        # (..., E, d_in, d_out): expert-parallel on the expert dim
        if model_ok:
            for i in range(nd - 2):
                if fits(i):
                    parts[i] = "model"
                    break
    elif leaf == "embedding" or leaf == "patch_proj" or "embed" in leaf:
        if model_ok and fits(0):
            parts[0] = "model"  # vocab-sharded embedding
    elif any(leaf.startswith(k) or leaf == k for k in _ROW_SHARDED):
        if model_ok and nd >= 2 and fits(nd - 2):
            parts[nd - 2] = "model"
    elif any(leaf.startswith(k) or leaf == k for k in _COL_SHARDED):
        if model_ok and nd >= 2 and fits(nd - 1):
            parts[nd - 1] = "model"
    elif any(k in leaf for k in _REPLICATED) or nd <= 1:
        pass
    elif nd >= 2:
        if model_ok and fits(nd - 1):
            parts[nd - 1] = "model"

    if fsdp:
        # ZeRO-3: shard the largest remaining free dim over the data axes
        daxes = data_axes(mesh)
        if daxes:
            dsize = _size(mesh, daxes)
            free = [i for i in range(nd)
                    if parts[i] is None and shape[i] % dsize == 0 and shape[i] >= dsize]
            if free:
                j = max(free, key=lambda i: shape[i])
                parts[j] = daxes if len(daxes) > 1 else daxes[0]
    return tuple(parts)


def _walk(node, path, fn):
    if isinstance(node, dict):
        return {k: _walk(v, path + (str(k),), fn) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_walk(v, path + (str(i),), fn) for i, v in enumerate(node))
    return fn(path, node)


def param_specs(params: Any, mesh, fsdp: Optional[bool] = None) -> Any:
    """Tree of specs matching ``params`` (tensors, meta tensors or shapes)."""
    if fsdp is None:
        ctx = current()
        fsdp = ctx["fsdp"] if ctx else True
    return _walk(params, (), lambda path, x: _spec_for(path, tuple(x.shape), mesh, fsdp))


def _is_q8(node) -> bool:
    return isinstance(node, dict) and set(node) == {"q", "scale"}


def opt_state_specs(params: Any, opt_state: Any, mesh, fsdp: bool = True) -> Any:
    """Moments inherit their parameter's spec; an int8 moment's ``scale``
    follows the rows of ``q`` only when their counts match."""
    pspecs = param_specs(params, mesh, fsdp)

    def moment(spec, node):
        if _is_q8(node):
            row = spec[0] if len(spec) else None
            scale_rows = node["scale"].shape[0] if node["scale"].dim() else 1
            q_rows = node["q"].shape[0] if node["q"].dim() else 1
            if scale_rows > 1 and scale_rows == q_rows and row is not None:
                return {"q": spec, "scale": (row,)}
            return {"q": spec, "scale": ()}
        return spec

    def zip_map(specs, tree):
        if _is_q8(tree) or not isinstance(tree, (dict, list)):
            return moment(specs, tree)
        if isinstance(tree, dict):
            return {k: zip_map(specs[k], v) for k, v in tree.items()}
        return [zip_map(s, v) for s, v in zip(specs, tree)]

    return {"m": zip_map(pspecs, opt_state["m"]), "v": zip_map(pspecs, opt_state["v"]),
            "step": ()}


def batch_specs(batch: Any, mesh) -> Any:
    """Shard dim 0 (batch) over the data-like axes when divisible."""
    daxes = data_axes(mesh)
    dsize = _size(mesh, daxes) if daxes else 1

    def spec(path, x):
        parts = [None] * len(x.shape)
        if daxes and len(x.shape) and x.shape[0] % dsize == 0 and x.shape[0] >= dsize:
            parts[0] = daxes if len(daxes) > 1 else daxes[0]
        return tuple(parts)

    return _walk(batch, (), spec)


def cache_specs(cache: Any, mesh, batch_size: int) -> Any:
    """KV caches and recurrent states: the batch dim over the data axes when
    divisible, else the longest divisible dim (the sequence: a flash-decoding
    split); ``model`` on the largest remaining divisible dim."""
    daxes = data_axes(mesh)
    dsize = _size(mesh, daxes) if daxes else 1
    msize = mesh_axes(mesh).get("model", 1)
    dval = daxes if len(daxes) > 1 else (daxes[0] if daxes else None)

    def spec(path, x):
        shape = tuple(x.shape)
        parts: list = [None] * len(shape)
        if not shape:
            return ()
        used = set()
        # data axes: prefer the dim that equals batch_size (skip dim 0, the
        # stacked-layer dim of rank >= 3 leaves)
        if daxes and dsize > 1:
            cand = [i for i in range(len(shape)) if shape[i] % dsize == 0 and shape[i] >= dsize]
            pref = [i for i in cand if shape[i] == batch_size and i != 0]
            pick = (pref or sorted(cand, key=lambda i: -shape[i]) or [None])[0]
            if pick is not None:
                parts[pick] = dval
                used.add(pick)
        if msize > 1 and "model" in mesh_axes(mesh):
            cand = [i for i in range(1, len(shape))
                    if i not in used and shape[i] % msize == 0 and shape[i] >= msize]
            if cand:
                parts[sorted(cand, key=lambda i: -shape[i])[0]] = "model"
        return tuple(parts)

    return _walk(cache, (), spec)


def distribute_cache(cache: Any, mesh, batch_size: int) -> Any:
    """``cache`` as DTensors placed by ``cache_specs``, except the per-layer
    ``index`` counters, which stay replicated: a step advances each layer's
    counter in place through a view of the stack, and DTensor cannot update
    a view of a shard in place (the reference's specs shard the stacked
    counters over the data axes, where JAX rewrites the whole array)."""
    def unshard_index(node, spec, key=None):
        if isinstance(node, dict):
            return {k: unshard_index(v, spec[k], k) for k, v in node.items()}
        if isinstance(node, list):
            return [unshard_index(v, sp, key) for v, sp in zip(node, spec)]
        return () if key == "index" else spec

    return distribute(cache, unshard_index(cache, cache_specs(cache, mesh, batch_size)), mesh)


# ---------------------------------------------------------------------------
# specs <-> DTensor placements
# ---------------------------------------------------------------------------
def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor; never imports DTensor (no DTensor exists
    before it is imported), so an unsharded run pays nothing for the check."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def placements(spec: Sequence[Any], mesh) -> tuple:
    """DTensor placements (one per mesh dim) of a spec: ``Shard(d)`` on each
    mesh axis of more than one rank that the spec names for tensor dim d,
    ``Replicate()`` else (a shard over one rank is the whole tensor; DTensor
    mis-propagates such shards)."""
    from torch.distributed.tensor import Replicate, Shard

    sizes = mesh_axes(mesh)
    names = list(sizes)
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry} is not in mesh order {names}")
        for i in idx:
            if sizes[names[i]] > 1:
                out[i] = Shard(d)
    return tuple(out)


def splits_heads(x, n_heads: int) -> bool:
    """True for a DTensor whose last dim is sharded over more ranks than
    divide ``n_heads``: a reshape into heads would split a shard."""
    if not is_dtensor(x):
        return False
    from torch.distributed.tensor import Shard

    ways = math.prod(n for n, pl in zip(x.device_mesh.shape, x.placements)
                     if isinstance(pl, Shard) and pl.dim in (-1, x.ndim - 1))
    return n_heads % ways != 0


def local_layout(x, *head_counts: int):
    """The spec entries of a per-rank region over the DTensor ``x`` (batch
    first): its batch dim's (the data axes where they divide the batch, or
    None) and its heads dims' ("model" where it divides every one of
    ``head_counts``, None without head counts)."""
    mesh = x.device_mesh
    sizes = mesh_axes(mesh)
    daxes = data_axes(mesh)
    dp = math.prod(sizes[a] for a in daxes)
    bax = None
    if daxes and dp > 1 and x.shape[0] % dp == 0:
        bax = daxes if len(daxes) > 1 else daxes[0]
    m = sizes.get("model", 1)
    divide = bool(head_counts) and all(h % m == 0 for h in head_counts)
    return bax, "model" if m > 1 and divide else None


def per_rank(fn, args: Sequence[Any], specs: Sequence[Any], out_specs):
    """``fn(*args)`` on each rank's blocks through ``local_map``: every
    DTensor in ``args`` is redistributed to its spec's placements and handed
    over as its local block; a plain tensor, a number or None goes to every
    rank as it is (its spec is ignored).  ``out_specs`` places the output: a
    spec for one tensor, a list of specs for a tuple of them.

    The gradient of an input replicated over a mesh axis that another
    input's spec splits is a partial sum there: each rank's work used it for
    its own part of the batch or heads.  ``fn`` sees plain tensors only, so
    nothing in it goes through DTensor's dispatch (no sharding rule is asked
    for, and a loop in it dispatches nothing per step)."""
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map

    mesh = next(a.device_mesh for a in args if is_dtensor(a))
    sizes = mesh_axes(mesh)

    def named(spec):
        return {a for e in spec if e is not None for a in ((e,) if isinstance(e, str) else e)}

    keep = [i for i, a in enumerate(args) if a is not None]
    split = set().union(*(named(specs[i]) for i in keep if is_dtensor(args[i])))
    local_args, in_pl, grad_pl = [], [], []
    for i in keep:
        a = args[i]
        if is_dtensor(a):
            pl = placements(specs[i], mesh)
            a = a.redistribute(mesh, pl)
            mine = named(specs[i])
            grad = tuple(Partial() if ax in split and ax not in mine and sizes[ax] > 1 else p
                         for ax, p in zip(sizes, pl))
            in_pl.append(pl)
            grad_pl.append(grad)
        else:
            in_pl.append(None)
            grad_pl.append(None)
        local_args.append(a)

    def local(*xs):
        full = [None] * len(args)
        for i, x in zip(keep, xs):
            full[i] = x
        return fn(*full)

    if isinstance(out_specs, list):
        out_pl = tuple(placements(s, mesh) for s in out_specs)
    else:
        out_pl = list(placements(out_specs, mesh))
    return local_map(local, out_placements=out_pl, in_placements=tuple(in_pl),
                     in_grad_placements=tuple(grad_pl), device_mesh=mesh)(*local_args)


def gather_fsdp(tree: Any) -> Any:
    """Under an fsdp mesh, each DTensor leaf of ``tree`` with its shards over
    the data axes gathered (ZeRO-3's gather before use; the gradient goes
    back as a reduce-scatter).  Left sharded there, a weight can make
    DTensor contract over the data axes and gather the activations instead,
    so that every data rank computes the whole batch.  A no-op outside a
    mesh, without fsdp and on plain tensors."""
    ctx = current()
    if ctx is None or not ctx["fsdp"]:
        return tree
    from torch.distributed.tensor import Replicate, Shard

    def gather(x):
        if not is_dtensor(x):
            return x
        daxes = data_axes(x.device_mesh)
        pl = tuple(Replicate() if name in daxes and isinstance(p, Shard) else p
                   for name, p in zip(x.device_mesh.mesh_dim_names, x.placements))
        return x if pl == tuple(x.placements) else x.redistribute(x.device_mesh, pl)

    return _map(gather, tree)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v) for v in tree]
    return fn(tree)


class _GradInPlacements(torch.autograd.Function):
    """Identity whose gradient is redistributed to the input's placements."""

    @staticmethod
    def forward(ctx, x):
        ctx.mesh, ctx.placements = x.device_mesh, tuple(x.placements)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if is_dtensor(g) and tuple(g.placements) != ctx.placements:
            g = g.redistribute(ctx.mesh, ctx.placements)
        return g


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """(B, S, H, D) -> (B, S, H * D).  A DTensor's gradient reaches the merge
    in the merged tensor's own placements: the projection after it may hand
    back a gradient sharded over H * D where H does not divide the shards,
    and DTensor cannot split such a shard back into heads."""
    b, s, h, d = x.shape
    y = x.reshape(b, s, h * d)
    return _GradInPlacements.apply(y) if is_dtensor(y) else y


def is_trivial(mesh) -> bool:
    """A mesh of one rank: tensors stay plain on it."""
    return mesh is None or all(s == 1 for s in mesh_axes(mesh).values())


def distribute(tree: Any, specs: Any, mesh) -> Any:
    """``tree``'s tensors as DTensors on ``mesh`` with ``specs``' placements.
    Every rank holds the same full tensor (a seeded draw or a checkpoint), so
    each keeps its own block and nothing is sent.  A DTensor leaf is
    redistributed; on a one-rank mesh the tree comes back unchanged."""
    if is_trivial(mesh):
        return tree
    from torch.distributed.tensor import distribute_tensor

    def put(x, spec):
        pl = placements(spec, mesh)
        if is_dtensor(x):
            return x.redistribute(mesh, pl)
        return distribute_tensor(x.detach(), mesh, pl, src_data_rank=None)

    return _zip(put, tree, specs)


def _zip(fn, tree, specs):
    if isinstance(tree, dict):
        return {k: _zip(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_zip(fn, v, s) for v, s in zip(tree, specs)]
    return fn(tree, specs)
