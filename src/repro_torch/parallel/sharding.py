"""Logical-axis sharding rules (MaxText-style), divisibility-checked: the
port of the JAX package's ``parallel/sharding.py``.

Every parameter, activation and cache tensor carries a tuple of
*logical* axis names (one per dimension, or None).  :class:`ShardingRules`
maps logical names to mesh axis names; resolution checks divisibility and
falls back to replication for axes that do not divide evenly (e.g.
qwen2's 28 heads on a 16-wide model axis), recording the fallback.  The
decisions, and the strings recorded, are the reference's.

A spec is a tuple with one entry per leading tensor dimension — None, a
mesh axis name, or a tuple of names — with trailing Nones dropped (the
reference's ``PartitionSpec``).  :func:`placements_for` turns it into
DTensor placements on a ``DeviceMesh``.  The rules read only the mesh's
axis names and sizes, so a shape-only :class:`MeshShape` stands in for a
production mesh without a process group.

The JAX layout stacks block parameters into (L, …) leaves whose first
axis is ``"layers"``; the port keeps one tensor a block.  Parameter
specs are computed on the stacked shapes (the FSDP threshold and the
"largest dim" choice depend on them) and :func:`block_spec` drops the
layer entry for a block's own tensor.

The SHARDING-SEARCH O-task (``tasks/sharding_search.py``) mutates these
rules.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

# Default logical → mesh mapping.  Entries may map to a tuple of mesh axes
# (composed sharding, e.g. batch over (pod, data)).
DEFAULT_RULES: dict[str, Any] = {
    "batch": ("pod", "data"),
    "seq": None,             # sequence replicated by default (train/prefill)
    "cache_seq": "model",    # decode KV caches shard sequence over model axis
    "embed": None,
    "vocab": "model",
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "ffn": "model",
    "experts": "model",
    "expert_ffn": None,
    "layers": None,
    "ssm_inner": "model",
    "ssm_heads": "model",
    "ssm_state": None,
    "conv_k": None,
    "kv_lora": None,
    "q_lora": None,
    "frames": None,
    "fsdp": ("pod", "data"),  # ZeRO/FSDP axis for param+opt-state sharding
}

# the data-parallel mesh axes, outermost first
DP_AXES = ("pod", "data")


class MeshShape(NamedTuple):
    """A mesh's axis names and sizes without devices: what the rules
    read, so that a production mesh's decisions need no process group."""
    mesh_dim_names: tuple[str, ...]
    shape: tuple[int, ...]


def axis_sizes(mesh) -> dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or a :class:`MeshShape`."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def _is_axes(x) -> bool:
    return isinstance(x, tuple)


def tree_map(fn, tree, *rest, is_leaf=_is_axes):
    """``fn`` over the leaves of a nested dict (leaves: ``is_leaf`` or
    anything that is not a dict) and the matching leaves of ``rest``."""
    if isinstance(tree, dict) and not is_leaf(tree):
        return {k: tree_map(fn, v, *(r[k] for r in rest), is_leaf=is_leaf)
                for k, v in tree.items()}
    return fn(tree, *rest)


def _dims(s) -> tuple[int, ...]:
    return tuple(s.shape) if hasattr(s, "shape") else tuple(s)


@dataclasses.dataclass
class ShardingRules:
    rules: dict[str, Any]
    mesh: Any
    # logical axes that, for this run, shard params over the fsdp axis too
    fsdp_axes: tuple[str, ...] = ()
    fallbacks: list[str] = dataclasses.field(default_factory=list)

    @classmethod
    def default(cls, mesh, overrides: dict[str, Any] | None = None,
                fsdp_axes: tuple[str, ...] = ()) -> "ShardingRules":
        rules = dict(DEFAULT_RULES)
        if overrides:
            rules.update(overrides)
        return cls(rules=rules, mesh=mesh, fsdp_axes=fsdp_axes)

    # ------------------------------------------------------------ resolve
    def _mesh_axes_for(self, logical: str | None) -> tuple[str, ...]:
        if logical is None:
            return ()
        target = self.rules.get(logical)
        if target is None:
            return ()
        if isinstance(target, str):
            return (target,)
        return tuple(a for a in target if a is not None)

    def _axis_size(self, mesh_axes: tuple[str, ...]) -> int:
        sizes = axis_sizes(self.mesh)
        return math.prod(sizes[a] for a in mesh_axes)

    def spec_for(self, logical_axes: tuple[str | None, ...],
                 dims: tuple[int, ...] | None = None) -> tuple:
        """The spec of a tensor with the given logical axes.

        With ``dims`` divisibility is enforced: a logical axis whose dim
        does not divide by the mesh-axis product is replicated and the
        fallback recorded.  Mesh axes named by the rules but absent from
        the mesh (e.g. "pod" on a single-pod mesh) are dropped, and no
        mesh axis is used twice."""
        names = tuple(self.mesh.mesh_dim_names)
        entries: list = []
        used: set[str] = set()
        for i, la in enumerate(logical_axes):
            axes = tuple(a for a in self._mesh_axes_for(la)
                         if a in names and a not in used)
            if not axes:
                entries.append(None)
                continue
            if dims is not None:
                size = self._axis_size(axes)
                if dims[i] % size != 0:
                    self.fallbacks.append(
                        f"{la}:dim{dims[i]}%{size}!=0->replicated")
                    entries.append(None)
                    continue
            used.update(axes)
            entries.append(axes[0] if len(axes) == 1 else axes)
        while entries and entries[-1] is None:
            entries.pop()
        return tuple(entries)

    # -------------------------------------------------------- tree helpers
    def tree_specs(self, axes_tree, shape_tree=None):
        """Map a nested dict of logical-axis tuples (and optionally of
        shapes: tuples or anything with ``.shape``) to specs."""
        if shape_tree is None:
            return tree_map(lambda ax: self.spec_for(tuple(ax)), axes_tree)
        return tree_map(
            lambda ax, s: self.spec_for(tuple(ax), _dims(s)), axes_tree,
            shape_tree)

    def sharding_for(self, logical_axes: tuple[str | None, ...],
                     dims: tuple[int, ...] | None = None) -> NamedSharding:
        return NamedSharding(self.mesh, self.spec_for(logical_axes, dims))

    def param_specs(self, axes_tree, shape_tree=None, fsdp: bool = False):
        """Param specs; optionally add FSDP sharding on the largest
        replicated dim of each big tensor (ZeRO-3-style weight sharding).
        Shapes are the JAX layout's, stacked (L, …) for block leaves."""
        specs = self.tree_specs(axes_tree, shape_tree)
        if not fsdp or shape_tree is None:
            return specs
        fsdp_axes = tuple(a for a in DP_AXES
                          if a in self.mesh.mesh_dim_names)
        if not fsdp_axes:
            return specs
        fsdp_size = self._axis_size(fsdp_axes)

        def add_fsdp(spec: tuple, shape):
            dims = _dims(shape)
            if math.prod(dims) < (1 << 20):  # leave small tensors alone
                return spec
            entries = list(spec) + [None] * (len(dims) - len(spec))
            # pick the largest dim not already sharded that divides evenly
            order = sorted(range(len(dims)), key=lambda i: -dims[i])
            for i in order:
                if entries[i] is None and dims[i] % fsdp_size == 0:
                    entries[i] = fsdp_axes if len(fsdp_axes) > 1 \
                        else fsdp_axes[0]
                    break
            while entries and entries[-1] is None:
                entries.pop()
            return tuple(entries)

        return tree_map(add_fsdp, specs, shape_tree)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the reference's ``jax.sharding.NamedSharding``).
    ``stacked``: the spec is one block's, for a leaf the JAX layout
    stacks (L, …) and the port keeps as one tensor a block."""
    mesh: Any
    spec: tuple
    stacked: bool = False

    @property
    def placements(self) -> tuple:
        return placements_for(self.spec, self.mesh)


def batch_spec(rules: ShardingRules, ndim: int = 2) -> tuple:
    """Spec for (batch, seq, ...) data tensors."""
    return rules.spec_for(("batch",) + (None,) * (ndim - 1))


def block_spec(spec: tuple) -> tuple:
    """A stacked (L, …) leaf's spec on one block's tensor: the layer
    entry dropped.  A spec that shards the layer dim has no per-block
    counterpart and raises (no registry config produces one)."""
    if spec and spec[0] is not None:
        raise ValueError(f"spec {spec} shards the stacked layer dim; the "
                         f"port keeps one tensor a block")
    return spec[1:]


def placements_for(spec: tuple, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: for each mesh dim,
    ``Shard(d)`` if tensor dim ``d``'s entry names it, else
    ``Replicate()``.  Two mesh axes on one tensor dim (``("pod",
    "data")`` on ``batch``) become ``Shard(d)`` on both mesh dims, which
    DTensor nests in mesh-dim order — pod outermost, as the reference's
    composed axis — the equivalent of a flattened (pod, data) dimension;
    an entry whose axes are not in mesh order raises."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names)
    where: dict[str, int] = {}
    for d, entry in enumerate(spec):
        axes = (entry,) if isinstance(entry, str) else tuple(entry or ())
        if list(axes) != sorted(axes, key=names.index):
            raise ValueError(f"spec entry {entry} is not in the mesh's axis "
                             f"order {names}")
        for a in axes:
            where[a] = d
    return tuple(Shard(where[a]) if a in where else Replicate()
                 for a in names)


# ------------------------------------------------------------- DTensors
def is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def batch_placements(mesh, batch_dim: int = 0,
                     rows: int | None = None) -> tuple:
    """Placements of an activation whose ``batch_dim`` (of ``rows``
    rows) is sharded over the data-parallel mesh axes and which is
    replicated over the rest; rows that do not divide over those axes
    stay whole (the ``batch`` rule's fallback)."""
    from torch.distributed.tensor import Replicate, Shard
    sizes = axis_sizes(mesh)
    dp = math.prod(sizes[a] for a in DP_AXES if a in sizes)
    split = rows is None or rows % dp == 0
    return tuple(Shard(batch_dim) if a in DP_AXES and split else Replicate()
                 for a in mesh.mesh_dim_names)


def local_slice(t, mesh, placements, coordinate=None):
    """This rank's shard of the full tensor (or numpy array) ``t`` under
    ``placements``: each ``Shard(d)`` narrows dim ``d`` to the rank's
    even chunk, mesh dims in order (so two mesh dims on one tensor dim
    nest as DTensor nests them).  A view; every sharded dim must divide
    evenly (the rules' fallbacks see to it)."""
    from torch.distributed.tensor import Shard
    coord = mesh.get_coordinate() if coordinate is None else coordinate
    for i, p in enumerate(placements):
        if not isinstance(p, Shard):
            continue
        n = mesh.size(i)
        size = t.shape[p.dim]
        if size % n:
            raise ValueError(f"dim {p.dim} of {tuple(t.shape)} does not "
                             f"divide over {n} ranks")
        step = size // n
        idx = [slice(None)] * t.ndim
        idx[p.dim] = slice(coord[i] * step, (coord[i] + 1) * step)
        t = t[tuple(idx)]
    return t


def distribute(t, mesh, placements):
    """A DTensor of the full tensor ``t`` (the same on every rank: drawn
    from one seed, or read from one file) from this rank's
    :func:`local_slice`, copied; no collective runs."""
    from torch.distributed.tensor import DTensor
    local = local_slice(t, mesh, placements).contiguous().clone()
    return DTensor.from_local(local, mesh, placements, run_check=False)
