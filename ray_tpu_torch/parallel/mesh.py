"""Device mesh construction and sharding rules over torch process groups.

Counterpart of ``ray_tpu/parallel/mesh.py``: parallelism is a named mesh
axis, and a strategy is a set of rules mapping a tensor's logical axes to
mesh axes. The axes and rules are the JAX package's:

- ``dp``   data parallel (batch dim; gradients summed over dp)
- ``fsdp`` fully-sharded data parallel (params sharded over fsdp and gathered
  where used; the batch also sharded)
- ``tp``   tensor parallel (hidden/heads/vocab dims)
- ``pp``   pipeline parallel (the layers dim)
- ``sp``   sequence parallel (sequence dim; ring attention or Ulysses)
- ``ep``   expert parallel (experts dim)

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the default
process group, one rank per device. It is built over the axes of size > 1
only, in ``AXIS_ORDER`` with tp innermost, as the JAX package reshapes its
devices (one dimension named ``dp`` when every axis is 1); ``Mesh`` wraps it
so that ``mesh.shape[name]`` reads all six names, 1 where an axis is absent.
A DeviceMesh with all six names, most of size 1, is not built: on gloo,
``init_device_mesh`` of a six-dim mesh did not return within 40 s where the
same world's two- to four-dim meshes built in under half a second.

``logical_to_spec`` keeps the JAX package's ``PartitionSpec`` result;
``spec_to_placements`` turns one into DTensor placements (``Shard(d)`` or
``Replicate()``, one per mesh dimension).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

AXIS_ORDER = ("pp", "dp", "fsdp", "sp", "ep", "tp")


@dataclass(frozen=True)
class MeshConfig:
    """Declarative mesh shape. -1 on at most one axis = fill with remaining devices."""

    dp: int = 1
    fsdp: int = 1
    tp: int = 1
    pp: int = 1
    sp: int = 1
    ep: int = 1

    def axis_sizes(self) -> dict[str, int]:
        return {a: getattr(self, a) for a in AXIS_ORDER}

    def resolve(self, num_devices: int) -> dict[str, int]:
        sizes = self.axis_sizes()
        unknown = [a for a, s in sizes.items() if s == -1]
        if len(unknown) > 1:
            raise ValueError("at most one mesh axis may be -1")
        known = math.prod(s for s in sizes.values() if s != -1)
        if unknown:
            if num_devices % known:
                raise ValueError(
                    f"{num_devices} devices not divisible by fixed axes product {known}"
                )
            sizes[unknown[0]] = num_devices // known
        if math.prod(sizes.values()) != num_devices:
            raise ValueError(
                f"mesh {sizes} does not cover {num_devices} devices"
            )
        return sizes


class Mesh:
    """A DeviceMesh over the live axes (size > 1), readable by every name of
    ``AXIS_ORDER``: ``shape[name]`` (1 for an absent axis), ``group(name)``
    (the axis's process group; None at size 1) and ``index(name)`` (this
    rank's coordinate on the axis)."""

    def __init__(self, device_mesh, sizes: dict[str, int]):
        self.device_mesh = device_mesh
        self.shape = {a: sizes[a] for a in AXIS_ORDER}
        self.dim_names = tuple(device_mesh.mesh_dim_names)
        self.device_type = device_mesh.device_type

    def group(self, name: str):
        return None if self.shape[name] == 1 else self.device_mesh.get_group(name)

    def index(self, name: str) -> int:
        return 0 if self.shape[name] == 1 else self.device_mesh.get_local_rank(name)

    @property
    def axes(self) -> dict[str, int]:
        """The DeviceMesh's own dimensions: the live axes (``{"dp": 1}``
        when every axis is 1)."""
        return dict(zip(self.dim_names, self.device_mesh.shape))

    def __repr__(self) -> str:
        return f"Mesh({self.axes}, {self.device_type})"


_BACKEND_DEVICE = {"nccl": "cuda", "gloo": "cpu"}


def _default_device_type() -> str:
    """The device the default process group's backend moves: ``nccl`` ->
    "cuda", ``gloo`` -> "cpu". Never chosen from whether a card is present:
    a gloo world on a box with a card stays on the CPU, and an nccl world
    never falls back to it."""
    import torch.distributed as dist

    backend = str(dist.get_backend()).lower()
    if backend not in _BACKEND_DEVICE:
        raise ValueError(f"device_type=None needs an nccl or gloo process group, not {backend!r}; "
                         "pass device_type explicitly")
    return _BACKEND_DEVICE[backend]


def _build(sizes: dict[str, int], device_type: str | None) -> Mesh:
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("a mesh needs torch.distributed's default process group: call "
                           "torch.distributed.init_process_group first")
    world = dist.get_world_size()
    if math.prod(sizes.values()) != world:
        raise ValueError(f"mesh {sizes} does not cover the process group's {world} ranks")
    names = tuple(a for a in AXIS_ORDER if sizes[a] > 1) or ("dp",)
    shape = tuple(sizes[a] for a in names)
    dm = init_device_mesh(device_type or _default_device_type(), shape, mesh_dim_names=names)
    return Mesh(dm, sizes)


def create_mesh(config: MeshConfig | None = None, device_type: str | None = None, **axis_sizes) -> Mesh:
    """A mesh over every rank of the default process group (one device per
    rank). ``device_type=None`` takes the device from the group's backend:
    "cuda" for nccl, "cpu" for gloo; any other backend raises."""
    import torch.distributed as dist

    if config is None:
        config = MeshConfig(**axis_sizes)
    world = dist.get_world_size() if dist.is_initialized() else 1
    return _build(config.resolve(world), device_type)


def single_axis_mesh(axis: str = "dp", device_type: str | None = None) -> Mesh:
    import torch.distributed as dist

    world = dist.get_world_size() if dist.is_initialized() else 1
    return _build({a: world if a == axis else 1 for a in AXIS_ORDER}, device_type)


# ---------------------------------------------------------------------------
# Logical-axis sharding rules
# ---------------------------------------------------------------------------

# Default rules for transformer-family models (models/transformer.py
# param_logical_axes names params with these logical names).
DEFAULT_RULES: dict[str, tuple] = {
    "batch": ("dp", "fsdp"),
    "seq": ("sp",),
    "embed": ("fsdp",),
    "mlp": ("tp",),
    "heads": ("tp",),
    "kv": (),
    "vocab": ("tp",),
    "layers": ("pp",),
    "expert": ("ep",),
}


class PartitionSpec(tuple):
    """Per tensor dim: None (not sharded), a mesh axis name, or a tuple of
    names (sharded over each, the first outermost) — jax's PartitionSpec."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


def logical_to_spec(logical_axes: tuple, rules: dict | None = None) -> PartitionSpec:
    """('batch','seq','embed') -> PartitionSpec(('dp','fsdp'), 'sp', 'fsdp')."""
    rules = rules or DEFAULT_RULES
    out = []
    for name in logical_axes:
        mapped = rules.get(name, ())
        if isinstance(mapped, str):
            mapped = (mapped,)
        if len(mapped) == 0:
            out.append(None)
        elif len(mapped) == 1:
            out.append(mapped[0])
        else:
            out.append(tuple(mapped))
    return PartitionSpec(*out)


def spec_to_placements(spec, mesh: Mesh, ndim: int) -> tuple:
    """DTensor placements of a tensor of ``ndim`` dims laid out by ``spec``
    on ``mesh``: ``Shard(d)`` on each mesh dimension that a tensor dim d
    names, ``Replicate()`` on the others. Axes of size 1 (absent from the
    DeviceMesh) are ignored. A tensor dim named by two mesh axes is sharded
    over both, the first outermost, which must be their order in
    ``AXIS_ORDER`` (DTensor nests shards in mesh-dimension order)."""
    from torch.distributed.tensor import Replicate, Shard

    if len(spec) > ndim:
        raise ValueError(f"spec {spec} has more entries than the tensor's {ndim} dims")
    placements = {name: Replicate() for name in mesh.dim_names}
    for d, entry in enumerate(spec):
        axes = (entry,) if isinstance(entry, str) else tuple(entry or ())
        if [AXIS_ORDER.index(a) for a in axes] != sorted(AXIS_ORDER.index(a) for a in axes):
            raise ValueError(f"dim {d} of {spec}: axes {axes} out of mesh order {AXIS_ORDER}")
        for a in axes:
            if mesh.shape[a] > 1:
                if not isinstance(placements[a], Replicate):
                    raise ValueError(f"mesh axis {a!r} shards two dims of {spec}")
                placements[a] = Shard(d)
    return tuple(placements[name] for name in mesh.dim_names)


def placements_keeping(t, mesh: Mesh, dims: tuple, **fixed) -> list:
    """DTensor ``t``'s placements with a ``Shard(d)`` kept for d in ``dims``
    and every other placement (shards of other dims, partial sums) made
    ``Replicate()``; ``fixed`` sets the placement of named axes."""
    from torch.distributed.tensor import Replicate, Shard

    return [fixed[n] if n in fixed else (p if isinstance(p, Shard) and p.dim in dims else Replicate())
            for n, p in zip(mesh.dim_names, t.placements)]


def _tree_map(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def shard_pytree(tree, mesh: Mesh, spec_fn):
    """``distribute_tensor`` each leaf of a nested dict, laid out by
    ``spec_fn(path, leaf)`` (path: the tuple of dict keys). Every rank passes
    the same values; rank 0's are scattered. A leaf that requires grad stays
    a leaf that requires grad."""
    from torch.distributed.tensor import distribute_tensor

    def place(path, leaf):
        placed = distribute_tensor(leaf.detach(), mesh.device_mesh,
                                   spec_to_placements(spec_fn(path, leaf), mesh, leaf.dim()))
        return placed.requires_grad_(leaf.requires_grad)

    return _tree_map(place, tree)


def replicate_pytree(tree, mesh: Mesh):
    return shard_pytree(tree, mesh, lambda _path, _leaf: PartitionSpec())
