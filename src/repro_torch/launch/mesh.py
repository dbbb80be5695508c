"""Meshes (port of ``repro.launch.mesh``): the serving plane's device
list, a mesh's names and sizes without devices (:class:`MeshShape`, what
the sharding rules read), the production shapes, the host mesh over
the initialised process group and a rank's place along the batch axes
(:func:`dp_rank`, what the mesh steps slice the batch by) and along
``model`` (:func:`model_rank`, the KV heads a mesh serving step attends).

A FUNCTION builds each mesh, never an import: importing this module
touches no device and no process group.  A ``DeviceMesh`` of the
production shapes needs one card per rank (256 or 512) and is not built
here; :func:`production_mesh_shape` gives its names and sizes, which is
all the rules of ``launch.sharding`` read.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes, no devices: the interface the
    sharding rules read, as JAX's ``AbstractMesh`` gives it."""
    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]

    def __post_init__(self):
        names, sizes = tuple(self.axis_names), tuple(map(int, self.sizes))
        if len(names) != len(sizes) or len(set(names)) != len(names):
            raise ValueError(f"a mesh of axes {names} and sizes {sizes}")
        object.__setattr__(self, "axis_names", names)
        object.__setattr__(self, "sizes", sizes)

    @property
    def shape(self) -> dict[str, int]:
        """Axis name -> size, in the mesh's order."""
        return dict(zip(self.axis_names, self.sizes))

    @classmethod
    def of(cls, mesh) -> "MeshShape":
        """The names and sizes of a ``MeshShape`` or of a
        ``torch.distributed.device_mesh.DeviceMesh`` (its
        ``mesh_dim_names`` and ``shape``)."""
        if isinstance(mesh, MeshShape):
            return mesh
        names = mesh.mesh_dim_names
        if names is None:
            raise ValueError("the DeviceMesh has no mesh_dim_names: the "
                             "sharding rules read axes by name")
        return cls(tuple(names), tuple(mesh.shape))


def production_mesh_shape(*, multi_pod: bool = False) -> MeshShape:
    """16 x 16 = 256 cards per pod over ``("data", "model")``; 2 pods =
    512 cards over ``("pod", "data", "model")`` (the shapes of JAX's
    ``make_production_mesh``)."""
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


def make_host_mesh():
    """Every rank of the initialised default process group, as a 1-D
    ``("data",)`` ``DeviceMesh``: on the cards (``nccl``) one rank a
    card, on the CPU (``gloo``) one rank a process.  Raises when no group
    is initialised: it never starts one."""
    from torch.distributed.device_mesh import DeviceMesh

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "make_host_mesh: no process group is initialised; call "
            "torch.distributed.init_process_group first (nccl with one "
            "rank a card, or gloo for CPU ranks)")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.arange(dist.get_world_size()),
                      mesh_dim_names=("data",))


def serve_devices(n: int | None = None) -> list[torch.device]:
    """The first ``n`` CUDA devices for the data-parallel serving plane
    (None = all of them).  Raises when fewer exist (none, without a card).

    The serving tier replicates the model per replica and shards the
    BATCH, so it wants a flat device list.  To run several replicas on one
    card, repeat its device (``[torch.device("cuda:0")] * 4``): each
    replica gets its own CUDA stream.
    """
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    want = have if n is None else n
    if want < 1 or want > have:
        raise ValueError(
            f"serve_devices({n}): only {have} CUDA devices exist; repeat a "
            "device to run several replicas on one card, or pass CPU "
            "devices to run the plain path")
    return [torch.device("cuda", i) for i in range(want)]


def dp_axes(mesh) -> tuple[str, ...]:
    """Axes carrying the batch: ('pod', 'data') multi-pod, ('data',) else
    (a ``MeshShape`` or a ``DeviceMesh``)."""
    names = MeshShape.of(mesh).axis_names
    return tuple(a for a in ("pod", "data") if a in names)


def dp_rank(device_mesh) -> tuple[int, int]:
    """``(r, n)``: this rank's coordinate along the dp axes of a
    ``DeviceMesh`` (``pod`` the major factor, as ``sharding.batch_spec``
    splits the batch) and the product ``n`` of their sizes.  Ranks that
    differ only along ``model`` share ``r``."""
    coord = device_mesh.get_coordinate()
    if coord is None:
        raise ValueError("this rank is not in the mesh")
    at = dict(zip(device_mesh.mesh_dim_names, coord))
    size = MeshShape.of(device_mesh).shape
    r, n = 0, 1
    for a in dp_axes(device_mesh):
        r, n = r * size[a] + at[a], n * size[a]
    return r, n


def model_axis_size(mesh) -> int:
    """The ``model`` axis's size, 1 where the mesh has none."""
    return MeshShape.of(mesh).shape.get("model", 1)


def model_rank(device_mesh) -> tuple[int, int]:
    """``(m, M)``: this rank's coordinate along the ``model`` axis of a
    ``DeviceMesh`` and the axis's size; ``(0, 1)`` where the mesh has no
    ``model`` axis.  Ranks that differ only along the dp axes share
    ``m``."""
    coord = device_mesh.get_coordinate()
    if coord is None:
        raise ValueError("this rank is not in the mesh")
    at = dict(zip(device_mesh.mesh_dim_names, coord))
    return at.get("model", 0), model_axis_size(device_mesh)
