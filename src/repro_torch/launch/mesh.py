"""Device meshes: the port of the JAX package's ``launch/mesh.py``.

Functions, not module-level constants: importing this module touches no
process group.  A mesh needs the default ``torch.distributed`` group to
hold as many ranks as the mesh has devices:

- :func:`make_host_mesh` over the ranks there are (gloo on the CPU, NCCL
  on the card), as the reference's mesh over the local devices;
- :func:`make_production_mesh`, the reference's 16 x 16 ("data",
  "model") single pod or 2 x 16 x 16 ("pod", "data", "model"), over a
  world of 256 or 512 ranks.  On one machine that world is a placeholder:
  :func:`placeholder_world` starts the ``"fake"`` backend over a
  ``FakeStore`` as rank 0 — the counterpart of the reference's forced
  host device count — whose collectives move no data.  The H100 enters
  the dry run through ``launch/roofline.py``'s constants, not through the
  mesh.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.parallel.sharding import axis_sizes

PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


def placeholder_world(world_size: int) -> None:
    """Make the default process group a placeholder of ``world_size``
    ranks with this process as rank 0: the ``"fake"`` backend over a
    ``FakeStore`` (``torch.testing._internal.distributed.fake_pg``), whose
    collectives return at once and leave their outputs unwritten.  An
    existing placeholder of another size is replaced; a real group
    raises."""
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("a real process group is running; a "
                               "placeholder world needs a process of its own")
        if dist.get_world_size() == world_size:
            return
        dist.destroy_process_group()
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def _device_type(device) -> str:
    if device is None:
        return "cuda" if torch.cuda.is_available() else "cpu"
    return torch.device(device).type


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...], device=None):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the default
    group's ranks, on ``device``'s type (CUDA when there is a card)."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(_device_type(device), tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """16x16 ("data","model") single pod; 2x16x16 ("pod","data","model")
    for the 2-pod / 512-chip configuration.  The default group must hold
    256 or 512 ranks (:func:`placeholder_world`)."""
    shape, axes = PRODUCTION_SHAPES[multi_pod]
    return make_mesh(shape, axes, device)


def host_mesh_shape(data: int, model: int, n: int) -> tuple[int, int]:
    """``(data, model)`` clamped to ``n`` devices, as the reference's
    :func:`make_host_mesh` clamps them."""
    data = min(data, n)
    return data, max(1, min(model, n // data))


def make_host_mesh(data: int = 1, model: int = 1, device=None):
    """A ("data", "model") mesh over the default group's ranks, clamped
    to the world size as the reference clamps it to the local devices
    (tests, examples, ``launch/train.py --mesh``)."""
    data, model = host_mesh_shape(data, model, dist.get_world_size())
    return make_mesh((data, model), ("data", "model"), device)


mesh_axis_sizes = axis_sizes
