"""Production meshes — the counterpart of ``repro/launch/mesh.py``.

Single pod: 16×16 = 256 ranks, ("data", "model"). Multi-pod: 2×16×16 =
512 ranks, ("pod", "data", "model"); the "pod" axis is the WaterWise
migration/geo unit and the axis cross-pod gradient compression applies
to. Functions, never module-level constants, so importing this module
touches no process group.

``production_mesh_shape`` gives the names and sizes alone (what the dry
run reads: ``runtime/sharding.py`` resolves specs on any object with a
``.shape`` mapping). ``make_production_mesh`` returns a ``DeviceMesh`` and
needs a process group of exactly that many ranks; it raises otherwise.
"""
from __future__ import annotations

from repro_torch.runtime.sharding import MeshShape


def production_mesh_shape(*, multi_pod: bool = False) -> MeshShape:
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


def _device_type() -> str:
    import torch.distributed as dist
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_production_mesh(*, multi_pod: bool = False):
    """The production ``DeviceMesh`` over the live process group, which
    must have exactly 256 (512 with ``multi_pod``) ranks, on the cards
    under NCCL and on the CPU under gloo."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    shape = production_mesh_shape(multi_pod=multi_pod)
    world = dist.get_world_size() if dist.is_initialized() else 0
    if world != shape.size:
        raise RuntimeError(
            f"the production mesh {shape.shape} needs {shape.size} ranks; "
            f"the process group has {world or 'none'} (run the dry run, "
            f"launch/dryrun.py, to size it without ranks)")
    return init_device_mesh(_device_type(), shape.sizes,
                            mesh_dim_names=shape.axis_names)


def make_host_mesh(model: int = 1):
    """A ("data", "model") mesh over every rank of the live process group
    (tests, the smoke run), ``model`` ranks along "model"."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("make_host_mesh needs an initialised process "
                           "group (torch.distributed.init_process_group)")
    n = dist.get_world_size()
    if n % model:
        raise ValueError(f"{n} ranks do not split into model={model}")
    return init_device_mesh(_device_type(), (n // model, model),
                            mesh_dim_names=("data", "model"))

