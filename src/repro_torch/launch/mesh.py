"""Device-mesh factories over ``torch.distributed``.

Functions, not module-level constants: importing this module starts no
process group.  Every mesh is ``init_device_mesh`` over the default
process group, which must hold exactly as many ranks as the mesh:

* ``host_mesh`` is what this process has: ``(1, world_size)``; with no
  group yet it starts a one-rank group in process (NCCL for ``cuda``,
  gloo for ``cpu``) over a ``HashStore``, so no TCP and no network.
* ``make_production_mesh`` needs a 256- or 512-rank group.  Only the dry
  run makes one: ``fake_world`` starts the ``fake`` backend over
  ``FakeStore`` in a process of its own (the counterpart of the
  reference's ``--xla_force_host_platform_device_count=512``).  A
  process holds one default group, so a fake world and a real one never
  share a process.

Axis semantics:
  pod   — outer data-parallel axis across pods (gradient all-reduce and
          optimizer sharding cross the slowest links)
  data  — in-pod data parallelism / FSDP (params' embed dims sharded)
  model — tensor parallelism (vocab/heads/mlp/experts/ssm)
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh


def _mk(shape, axes, device_type: str):
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """(16, 16) ``("data", "model")``, or (2, 16, 16) ``("pod", "data",
    "model")`` with ``multi_pod``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mk(shape, axes, device_type)


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...] | None = None,
              device_type: str = "cuda"):
    """Elastic mesh factory: any (pods, data, model) shape.  1-sized
    leading axes are squeezed so the same code serves 1..N pods."""
    if axes is None:
        axes = ("pod", "data", "model")[-len(shape):]
    keep = [(s, a) for s, a in zip(shape, axes) if s > 1 or a == "model"]
    if not keep:
        keep = [(1, "data")]
    return _mk(tuple(s for s, _ in keep), tuple(a for _, a in keep),
               device_type)


def host_mesh(device="cuda"):
    """``(1, world_size)`` ``("data", "model")`` over the default group,
    started here as a one-rank group when none exists."""
    device_type = torch.device(device).type
    if not dist.is_initialized():
        if device_type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("host_mesh('cuda') needs a CUDA device; "
                               "pass device='cpu' for a gloo mesh")
        dist.init_process_group(
            "nccl" if device_type == "cuda" else "gloo",
            store=dist.HashStore(), rank=0, world_size=1)
    return _mk((1, dist.get_world_size()), ("data", "model"), device_type)


def fake_world(world_size: int) -> None:
    """Start the default group as ``world_size`` fake ranks (this
    process is rank 0): collectives return at once and move nothing."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a default process group already exists; a fake "
                           "world needs a process of its own")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
