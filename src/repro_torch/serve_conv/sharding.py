"""Multi-device wave sharding for the lane-batched serve engine.

A packed wave is ``[B, H, W, C]`` images that become ``B*H*W`` pixel
rows of the plane carrier — requests occupy disjoint row slabs (lanes
carry channels; see ``lanes.py``).  Sharding a wave therefore splits
the batch axis over a list of devices: each device encodes, runs, and
decodes its own slab of whole images through the same resident graph,
on a replica of the graph's live weights.  No cross-device
communication exists anywhere in the graph body (every plane op is
row-local to an image), so the only gather is the concatenation of the
shards' outputs, in order, on the first device.

Bit-exactness is inherited from the lane-packing argument: an image's
rows compute identical codes whether its slab is the whole wave or a
per-device shard, and each shard still performs exactly one encode and
one decode.  ``tests/test_torch_serve_conv.py`` asserts the sharded
wave equals the unsharded one bit-for-bit over ``["cpu", "cpu"]``; on
one H100 the mesh is the degenerate one-device split.
"""
from __future__ import annotations

import torch

from repro_torch._build import resolve_device
from repro_torch.kernels.conv2d_bitslice.network import NetworkGraph
from repro_torch.serve_conv.cache import build_kernels_for
from repro_torch.serve_conv.errors import WaveShardingError


def wave_mesh(devices=None) -> list[torch.device]:
    """The wave's devices: every visible CUDA device by default, the
    first ``devices`` of them for an int, or the given list.  A CUDA
    device on a machine without a card raises."""
    if devices is None or isinstance(devices, int):
        n = devices or torch.cuda.device_count()
        if n < 1:
            resolve_device("cuda")          # raises: no card
        devices = [f"cuda:{i}" for i in range(n)]
    return [resolve_device(d) for d in devices]


def mesh_size(mesh) -> int:
    return len(mesh)


def wave_sharded_runner(graph: NetworkGraph, mesh=None):
    """A wave entrypoint ``images [B,H,W,C] (numpy or tensor) ->
    [B,Ho,Wo,M]`` f32 on ``mesh[0]`` that splits the batch axis into
    one equal shard a device, runs each on a replica of the graph's live
    weights there, and concatenates the shards in order.  ``B`` must
    divide by the mesh size (the engine guarantees this by scaling its
    batch buckets to multiples of it).  Not synchronised: the caller
    waits for every device of the mesh."""
    mesh = wave_mesh(mesh)
    n = mesh_size(mesh)
    build_kernels_for(graph, mesh)
    fn = graph._resident_fn
    replicas = [{name: w.to(d) for name, w in graph._live_weights.items()}
                for d in mesh]

    def runner(images):
        images = torch.as_tensor(images, dtype=torch.float32)
        if images.shape[0] % n:
            raise WaveShardingError(
                f"wave batch {images.shape[0]} does not divide over "
                f"the {n}-device wave mesh")
        shards = images.chunk(n)
        outs = [fn(s.to(d), w) for s, d, w in zip(shards, mesh, replicas)]
        return torch.cat([o.to(mesh[0]) for o in outs])

    return runner
