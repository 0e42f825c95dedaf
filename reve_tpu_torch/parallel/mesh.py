"""The engine's device mesh: frames split over several CUDA devices.

Counterpart of reve_tpu/parallel/mesh.py on the serving path.  The JAX
package's CLI and API build a 1-axis ("dp",) mesh and shard each batch
of frames over it, params replicated, outputs gathered, no collective
(the ncnn engine's multi-GPU `-g 0,1,...`).  Here a `Mesh` is that axis:
a tuple of torch devices, each entry one engine replica with its own
params and CUDA stream (pipeline/engine.py).  An entry may repeat a
device: then two replicas share it, each planning for its part of the
device's memory (how the CPU tests run `Mesh((cpu,) * k)` and a one-card
host runs two replicas on cuda:0).

The JAX package's 'sp' and 'tp' axes, its device factoring and its
parameter sharding serve its mesh trainer: they come with the ROADMAP.md
item "Multi-GPU training".
"""

from __future__ import annotations

from typing import Sequence

from reve_tpu_torch import device as device_mod


class Mesh:
    """A data-parallel axis "dp" over `devices` (torch devices, or what
    device.resolve_device takes): `shape == {"dp": len(devices)}`.  A
    CUDA entry without CUDA raises NoCudaDeviceError, as the engine's
    one device does."""

    axis_names = ("dp",)

    def __init__(self, devices: Sequence[device_mod.DeviceLike]):
        devices = tuple(device_mod.resolve_device(d) for d in devices)
        if not devices:
            raise ValueError("a mesh needs at least one device")
        if len({d.type for d in devices}) > 1:
            raise ValueError(f"a mesh's devices are all CUDA devices or "
                             f"all the CPU, got {devices}")
        self.devices = devices

    @property
    def shape(self) -> dict:
        return {"dp": len(self.devices)}

    def __len__(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return f"Mesh(dp={len(self.devices)}: " \
            f"{', '.join(map(str, self.devices))})"

    def __str__(self) -> str:
        return ",".join(map(str, self.devices))

