"""Multi-process bootstrap: the lease-queue worker identity.

Counterpart of reve_tpu/parallel/distributed.py.  Processes on one host
or several derive a stable worker id for the file-lease segment queue
(pipeline/leases.py) over a shared workspace from the launcher's
environment (RANK, WORLD_SIZE, LOCAL_RANK, as torchrun sets them).  No
collective runs on the segment path: coordination is the lease files
alone, so no process group is joined and no process waits for another
to start.

Usage in each process, e.g. under `torchrun --nproc-per-node 2`:

    from reve_tpu_torch.parallel import distributed
    ident = distributed.initialize()       # RANK, WORLD_SIZE, ... env
    # python -m reve_tpu_torch ... --device {ident.local_rank}
    #     --shard-worker {ident.worker_id}

Nothing here picks a device: `local_rank` is for the launcher or the
caller to pass on as `--device`.
"""

from __future__ import annotations

import dataclasses
import os
import socket

#: the launcher's environment read here (torchrun sets all three)
ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK")


@dataclasses.dataclass(frozen=True)
class Identity:
    worker_id: str
    process_index: int
    process_count: int
    #: LOCAL_RANK (the process's index on its host), 0 without it
    local_rank: int = 0


def initialize() -> Identity:
    """This process's identity from RANK, WORLD_SIZE and LOCAL_RANK
    (defaults 0, 1 and 0: the single-process identity, so the same code
    runs on one host and on many)."""
    index = int(os.environ.get("RANK", "0"))
    return Identity(worker_id=f"{socket.gethostname()}-p{index}",
                    process_index=index,
                    process_count=int(os.environ.get("WORLD_SIZE", "1")),
                    local_rank=int(os.environ.get("LOCAL_RANK", "0")))
