"""A cell's ranks as its driver sees them: which one this process is, how
many there are, and the few collectives the drivers need to keep them in
step (set-up and the window start and end at a barrier; the window ends
on the same step everywhere). A cell on one chip has one rank and no
process group: every call is then a no-op or its own answer.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Optional


@dataclass
class Ranks:
    rank: int = 0
    world: int = 1
    device: Any = None          # this rank's device (its collectives' tensors live there)

    def barrier(self) -> None:
        if self.world > 1:
            import torch.distributed as dist

            if self.device is not None and self.device.type == "cuda":
                dist.barrier(device_ids=[self.device.index])
            else:
                dist.barrier()

    def any(self, flag: bool) -> bool:
        """Whether ``flag`` holds on any rank (every rank must ask)."""
        if self.world == 1:
            return flag
        import torch
        import torch.distributed as dist

        t = torch.tensor([1 if flag else 0], dtype=torch.int32, device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return bool(t.item())

    def gather(self, obj) -> Optional[List]:
        """Every rank's ``obj`` in rank order on rank 0, None on the others."""
        if self.world == 1:
            return [obj]
        import torch.distributed as dist

        out = [None] * self.world if self.rank == 0 else None
        dist.gather_object(obj, out, dst=0)
        return out
