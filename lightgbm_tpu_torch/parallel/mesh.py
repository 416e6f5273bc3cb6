"""The process group as the data-parallel learner sees it.

Port of lightgbm_tpu/parallel/mesh.py. The JAX package's mesh is a
jax.sharding.Mesh over every device of the process group, rows sharded
over its 'data' axis. Here one process drives one device, so the mesh is
the group itself: its world size, this process's rank, its device and the
axis name, and the row-block arithmetic of the JAX data-parallel learner
(lightgbm_tpu/parallel/learners.py:742-743): ``local_n = ceil(n / W)``
rows per rank, rank r owning rows [r * local_n, min((r + 1) * local_n,
n)), its block padded to local_n rows that carry weight 0.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..distributed import bootstrap


class Mesh(NamedTuple):
    """A 1-D group: `size` ranks along `axis_name`, this process `rank`
    on `device`."""
    size: int
    rank: int
    device: torch.device
    axis_name: str = "data"

    def local_n(self, num_data: int) -> int:
        """Rows per rank: ceil(num_data / size)."""
        return -(-int(num_data) // self.size)

    def row_block(self, num_data: int) -> Tuple[int, int]:
        """[begin, end) of this rank's real rows (end - begin may be less
        than local_n on the last ranks, even 0)."""
        local_n = self.local_n(num_data)
        begin = min(self.rank * local_n, int(num_data))
        return begin, min(begin + local_n, int(num_data))


def make_mesh(device="cpu", axis_name: str = "data",
              size: Optional[int] = None, rank: Optional[int] = None) -> Mesh:
    """The group's Mesh with this process on `device` (size and rank from
    the process group unless given: a test's stand-in group)."""
    return Mesh(bootstrap.process_count() if size is None else int(size),
                bootstrap.rank() if rank is None else int(rank),
                torch.device(device), axis_name)
