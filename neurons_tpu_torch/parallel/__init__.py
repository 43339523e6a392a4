"""Data-parallel training over torch.distributed: the process group
(`distributed`) and the loops' layout and batch feed (`mesh`).
Counterpart of neurons_tpu/parallel/."""

from neurons_tpu_torch.parallel.mesh import (Mesh, create_mesh, local_rows,
                                             prefetch_to_device, replicate,
                                             shard_batch)
