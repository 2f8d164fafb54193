"""Several devices: the data-axis mesh, placement on it, and the multi-process glue.

Counterpart of ``evi_rag_tpu/parallel``.  JAX runs one program over every
device of a mesh; PyTorch runs one program per device.  So the single-
controller paths (the sharded pooled query and index build, kNN, the
data-parallel serve) loop over the mesh's devices in one process, and
data-parallel training runs one process per device (``torchrun`` or the
``EVI_*`` variables), each computing its shards of the stacked batch, with
the gradients all-reduced (``multihost``).
"""

from evi_rag_tpu_torch.parallel.mesh import (
    Mesh,
    make_mesh,
    per_device,
    place_replicated,
    shard_batch,
)

__all__ = ["Mesh", "make_mesh", "per_device", "place_replicated", "shard_batch"]
