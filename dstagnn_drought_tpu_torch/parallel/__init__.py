"""Multi-device training of the port over ``torch.distributed``.

Counterpart of ``dstagnn_drought_tpu/parallel``: one process is one rank,
one device of the ``('data', 'graph')`` mesh (:mod:`.mesh`); the
collectives with their conjugate backwards are in :mod:`.comm`; the
parameter and batch slices in :mod:`.sharding`; the node-partitioned ELL
convs in :mod:`.graph_partition` and the partitioned BELL convs, which
launch the fused BELL kernels on each rank's own tiles, in
:mod:`.bell_partition`.
"""
from dstagnn_drought_tpu_torch.parallel.mesh import factor_devices, make_mesh  # noqa: F401
from dstagnn_drought_tpu_torch.parallel.sharding import batch_sharding  # noqa: F401
