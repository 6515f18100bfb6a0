"""Device-mesh parallelism and training collectives for the port: the
counterpart of ``client_tpu/parallel/``.

The reference runs SPMD over ``jax.sharding.Mesh``, with XLA inserting the
collectives. The port runs one process per device in a
``torch.distributed`` group (NCCL on the card, gloo on the CPU), a
``DeviceMesh`` names its axes (``mesh.py``), and the model calls the
collectives itself (``collectives.py``); ``pipeline.py`` is the GPipe
schedule and ``dryrun.py`` the three-step multi-device check.
"""

from client_tpu_torch.parallel.collectives import run_ranks
from client_tpu_torch.parallel.mesh import (
    MESH_AXES,
    factor_devices,
    logical_to_physical,
    make_mesh,
)
from client_tpu_torch.parallel.pipeline import pipeline_forward

__all__ = [
    "MESH_AXES",
    "factor_devices",
    "make_mesh",
    "logical_to_physical",
    "pipeline_forward",
    "run_ranks",
]
