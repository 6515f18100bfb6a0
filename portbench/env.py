"""Where a run may write: the checkout, ``HOME``, ``XDG_CACHE_HOME`` and
``TMPDIR``. Build and kernel caches go to fixed directories inside the
checkout, so that only a checkout's first run builds (the port's own nvcc
builds already live in ``client_tpu_torch/_build/``)."""

from __future__ import annotations

import os
import tempfile
from pathlib import Path


def contain(checkout: Path) -> None:
    """Point every cache the run could fill into the checkout, and the
    POSIX staging buffers behind the port's CUDA shared-memory regions
    (``/dev/shm`` by default, with no public setting) into ``TMPDIR``."""
    cache = checkout / ".portbench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ.setdefault("USE_FLAX", "0")
    from client_tpu_torch.utils import shared_memory

    staging = Path(tempfile.gettempdir()) / "portbench-shm"
    staging.mkdir(parents=True, exist_ok=True)
    shared_memory._SHM_DIR = str(staging)
