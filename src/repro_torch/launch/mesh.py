"""Back-compat shim: mesh construction lives in ``repro_torch.runtime.
mesh``, as in the reference.  Touches no process group on import."""
from __future__ import annotations

from ..runtime.mesh import (  # noqa: F401
    make_local_mesh,
    make_mesh,
    make_production_mesh,
)
