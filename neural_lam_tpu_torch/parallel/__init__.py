"""Data parallelism across processes and the grid spatial scheme, on
torch.distributed (one process per device; see distributed.py)."""

from .mesh import make_mesh, replicate  # noqa: F401
