"""Architecture configs: importing the package registers the ported
archs (the four recsys models); the paper's own bandit configuration is
the plain module ``distclub_paper``."""
from . import bert4rec, dcn_v2, mind, sasrec  # noqa: F401
from .base import REGISTRY, ArchSpec, ShapeCell, all_cells, get  # noqa: F401
