"""The neighbor engine: cell-list Verlet lists and k-nearest neighbors."""

from .neighbor import Neighbor  # noqa: F401
from .knn import NearestNeighbor  # noqa: F401
