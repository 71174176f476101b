"""Shard-aware solid geometry: composable primitives rasterized in
global coordinates (see ``primitives`` and ``raster``)."""
from repro_torch.geometry.primitives import (Disk, Empty, Geometry, HalfPlane,
                                       Intersection, ObstacleArray,
                                       PorousMedium, Rectangle, Union,
                                       channel_walls, doubled_x)
from repro_torch.geometry.raster import (node_window, pack_mask, rasterize,
                                   solid_words)

__all__ = [
    "Disk", "Empty", "Geometry", "HalfPlane", "Intersection",
    "ObstacleArray", "PorousMedium", "Rectangle", "Union",
    "channel_walls", "doubled_x",
    "node_window", "pack_mask", "rasterize", "solid_words",
]
