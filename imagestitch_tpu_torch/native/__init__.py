"""The port's native host runtime (`imagestitch_tpu.native`): labeling,
flood fill, BK maxflow and the seam corridor's dual shortest path, built
with g++ at first use (see `ccl`)."""

from imagestitch_tpu_torch.native.ccl import (band_dijkstra,
                                              component_stats,
                                              connected_components,
                                              flood_fill, grid_maxflow,
                                              have_native)

__all__ = ["band_dijkstra", "component_stats", "connected_components",
           "flood_fill", "grid_maxflow", "have_native"]
