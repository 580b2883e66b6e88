"""The `pair` driver: one client, `stitch_pair(a, b, cfg, seed=k)` per
request on a pool item's two views.

A traffic mix names it as `"driver": "pair"`."""

from stitchbench.harness import ClosedLoop


class Driver(ClosedLoop):
    """`stitch_pair(a, b, cfg, seed=k)` per request."""

    def call(self, item, seed):
        a, b = self.pool[item].views
        pano, m = self.ist.stitch_pair(a, b, self.cfg, seed=seed,
                                       device=self.device)
        return pano, m["focal"], m, bool(m["h_valid"])
