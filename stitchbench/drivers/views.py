"""The `views` driver: one client, `Stitcher(cfg).stitch(views, seed=k)` per
request on a pool item's views.

A traffic mix names it as `"driver": "views"`."""

from stitchbench.harness import ClosedLoop


class Driver(ClosedLoop):
    """`Stitcher(cfg).stitch(views, seed=k)` per request; a stitch that
    leaves a view out of the panorama fails."""

    def prepare(self):
        self.stitcher = self.ist.Stitcher(self.cfg, device=self.device)

    def call(self, item, seed):
        pano, m = self.stitcher.stitch(list(self.pool[item].views), seed=seed)
        return pano, m["focal"], m, bool(all(m["reachable"]))
