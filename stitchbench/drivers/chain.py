"""The `chain` driver: one client, `stitch_chain(views, cfg, seed=k)` per
request on a pool item's views in sequence.

A traffic mix names it as `"driver": "chain"`."""

from stitchbench.harness import ClosedLoop


class Driver(ClosedLoop):
    """`stitch_chain(views, cfg, seed=k)` per request: N views in
    sequence, consecutive (and skip) pairs; a stitch with a pair left
    without a homography or a view out of the panorama fails."""

    def call(self, item, seed):
        pano, m = self.ist.stitch_chain(list(self.pool[item].views),
                                        self.cfg, seed=seed,
                                        device=self.device)
        ok = bool(all(m["h_valid"])) and bool(all(m["reachable"]))
        return pano, m["focal"], m, ok
