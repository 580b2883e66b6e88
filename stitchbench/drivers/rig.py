"""The `rig` driver: a fixed rig, calibrated once in set-up, then one
client composing frame sets back to back.

A traffic mix names it as `"driver": "rig"`."""

from stitchbench.harness import ClosedLoop


class Driver(ClosedLoop):
    """A fixed rig: `StreamStitcher.calibrate` once in set-up on pool item
    0, then `compose` of a frame set per request (pool items 1 on). The
    rig's registration is the calibration's, so its focal is every
    compose's."""

    def prepare(self):
        self.stream = self.ist.StreamStitcher(self.cfg, device=self.device)
        _, m = self.stream.calibrate(list(self.pool[0].views),
                                     seed=int(self.seeds.integers(1 << 62)))
        self.calib_focal = m["focal"]
        self.calib_ok = bool(all(m["reachable"]))

    def one(self, item):
        # item 0 is the calibration frame set; composes take 1..
        return super().one(1 + item % (len(self.pool) - 1))

    def call(self, item, seed):
        pano = self.stream.compose(list(self.pool[item].views))
        return pano, self.calib_focal, dict(self.stream.stages_ms), \
            self.calib_ok
