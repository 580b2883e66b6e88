"""Median over the traced window's requests of the mean wall ms of one
Levenberg-Marquardt step of the bundle adjustment: a request's summed
`lm_step` stages (the Jacobian, the solve and the stopping test's read on
the host) over its `lm_iters` counter, the steps its adjustment ran.
Nothing to read where no request ran a step."""

import statistics


def read(ctx):
    vals = [r.metrics["lm_step"] / r.metrics["lm_iters"]
            for r in ctx.requests
            if r.ok and r.metrics.get("lm_iters") and "lm_step" in r.metrics]
    return float(statistics.median(vals)) if vals else None
