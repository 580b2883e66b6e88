"""Median over the traced window's serving dispatches of one of the
seconds `tools.serve_demo.serve` records per dispatch, in ms."""

import statistics


def median_dispatch(ctx, key: str):
    per = {r.metrics["dispatch"]: r.metrics[key] for r in ctx.requests
           if "dispatch" in r.metrics}
    return float(statistics.median(per.values())) * 1e3 if per else None
