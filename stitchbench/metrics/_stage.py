"""Median over the traced window's requests of a stage's wall ms, as the
program's StageTimer returns it in the entry's metrics."""

import statistics


def median_stage(ctx, key: str, scale: float = 1.0):
    vals = [r.metrics[key] * scale for r in ctx.requests
            if r.ok and key in r.metrics]
    return float(statistics.median(vals)) if vals else None
