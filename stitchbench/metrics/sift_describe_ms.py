"""Median over the traced window's requests of the entry's returned
`sift_describe` stage (wall ms, synchronized, summed over the octaves of
both views): each octave's descriptor call and its per-peak assembly
(`features/sift.detect_and_compute_sift`)."""

from stitchbench.metrics._stage import median_stage


def read(ctx):
    return median_stage(ctx, "sift_describe")
