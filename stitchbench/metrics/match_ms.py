"""Median over the traced window's requests of the entry's returned
`match` stage (wall ms, synchronized): the 2-NN matching and RANSAC of
every pair (`pipeline.register_pair`, `register_chain`'s consecutive and
skip pairs)."""

from stitchbench.metrics._stage import median_stage


def read(ctx):
    return median_stage(ctx, "match")
