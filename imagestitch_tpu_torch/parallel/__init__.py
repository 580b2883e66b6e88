"""Batched stitching on one card (`imagestitch_tpu.parallel`):
`stitch_pairs_batched`. The JAX package's mesh helpers and
`stitch_pairs_sharded` split a batch across devices; they are not ported
and wait for more than one GPU."""

from imagestitch_tpu_torch.parallel.batch import stitch_pairs_batched

__all__ = ["stitch_pairs_batched"]
