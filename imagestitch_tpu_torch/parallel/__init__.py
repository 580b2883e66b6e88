"""Stitching over devices (`imagestitch_tpu.parallel`): the mesh helpers,
the batched pair stitch on one device and its split over a mesh's "data"
axis, and one chain panorama split over a mesh (`parallel.pano`)."""

from imagestitch_tpu_torch.parallel.mesh import (Mesh, data_sharding,
                                                 make_mesh, use_mesh)

__all__ = [
    "Mesh",
    "make_mesh",
    "use_mesh",
    "data_sharding",
    "stitch_pairs_batched",
    "stitch_pairs_sharded",
    "stitch_chain_pano",
    "stitch_chain_pano_sharded",
    "stitch_pair_hostseam_sharded",
]


def __getattr__(name):
    # lazy: parallel.batch imports the pipeline, whose RANSAC engines
    # import parallel.mesh; an eager re-export would be circular
    if name in ("stitch_pairs_batched", "stitch_pairs_sharded"):
        from imagestitch_tpu_torch.parallel import batch
        return getattr(batch, name)
    if name in ("stitch_chain_pano", "stitch_chain_pano_sharded",
                "stitch_pair_hostseam_sharded"):
        from imagestitch_tpu_torch.parallel import pano
        return getattr(pano, name)
    raise AttributeError(name)
