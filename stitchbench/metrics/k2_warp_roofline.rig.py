"""K2's share of its roofline in the rig cell: `k2_warp_roofline`'s
reader over the traced window's composes (each frame set's 4 views into
the frozen spherical canvas, over the device time of the window's
`warp_kernel` launches, in %)."""

from stitchbench import find

read = find.part("metrics", "k2_warp_roofline").read
