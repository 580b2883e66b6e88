"""K2's share of its roofline in the pan cell: `k2_warp_roofline`'s
reader (every view into its stitch's spherical canvas over the device
time of the window's `warp_kernel` launches, in %)."""

from stitchbench import find

read = find.part("metrics", "k2_warp_roofline").read
