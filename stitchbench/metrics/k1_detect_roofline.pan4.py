"""K1's share of its roofline in the pan cell: `k1_detect_roofline`'s
reader (every view's pyramid at the work scale over the device time of
the window's `detect_maps_kernel` launches, in %)."""

from stitchbench import find

read = find.part("metrics", "k1_detect_roofline").read
