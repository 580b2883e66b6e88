"""Seconds of the process's first entry call (with a rig's calibration),
after the libraries are imported and the inputs made: the program's cold
start (`ops/cuda_build`, `native/ccl`, the first `jacfwd` of
`geometry/bundle`), on the harness's own clock."""


def read(ctx):
    return ctx.first_call_s
