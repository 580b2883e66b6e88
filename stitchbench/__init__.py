"""stitchbench: the benchmark of `imagestitch_tpu_torch` on one H100.
`python3 stitchbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of `BENCHMARK.json` once (see run.py)."""
