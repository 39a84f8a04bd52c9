"""The benchmark of gvpm_tpu_torch: run one cell with
`python3 -m gbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>`
(see BENCHMARK.json and gbench/harness.py)."""
