"""The benchmark of ``tvidz_tpu_torch`` on one NVIDIA H100: its harness,
configurations, traffic, metric readers and plain reference. Run a cell with
``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``; ``BENCHMARK.json`` at the repository's root names them."""
