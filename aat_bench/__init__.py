"""The benchmark of ``alignment_algos_tpu_torch`` on the NVIDIA cards a cell asks for.

``python -m aat_bench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` from the root of a checkout; see README.md."""
