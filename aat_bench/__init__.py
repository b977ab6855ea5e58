"""The benchmark of ``alignment_algos_tpu_torch`` on one NVIDIA card.

``python -m aat_bench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` from the root of a checkout; see README.md."""
