"""The benchmark of mash_tpu_torch on one NVIDIA H100 (see BENCHMARK.json
and ``python3 -m h100_bench.run --help``)."""
