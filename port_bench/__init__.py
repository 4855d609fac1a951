"""The benchmark of ``i2v_tpu_torch`` on NVIDIA cards: one command runs one
cell once (``python3 -m port_bench.run --workload <name> --seed <n>
--seconds <s> --trace <0|1>``). See ``port_bench/README.md``."""
