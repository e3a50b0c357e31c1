"""The port's benchmark: one command runs one cell of ``BENCHMARK.json``
(``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``)."""
