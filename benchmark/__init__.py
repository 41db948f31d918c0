"""The benchmark of the PyTorch/CUDA port (`BENCHMARK.json` at the repository's
root): one cell, one run, `python3 benchmark/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`. Imports nothing of the JAX package."""
