"""The benchmark of zzflate_tpu_torch (the PyTorch and CUDA port): one
cell of ``BENCHMARK.json`` a run, ``python3 portbench/run.py --workload
<name> --seed <n> --seconds <s> --trace <0|1>``. See ``harness``."""
