"""The benchmark of the PyTorch and CUDA port (``tqdne_tpu_torch``): one run
of one cell is ``python3 portbench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` from the root of a checkout."""
