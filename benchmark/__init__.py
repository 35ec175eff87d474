"""The benchmark of the PyTorch/CUDA port (`slam1_tpu_torch`): one
command runs one cell (`run.py`), driven by `BENCHMARK.json` and the
data files under `configs/` and `traffic/`; `yardstick/` and
`reference/` are frozen copies that the program cannot change."""
