"""CPU tests of the benchmark (run them with `python -m pytest
benchmark/tests`); the `gpu` cases need a CUDA card and skip themselves
without one."""

import torch


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; the test skips itself without one")
    # small batches: more threads than this only contend
    torch.set_num_threads(2)
