"""The benchmark of metalquicha_tpu_torch on one CUDA card (`run.py`)."""
