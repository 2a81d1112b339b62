"""The benchmark of capsaicin_tpu_torch on one CUDA card (run.py)."""
