"""The benchmark of gan_rl_3d_tpu_torch: see harness.py and PERF.md."""
