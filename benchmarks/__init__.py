"""The benchmark of ``eeg_image_decode_tpu_torch`` on an NVIDIA H100: run
``python benchmarks/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` from the repository's root (``README.md`` here)."""
