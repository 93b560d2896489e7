"""The benchmark of the PyTorch and CUDA port (``repro_torch``): the
elastic-SGD grid stepped through the trainer's public entry on one card.
Run ``python3 bench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` from the root of the repository."""
