"""The benchmark of the PyTorch and CUDA port (orthosfm_torch): whole
reconstructions, from tracks and from images, timed end to end on the card.
Run one cell: python3 sfm_bench/run.py --workload CELL --seed N --seconds S
--trace 0|1 (or python3 -m sfm_bench with the same arguments)."""
