"""Plain-PyTorch references of the benchmark: the lateral fast tier the
timed path is held to (lateral.py) and the exact ray march psnr_db reads
(exact.py). Neither imports the program, JAX or its package."""
