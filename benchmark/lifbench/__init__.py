"""The harness of the benchmark: manifest, scenes, traffic, timing, the
trace reader, the work counts and the output check. run.py drives it."""
