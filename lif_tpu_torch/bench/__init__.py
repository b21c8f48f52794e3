"""The port's benches: runners that drive lif_tpu_torch's entry points on
one CUDA card and print what they measure.

- throughput: the headline (render_fast_batch over a batch of lateral
  poses), the mixed-family composite and the headline's fidelity
  (``python3 bench_torch.py``);
- configs: the per-configuration sections, written to a JSON record
  (``python3 bench_configs_torch.py``);
- scaling: the tile-sharded exact march over 1..8 ranks and the fused
  oracle over a 4-rank view mesh, started by configs as a subprocess
  (``python3 bench_scaling_torch.py``);
- scenes: the seeded synthetic scenes and camera builders the runners and
  chip_smoke.py share;
- common: the sizes (BenchSizes and its presets), the device, timing,
  launch counts and fidelity bars.

Every runner measures on the card (``--device cuda``, the default) and
raises where there is none; ``--device cpu`` exists for the tests, and a
CPU run's timings are printed under a ``cpu_smoke`` key only.
"""
