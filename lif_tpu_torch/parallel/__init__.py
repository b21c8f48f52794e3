"""Multi-projector rendering: the exact fused oracle (sharding.py).

The counterpart of lif_tpu.parallel, so far in one process: the view axis
that lif_tpu shards over a device mesh is a stacked axis on the
projectors' device, and its collectives are reductions over it."""
