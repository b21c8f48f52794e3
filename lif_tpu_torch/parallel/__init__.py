"""Multi-device rendering (sharding.py) and the launcher of one-host
multi-rank runs (launch.py).

The counterpart of lif_tpu.parallel on torch.distributed: the mesh is a
DeviceMesh over the ranks of a process group, and lif_tpu's shard_map
collectives are all_gather and all_reduce over its axes' groups; without
a mesh, render_fused_projectors runs in one process."""
