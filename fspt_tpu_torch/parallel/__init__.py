"""Distribution layer (port of fspt_tpu.parallel) over torch.distributed:
meshes of shards over the ranks of a process group, the sharded sample
step, the train step with its gradient all-reduce (dist.py), the process
group's bring-up (multihost.py) and the scaling meter (scaling.py)."""
