"""Scale-out: task scheduling, graph partitioning, sharded counting over a
device mesh and multi-process counting (the counterpart of
graphminer_tpu/parallel/)."""
