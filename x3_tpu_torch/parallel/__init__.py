"""Scale-out of the port (x3_tpu.parallel): the device mesh and multi-process
input sharding."""
