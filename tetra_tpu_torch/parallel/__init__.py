"""Multi-rank operation of the port (port of tetra_tpu.parallel):
carrier- and time-sharded meshes of torch.distributed ranks (`mesh`),
their collectives (`collectives`), the rank launcher (`launch`), the
two-host worker (`dist_worker`) and the sharded dry run (`dryrun`)."""
