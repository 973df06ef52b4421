"""Multi-stream tracking and its multi-device half.

`multistream`: S SLAM streams through one set of launches on one card (the
step and the batched local BA on array state) and `shard_step_over_mesh`,
the step with streams over `dp` and map points over `mp`; `multisystem`: S
complete systems behind one batched front end; `sharded_ba`: the CG bundle
adjustment and the essential graph with their observation / edge axis
split over a mesh; `mesh`: meshes of `torch.distributed` ranks, the
collectives they use and `spawn`, which runs N local ranks."""
