"""Batched multi-stream tracking: S SLAM streams through one set of launches
on one card (`multistream`: the step and the batched local BA on array
state; `multisystem`: S complete systems behind one batched front end)."""
