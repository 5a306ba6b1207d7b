"""Step bodies of the port (counterpart of ``repro.launch``): the train
steps only; the mesh, the lowering and the dry runs wait for the
multi-GPU slice (A10/A12)."""
