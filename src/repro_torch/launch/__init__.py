"""The port's launch layer (counterpart of ``repro.launch``): the step
bodies and the LM's sharding rules and sharded steps (``steps``), the
LAF launch lowerings (``cell``, ``mesh``, ``laf_cluster``), the
shape-only dry run on fake ranks (``dryrun``, with ``trace_analysis``
for the reference's ``hlo_analysis``) and its roofline (``roofline``).
The LM, recsys and GNN cell builders are still to be ported (A12b)."""
