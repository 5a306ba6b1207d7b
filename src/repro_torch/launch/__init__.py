"""The port's launch layer (counterpart of ``repro.launch``): the step
bodies, the sharding rules, the sharded steps and the LM, recsys and
GNN cell builders with their dispatcher ``build_cell`` (``steps``), the
LAF launch lowerings (``cell``, ``mesh``, ``laf_cluster``), the
shape-only dry run on fake ranks (``dryrun``, with ``trace_analysis``
for the reference's ``hlo_analysis``) and its roofline (``roofline``)."""
