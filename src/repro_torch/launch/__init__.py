"""The port's launch layer (counterpart of ``repro.launch``): the train
step bodies (``steps``), the LAF launch lowerings (``cell``, ``mesh``,
``laf_cluster``), the shape-only dry run on fake ranks (``dryrun``, with
``trace_analysis`` for the reference's ``hlo_analysis``) and its
roofline (``roofline``).  The LM, recsys and GNN cell builders wait for
their parameter sharding rules (A10b)."""
