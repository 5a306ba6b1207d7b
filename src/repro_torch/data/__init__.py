"""Seeded synthetic datasets and the host data pipeline (numpy copies of
``repro.data.synthetic``, ``repro.data.pipeline`` and
``repro.data.graph_sampler``)."""
