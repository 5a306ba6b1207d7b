"""Seeded synthetic datasets (numpy copy of the LAF part of
``repro.data.synthetic``)."""
