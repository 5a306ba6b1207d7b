"""LAF-DBSCAN engines, post-processing and the pipeline (port of
``repro.core``, batch LAF-DBSCAN slice)."""
