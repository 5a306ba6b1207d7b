"""LAF104 bad twin: rank 1's labels never met rank 0's (no MIN)."""


def build():
    return {"per_rank": [{"labels": [0, 0, 2, 3]}, {"labels": [0, 1, 2, 2]}], "replicated": ["labels"]}
