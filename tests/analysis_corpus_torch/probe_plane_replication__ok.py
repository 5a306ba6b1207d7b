"""LAF104 ok twin: the labels agree after the round's MIN all-reduce."""


def build():
    return {"per_rank": [{"labels": [0, 0, 2, 2]}, {"labels": [0, 0, 2, 2]}], "replicated": ["labels"]}
