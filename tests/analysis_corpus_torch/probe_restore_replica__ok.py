"""LAF108 ok twin: the restore rebuilt the capacity buffers."""


def build():
    pre = [("count", 64, 512, 48), ("bitmap", 64, 512, 48)]
    return {"pre_signatures": pre, "post_signatures": list(pre)}
