"""LAF108 bad twin: the restore trimmed the capacity buffers to the live
rows, so the first query after it runs a new launch signature."""


def build():
    pre = [("count", 64, 512, 48), ("bitmap", 64, 512, 48)]
    post = [("count", 64, 400, 48), ("bitmap", 64, 400, 48)]
    return {"pre_signatures": pre, "post_signatures": post}
