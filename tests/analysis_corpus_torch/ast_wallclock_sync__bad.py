"""LAF302 bad twin: a wall-clock pair around an enqueue, no sync."""
import time

from repro_torch.kernels.label_prop import packed_cluster_labels


def timed(slab, rows):
    t0 = time.perf_counter()
    out = packed_cluster_labels(slab, rows, 5, n=1024)
    return out, time.perf_counter() - t0
