"""LAF302 ok twin: the card is synchronized before the clock is read."""
import time

import torch

from repro_torch.kernels.label_prop import packed_cluster_labels


def timed(slab, rows):
    t0 = time.perf_counter()
    out = packed_cluster_labels(slab, rows, 5, n=1024)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0
