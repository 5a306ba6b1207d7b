"""LAF105 ok twin: query counts quantize to a power-of-two ladder."""
import math

N_MAX = 4096


def signatures(n):
    return (1 << max(7, math.ceil(math.log2(n))),)


def bound(n_max):
    return int(math.log2(n_max)) + 2
