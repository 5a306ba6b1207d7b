"""LAF105 bad twin: every query count is its own launch signature."""
import math

N_MAX = 4096


def signatures(n):
    return (n,)


def bound(n_max):
    return int(math.log2(n_max)) + 2
